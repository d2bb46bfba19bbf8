"""The consensus script interpreter: EvalScript / VerifyScript.

Host-side equivalent of the reference's `script/interpreter.cpp` — the full
stack machine with every consensus rule of Bitcoin Core 0.21:

- opcode loop with all limits (`interpreter.cpp:431-1259` EvalScript)
- CHECKSIG / CHECKSIGADD / CHECKMULTISIG incl. the extra-element bug
  (`interpreter.cpp:1083-1239`)
- CLTV/CSV (`interpreter.cpp:546-617`), conditionals, minimal-if
- VerifyScript orchestration: scriptSig → scriptPubKey on a shared stack,
  P2SH redeem re-eval, witness v0/v1 dispatch, cleanstack
  (`interpreter.cpp:1937-2056`)
- witness program execution P2WSH/P2WPKH (`interpreter.cpp:1855-1884`),
  Taproot key/script path + annex (`interpreter.cpp:1885-1926`), tapleaf
  merkle commitment (`interpreter.cpp:1834-1853`), OP_SUCCESSx and the
  tapscript validation-weight budget (`interpreter.cpp:1794-1832,371-409`)

The signature checker is an injection seam (mirroring the reference's
`BaseSignatureChecker` virtual dispatch, `interpreter.h:224-301`): the TPU
batch path substitutes a deferring checker here
(`bitcoinconsensus_tpu.models.batch` — SURVEY.md §7 deferral protocol).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from . import script as S
from .flags import (
    VERIFY_CHECKLOCKTIMEVERIFY,
    VERIFY_CHECKSEQUENCEVERIFY,
    VERIFY_CLEANSTACK,
    VERIFY_CONST_SCRIPTCODE,
    VERIFY_DERSIG,
    VERIFY_DISCOURAGE_OP_SUCCESS,
    VERIFY_DISCOURAGE_UPGRADABLE_NOPS,
    VERIFY_DISCOURAGE_UPGRADABLE_PUBKEYTYPE,
    VERIFY_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION,
    VERIFY_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM,
    VERIFY_LOW_S,
    VERIFY_MINIMALDATA,
    VERIFY_MINIMALIF,
    VERIFY_NULLDUMMY,
    VERIFY_NULLFAIL,
    VERIFY_P2SH,
    VERIFY_SIGPUSHONLY,
    VERIFY_STRICTENC,
    VERIFY_TAPROOT,
    VERIFY_WITNESS,
    VERIFY_WITNESS_PUBKEYTYPE,
)
from .script import (
    ANNEX_TAG,
    LOCKTIME_THRESHOLD,
    MAX_OPS_PER_SCRIPT,
    MAX_PUBKEYS_PER_MULTISIG,
    MAX_SCRIPT_ELEMENT_SIZE,
    MAX_SCRIPT_SIZE,
    MAX_STACK_SIZE,
    VALIDATION_WEIGHT_OFFSET,
    VALIDATION_WEIGHT_PER_SIGOP_PASSED,
    ScriptNumError,
    check_minimal_push,
    decode_op,
    find_and_delete,
    is_op_success,
    is_p2sh,
    is_push_only,
    is_witness_program,
    push_data,
    script_num_decode,
    script_num_encode,
    script_num_to_bool,
)
from .script_error import ScriptError as E
from .serialize import ser_string, write_compact_size
from .sighash import (
    SIGHASH_DEFAULT,
    PrecomputedTxData,
    SigVersion,
    bip143_sighash,
    bip341_sighash,
    legacy_sighash,
)
from .tx import SEQUENCE_FINAL, SEQUENCE_LOCKTIME_DISABLE_FLAG, SEQUENCE_LOCKTIME_MASK, SEQUENCE_LOCKTIME_TYPE_FLAG, Tx
from ..crypto import secp_host
from ..utils.hashes import hash160, ripemd160, sha1, sha256, sha256d, tagged_hash_midstate_engine

__all__ = [
    "BaseSignatureChecker",
    "TransactionSignatureChecker",
    "ScriptExecutionData",
    "eval_script",
    "verify_script",
    "verify_witness_program",
    "verify_taproot_commitment",
]

# interpreter.h:214-219 taproot control-block geometry
TAPROOT_LEAF_MASK = 0xFE
TAPROOT_LEAF_TAPSCRIPT = 0xC0
TAPROOT_CONTROL_BASE_SIZE = 33
TAPROOT_CONTROL_NODE_SIZE = 32
TAPROOT_CONTROL_MAX_NODE_COUNT = 128
TAPROOT_CONTROL_MAX_SIZE = (
    TAPROOT_CONTROL_BASE_SIZE + TAPROOT_CONTROL_NODE_SIZE * TAPROOT_CONTROL_MAX_NODE_COUNT
)

_TRUE = b"\x01"
_FALSE = b""


class ConditionStack:
    """O(1) IF/ELSE condition tracking (interpreter.cpp:297-342).

    Stores only the depth and the position of the first false value —
    all_true() must not rescan the stack (the opcode loop calls it per
    opcode, and nesting can be thousands deep within a 10kB script).
    """

    NO_FALSE = -1

    __slots__ = ("size", "first_false_pos")

    def __init__(self):
        self.size = 0
        self.first_false_pos = self.NO_FALSE

    def empty(self) -> bool:
        return self.size == 0

    def all_true(self) -> bool:
        return self.first_false_pos == self.NO_FALSE

    def push_back(self, f: bool) -> None:
        if self.first_false_pos == self.NO_FALSE and not f:
            self.first_false_pos = self.size
        self.size += 1

    def pop_back(self) -> None:
        self.size -= 1
        if self.first_false_pos == self.size:
            self.first_false_pos = self.NO_FALSE

    def toggle_top(self) -> None:
        if self.first_false_pos == self.NO_FALSE:
            # The top is true; make it false.
            self.first_false_pos = self.size - 1
        elif self.first_false_pos == self.size - 1:
            # The top is the first false; make it true again.
            self.first_false_pos = self.NO_FALSE
        # Otherwise a false beneath the top stays; top value is irrelevant.


class ScriptExecutionData:
    """interpreter.h ScriptExecutionData: per-execution taproot context."""

    __slots__ = (
        "annex_init",
        "annex_present",
        "annex_hash",
        "tapleaf_hash_init",
        "tapleaf_hash",
        "codeseparator_pos_init",
        "codeseparator_pos",
        "validation_weight_left_init",
        "validation_weight_left",
    )

    def __init__(self):
        self.annex_init = False
        self.annex_present = False
        self.annex_hash = b""
        self.tapleaf_hash_init = False
        self.tapleaf_hash = b""
        self.codeseparator_pos_init = False
        self.codeseparator_pos = 0xFFFFFFFF
        self.validation_weight_left_init = False
        self.validation_weight_left = 0


class BaseSignatureChecker:
    """interpreter.h:224-248 — all checks fail by default (context-free
    script evaluation uses this directly)."""

    def check_ecdsa_signature(
        self, sig: bytes, pubkey: bytes, script_code: bytes, sigversion: int
    ) -> bool:
        return False

    def check_schnorr_signature(
        self, sig: bytes, pubkey: bytes, sigversion: int, execdata: ScriptExecutionData
    ) -> Tuple[bool, Optional[E]]:
        """Returns (ok, error). error is set only for hard failures that
        abort the script (mirrors the serror out-param)."""
        return False, E.SCHNORR_SIG

    def check_lock_time(self, lock_time: int) -> bool:
        return False

    def check_sequence(self, sequence: int) -> bool:
        return False

    def verify_taproot_tweak(
        self, q: bytes, parity: int, p: bytes, t: bytes
    ) -> bool:
        """Taproot commitment curve check (pubkey.cpp:184-189
        CheckPayToContract). Exposed on the checker as the deferral seam for
        the batched TPU backend; semantics are pure (no tx context)."""
        return secp_host.xonly_tweak_add_check(q, parity, p, t)


class TransactionSignatureChecker(BaseSignatureChecker):
    """interpreter.cpp:1645-1788 GenericTransactionSignatureChecker."""

    def __init__(
        self,
        tx: Tx,
        n_in: int,
        amount: int,
        txdata: Optional[PrecomputedTxData] = None,
    ):
        self.tx = tx
        self.n_in = n_in
        self.amount = amount
        self.txdata = txdata

    # -- raw curve operations (override seam for caching/deferral/TPU) ------
    def verify_ecdsa(self, sig_der: bytes, pubkey: bytes, sighash: bytes) -> bool:
        return secp_host.verify_ecdsa(pubkey, sig_der, sighash)

    def verify_schnorr(self, sig64: bytes, pubkey32: bytes, sighash: bytes) -> bool:
        return secp_host.verify_schnorr(pubkey32, sig64, sighash)

    # -- checker interface ---------------------------------------------------
    def check_ecdsa_signature(
        self, sig: bytes, pubkey: bytes, script_code: bytes, sigversion: int
    ) -> bool:
        if not sig:
            return False
        # Fast pre-reject of unparseable pubkeys (CPubKey::IsValid — a pure
        # size/prefix sanity check; full point validation happens in verify).
        if not _pubkey_size_valid(pubkey):
            return False
        hash_type = sig[-1]
        sig_body = sig[:-1]
        if sigversion == SigVersion.WITNESS_V0:
            sighash = bip143_sighash(
                script_code, self.tx, self.n_in, hash_type, self.amount, self.txdata
            )
        else:
            sighash = legacy_sighash(script_code, self.tx, self.n_in, hash_type)
        return self.verify_ecdsa(sig_body, pubkey, sighash)

    def check_schnorr_signature(
        self, sig: bytes, pubkey: bytes, sigversion: int, execdata: ScriptExecutionData
    ) -> Tuple[bool, Optional[E]]:
        assert sigversion in (SigVersion.TAPROOT, SigVersion.TAPSCRIPT)
        assert len(pubkey) == 32
        if len(sig) not in (64, 65):
            return False, E.SCHNORR_SIG_SIZE
        hash_type = SIGHASH_DEFAULT
        if len(sig) == 65:
            hash_type = sig[-1]
            sig = sig[:-1]
            if hash_type == SIGHASH_DEFAULT:
                return False, E.SCHNORR_SIG_HASHTYPE
        assert self.txdata is not None
        sighash = bip341_sighash(
            self.tx,
            self.n_in,
            hash_type,
            sigversion,
            self.txdata,
            execdata.annex_present,
            execdata.annex_hash,
            execdata.tapleaf_hash,
            execdata.codeseparator_pos,
        )
        if sighash is None:
            return False, E.SCHNORR_SIG_HASHTYPE
        if not self.verify_schnorr(sig, pubkey, sighash):
            return False, E.SCHNORR_SIG
        return True, None

    def check_lock_time(self, lock_time: int) -> bool:
        tx_lock = self.tx.locktime
        if not (
            (tx_lock < LOCKTIME_THRESHOLD and lock_time < LOCKTIME_THRESHOLD)
            or (tx_lock >= LOCKTIME_THRESHOLD and lock_time >= LOCKTIME_THRESHOLD)
        ):
            return False
        if lock_time > tx_lock:
            return False
        if self.tx.vin[self.n_in].sequence == SEQUENCE_FINAL:
            return False
        return True

    def check_sequence(self, sequence: int) -> bool:
        tx_sequence = self.tx.vin[self.n_in].sequence
        # uint32 version comparison (interpreter.cpp:1752).
        if (self.tx.version & 0xFFFFFFFF) < 2:
            return False
        if tx_sequence & SEQUENCE_LOCKTIME_DISABLE_FLAG:
            return False
        mask = SEQUENCE_LOCKTIME_TYPE_FLAG | SEQUENCE_LOCKTIME_MASK
        tx_masked = tx_sequence & mask
        seq_masked = sequence & mask
        if not (
            (tx_masked < SEQUENCE_LOCKTIME_TYPE_FLAG and seq_masked < SEQUENCE_LOCKTIME_TYPE_FLAG)
            or (
                tx_masked >= SEQUENCE_LOCKTIME_TYPE_FLAG
                and seq_masked >= SEQUENCE_LOCKTIME_TYPE_FLAG
            )
        ):
            return False
        if seq_masked > tx_masked:
            return False
        return True


def _pubkey_size_valid(pubkey: bytes) -> bool:
    """CPubKey header/size validity (pubkey.h GetLen + IsValid)."""
    if not pubkey:
        return False
    if pubkey[0] in (2, 3):
        return len(pubkey) == 33
    if pubkey[0] in (4, 6, 7):
        return len(pubkey) == 65
    return False


# ---------------------------------------------------------------------------
# Signature / pubkey encoding checks (interpreter.cpp:189-226)
# ---------------------------------------------------------------------------

def _check_signature_encoding(sig: bytes, flags: int) -> Optional[E]:
    """CheckSignatureEncoding — returns error or None."""
    if len(sig) == 0:
        return None
    if flags & (VERIFY_DERSIG | VERIFY_LOW_S | VERIFY_STRICTENC):
        if not secp_host.is_valid_signature_encoding(sig):
            return E.SIG_DER
    if flags & VERIFY_LOW_S:
        # IsLowDERSignature: DER validity re-checked, then low-S.
        if not secp_host.is_valid_signature_encoding(sig):
            return E.SIG_DER
        if not secp_host.is_low_der_signature(sig):
            return E.SIG_HIGH_S
    if flags & VERIFY_STRICTENC:
        # IsDefinedHashtypeSignature (interpreter.cpp:189-198).
        hash_type = sig[-1] & ~0x80
        if hash_type < 1 or hash_type > 3:
            return E.SIG_HASHTYPE
    return None


def _check_pubkey_encoding(pubkey: bytes, flags: int, sigversion: int) -> Optional[E]:
    if flags & VERIFY_STRICTENC and not secp_host.is_compressed_or_uncompressed_pubkey(pubkey):
        return E.PUBKEYTYPE
    if (
        flags & VERIFY_WITNESS_PUBKEYTYPE
        and sigversion == SigVersion.WITNESS_V0
        and not secp_host.is_compressed_pubkey(pubkey)
    ):
        return E.WITNESS_PUBKEYTYPE
    return None


# ---------------------------------------------------------------------------
# EvalChecksig (interpreter.cpp:345-429)
# ---------------------------------------------------------------------------

def _eval_checksig(
    sig: bytes,
    pubkey: bytes,
    script_code_span: bytes,
    execdata: ScriptExecutionData,
    flags: int,
    checker: BaseSignatureChecker,
    sigversion: int,
) -> Tuple[bool, bool, Optional[E]]:
    """Returns (continue_ok, success, error)."""
    if sigversion in (SigVersion.BASE, SigVersion.WITNESS_V0):
        script_code = script_code_span
        if sigversion == SigVersion.BASE:
            script_code, found = find_and_delete(script_code, push_data(sig))
            if found > 0 and (flags & VERIFY_CONST_SCRIPTCODE):
                return False, False, E.SIG_FINDANDDELETE
        err = _check_signature_encoding(sig, flags)
        if err is None:
            err = _check_pubkey_encoding(pubkey, flags, sigversion)
        if err is not None:
            return False, False, err
        success = checker.check_ecdsa_signature(sig, pubkey, script_code, sigversion)
        if not success and (flags & VERIFY_NULLFAIL) and len(sig):
            return False, False, E.SIG_NULLFAIL
        return True, success, None

    assert sigversion == SigVersion.TAPSCRIPT
    # EvalChecksigTapscript (interpreter.cpp:371-409).
    success = len(sig) > 0
    if success:
        assert execdata.validation_weight_left_init
        execdata.validation_weight_left -= VALIDATION_WEIGHT_PER_SIGOP_PASSED
        if execdata.validation_weight_left < 0:
            return False, False, E.TAPSCRIPT_VALIDATION_WEIGHT
    if len(pubkey) == 0:
        return False, False, E.PUBKEYTYPE
    elif len(pubkey) == 32:
        if success:
            ok, err = checker.check_schnorr_signature(sig, pubkey, sigversion, execdata)
            if not ok:
                return False, False, err
    else:
        # Upgradable pubkey type: anything-goes unless discouraged.
        if flags & VERIFY_DISCOURAGE_UPGRADABLE_PUBKEYTYPE:
            return False, False, E.DISCOURAGE_UPGRADABLE_PUBKEYTYPE
    return True, success, None


# ---------------------------------------------------------------------------
# EvalScript (interpreter.cpp:431-1259)
# ---------------------------------------------------------------------------

_DISABLED_OPCODES = frozenset(
    [
        S.OP_CAT, S.OP_SUBSTR, S.OP_LEFT, S.OP_RIGHT, S.OP_INVERT, S.OP_AND,
        S.OP_OR, S.OP_XOR, S.OP_2MUL, S.OP_2DIV, S.OP_MUL, S.OP_DIV, S.OP_MOD,
        S.OP_LSHIFT, S.OP_RSHIFT,
    ]
)

_UPGRADABLE_NOPS = frozenset(
    [S.OP_NOP1, S.OP_NOP4, S.OP_NOP5, S.OP_NOP6, S.OP_NOP7, S.OP_NOP8, S.OP_NOP9, S.OP_NOP10]
)

_SIMPLE_NUMERIC = frozenset(
    [
        S.OP_ADD, S.OP_SUB, S.OP_BOOLAND, S.OP_BOOLOR, S.OP_NUMEQUAL,
        S.OP_NUMEQUALVERIFY, S.OP_NUMNOTEQUAL, S.OP_LESSTHAN, S.OP_GREATERTHAN,
        S.OP_LESSTHANOREQUAL, S.OP_GREATERTHANOREQUAL, S.OP_MIN, S.OP_MAX,
    ]
)

_UNARY_NUMERIC = frozenset(
    [S.OP_1ADD, S.OP_1SUB, S.OP_NEGATE, S.OP_ABS, S.OP_NOT, S.OP_0NOTEQUAL]
)

_HASH_OPS = frozenset(
    [S.OP_RIPEMD160, S.OP_SHA1, S.OP_SHA256, S.OP_HASH160, S.OP_HASH256]
)


def _getint(v: int) -> int:
    """CScriptNum::getint — clamp to int32 range (script.h:362-370)."""
    if v > 0x7FFFFFFF:
        return 0x7FFFFFFF
    if v < -0x80000000:
        return -0x80000000
    return v


def eval_script(
    stack: List[bytes],
    script: bytes,
    flags: int,
    checker: BaseSignatureChecker,
    sigversion: int,
    execdata: Optional[ScriptExecutionData] = None,
) -> Tuple[bool, E]:
    """EvalScript (interpreter.cpp:431-1259). Mutates ``stack`` in place."""
    if execdata is None:
        execdata = ScriptExecutionData()
    assert sigversion in (SigVersion.BASE, SigVersion.WITNESS_V0, SigVersion.TAPSCRIPT)

    pre_tapscript = sigversion in (SigVersion.BASE, SigVersion.WITNESS_V0)
    if pre_tapscript and len(script) > MAX_SCRIPT_SIZE:
        return False, E.SCRIPT_SIZE

    pc = 0
    pend = len(script)
    pbegincodehash = 0
    vf_exec = ConditionStack()
    altstack: List[bytes] = []
    n_op_count = 0
    require_minimal = bool(flags & VERIFY_MINIMALDATA)
    opcode_pos = 0
    execdata.codeseparator_pos = 0xFFFFFFFF
    execdata.codeseparator_pos_init = True

    try:
        while pc < pend:
            f_exec = vf_exec.all_true()

            opcode, push_value, pc = decode_op(script, pc)
            if opcode is None:
                return False, E.BAD_OPCODE
            if push_value is not None and len(push_value) > MAX_SCRIPT_ELEMENT_SIZE:
                return False, E.PUSH_SIZE

            if pre_tapscript:
                # OP_RESERVED does not count toward the opcode limit.
                if opcode > S.OP_16:
                    n_op_count += 1
                    if n_op_count > MAX_OPS_PER_SCRIPT:
                        return False, E.OP_COUNT

            if opcode in _DISABLED_OPCODES:
                return False, E.DISABLED_OPCODE  # CVE-2010-5137

            # CONST_SCRIPTCODE rejects OP_CODESEPARATOR in pre-segwit even in
            # an unexecuted branch (interpreter.cpp:498-500).
            if (
                opcode == S.OP_CODESEPARATOR
                and sigversion == SigVersion.BASE
                and (flags & VERIFY_CONST_SCRIPTCODE)
            ):
                return False, E.OP_CODESEPARATOR

            if f_exec and opcode <= S.OP_PUSHDATA4:
                if require_minimal and not check_minimal_push(push_value, opcode):
                    return False, E.MINIMALDATA
                stack.append(push_value)
            elif f_exec or (S.OP_IF <= opcode <= S.OP_ENDIF):
                # ---- push small integers -----------------------------------
                if opcode == S.OP_1NEGATE or (S.OP_1 <= opcode <= S.OP_16):
                    stack.append(script_num_encode(opcode - (S.OP_1 - 1)))

                # ---- control ----------------------------------------------
                elif opcode == S.OP_NOP:
                    pass

                elif opcode == S.OP_CHECKLOCKTIMEVERIFY:
                    if not (flags & VERIFY_CHECKLOCKTIMEVERIFY):
                        pass  # treat as NOP2
                    else:
                        if len(stack) < 1:
                            return False, E.INVALID_STACK_OPERATION
                        # 5-byte operand (interpreter.cpp:570).
                        lock_time = script_num_decode(stack[-1], require_minimal, 5)
                        if lock_time < 0:
                            return False, E.NEGATIVE_LOCKTIME
                        if not checker.check_lock_time(lock_time):
                            return False, E.UNSATISFIED_LOCKTIME

                elif opcode == S.OP_CHECKSEQUENCEVERIFY:
                    if not (flags & VERIFY_CHECKSEQUENCEVERIFY):
                        pass  # treat as NOP3
                    else:
                        if len(stack) < 1:
                            return False, E.INVALID_STACK_OPERATION
                        sequence = script_num_decode(stack[-1], require_minimal, 5)
                        if sequence < 0:
                            return False, E.NEGATIVE_LOCKTIME
                        if not (sequence & SEQUENCE_LOCKTIME_DISABLE_FLAG):
                            if not checker.check_sequence(sequence):
                                return False, E.UNSATISFIED_LOCKTIME

                elif opcode in _UPGRADABLE_NOPS:
                    if flags & VERIFY_DISCOURAGE_UPGRADABLE_NOPS:
                        return False, E.DISCOURAGE_UPGRADABLE_NOPS

                elif opcode in (S.OP_IF, S.OP_NOTIF):
                    f_value = False
                    if f_exec:
                        if len(stack) < 1:
                            return False, E.UNBALANCED_CONDITIONAL
                        vch = stack[-1]
                        if sigversion == SigVersion.TAPSCRIPT:
                            # Minimal IF is consensus in tapscript.
                            if len(vch) > 1 or (len(vch) == 1 and vch[0] != 1):
                                return False, E.TAPSCRIPT_MINIMALIF
                        if sigversion == SigVersion.WITNESS_V0 and (flags & VERIFY_MINIMALIF):
                            if len(vch) > 1:
                                return False, E.MINIMALIF
                            if len(vch) == 1 and vch[0] != 1:
                                return False, E.MINIMALIF
                        f_value = script_num_to_bool(vch)
                        if opcode == S.OP_NOTIF:
                            f_value = not f_value
                        stack.pop()
                    vf_exec.push_back(f_value)

                elif opcode == S.OP_ELSE:
                    if vf_exec.empty():
                        return False, E.UNBALANCED_CONDITIONAL
                    vf_exec.toggle_top()

                elif opcode == S.OP_ENDIF:
                    if vf_exec.empty():
                        return False, E.UNBALANCED_CONDITIONAL
                    vf_exec.pop_back()

                elif opcode == S.OP_VERIFY:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    if script_num_to_bool(stack[-1]):
                        stack.pop()
                    else:
                        return False, E.VERIFY

                elif opcode == S.OP_RETURN:
                    return False, E.OP_RETURN

                # ---- stack ops --------------------------------------------
                elif opcode == S.OP_TOALTSTACK:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    altstack.append(stack.pop())

                elif opcode == S.OP_FROMALTSTACK:
                    if len(altstack) < 1:
                        return False, E.INVALID_ALTSTACK_OPERATION
                    stack.append(altstack.pop())

                elif opcode == S.OP_2DROP:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    stack.pop()
                    stack.pop()

                elif opcode == S.OP_2DUP:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    stack.extend([stack[-2], stack[-1]])

                elif opcode == S.OP_3DUP:
                    if len(stack) < 3:
                        return False, E.INVALID_STACK_OPERATION
                    stack.extend([stack[-3], stack[-2], stack[-1]])

                elif opcode == S.OP_2OVER:
                    if len(stack) < 4:
                        return False, E.INVALID_STACK_OPERATION
                    stack.extend([stack[-4], stack[-3]])

                elif opcode == S.OP_2ROT:
                    if len(stack) < 6:
                        return False, E.INVALID_STACK_OPERATION
                    vch1, vch2 = stack[-6], stack[-5]
                    del stack[-6:-4]
                    stack.extend([vch1, vch2])

                elif opcode == S.OP_2SWAP:
                    if len(stack) < 4:
                        return False, E.INVALID_STACK_OPERATION
                    stack[-4], stack[-2] = stack[-2], stack[-4]
                    stack[-3], stack[-1] = stack[-1], stack[-3]

                elif opcode == S.OP_IFDUP:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    if script_num_to_bool(stack[-1]):
                        stack.append(stack[-1])

                elif opcode == S.OP_DEPTH:
                    stack.append(script_num_encode(len(stack)))

                elif opcode == S.OP_DROP:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    stack.pop()

                elif opcode == S.OP_DUP:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    stack.append(stack[-1])

                elif opcode == S.OP_NIP:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    del stack[-2]

                elif opcode == S.OP_OVER:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    stack.append(stack[-2])

                elif opcode in (S.OP_PICK, S.OP_ROLL):
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    n = _getint(script_num_decode(stack[-1], require_minimal))
                    stack.pop()
                    if n < 0 or n >= len(stack):
                        return False, E.INVALID_STACK_OPERATION
                    vch = stack[-n - 1]
                    if opcode == S.OP_ROLL:
                        del stack[-n - 1]
                    stack.append(vch)

                elif opcode == S.OP_ROT:
                    if len(stack) < 3:
                        return False, E.INVALID_STACK_OPERATION
                    stack[-3], stack[-2] = stack[-2], stack[-3]
                    stack[-2], stack[-1] = stack[-1], stack[-2]

                elif opcode == S.OP_SWAP:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    stack[-2], stack[-1] = stack[-1], stack[-2]

                elif opcode == S.OP_TUCK:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    stack.insert(-2, stack[-1])

                elif opcode == S.OP_SIZE:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    stack.append(script_num_encode(len(stack[-1])))

                # ---- bitwise logic ----------------------------------------
                elif opcode in (S.OP_EQUAL, S.OP_EQUALVERIFY):
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    f_equal = stack[-2] == stack[-1]
                    stack.pop()
                    stack.pop()
                    stack.append(_TRUE if f_equal else _FALSE)
                    if opcode == S.OP_EQUALVERIFY:
                        if f_equal:
                            stack.pop()
                        else:
                            return False, E.EQUALVERIFY

                # ---- numeric ----------------------------------------------
                elif opcode in _UNARY_NUMERIC:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    bn = script_num_decode(stack[-1], require_minimal)
                    if opcode == S.OP_1ADD:
                        bn += 1
                    elif opcode == S.OP_1SUB:
                        bn -= 1
                    elif opcode == S.OP_NEGATE:
                        bn = -bn
                    elif opcode == S.OP_ABS:
                        bn = abs(bn)
                    elif opcode == S.OP_NOT:
                        bn = int(bn == 0)
                    elif opcode == S.OP_0NOTEQUAL:
                        bn = int(bn != 0)
                    stack.pop()
                    stack.append(script_num_encode(bn))

                elif opcode in _SIMPLE_NUMERIC:
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    bn1 = script_num_decode(stack[-2], require_minimal)
                    bn2 = script_num_decode(stack[-1], require_minimal)
                    if opcode == S.OP_ADD:
                        bn = bn1 + bn2
                    elif opcode == S.OP_SUB:
                        bn = bn1 - bn2
                    elif opcode == S.OP_BOOLAND:
                        bn = int(bn1 != 0 and bn2 != 0)
                    elif opcode == S.OP_BOOLOR:
                        bn = int(bn1 != 0 or bn2 != 0)
                    elif opcode in (S.OP_NUMEQUAL, S.OP_NUMEQUALVERIFY):
                        bn = int(bn1 == bn2)
                    elif opcode == S.OP_NUMNOTEQUAL:
                        bn = int(bn1 != bn2)
                    elif opcode == S.OP_LESSTHAN:
                        bn = int(bn1 < bn2)
                    elif opcode == S.OP_GREATERTHAN:
                        bn = int(bn1 > bn2)
                    elif opcode == S.OP_LESSTHANOREQUAL:
                        bn = int(bn1 <= bn2)
                    elif opcode == S.OP_GREATERTHANOREQUAL:
                        bn = int(bn1 >= bn2)
                    elif opcode == S.OP_MIN:
                        bn = min(bn1, bn2)
                    else:  # OP_MAX
                        bn = max(bn1, bn2)
                    stack.pop()
                    stack.pop()
                    stack.append(script_num_encode(bn))
                    if opcode == S.OP_NUMEQUALVERIFY:
                        if script_num_to_bool(stack[-1]):
                            stack.pop()
                        else:
                            return False, E.NUMEQUALVERIFY

                elif opcode == S.OP_WITHIN:
                    if len(stack) < 3:
                        return False, E.INVALID_STACK_OPERATION
                    bn1 = script_num_decode(stack[-3], require_minimal)
                    bn2 = script_num_decode(stack[-2], require_minimal)
                    bn3 = script_num_decode(stack[-1], require_minimal)
                    f_value = bn2 <= bn1 < bn3
                    stack.pop()
                    stack.pop()
                    stack.pop()
                    stack.append(_TRUE if f_value else _FALSE)

                # ---- crypto -----------------------------------------------
                elif opcode in _HASH_OPS:
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    vch = stack.pop()
                    if opcode == S.OP_RIPEMD160:
                        stack.append(ripemd160(vch))
                    elif opcode == S.OP_SHA1:
                        stack.append(sha1(vch))
                    elif opcode == S.OP_SHA256:
                        stack.append(sha256(vch))
                    elif opcode == S.OP_HASH160:
                        stack.append(hash160(vch))
                    else:  # OP_HASH256
                        stack.append(sha256d(vch))

                elif opcode == S.OP_CODESEPARATOR:
                    # Hash starts after the code separator.
                    pbegincodehash = pc
                    execdata.codeseparator_pos = opcode_pos

                elif opcode in (S.OP_CHECKSIG, S.OP_CHECKSIGVERIFY):
                    if len(stack) < 2:
                        return False, E.INVALID_STACK_OPERATION
                    vch_sig = stack[-2]
                    vch_pubkey = stack[-1]
                    cont, f_success, err = _eval_checksig(
                        vch_sig, vch_pubkey, script[pbegincodehash:pend],
                        execdata, flags, checker, sigversion,
                    )
                    if not cont:
                        return False, err
                    stack.pop()
                    stack.pop()
                    stack.append(_TRUE if f_success else _FALSE)
                    if opcode == S.OP_CHECKSIGVERIFY:
                        if f_success:
                            stack.pop()
                        else:
                            return False, E.CHECKSIGVERIFY

                elif opcode == S.OP_CHECKSIGADD:
                    # Tapscript only (interpreter.cpp:1108-1127).
                    if pre_tapscript:
                        return False, E.BAD_OPCODE
                    if len(stack) < 3:
                        return False, E.INVALID_STACK_OPERATION
                    sig = stack[-3]
                    num = script_num_decode(stack[-2], require_minimal)
                    pubkey = stack[-1]
                    cont, f_success, err = _eval_checksig(
                        sig, pubkey, script[pbegincodehash:pend],
                        execdata, flags, checker, sigversion,
                    )
                    if not cont:
                        return False, err
                    stack.pop()
                    stack.pop()
                    stack.pop()
                    stack.append(script_num_encode(num + (1 if f_success else 0)))

                elif opcode in (S.OP_CHECKMULTISIG, S.OP_CHECKMULTISIGVERIFY):
                    if sigversion == SigVersion.TAPSCRIPT:
                        return False, E.TAPSCRIPT_CHECKMULTISIG

                    i = 1
                    if len(stack) < i:
                        return False, E.INVALID_STACK_OPERATION
                    n_keys = _getint(script_num_decode(stack[-i], require_minimal))
                    if n_keys < 0 or n_keys > MAX_PUBKEYS_PER_MULTISIG:
                        return False, E.PUBKEY_COUNT
                    n_op_count += n_keys
                    if n_op_count > MAX_OPS_PER_SCRIPT:
                        return False, E.OP_COUNT
                    i += 1
                    ikey = i
                    # ikey2: position of the last non-signature item
                    # (for NULLFAIL cleanup; interpreter.cpp:1147-1149).
                    ikey2 = n_keys + 2
                    i += n_keys
                    if len(stack) < i:
                        return False, E.INVALID_STACK_OPERATION
                    n_sigs = _getint(script_num_decode(stack[-i], require_minimal))
                    if n_sigs < 0 or n_sigs > n_keys:
                        return False, E.SIG_COUNT
                    i += 1
                    isig = i
                    i += n_sigs
                    if len(stack) < i:
                        return False, E.INVALID_STACK_OPERATION

                    script_code = script[pbegincodehash:pend]
                    # FindAndDelete every signature (pre-segwit only).
                    for k in range(n_sigs):
                        vch_sig = stack[-isig - k]
                        if sigversion == SigVersion.BASE:
                            script_code, found = find_and_delete(script_code, push_data(vch_sig))
                            if found > 0 and (flags & VERIFY_CONST_SCRIPTCODE):
                                return False, E.SIG_FINDANDDELETE

                    f_success = True
                    while f_success and n_sigs > 0:
                        vch_sig = stack[-isig]
                        vch_pubkey = stack[-ikey]
                        # The evaluation order of pubkey/sig checks is
                        # distinguishable under STRICTENC (interpreter.cpp:1182).
                        err = _check_signature_encoding(vch_sig, flags)
                        if err is None:
                            err = _check_pubkey_encoding(vch_pubkey, flags, sigversion)
                        if err is not None:
                            return False, err
                        f_ok = checker.check_ecdsa_signature(
                            vch_sig, vch_pubkey, script_code, sigversion
                        )
                        if f_ok:
                            isig += 1
                            n_sigs -= 1
                        ikey += 1
                        n_keys -= 1
                        # More sigs left than keys → cannot succeed.
                        if n_sigs > n_keys:
                            f_success = False

                    # Clean up all arguments (interpreter.cpp:1207-1215).
                    while i > 1:
                        i -= 1
                        if (
                            not f_success
                            and (flags & VERIFY_NULLFAIL)
                            and ikey2 == 0
                            and len(stack[-1])
                        ):
                            return False, E.SIG_NULLFAIL
                        if ikey2 > 0:
                            ikey2 -= 1
                        stack.pop()

                    # The extra-element consumption bug (interpreter.cpp:1217-1227).
                    if len(stack) < 1:
                        return False, E.INVALID_STACK_OPERATION
                    if (flags & VERIFY_NULLDUMMY) and len(stack[-1]):
                        return False, E.SIG_NULLDUMMY
                    stack.pop()

                    stack.append(_TRUE if f_success else _FALSE)
                    if opcode == S.OP_CHECKMULTISIGVERIFY:
                        if f_success:
                            stack.pop()
                        else:
                            return False, E.CHECKMULTISIGVERIFY

                else:
                    return False, E.BAD_OPCODE

            if len(stack) + len(altstack) > MAX_STACK_SIZE:
                return False, E.STACK_SIZE

            opcode_pos += 1
    except ScriptNumError:
        return False, E.UNKNOWN_ERROR

    if not vf_exec.empty():
        return False, E.UNBALANCED_CONDITIONAL
    return True, E.OK


# ---------------------------------------------------------------------------
# Witness program execution (interpreter.cpp:1794-1935)
# ---------------------------------------------------------------------------

def execute_witness_script(
    stack_in: List[bytes],
    exec_script: bytes,
    flags: int,
    sigversion: int,
    checker: BaseSignatureChecker,
    execdata: ScriptExecutionData,
) -> Tuple[bool, E]:
    stack = list(stack_in)

    if sigversion == SigVersion.TAPSCRIPT:
        # OP_SUCCESSx processing overrides everything, incl. size limits.
        pos = 0
        while pos < len(exec_script):
            opcode, _, pos = decode_op(exec_script, pos)
            if opcode is None:
                # Unreachable if an OP_SUCCESSx appeared earlier.
                return False, E.BAD_OPCODE
            if is_op_success(opcode):
                if flags & VERIFY_DISCOURAGE_OP_SUCCESS:
                    return False, E.DISCOURAGE_OP_SUCCESS
                return True, E.OK
        # Tapscript enforces initial stack size limits.
        if len(stack) > MAX_STACK_SIZE:
            return False, E.STACK_SIZE

    for elem in stack:
        if len(elem) > MAX_SCRIPT_ELEMENT_SIZE:
            return False, E.PUSH_SIZE

    ok, err = eval_script(stack, exec_script, flags, checker, sigversion, execdata)
    if not ok:
        return False, err

    # Scripts inside witness implicitly require cleanstack behaviour.
    if len(stack) != 1:
        return False, E.CLEANSTACK
    if not script_num_to_bool(stack[-1]):
        return False, E.EVAL_FALSE
    return True, E.OK


def verify_taproot_commitment(
    control: bytes,
    program: bytes,
    script: bytes,
    checker: Optional[BaseSignatureChecker] = None,
) -> Optional[bytes]:
    """VerifyTaprootCommitment (interpreter.cpp:1834-1853).

    Returns the tapleaf hash on success, None on failure. The final curve
    check routes through `checker.verify_taproot_tweak` when a checker is
    given (deferral seam).
    """
    path_len = (len(control) - TAPROOT_CONTROL_BASE_SIZE) // TAPROOT_CONTROL_NODE_SIZE
    p = control[1:TAPROOT_CONTROL_BASE_SIZE]  # internal key
    q = program  # output key

    eng = tagged_hash_midstate_engine("TapLeaf")
    eng.update(bytes([control[0] & TAPROOT_LEAF_MASK]) + ser_string(script))
    tapleaf_hash = eng.digest()

    k = tapleaf_hash
    for i in range(path_len):
        node = control[
            TAPROOT_CONTROL_BASE_SIZE
            + TAPROOT_CONTROL_NODE_SIZE * i : TAPROOT_CONTROL_BASE_SIZE
            + TAPROOT_CONTROL_NODE_SIZE * (i + 1)
        ]
        eng = tagged_hash_midstate_engine("TapBranch")
        if k < node:
            eng.update(k + node)
        else:
            eng.update(node + k)
        k = eng.digest()

    eng = tagged_hash_midstate_engine("TapTweak")
    eng.update(p + k)
    t = eng.digest()
    if checker is None:
        ok = secp_host.xonly_tweak_add_check(q, control[0] & 1, p, t)
    else:
        ok = checker.verify_taproot_tweak(q, control[0] & 1, p, t)
    if ok:
        return tapleaf_hash
    return None


def _witness_stack_serialized_size(witness: List[bytes]) -> int:
    """GetSerializeSize of the witness stack (vector of byte vectors)."""
    total = len(write_compact_size(len(witness)))
    for item in witness:
        total += len(write_compact_size(len(item))) + len(item)
    return total


def verify_witness_program(
    witness: List[bytes],
    witversion: int,
    program: bytes,
    flags: int,
    checker: BaseSignatureChecker,
    is_p2sh_wrapped: bool,
) -> Tuple[bool, E]:
    """VerifyWitnessProgram (interpreter.cpp:1855-1935)."""
    stack = list(witness)
    execdata = ScriptExecutionData()

    if witversion == 0:
        if len(program) == 32:
            # BIP141 P2WSH.
            if len(stack) == 0:
                return False, E.WITNESS_PROGRAM_WITNESS_EMPTY
            script_bytes = stack.pop()
            exec_script = script_bytes
            if sha256(exec_script) != program:
                return False, E.WITNESS_PROGRAM_MISMATCH
            return execute_witness_script(
                stack, exec_script, flags, SigVersion.WITNESS_V0, checker, execdata
            )
        elif len(program) == 20:
            # BIP141 P2WPKH.
            if len(stack) != 2:
                return False, E.WITNESS_PROGRAM_MISMATCH
            exec_script = (
                bytes([S.OP_DUP, S.OP_HASH160]) + push_data(program)
                + bytes([S.OP_EQUALVERIFY, S.OP_CHECKSIG])
            )
            return execute_witness_script(
                stack, exec_script, flags, SigVersion.WITNESS_V0, checker, execdata
            )
        else:
            return False, E.WITNESS_PROGRAM_WRONG_LENGTH
    elif witversion == 1 and len(program) == 32 and not is_p2sh_wrapped:
        # BIP341 Taproot.
        if not (flags & VERIFY_TAPROOT):
            return True, E.OK
        if len(stack) == 0:
            return False, E.WITNESS_PROGRAM_WITNESS_EMPTY
        if len(stack) >= 2 and stack[-1] and stack[-1][0] == ANNEX_TAG:
            annex = stack.pop()
            execdata.annex_hash = sha256(ser_string(annex))
            execdata.annex_present = True
        else:
            execdata.annex_present = False
        execdata.annex_init = True
        if len(stack) == 1:
            # Key path spend.
            ok, err = checker.check_schnorr_signature(
                stack[0], program, SigVersion.TAPROOT, execdata
            )
            if not ok:
                return False, err if err is not None else E.SCHNORR_SIG
            return True, E.OK
        else:
            # Script path spend.
            control = stack.pop()
            script_bytes = stack.pop()
            exec_script = script_bytes
            if (
                len(control) < TAPROOT_CONTROL_BASE_SIZE
                or len(control) > TAPROOT_CONTROL_MAX_SIZE
                or (len(control) - TAPROOT_CONTROL_BASE_SIZE) % TAPROOT_CONTROL_NODE_SIZE != 0
            ):
                return False, E.TAPROOT_WRONG_CONTROL_SIZE
            tapleaf_hash = verify_taproot_commitment(
                control, program, exec_script, checker
            )
            if tapleaf_hash is None:
                return False, E.WITNESS_PROGRAM_MISMATCH
            execdata.tapleaf_hash = tapleaf_hash
            execdata.tapleaf_hash_init = True
            if (control[0] & TAPROOT_LEAF_MASK) == TAPROOT_LEAF_TAPSCRIPT:
                # Tapscript (leaf version 0xc0): budget from FULL witness.
                execdata.validation_weight_left = (
                    _witness_stack_serialized_size(witness) + VALIDATION_WEIGHT_OFFSET
                )
                execdata.validation_weight_left_init = True
                return execute_witness_script(
                    stack, exec_script, flags, SigVersion.TAPSCRIPT, checker, execdata
                )
            if flags & VERIFY_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION:
                return False, E.DISCOURAGE_UPGRADABLE_TAPROOT_VERSION
            return True, E.OK
    else:
        if flags & VERIFY_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM:
            return False, E.DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM
        # Future softfork compatibility.
        return True, E.OK


def verify_script(
    script_sig: bytes,
    script_pubkey: bytes,
    witness: Optional[List[bytes]],
    flags: int,
    checker: BaseSignatureChecker,
) -> Tuple[bool, E]:
    """VerifyScript (interpreter.cpp:1937-2056)."""
    if witness is None:
        witness = []
    had_witness = False

    if (flags & VERIFY_SIGPUSHONLY) and not is_push_only(script_sig):
        return False, E.SIG_PUSHONLY

    # scriptSig and scriptPubKey evaluated sequentially on the same stack
    # (CVE-2010-5141).
    stack: List[bytes] = []
    ok, err = eval_script(stack, script_sig, flags, checker, SigVersion.BASE)
    if not ok:
        return False, err
    stack_copy = list(stack) if flags & VERIFY_P2SH else []
    ok, err = eval_script(stack, script_pubkey, flags, checker, SigVersion.BASE)
    if not ok:
        return False, err
    if not stack:
        return False, E.EVAL_FALSE
    if not script_num_to_bool(stack[-1]):
        return False, E.EVAL_FALSE

    # Bare witness programs.
    if flags & VERIFY_WITNESS:
        wp = is_witness_program(script_pubkey)
        if wp is not None:
            had_witness = True
            if len(script_sig) != 0:
                # scriptSig must be exactly empty or malleability returns.
                return False, E.WITNESS_MALLEATED
            ok, err = verify_witness_program(
                witness, wp[0], wp[1], flags, checker, is_p2sh_wrapped=False
            )
            if not ok:
                return False, err
            # Bypass the cleanstack check: leave exactly one element.
            del stack[1:]

    # Additional validation for P2SH.
    if (flags & VERIFY_P2SH) and is_p2sh(script_pubkey):
        if not is_push_only(script_sig):
            return False, E.SIG_PUSHONLY
        # Restore the scriptSig-only stack.
        stack = stack_copy
        assert stack
        pubkey_serialized = stack.pop()
        pubkey2 = pubkey_serialized

        ok, err = eval_script(stack, pubkey2, flags, checker, SigVersion.BASE)
        if not ok:
            return False, err
        if not stack:
            return False, E.EVAL_FALSE
        if not script_num_to_bool(stack[-1]):
            return False, E.EVAL_FALSE

        # P2SH witness program.
        if flags & VERIFY_WITNESS:
            wp = is_witness_program(pubkey2)
            if wp is not None:
                had_witness = True
                if script_sig != push_data(pubkey2):
                    # scriptSig must be exactly a single push of the
                    # redeemScript.
                    return False, E.WITNESS_MALLEATED_P2SH
                ok, err = verify_witness_program(
                    witness, wp[0], wp[1], flags, checker, is_p2sh_wrapped=True
                )
                if not ok:
                    return False, err
                del stack[1:]

    # CLEANSTACK only after potential P2SH/witness evaluation.
    if flags & VERIFY_CLEANSTACK:
        assert flags & VERIFY_P2SH
        assert flags & VERIFY_WITNESS
        if len(stack) != 1:
            return False, E.CLEANSTACK

    if flags & VERIFY_WITNESS:
        assert flags & VERIFY_P2SH
        if not had_witness and witness:
            return False, E.WITNESS_UNEXPECTED

    return True, E.OK
