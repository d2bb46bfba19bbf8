"""Script container: opcodes, decoding, pattern predicates, CScriptNum.

Host-side equivalent of the reference's `script/script.{h,cpp}`: the opcode
enum (`script.h:65-205`), consensus limits (`script.h:23-56`), push decoding
(`script.cpp:283-333` GetScriptOp), pattern tests (`script.cpp:201-256`),
OP_SUCCESSx classification (`script.cpp:335-341`), legacy sigop counting
(`script.cpp:153-199`) and the minimal-encoding int64 `CScriptNum`
(`script.h:218-391`).

Scripts are plain `bytes` here — the structure lives in the decoder, not in
a container class; this keeps the hot host loop allocation-light.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

__all__ = [
    "ScriptNumError",
    "script_num_decode",
    "script_num_encode",
    "decode_op",
    "iter_ops",
    "is_p2sh",
    "is_witness_program",
    "is_push_only",
    "is_op_success",
    "is_unspendable",
    "check_minimal_push",
    "get_sig_op_count",
    "witness_sig_ops",
    "find_and_delete",
    "push_data",
]

# --- consensus limits (script.h:23-56) -------------------------------------
MAX_SCRIPT_ELEMENT_SIZE = 520
MAX_OPS_PER_SCRIPT = 201
MAX_PUBKEYS_PER_MULTISIG = 20
MAX_SCRIPT_SIZE = 10000
MAX_STACK_SIZE = 1000
LOCKTIME_THRESHOLD = 500_000_000
ANNEX_TAG = 0x50
VALIDATION_WEIGHT_PER_SIGOP_PASSED = 50
VALIDATION_WEIGHT_OFFSET = 50

# --- opcodes (script.h:65-205) ---------------------------------------------
OP_0 = 0x00
OP_FALSE = OP_0
OP_PUSHDATA1 = 0x4C
OP_PUSHDATA2 = 0x4D
OP_PUSHDATA4 = 0x4E
OP_1NEGATE = 0x4F
OP_RESERVED = 0x50
OP_1 = 0x51
OP_TRUE = OP_1
OP_2 = 0x52
OP_3 = 0x53
OP_4 = 0x54
OP_5 = 0x55
OP_6 = 0x56
OP_7 = 0x57
OP_8 = 0x58
OP_9 = 0x59
OP_10 = 0x5A
OP_11 = 0x5B
OP_12 = 0x5C
OP_13 = 0x5D
OP_14 = 0x5E
OP_15 = 0x5F
OP_16 = 0x60

# control
OP_NOP = 0x61
OP_VER = 0x62
OP_IF = 0x63
OP_NOTIF = 0x64
OP_VERIF = 0x65
OP_VERNOTIF = 0x66
OP_ELSE = 0x67
OP_ENDIF = 0x68
OP_VERIFY = 0x69
OP_RETURN = 0x6A

# stack ops
OP_TOALTSTACK = 0x6B
OP_FROMALTSTACK = 0x6C
OP_2DROP = 0x6D
OP_2DUP = 0x6E
OP_3DUP = 0x6F
OP_2OVER = 0x70
OP_2ROT = 0x71
OP_2SWAP = 0x72
OP_IFDUP = 0x73
OP_DEPTH = 0x74
OP_DROP = 0x75
OP_DUP = 0x76
OP_NIP = 0x77
OP_OVER = 0x78
OP_PICK = 0x79
OP_ROLL = 0x7A
OP_ROT = 0x7B
OP_SWAP = 0x7C
OP_TUCK = 0x7D

# splice ops
OP_CAT = 0x7E
OP_SUBSTR = 0x7F
OP_LEFT = 0x80
OP_RIGHT = 0x81
OP_SIZE = 0x82

# bit logic
OP_INVERT = 0x83
OP_AND = 0x84
OP_OR = 0x85
OP_XOR = 0x86
OP_EQUAL = 0x87
OP_EQUALVERIFY = 0x88
OP_RESERVED1 = 0x89
OP_RESERVED2 = 0x8A

# numeric
OP_1ADD = 0x8B
OP_1SUB = 0x8C
OP_2MUL = 0x8D
OP_2DIV = 0x8E
OP_NEGATE = 0x8F
OP_ABS = 0x90
OP_NOT = 0x91
OP_0NOTEQUAL = 0x92
OP_ADD = 0x93
OP_SUB = 0x94
OP_MUL = 0x95
OP_DIV = 0x96
OP_MOD = 0x97
OP_LSHIFT = 0x98
OP_RSHIFT = 0x99
OP_BOOLAND = 0x9A
OP_BOOLOR = 0x9B
OP_NUMEQUAL = 0x9C
OP_NUMEQUALVERIFY = 0x9D
OP_NUMNOTEQUAL = 0x9E
OP_LESSTHAN = 0x9F
OP_GREATERTHAN = 0xA0
OP_LESSTHANOREQUAL = 0xA1
OP_GREATERTHANOREQUAL = 0xA2
OP_MIN = 0xA3
OP_MAX = 0xA4
OP_WITHIN = 0xA5

# crypto
OP_RIPEMD160 = 0xA6
OP_SHA1 = 0xA7
OP_SHA256 = 0xA8
OP_HASH160 = 0xA9
OP_HASH256 = 0xAA
OP_CODESEPARATOR = 0xAB
OP_CHECKSIG = 0xAC
OP_CHECKSIGVERIFY = 0xAD
OP_CHECKMULTISIG = 0xAE
OP_CHECKMULTISIGVERIFY = 0xAF

# expansion
OP_NOP1 = 0xB0
OP_CHECKLOCKTIMEVERIFY = 0xB1
OP_NOP2 = OP_CHECKLOCKTIMEVERIFY
OP_CHECKSEQUENCEVERIFY = 0xB2
OP_NOP3 = OP_CHECKSEQUENCEVERIFY
OP_NOP4 = 0xB3
OP_NOP5 = 0xB4
OP_NOP6 = 0xB5
OP_NOP7 = 0xB6
OP_NOP8 = 0xB7
OP_NOP9 = 0xB8
OP_NOP10 = 0xB9

# BIP342
OP_CHECKSIGADD = 0xBA

OP_INVALIDOPCODE = 0xFF

class ScriptNumError(Exception):
    """CScriptNum overflow / non-minimal encoding (script.h:227-240 throws)."""


def script_num_decode(
    data: bytes, require_minimal: bool, max_size: int = 4
) -> int:
    """Decode a stack element as CScriptNum (script.h:222-251, 296-330).

    Little-endian sign-magnitude; rejects encodings longer than ``max_size``
    and, when ``require_minimal``, encodings with a redundant leading byte.
    """
    if len(data) > max_size:
        raise ScriptNumError("script number overflow")
    if require_minimal and len(data) > 0:
        # script.h:230-239: top byte must carry information.
        if data[-1] & 0x7F == 0:
            if len(data) <= 1 or not (data[-2] & 0x80):
                raise ScriptNumError("non-minimally encoded script number")
    if not data:
        return 0
    result = int.from_bytes(data, "little")
    if data[-1] & 0x80:
        # Clear the sign bit and negate.
        result &= ~(0x80 << (8 * (len(data) - 1)))
        return -result
    return result


def script_num_encode(n: int) -> bytes:
    """Serialize an int64 as minimal CScriptNum (script.h:332-360)."""
    if n == 0:
        return b""
    negative = n < 0
    absvalue = -n if negative else n
    out = bytearray()
    while absvalue:
        out.append(absvalue & 0xFF)
        absvalue >>= 8
    # If the MSB is set, an extra byte carries the sign; else fold it in.
    if out[-1] & 0x80:
        out.append(0x80 if negative else 0x00)
    elif negative:
        out[-1] |= 0x80
    return bytes(out)


def script_num_to_bool(data: bytes) -> bool:
    """CastToBool (interpreter.cpp:36-48): any nonzero byte → true, except
    negative zero (0x80 in the top position alone)."""
    for i, b in enumerate(data):
        if b != 0:
            return not (i == len(data) - 1 and b == 0x80)
    return False


def decode_op(script: bytes, pos: int) -> Tuple[Optional[int], Optional[bytes], int]:
    """Decode one opcode at ``pos`` → (opcode, pushdata|None, next_pos).

    Mirrors GetScriptOp (script.cpp:283-333): returns opcode=None on a
    truncated push (the interpreter maps that to BAD_OPCODE).
    """
    opcode = script[pos]
    pos += 1
    if opcode > OP_PUSHDATA4:
        return opcode, None, pos

    if opcode < OP_PUSHDATA1:
        size = opcode
    elif opcode == OP_PUSHDATA1:
        if pos + 1 > len(script):
            return None, None, pos
        size = script[pos]
        pos += 1
    elif opcode == OP_PUSHDATA2:
        if pos + 2 > len(script):
            return None, None, pos
        size = int.from_bytes(script[pos : pos + 2], "little")
        pos += 2
    else:  # OP_PUSHDATA4
        if pos + 4 > len(script):
            return None, None, pos
        size = int.from_bytes(script[pos : pos + 4], "little")
        pos += 4
    if pos + size > len(script):
        return None, None, pos
    return opcode, script[pos : pos + size], pos + size


def iter_ops(script: bytes) -> Iterator[Tuple[Optional[int], Optional[bytes]]]:
    """Iterate (opcode, data) pairs; yields (None, None) once on corruption."""
    pos = 0
    while pos < len(script):
        opcode, data, pos = decode_op(script, pos)
        yield opcode, data
        if opcode is None:
            return


def push_data(data: bytes) -> bytes:
    """Encode a data push exactly as CScript::operator<<(vector) does
    (script.h:442-464): direct-push/PUSHDATA only, NO folding into
    OP_0/OP_1..OP_16. FindAndDelete and the P2SH-witness malleability check
    both compare against this exact encoding."""
    n = len(data)
    if n < OP_PUSHDATA1:
        return bytes([n]) + data
    if n <= 0xFF:
        return bytes([OP_PUSHDATA1, n]) + data
    if n <= 0xFFFF:
        return bytes([OP_PUSHDATA2]) + n.to_bytes(2, "little") + data
    return bytes([OP_PUSHDATA4]) + n.to_bytes(4, "little") + data


def check_minimal_push(data: bytes, opcode: int) -> bool:
    """CheckMinimalPush (interpreter.cpp:228-251)."""
    assert 0 <= opcode <= OP_PUSHDATA4
    if len(data) == 0:
        return opcode == OP_0
    if len(data) == 1 and 1 <= data[0] <= 16:
        return False  # should have used OP_1..OP_16
    if len(data) == 1 and data[0] == 0x81:
        return False  # should have used OP_1NEGATE
    if len(data) <= 75:
        return opcode == len(data)
    if len(data) <= 255:
        return opcode == OP_PUSHDATA1
    if len(data) <= 65535:
        return opcode == OP_PUSHDATA2
    return True


# --- pattern predicates (script.cpp:201-256) --------------------------------

def is_p2sh(script: bytes) -> bool:
    return (
        len(script) == 23
        and script[0] == OP_HASH160
        and script[1] == 0x14
        and script[22] == OP_EQUAL
    )


def is_witness_program(script: bytes) -> Optional[Tuple[int, bytes]]:
    """Return (version, program) if the script is a witness program
    (script.cpp:220-234), else None."""
    if len(script) < 4 or len(script) > 42:
        return None
    if script[0] != OP_0 and not (OP_1 <= script[0] <= OP_16):
        return None
    if script[1] + 2 == len(script):
        version = 0 if script[0] == OP_0 else script[0] - OP_1 + 1
        return version, script[2:]
    return None


def is_push_only(script: bytes) -> bool:
    """script.cpp:236-250: every op ≤ OP_16 (push-class)."""
    pos = 0
    while pos < len(script):
        opcode, _, pos = decode_op(script, pos)
        if opcode is None or opcode > OP_16:
            return False
    return True


def is_unspendable(script: bytes) -> bool:
    return (len(script) > 0 and script[0] == OP_RETURN) or len(script) > MAX_SCRIPT_SIZE


def is_op_success(opcode: int) -> bool:
    """Tapscript OP_SUCCESSx set (script.cpp:335-341 / BIP342)."""
    return (
        opcode == 0x50
        or opcode == 0x62
        or 0x7E <= opcode <= 0x81
        or 0x83 <= opcode <= 0x86
        or 0x89 <= opcode <= 0x8A
        or 0x8D <= opcode <= 0x8E
        or 0x95 <= opcode <= 0x99
        or 0xBB <= opcode <= 0xFE
    )


def _decode_op_n(opcode: int) -> int:
    if opcode == OP_0:
        return 0
    assert OP_1 <= opcode <= OP_16
    return opcode - (OP_1 - 1)


def get_sig_op_count(script: bytes, accurate: bool) -> int:
    """Legacy sigop counting (script.cpp:153-177)."""
    n = 0
    last_opcode = OP_INVALIDOPCODE
    pos = 0
    while pos < len(script):
        opcode, _, pos = decode_op(script, pos)
        if opcode is None:
            break
        if opcode in (OP_CHECKSIG, OP_CHECKSIGVERIFY):
            n += 1
        elif opcode in (OP_CHECKMULTISIG, OP_CHECKMULTISIGVERIFY):
            if accurate and OP_1 <= last_opcode <= OP_16:
                n += _decode_op_n(last_opcode)
            else:
                n += MAX_PUBKEYS_PER_MULTISIG
        last_opcode = opcode
    return n


def witness_sig_ops(witness_version: int, witness_program: bytes, witness: List[bytes]) -> int:
    """Witness sigop counting (interpreter.cpp:2058-2103 WitnessSigOps)."""
    if witness_version == 0:
        if len(witness_program) == 20:
            return 1
        if len(witness_program) == 32 and witness:
            return get_sig_op_count(witness[-1], True)
    return 0


def find_and_delete(script: bytes, needle: bytes) -> Tuple[bytes, int]:
    """FindAndDelete (interpreter.cpp:253-279): remove every *opcode-aligned*
    occurrence of the serialized push ``needle`` from ``script``.

    Returns (new_script, n_found). Consensus-critical quirk: matching is on
    raw serialized bytes at opcode boundaries, and overlapping repeats are
    skipped byte-for-byte the way the reference's do/while does.
    """
    if not needle:
        return script, 0
    out = bytearray()
    n_found = 0
    pos = 0
    last = 0
    while pos < len(script):
        # Append the segment before this opcode boundary.
        out += script[last:pos]
        # Skip every consecutive occurrence starting exactly here.
        while script[pos : pos + len(needle)] == needle:
            pos += len(needle)
            n_found += 1
        last = pos
        opcode, _, pos = decode_op(script, pos) if pos < len(script) else (None, None, pos)
        if opcode is None:
            break
    out += script[last:]
    return bytes(out), n_found
