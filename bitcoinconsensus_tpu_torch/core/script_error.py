"""Script-level error codes.

Mirrors the reference's `script/script_error.h:11-86` member-for-member —
these are part of the behavioral contract (the JSON consensus vectors name
them, and our batch API reports them per input, improving on the reference
C ABI which swallows them — SURVEY.md §5 failure-detection note).
"""

from __future__ import annotations

import enum

__all__ = ["ScriptError", "script_error_string"]


class ScriptError(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = enum.auto()
    EVAL_FALSE = enum.auto()
    OP_RETURN = enum.auto()

    # Max sizes
    SCRIPT_SIZE = enum.auto()
    PUSH_SIZE = enum.auto()
    OP_COUNT = enum.auto()
    STACK_SIZE = enum.auto()
    SIG_COUNT = enum.auto()
    PUBKEY_COUNT = enum.auto()

    # Failed verify operations
    VERIFY = enum.auto()
    EQUALVERIFY = enum.auto()
    CHECKMULTISIGVERIFY = enum.auto()
    CHECKSIGVERIFY = enum.auto()
    NUMEQUALVERIFY = enum.auto()

    # Logical/Format/Canonical errors
    BAD_OPCODE = enum.auto()
    DISABLED_OPCODE = enum.auto()
    INVALID_STACK_OPERATION = enum.auto()
    INVALID_ALTSTACK_OPERATION = enum.auto()
    UNBALANCED_CONDITIONAL = enum.auto()

    # CHECKLOCKTIMEVERIFY and CHECKSEQUENCEVERIFY
    NEGATIVE_LOCKTIME = enum.auto()
    UNSATISFIED_LOCKTIME = enum.auto()

    # Malleability
    SIG_HASHTYPE = enum.auto()
    SIG_DER = enum.auto()
    MINIMALDATA = enum.auto()
    SIG_PUSHONLY = enum.auto()
    SIG_HIGH_S = enum.auto()
    SIG_NULLDUMMY = enum.auto()
    PUBKEYTYPE = enum.auto()
    CLEANSTACK = enum.auto()
    MINIMALIF = enum.auto()
    SIG_NULLFAIL = enum.auto()

    # softfork safeness
    DISCOURAGE_UPGRADABLE_NOPS = enum.auto()
    DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM = enum.auto()
    DISCOURAGE_UPGRADABLE_TAPROOT_VERSION = enum.auto()
    DISCOURAGE_OP_SUCCESS = enum.auto()
    DISCOURAGE_UPGRADABLE_PUBKEYTYPE = enum.auto()

    # segregated witness
    WITNESS_PROGRAM_WRONG_LENGTH = enum.auto()
    WITNESS_PROGRAM_WITNESS_EMPTY = enum.auto()
    WITNESS_PROGRAM_MISMATCH = enum.auto()
    WITNESS_MALLEATED = enum.auto()
    WITNESS_MALLEATED_P2SH = enum.auto()
    WITNESS_UNEXPECTED = enum.auto()
    WITNESS_PUBKEYTYPE = enum.auto()

    # Taproot
    SCHNORR_SIG_SIZE = enum.auto()
    SCHNORR_SIG_HASHTYPE = enum.auto()
    SCHNORR_SIG = enum.auto()
    TAPROOT_WRONG_CONTROL_SIZE = enum.auto()
    TAPSCRIPT_VALIDATION_WEIGHT = enum.auto()
    TAPSCRIPT_CHECKMULTISIG = enum.auto()
    TAPSCRIPT_MINIMALIF = enum.auto()

    # Constant scriptCode
    OP_CODESEPARATOR = enum.auto()
    SIG_FINDANDDELETE = enum.auto()


_ERROR_STRINGS = {
    ScriptError.OK: "No error",
    ScriptError.EVAL_FALSE: "Script evaluated without error but finished with a false/empty top stack element",
    ScriptError.VERIFY: "Script failed an OP_VERIFY operation",
    ScriptError.EQUALVERIFY: "Script failed an OP_EQUALVERIFY operation",
    ScriptError.CHECKMULTISIGVERIFY: "Script failed an OP_CHECKMULTISIGVERIFY operation",
    ScriptError.CHECKSIGVERIFY: "Script failed an OP_CHECKSIGVERIFY operation",
    ScriptError.NUMEQUALVERIFY: "Script failed an OP_NUMEQUALVERIFY operation",
    ScriptError.SCRIPT_SIZE: "Script is too big",
    ScriptError.PUSH_SIZE: "Push value size limit exceeded",
    ScriptError.OP_COUNT: "Operation limit exceeded",
    ScriptError.STACK_SIZE: "Stack size limit exceeded",
    ScriptError.SIG_COUNT: "Signature count negative or greater than pubkey count",
    ScriptError.PUBKEY_COUNT: "Pubkey count negative or limit exceeded",
    ScriptError.BAD_OPCODE: "Opcode missing or not understood",
    ScriptError.DISABLED_OPCODE: "Attempted to use a disabled opcode",
    ScriptError.INVALID_STACK_OPERATION: "Operation not valid with the current stack size",
    ScriptError.INVALID_ALTSTACK_OPERATION: "Operation not valid with the current altstack size",
    ScriptError.OP_RETURN: "OP_RETURN was encountered",
    ScriptError.UNBALANCED_CONDITIONAL: "Invalid OP_IF construction",
    ScriptError.NEGATIVE_LOCKTIME: "Negative locktime",
    ScriptError.UNSATISFIED_LOCKTIME: "Locktime requirement not satisfied",
    ScriptError.SIG_HASHTYPE: "Signature hash type missing or not understood",
    ScriptError.SIG_DER: "Non-canonical DER signature",
    ScriptError.MINIMALDATA: "Data push larger than necessary",
    ScriptError.SIG_PUSHONLY: "Only push operators allowed in signatures",
    ScriptError.SIG_HIGH_S: "Non-canonical signature: S value is unnecessarily high",
    ScriptError.SIG_NULLDUMMY: "Dummy CHECKMULTISIG argument must be zero",
    ScriptError.MINIMALIF: "OP_IF/NOTIF argument must be minimal",
    ScriptError.SIG_NULLFAIL: "Signature must be zero for failed CHECK(MULTI)SIG operation",
    ScriptError.DISCOURAGE_UPGRADABLE_NOPS: "NOPx reserved for soft-fork upgrades",
    ScriptError.DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM: "Witness version reserved for soft-fork upgrades",
    ScriptError.DISCOURAGE_UPGRADABLE_TAPROOT_VERSION: "Taproot version reserved for soft-fork upgrades",
    ScriptError.DISCOURAGE_OP_SUCCESS: "OP_SUCCESSx reserved for soft-fork upgrades",
    ScriptError.DISCOURAGE_UPGRADABLE_PUBKEYTYPE: "Public key version reserved for soft-fork upgrades",
    ScriptError.PUBKEYTYPE: "Public key is neither compressed or uncompressed",
    ScriptError.CLEANSTACK: "Stack size must be exactly one after execution",
    ScriptError.WITNESS_PROGRAM_WRONG_LENGTH: "Witness program has incorrect length",
    ScriptError.WITNESS_PROGRAM_WITNESS_EMPTY: "Witness program was passed an empty witness",
    ScriptError.WITNESS_PROGRAM_MISMATCH: "Witness program hash mismatch",
    ScriptError.WITNESS_MALLEATED: "Witness requires empty scriptSig",
    ScriptError.WITNESS_MALLEATED_P2SH: "Witness requires only-redeemscript scriptSig",
    ScriptError.WITNESS_UNEXPECTED: "Witness provided for non-witness script",
    ScriptError.WITNESS_PUBKEYTYPE: "Using non-compressed keys in segwit",
    ScriptError.SCHNORR_SIG_SIZE: "Invalid Schnorr signature size",
    ScriptError.SCHNORR_SIG_HASHTYPE: "Invalid Schnorr signature hash type",
    ScriptError.SCHNORR_SIG: "Invalid Schnorr signature",
    ScriptError.TAPROOT_WRONG_CONTROL_SIZE: "Invalid Taproot control block size",
    ScriptError.TAPSCRIPT_VALIDATION_WEIGHT: "Too much signature validation relative to witness weight",
    ScriptError.TAPSCRIPT_CHECKMULTISIG: "OP_CHECKMULTISIG(VERIFY) is not available in tapscript",
    ScriptError.TAPSCRIPT_MINIMALIF: "OP_IF/NOTIF argument must be minimal in tapscript",
    ScriptError.OP_CODESEPARATOR: "Using OP_CODESEPARATOR in non-witness script",
    ScriptError.SIG_FINDANDDELETE: "Signature is found in scriptCode",
    ScriptError.UNKNOWN_ERROR: "unknown error",
}


def script_error_string(err: ScriptError) -> str:
    """Human-readable error description (script_error.cpp)."""
    return _ERROR_STRINGS.get(err, "unknown error")
