"""Script-ASM parser for the consensus test-vector format.

A copy of `bitcoinconsensus_tpu/utils/script_asm.py` on the port's
`core.script`.

Equivalent of the reference's ParseScript (`core_read.cpp`): the stringified
script dialect used by `script_tests.json` / `tx_valid.json` /
`tx_invalid.json` — decimal numbers (CScriptNum-encoded pushes with the
OP_0/OP_1..16/OP_1NEGATE folding of CScript::operator<<(int64_t)), raw
``0x``-hex inserted verbatim, single-quoted strings pushed as data, and
opcode names with or without the ``OP_`` prefix (only opcodes ≥ OP_NOP plus
OP_RESERVED are named, exactly like the reference's name map).
"""

from __future__ import annotations

import re

from ..core import script as S
from ..core.script import push_data, script_num_encode

__all__ = ["parse_asm", "ScriptParseError"]

INT64_MAX = 2**63 - 1
INT64_MIN = -(2**63)


class ScriptParseError(ValueError):
    pass


def _build_op_names() -> dict:
    names = {}
    for name in dir(S):
        if not name.startswith("OP_"):
            continue
        value = getattr(S, name)
        if not isinstance(value, int):
            continue
        # Only OP_RESERVED (0x50) and opcodes >= OP_NOP are nameable
        # (core_read.cpp skips the rest). Aliases like OP_NOP2/OP_TRUE are
        # attribute aliases of the same value; the reference resolves each
        # value to its canonical GetOpName string, but accepting the alias
        # spellings here is harmless for the vector corpus (which only uses
        # canonical names) and convenient for hand-written tests.
        if value == S.OP_RESERVED or S.OP_NOP <= value <= S.OP_CHECKSIGADD:
            names[name] = value
            names[name[3:]] = value
    names.pop("INVALIDOPCODE", None)
    names.pop("OP_INVALIDOPCODE", None)
    return names


_OP_NAMES = _build_op_names()
_HEX_RE = re.compile(r"^[0-9a-fA-F]+$")


def _push_int64(n: int) -> bytes:
    """CScript::operator<<(int64_t) (script.h:425-434)."""
    if n == -1 or 1 <= n <= 16:
        return bytes([n + (S.OP_1 - 1)])
    if n == 0:
        return bytes([S.OP_0])
    return push_data(script_num_encode(n))


def parse_asm(text: str) -> bytes:
    result = bytearray()
    for word in text.split():
        if not word:
            continue
        if word.isdigit() or (word[0] == "-" and len(word) > 1 and word[1:].isdigit()):
            n = int(word)
            # atoi64 clamps to the int64 range on overflow.
            n = max(INT64_MIN, min(INT64_MAX, n))
            result += _push_int64(n)
        elif word.startswith("0x") and len(word) > 2 and _HEX_RE.match(word[2:]):
            # Raw hex: inserted verbatim, NOT pushed.
            if len(word) % 2 != 0:
                raise ScriptParseError(f"odd-length hex: {word}")
            result += bytes.fromhex(word[2:])
        elif len(word) >= 2 and word[0] == "'" and word[-1] == "'":
            result += push_data(word[1:-1].encode("latin-1"))
        elif word in _OP_NAMES:
            result.append(_OP_NAMES[word])
        else:
            raise ScriptParseError(f"script parse error: {word!r}")
    return bytes(result)
