"""Script verification flags — the bitfield consensus surface.

Values mirror the reference's `script/interpreter.h:41-142` exactly (the flag
bits are part of the cross-implementation contract: the JSON consensus vectors
and the C ABI both speak these bits), plus the libconsensus-exported subset
(`script/bitcoinconsensus.h:49-61`) and the Rust crate's mainnet soft-fork
schedule (`src/lib.rs:45-65`).
"""

from __future__ import annotations

VERIFY_NONE = 0
VERIFY_P2SH = 1 << 0
VERIFY_STRICTENC = 1 << 1
VERIFY_DERSIG = 1 << 2
VERIFY_LOW_S = 1 << 3
VERIFY_NULLDUMMY = 1 << 4
VERIFY_SIGPUSHONLY = 1 << 5
VERIFY_MINIMALDATA = 1 << 6
VERIFY_DISCOURAGE_UPGRADABLE_NOPS = 1 << 7
VERIFY_CLEANSTACK = 1 << 8
VERIFY_CHECKLOCKTIMEVERIFY = 1 << 9
VERIFY_CHECKSEQUENCEVERIFY = 1 << 10
VERIFY_WITNESS = 1 << 11
VERIFY_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM = 1 << 12
VERIFY_MINIMALIF = 1 << 13
VERIFY_NULLFAIL = 1 << 14
VERIFY_WITNESS_PUBKEYTYPE = 1 << 15
VERIFY_CONST_SCRIPTCODE = 1 << 16
VERIFY_TAPROOT = 1 << 17
VERIFY_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION = 1 << 18
VERIFY_DISCOURAGE_OP_SUCCESS = 1 << 19
VERIFY_DISCOURAGE_UPGRADABLE_PUBKEYTYPE = 1 << 20

ALL_FLAG_BITS = (1 << 21) - 1

# libconsensus-exported subset (bitcoinconsensus.h:49-61). Note TAPROOT is
# deliberately absent — the reference C ABI cannot reach the taproot path
# (SURVEY.md §3.2); our extended API lifts that restriction.
LIBCONSENSUS_FLAGS = (
    VERIFY_P2SH
    | VERIFY_DERSIG
    | VERIFY_NULLDUMMY
    | VERIFY_CHECKLOCKTIMEVERIFY
    | VERIFY_CHECKSEQUENCEVERIFY
    | VERIFY_WITNESS
)

# The Rust crate's VERIFY_ALL (src/lib.rs:37-42).
VERIFY_ALL_LIBCONSENSUS = LIBCONSENSUS_FLAGS

# Extended "all" for the new framework: everything consensus-active post
# taproot activation (what Core 0.21 applies at tip via its own flag plumbing).
VERIFY_ALL_EXTENDED = VERIFY_ALL_LIBCONSENSUS | VERIFY_TAPROOT

# Mainnet soft-fork activation heights (src/lib.rs:45-65).
HEIGHT_P2SH = 173_805
HEIGHT_DERSIG = 363_725
HEIGHT_CLTV = 388_381
HEIGHT_CSV = 419_328
HEIGHT_SEGWIT = 481_824  # NULLDUMMY + WITNESS
HEIGHT_TAPROOT = 709_632  # extended schedule (not in the reference crate)


def height_to_flags(height: int, extended: bool = False) -> int:
    """Map a mainnet block height to consensus flags (src/lib.rs:45-65).

    With ``extended=True`` also schedules TAPROOT at its mainnet activation
    height — a capability the reference's API cannot express (SURVEY.md §3.2).
    """
    flags = VERIFY_NONE
    if height >= HEIGHT_P2SH:
        flags |= VERIFY_P2SH
    if height >= HEIGHT_DERSIG:
        flags |= VERIFY_DERSIG
    if height >= HEIGHT_CLTV:
        flags |= VERIFY_CHECKLOCKTIMEVERIFY
    if height >= HEIGHT_CSV:
        flags |= VERIFY_CHECKSEQUENCEVERIFY
    if height >= HEIGHT_SEGWIT:
        flags |= VERIFY_NULLDUMMY | VERIFY_WITNESS
    if extended and height >= HEIGHT_TAPROOT:
        flags |= VERIFY_TAPROOT
    return flags


__all__ = [n for n in dir() if n.startswith(("VERIFY_", "HEIGHT_"))] + [
    "height_to_flags",
    "LIBCONSENSUS_FLAGS",
    "ALL_FLAG_BITS",
]
