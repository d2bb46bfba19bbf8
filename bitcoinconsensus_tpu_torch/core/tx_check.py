"""Context-free transaction sanity checks.

Equivalent of the reference's `consensus/tx_check.cpp` CheckTransaction:
empty vin/vout, stripped-size weight cap, output value ranges
(CVE-2010-5139), duplicate inputs (CVE-2018-17144), coinbase scriptSig
length, null prevouts.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .tx import MAX_MONEY, Tx

__all__ = ["check_transaction"]

MAX_BLOCK_WEIGHT = 4_000_000
WITNESS_SCALE_FACTOR = 4


def check_transaction(tx: Tx) -> Tuple[bool, Optional[str]]:
    """Returns (ok, reject-reason). Reasons match tx_check.cpp strings."""
    if not tx.vin:
        return False, "bad-txns-vin-empty"
    if not tx.vout:
        return False, "bad-txns-vout-empty"
    if len(tx.serialize(include_witness=False)) * WITNESS_SCALE_FACTOR > MAX_BLOCK_WEIGHT:
        return False, "bad-txns-oversize"

    value_out = 0
    for txout in tx.vout:
        if txout.value < 0:
            return False, "bad-txns-vout-negative"
        if txout.value > MAX_MONEY:
            return False, "bad-txns-vout-toolarge"
        value_out += txout.value
        if value_out < 0 or value_out > MAX_MONEY:
            return False, "bad-txns-txouttotal-toolarge"

    seen = set()
    for txin in tx.vin:
        key = (txin.prevout.hash, txin.prevout.n)
        if key in seen:
            return False, "bad-txns-inputs-duplicate"
        seen.add(key)

    if tx.is_coinbase():
        if not (2 <= len(tx.vin[0].script_sig) <= 100):
            return False, "bad-cb-length"
    else:
        for txin in tx.vin:
            if txin.prevout.is_null():
                return False, "bad-txns-prevout-null"

    return True, None
