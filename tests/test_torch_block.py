"""The port's `connect_block` on the CPU, held to the JAX package.

The scenarios of `tests/test_native_block.py` (a valid mixed block, a bad
signature, a missing input, a double spend, a premature coinbase spend,
BIP30, value conservation, a greedy coinbase, in-block chaining, a bad
merkle root and the duplicate-tx mutation, a high hash, a broken witness
commitment). Each block goes through the port's `connect_block` twice:
on a `NativeCoinsView` (the native block layer and the index-mode
fixpoint) and on a plain `CoinsView` on the Python engine. Both are held to
the JAX package's `connect_block(..., check_scripts=False)` for (ok,
reason, fees, sigop cost), and their per-input results to the JAX
package's per-input API: the reference's own script phase would build a
JAX verifier, which takes minutes on this CPU. The three views are built
from the same entry tuples (txid, n, value, height, coinbase, spk).

Blocks are built with the port's `utils/blockgen`, which is held to the
JAX package's byte for byte. Verifiers run on the CPU (the plain torch
version of the kernel). Tolerance everywhere: zero.
"""

import copy
import hashlib
import pickle

import pytest
import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu.core import block as JBLK
from bitcoinconsensus_tpu.core import tx as JTX
from bitcoinconsensus_tpu.core.flags import height_to_flags
from bitcoinconsensus_tpu.models import validate as JV
from bitcoinconsensus_tpu.utils import blockgen as JB
from bitcoinconsensus_tpu_torch import native_bridge as NB
from bitcoinconsensus_tpu_torch.core.block import (
    Block,
    block_merkle_root,
    check_block,
    check_proof_of_work,
)
from bitcoinconsensus_tpu_torch.core.tx import COIN, OutPoint, Tx, TxIn, TxOut
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.models.validate import (
    COINBASE_MATURITY,
    Coin,
    CoinsView,
    connect_block,
)
from bitcoinconsensus_tpu_torch.utils import blockgen as B

torch.set_num_threads(1)

HEIGHT = 710_000
FLAGS = height_to_flags(HEIGHT, extended=True)


def _entries(coins: CoinsView):
    return [(txid, n, c.out.value, c.height, c.coinbase, c.out.script_pubkey)
            for (txid, n), c in coins._map.items()]


def _views(entries):
    """The reference's CoinsView, the port's CoinsView and a NativeCoinsView,
    each from the same entry tuples."""
    ref, plain, nat = JV.CoinsView(), CoinsView(), NB.NativeCoinsView()
    for txid, n, value, height, cb, spk in entries:
        ref.add(JTX.OutPoint(txid, n), JV.Coin(JTX.TxOut(value, spk), height, cb))
        plain.add(OutPoint(txid, n), Coin(TxOut(value, spk), height, cb))
    nat.add_coins_batch(entries)
    return ref, plain, nat


def _api_result(raw, i, outs):
    try:
        JAPI.verify_with_spent_outputs(raw, i, outs, FLAGS)
    except JAPI.ConsensusError as e:
        return False, int(e.code), None if e.script_error is None else int(e.script_error)
    return True, 0, 0


def _per_input_reference(jblock, entries):
    """Each non-coinbase input of the block, in block order, through the JAX
    package's per-input API, its prevouts from the entries and from the
    outputs of earlier txs of the block."""
    utxo = {(e[0], e[1]): (e[2], e[5]) for e in entries}
    out = []
    for tx in jblock.vtx:
        if not tx.is_coinbase():
            outs = [utxo[(t.prevout.hash, t.prevout.n)] for t in tx.vin]
            raw = tx.serialize()
            out += [_api_result(raw, i, outs) for i in range(len(tx.vin))]
        for n, o in enumerate(tx.vout):
            utxo[(tx.txid, n)] = (o.value, o.script_pubkey)
    return out


def _tuple(res):
    inputs = None
    if res.input_results is not None:
        inputs = [(r.ok, int(r.error),
                   None if r.script_error is None else int(r.script_error))
                  for r in res.input_results]
    return res.ok, res.reason, res.fees, res.sigop_cost, inputs


def _coin_set(view, block):
    """Every output of the block and every prevout it spends, as the view
    holds them (None where absent)."""
    out = []
    for tx in block.vtx:
        ops = [(tx.txid, n) for n in range(len(tx.vout))]
        if not tx.is_coinbase():
            ops += [(t.prevout.hash, t.prevout.n) for t in tx.vin]
        for h, n in ops:
            c = view.get(JTX.OutPoint(h, n) if isinstance(view, JV.CoinsView)
                         else OutPoint(h, n))
            out.append(None if c is None else
                       (c.out.value, c.out.script_pubkey, c.height, c.coinbase))
    return out


def assert_parity(block, coins, check_scripts=True, **kw):
    kw.setdefault("pow_limit", B.REGTEST_POW_LIMIT)
    entries = _entries(coins)
    ref_view, plain, nat = _views(entries)
    jblock = JBLK.Block.deserialize(block.serialize())
    ref = JV.connect_block(jblock, ref_view, HEIGHT, check_scripts=False, **kw)
    if not ref.ok:
        want = (False, ref.reason, ref.fees, ref.sigop_cost, None)
    elif not check_scripts:
        want = (True, None, ref.fees, ref.sigop_cost, None)
    else:
        inputs = _per_input_reference(jblock, entries)
        ok = all(r[0] for r in inputs)
        want = (ok, None if ok else "block-validation-failed", ref.fees,
                ref.sigop_cost, inputs)
    got_nat = connect_block(block, nat, HEIGHT, verifier=TorchSecpVerifier(device="cpu"),
                            sig_cache=SigCache(), script_cache=ScriptExecutionCache(),
                            check_scripts=check_scripts, **kw)
    got_py = connect_block(block, plain, HEIGHT,
                           verifier=TorchSecpVerifier(device="cpu", engine="python"),
                           sig_cache=SigCache(), script_cache=ScriptExecutionCache(),
                           check_scripts=check_scripts, engine="python", **kw)
    assert _tuple(got_nat) == want
    assert _tuple(got_py) == want
    # The views: applied alike on success, untouched on a reject.
    assert len(nat) == len(plain) == (len(ref_view) if want[0] else len(entries))
    if want[0]:
        assert _coin_set(nat, block) == _coin_set(plain, block) == _coin_set(ref_view, block)
    else:
        pristine = _views(entries)[1]
        assert _coin_set(nat, block) == _coin_set(plain, block) == _coin_set(pristine, block)
    return got_nat


def _mine(block):
    """Grind the nonce of a changed header until it meets the regtest target."""
    while not check_proof_of_work(block.hash, block.header.bits, B.REGTEST_POW_LIMIT):
        block.header.nonce += 1


def test_valid_mixed_block():
    coins, funded = B.make_funded_view(
        12, kinds=("p2wpkh", "p2tr", "p2wsh_multisig", "p2pkh"), seed="tb1")
    txs = [B.build_spend_tx(funded[i : i + 4], fee=800) for i in range(0, 12, 4)]
    res = assert_parity(B.build_block(txs, HEIGHT, fees=2400), coins)
    assert res.ok and len(res.input_results) == 12


def test_bad_signature():
    coins, funded = B.make_funded_view(4, seed="tb2")
    block = B.build_block([B.build_spend_tx(funded, fee=1000, corrupt_input=2)],
                          HEIGHT, fees=1000)
    res = assert_parity(block, coins)
    assert res.reason == "block-validation-failed" and res.script_failures == [2]
    assert res.input_results[2].error == JAPI.Error.ERR_SCRIPT


def test_missing_input():
    coins, funded = B.make_funded_view(2, seed="tb3")
    block = B.build_block([B.build_spend_tx(funded)], HEIGHT, fees=2000)
    coins.spend(funded[0].outpoint)
    assert assert_parity(block, coins).reason == "bad-txns-inputs-missingorspent"


def test_double_spend():
    coins, funded = B.make_funded_view(1, seed="tb4")
    block = B.build_block([B.build_spend_tx(funded, fee=500),
                           B.build_spend_tx(funded, fee=600)], HEIGHT, fees=1100)
    assert assert_parity(block, coins).reason == "bad-txns-inputs-missingorspent"


@pytest.mark.parametrize("age", [10, COINBASE_MATURITY])
def test_coinbase_maturity(age):
    coins, funded = B.make_funded_view(1, height=HEIGHT - age, seed=f"tb5/{age}")
    op = funded[0].outpoint
    c = coins.get(op)
    coins.add(op, Coin(c.out, c.height, coinbase=True))
    res = assert_parity(B.build_block([B.build_spend_tx(funded)], HEIGHT, fees=1000),
                        coins)
    assert res.ok == (age >= COINBASE_MATURITY)
    if not res.ok:
        assert res.reason == "bad-txns-premature-spend-of-coinbase"


def test_bip30():
    coins, funded = B.make_funded_view(1, seed="tb6")
    tx = B.build_spend_tx(funded, fee=1000)
    coins.add_tx(tx, HEIGHT - 50)
    assert assert_parity(B.build_block([tx], HEIGHT, fees=1000), coins).reason == \
        "bad-txns-BIP30"


def test_value_conservation():
    coins, funded = B.make_funded_view(1, seed="tb7")
    tx = B.build_spend_tx(funded, fee=1000)
    tx.vout[0] = TxOut(tx.vout[0].value + 5000, tx.vout[0].script_pubkey)
    tx.invalidate_caches()
    assert assert_parity(B.build_block([tx], HEIGHT, fees=1000), coins).reason == \
        "bad-txns-in-belowout"


def test_greedy_coinbase():
    coins, funded = B.make_funded_view(1, seed="tb8")
    block = B.build_block([B.build_spend_tx(funded, fee=1000)], HEIGHT, fees=999_999)
    assert assert_parity(block, coins).reason == "bad-cb-amount"


def test_in_block_chaining():
    coins, funded = B.make_funded_view(1, kinds=("p2wpkh",), amount=COIN, seed="tb9")
    w2 = B.Wallet("tb9-chain", "p2wpkh")
    t1 = Tx(2, [TxIn(funded[0].outpoint)], [TxOut(COIN - 1000, w2.spk)], 0)
    funded[0].wallet.sign_input(t1, 0, funded[0].amount)
    t1.invalidate_caches()
    t2 = B.build_spend_tx([B.FundedOutput(OutPoint(t1.txid, 0), w2, COIN - 1000)],
                          fee=700)
    res = assert_parity(B.build_block([t1, t2], HEIGHT, fees=1700), coins)
    assert res.ok and len(res.input_results) == 2


def test_bad_merkle_and_mutation():
    coins, funded = B.make_funded_view(2, seed="tb10")
    block = B.build_block([B.build_spend_tx(funded)], HEIGHT, fees=2000)
    block.header.merkle_root = b"\xAA" * 32
    _mine(block)
    assert assert_parity(block, coins).reason == "bad-txnmrklroot"
    coins2, funded2 = B.make_funded_view(2, seed="tb11")
    t1, t2 = (B.build_spend_tx([f]) for f in funded2)
    # Leaves (coinbase, t1, t2, t2): a duplicated sibling pair, the
    # CVE-2012-2459 shape the merkle check flags as mutated.
    block2 = B.build_block([t1, t2, t2], HEIGHT, fees=3000)
    assert assert_parity(block2, coins2).reason == "bad-txns-duplicate"
    # (coinbase, t, t) is no sibling pair: the double spend rejects it.
    block3 = B.build_block([t1, t1], HEIGHT, fees=2000)
    assert assert_parity(block3, coins2).reason == "bad-txns-inputs-missingorspent"


def test_high_hash():
    coins, funded = B.make_funded_view(1, seed="tb12")
    block = B.build_block([B.build_spend_tx(funded)], HEIGHT, fees=1000)
    assert assert_parity(block, coins, pow_limit=0).reason == "high-hash"


def test_witness_commitment():
    coins, funded = B.make_funded_view(2, seed="tb13")
    block = B.build_block([B.build_spend_tx(funded)], HEIGHT, fees=2000)
    cb = block.vtx[0]
    for o, out in enumerate(cb.vout):
        spk = out.script_pubkey
        if len(spk) >= 38 and spk[1:6] == b"\x24\xaa\x21\xa9\xed":
            cb.vout[o] = TxOut(out.value, spk[:6] + bytes(32))
    cb.invalidate_caches()
    block.header.merkle_root = block_merkle_root(block)[0]
    _mine(block)
    assert assert_parity(block, coins).reason == "bad-witness-merkle-match"


def test_check_scripts_false():
    coins, funded = B.make_funded_view(3, seed="tb14")
    block = B.build_block([B.build_spend_tx(funded, fee=900, corrupt_input=1)],
                          HEIGHT, fees=900)
    assert assert_parity(block, coins, check_scripts=False).ok  # scripts skipped


@pytest.mark.parametrize("kinds", [B.KINDS, ("p2wpkh", "p2tr", "p2wpkh", "p2wsh_multisig")])
def test_port_block_builders_equal_the_reference(kinds):
    coins_t, funded_t = B.make_funded_view(8, kinds=kinds, amount=50_000, seed="tbgen")
    coins_j, funded_j = JB.make_funded_view(8, kinds=kinds, amount=50_000, seed="tbgen")
    assert sorted(_entries(coins_t)) == sorted(
        (t, n, c.out.value, c.height, c.coinbase, c.out.script_pubkey)
        for (t, n), c in coins_j._map.items())
    blocks = []
    for mod, funded in ((B, funded_t), (JB, funded_j)):
        txs = [mod.build_spend_tx(funded[i : i + 4], fee=700) for i in (0, 4)]
        blocks.append(mod.build_block(txs, HEIGHT, fees=1400).serialize())
    assert blocks[0] == blocks[1]
    assert (B.REGTEST_POW_LIMIT, B.REGTEST_BITS) == (JB.REGTEST_POW_LIMIT, JB.REGTEST_BITS)


def test_native_block_and_view_handles():
    coins, funded = B.make_funded_view(3, seed="tb15")
    block = B.build_block([B.build_spend_tx(funded)], HEIGHT, fees=1000)
    raw = block.serialize()
    nblk = NB.NativeBlock(raw)
    assert (nblk.n_tx, nblk.n_inputs) == (2, 3)
    assert [nblk.txid(i) for i in range(2)] == [tx.txid for tx in block.vtx]
    assert [nblk.wtxid(i) for i in range(2)] == [tx.wtxid for tx in block.vtx]
    assert nblk.tx(1).wtxid == block.vtx[1].wtxid and nblk.tx(1).n_inputs == 3
    assert check_block(block, pow_limit=B.REGTEST_POW_LIMIT) == (True, None)
    assert nblk.check(True, B.REGTEST_POW_LIMIT) is None
    for other in (pickle.loads(pickle.dumps(nblk)), copy.deepcopy(nblk)):
        assert other is not nblk and other.n_tx == 2 and other.txid(1) == nblk.txid(1)
    with pytest.raises(IndexError):
        nblk.txid(2)
    with pytest.raises(ValueError):
        NB.NativeBlock(raw + b"\x00")
    assert Block.deserialize(raw).serialize() == raw
    view = _views(_entries(coins))[2]
    op = funded[0].outpoint
    c = view.get(op)
    assert (c.out.value, c.out.script_pubkey, c.height, c.coinbase) == (
        funded[0].amount, funded[0].wallet.spk, 1, False)
    clone = view.clone()
    assert view.spend(op) is not None and view.get(op) is None
    assert clone.get(op) is not None and len(clone) == len(view) + 1
    assert view.get(OutPoint(hashlib.sha256(b"absent").digest(), 7)) is None
    with pytest.raises(TypeError):
        pickle.dumps(view)
