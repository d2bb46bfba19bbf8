"""The slice as a whole: the port's `verify_batch` on the CPU against the JAX
package's per-input API.

About 40 inputs are built with the JAX package's `utils/blockgen` in the
replay mix (p2wpkh / p2tr / p2pkh / p2wsh 2-of-3), with corrupted inputs, a
2-of-3 multisig whose signatures pair with the later keys (the fixpoint
needs a second dispatch), legacy items without spent outputs, a taproot
flag without spent outputs (ERR_INVALID_FLAGS) and a bad index
(ERR_TX_INDEX). Every item's (ok, Error, ScriptError) must equal the
reference's; the port's own blockgen must give the same bytes.
"""

import functools
import hashlib
import random

import pytest
import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu.core.flags import VERIFY_ALL_EXTENDED, VERIFY_ALL_LIBCONSENSUS
from bitcoinconsensus_tpu.utils import blockgen as JB
from bitcoinconsensus_tpu.workloads.replay import DEFAULT_MIX as J_MIX
from bitcoinconsensus_tpu_torch import api as TAPI
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import BatchItem, verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.utils import blockgen as TB

# The plain version runs thousands of tiny ops; intra-op threads only add
# contention at these widths.
torch.set_num_threads(1)


def _pick(rng, mix):
    r = rng.random() * sum(w for _, w in mix)
    for kind, w in mix:
        r -= w
        if r <= 0:
            return kind
    return mix[-1][0]


def _txs(mod, seed: int, n_txs: int):
    """(raw, funded, corrupt_input) per tx, from `mod`'s builders, with
    script types drawn in the replay mix (the first tx a 2-of-3)."""
    rng = random.Random(seed)
    out = []
    for t in range(n_txs):
        n_in = rng.randint(1, 3)
        funded = []
        for i in range(n_in):
            kind = _pick(rng, J_MIX) if t else "p2wsh_multisig"
            w = mod.Wallet(f"torch-batch/{seed}/{t}/{i}", kind)
            op = mod.OutPoint(hashlib.sha256(f"op/{seed}/{t}/{i}".encode()).digest(), i)
            funded.append(mod.FundedOutput(op, w, rng.randrange(10_000, 1_000_000)))
        bad = rng.randrange(n_in) if t % 5 == 4 else None
        out.append((mod.build_spend_tx(funded, corrupt_input=bad).serialize(),
                    funded, bad))
    return out


@functools.lru_cache(maxsize=1)
def _items():
    items = []
    for raw, funded, _bad in _txs(JB, seed=5, n_txs=18):
        outs = [(f.amount, f.wallet.spk) for f in funded]
        for i in range(len(funded)):
            items.append(BatchItem(raw, i, VERIFY_ALL_EXTENDED, spent_outputs=outs))
        f0 = funded[0]
        if f0.wallet.kind in ("p2pkh", "p2wpkh", "p2wsh_multisig"):
            # The reference C ABI's reach: one prevout, libconsensus flags.
            items.append(BatchItem(raw, 0, VERIFY_ALL_LIBCONSENSUS,
                                   spent_output_script=f0.wallet.spk,
                                   amount=f0.amount))
    raw, funded, _ = _txs(JB, seed=6, n_txs=1)[0]
    outs = [(f.amount, f.wallet.spk) for f in funded]
    items.append(BatchItem(raw, 0, VERIFY_ALL_EXTENDED,
                           spent_output_script=funded[0].wallet.spk,
                           amount=funded[0].amount))  # taproot flag, no prevouts
    items.append(BatchItem(raw, 7, VERIFY_ALL_EXTENDED, spent_outputs=outs))
    items.append(BatchItem(raw[:-1], 0, VERIFY_ALL_EXTENDED, spent_outputs=outs))
    return items


def _reference(api, item):
    try:
        if item.spent_outputs is not None:
            api.verify_with_spent_outputs(item.spending_tx, item.input_index,
                                          item.spent_outputs, item.flags)
        else:
            api.verify_with_flags(item.spent_output_script, item.amount,
                                  item.spending_tx, item.input_index, item.flags)
    except api.ConsensusError as e:
        return False, int(e.code), None if e.script_error is None else int(e.script_error)
    return True, 0, 0


def test_port_blockgen_is_byte_identical():
    want = _txs(JB, seed=5, n_txs=18)
    got = _txs(TB, seed=5, n_txs=18)
    assert [w[0] for w in want] == [g[0] for g in got]
    assert TB.DEFAULT_MIX == J_MIX


def test_mixed_items_cover_the_mix():
    items, bad = TB.mixed_items(60, seed=1, corrupt_rate=0.05)
    assert len(items) == 60 and 0 < sum(bad) < 60
    kinds = {TB._pick_kind(random.Random(s), TB.DEFAULT_MIX) for s in range(40)}
    assert kinds == set(TB.KINDS)


@functools.lru_cache(maxsize=2)
def _batch(engine="native"):
    v = TorchSecpVerifier(device="cpu", engine=engine)
    got = verify_batch(_items(), verifier=v, sig_cache=SigCache(),
                       script_cache=ScriptExecutionCache(), engine=engine)
    return got, v


def _norm(results):
    return [(r.ok, int(r.error),
             None if r.script_error is None else int(r.script_error)) for r in results]


@pytest.mark.parametrize("api", ["jax_package", "port"])
def test_verify_batch_matches_per_input_api(api):
    items = _items()
    assert len(items) >= 40
    got, v = _batch()
    ref_api = JAPI if api == "jax_package" else TAPI
    want = [_reference(ref_api, it) for it in items]
    assert _norm(got) == want
    codes = {w[1] for w in want}
    assert {0, int(JAPI.Error.ERR_SCRIPT), int(JAPI.Error.ERR_INVALID_FLAGS),
            int(JAPI.Error.ERR_TX_INDEX)} <= codes
    # The 2-of-3 multisig resolves its CHECKMULTISIG pairing on the device,
    # not on the host; on the native engine (the default) the pairings it
    # could need ride the first dispatch, so there is only one.
    assert v.stats["dispatches"] == 1 and v.stats["fixups"] == 0
    assert got[0].ok


def test_python_engine_matches_native_engine():
    """The Python engine, chosen explicitly, gives the native engine's
    verdicts; without speculative pairings its 2-of-3 multisig needs a
    second device dispatch (the fixpoint round)."""
    got, v = _batch("python")
    assert _norm(got) == _norm(_batch()[0])
    assert v.stats["dispatches"] >= 2 and v.stats["fixups"] == 0


def test_caches_skip_a_repeat_batch():
    items = _items()[:6]
    v = TorchSecpVerifier(device="cpu")
    sig, script = SigCache(), ScriptExecutionCache()
    first = verify_batch(items, verifier=v, sig_cache=sig, script_cache=script)
    lanes = v.stats["lanes"]
    again = verify_batch(items, verifier=v, sig_cache=sig, script_cache=script)
    assert first == again and all(r.ok for r in first)
    assert v.stats["lanes"] == lanes  # every input hit the script cache
    assert script.hits == len(items)
