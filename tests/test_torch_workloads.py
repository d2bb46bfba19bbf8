"""The port's gauntlet (`bitcoinconsensus_tpu_torch/workloads/`) on the CPU,
held to the JAX package's `bitcoinconsensus_tpu/workloads/` with tolerance
0 (verdicts, `Error` and `ScriptError` names, bytes):

- the corpus: `build_corpus()` and `shape_batch()` byte for byte; the pins
  hold on the port's three engines (`run_corpus_check(device="cpu")`), and
  a planted wrong pin fails them;
- the differential fuzz: `mutate` byte for byte; `run_diff_fuzz` over the
  five seeds of `fuzz/gauntlet_seeds.json` with 0 divergences, and its
  three engines' verdicts equal to the JAX package's `python_verdict` and
  `native_verdict`; a lying engine is caught;
- the replay: `generate_stream` byte for byte; the tiny stream
  bit-identical and cache-warmed; `run_replay_serving` (both modes) and
  `run_replay_cell` all accounted; every verdict of those runs held to
  the JAX package's `python_verdict`; the overload trial is `slow`, as
  in the reference;
- `utils/refbridge.py` (the reference `.so` differential, which skips
  without `.baseline/`, as the reference's does) and `utils/script_asm.py`;
- the one replay mix of the port (`utils/blockgen`), and `mixed_items`
  drawing the bytes it drew before.

The batch engine runs the plain torch version of `verify_tiles` through
`torch_serving_common.PLAIN`, which runs each distinct lane row once; one
dispatch of every input of this file warms it first.
"""

import dataclasses
import hashlib
import json
import os
import random

import pytest
import torch

from torch_serving_common import PLAIN, patch_plain_rows

from bitcoinconsensus_tpu import native_bridge as J_NB
from bitcoinconsensus_tpu.utils import script_asm as J_ASM
from bitcoinconsensus_tpu.workloads import corpus as JC
from bitcoinconsensus_tpu.workloads import diff_fuzz as JD
from bitcoinconsensus_tpu.workloads import replay as JR
from bitcoinconsensus_tpu_torch import native_bridge
from bitcoinconsensus_tpu_torch.core.flags import LIBCONSENSUS_FLAGS
from bitcoinconsensus_tpu_torch.core.tx import Tx
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.utils import blockgen
from bitcoinconsensus_tpu_torch.utils import script_asm as T_ASM
from bitcoinconsensus_tpu_torch.utils.refbridge import load_reference_lib
from bitcoinconsensus_tpu_torch.workloads import corpus as TC
from bitcoinconsensus_tpu_torch.workloads import diff_fuzz as TD
from bitcoinconsensus_tpu_torch.workloads import replay as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = load_reference_lib()
with open(os.path.join(REPO, "fuzz", "gauntlet_seeds.json"), encoding="utf-8") as fh:
    SEEDS = json.load(fh)["seeds"]
FUZZ_N = 8
LIAR_N = 12  # the lying-engine case's mutants of seed 1 (the first 8 shared)
# (seed, n_blocks, txs_per_block, max_inputs) of the streams compared here;
# the first is run_replay's, the second the serving and cell legs' (the
# reference's CI size: 9 inputs, one of them a rejected spend).
STREAMS = ((3, 2, 2, 2), (1, 2, 3, 3), (4, 2, 3, 3), (5, 2, 2, 3))
SERVE_CFG = TR.ReplayConfig(seed=1, n_blocks=2, txs_per_block=3)
REPLAY_CFG = TR.ReplayConfig(seed=3, n_blocks=2, txs_per_block=2, max_inputs=2)


def _fields(item):
    return (item.spending_tx, item.input_index, item.flags, item.spent_output_script,
            item.amount, None if item.spent_outputs is None else
            [tuple(o) for o in item.spent_outputs])


@pytest.fixture(scope="module")
def corpora():
    return TC.build_corpus(), JC.build_corpus()


@pytest.fixture(scope="module")
def mutants(corpora):
    """{seed: (items, meta)} of the port's mutant stream per CI seed."""
    port = corpora[0]
    out = {s: TD.fuzz_cases(s, FUZZ_N, port) for s in SEEDS}
    out["liar"] = TD.fuzz_cases(1, LIAR_N, port)
    return out


@pytest.fixture(scope="module", autouse=True)
def plain(corpora, mutants):
    """The plain kernel behind every verifier of this file, warmed by one
    dispatch of every input the tests send."""
    with pytest.MonkeyPatch.context() as mp:
        patch_plain_rows(mp)
        torch.set_num_threads(1)
        items = [c.item for c in corpora[0]]
        for its, _meta in mutants.values():
            items += its
        for cfg in (REPLAY_CFG, SERVE_CFG):
            items += [it for b in TR.generate_stream(cfg) for it in b.block_items]
        verify_batch(items, verifier=TorchSecpVerifier(device="cpu"),
                     sig_cache=SigCache(), script_cache=ScriptExecutionCache())
        yield PLAIN


# ---------------------------------------------------------------- corpus


def test_corpus_is_byte_identical_to_the_jax_package(corpora):
    port, ref = corpora
    assert len(port) == len(ref) == 26
    assert TC.SHAPES == JC.SHAPES
    for t, j in zip(port, ref):
        assert (t.name, t.shape, t.description) == (j.name, j.shape, j.description)
        assert _fields(t.item) == _fields(j.item), t.name
        assert t.expected() == j.expected(), t.name
    shapes = {}
    for c in port:
        shapes[c.shape] = shapes.get(c.shape, 0) + 1
    assert shapes == {"multisig_fanout": 3, "quadratic_sighash": 2,
                      "max_size_script": 2, "taproot_annex": 2,
                      "sig_malleation": 4, "boundary_flags": 4, "scalar_edge": 9}


@pytest.mark.parametrize("shape", ("multisig_fanout", "quadratic_sighash",
                                   "max_size_script", "taproot_annex"))
def test_shape_batch_is_byte_identical_to_the_jax_package(shape):
    port, ref = TC.shape_batch(shape, 4, seed=7), JC.shape_batch(shape, 4, seed=7)
    assert [_fields(i) for i in port] == [_fields(i) for i in ref]
    assert all(TD.python_verdict(it)[0] for it in port), shape


def test_shape_batch_refuses_the_pinning_shapes():
    for shape in ("sig_malleation", "boundary_flags", "scalar_edge"):
        with pytest.raises(ValueError):
            TC.shape_batch(shape, 2)


def test_corpus_pins_hold_on_every_engine_on_the_cpu():
    rep = TC.run_corpus_check(device="cpu")
    assert rep["pinned"], rep["mismatches"]
    assert rep["cases"] == 26 and rep["device"] == "cpu"
    assert rep["native_available"] == native_bridge.available()
    assert rep["batch_launches"] == 0  # the plain version counts no launch


def test_planted_wrong_pin_fails_the_gauntlet(corpora):
    corpus = list(corpora[0])
    victim = corpus[0]
    corpus[0] = dataclasses.replace(victim, expect_ok=not victim.expect_ok)
    rep = TC.run_corpus_check(corpus=corpus, device="cpu")
    assert not rep["pinned"]
    assert {m["case"] for m in rep["mismatches"]} == {victim.name}
    assert {m["engine"] for m in rep["mismatches"]} == {"python", "native", "batch"}


@pytest.mark.skipif(
    REF is None, reason="reference lib not built (scripts/build_reference.sh)"
)
def test_corpus_reference_so_differential(corpora):
    """Corpus entries through the reference .so under masked libconsensus
    flags: agreement with the port's api (not the pin — the mask can change
    the expectation), as the JAX package's test holds its own."""
    from bitcoinconsensus_tpu_torch import api
    from bitcoinconsensus_tpu_torch.api import ConsensusError, Error

    checked = 0
    for case in corpora[0]:
        item = case.item
        flags = item.flags & LIBCONSENSUS_FLAGS
        idx = item.input_index
        amount, spk = item.spent_outputs[idx]
        try:
            api.verify_with_flags(spk, amount, item.spending_tx, idx, flags)
            ours = (True, 0)
        except ConsensusError as e:
            ours = (False, 0 if e.code == Error.ERR_SCRIPT else int(e.code))
        assert ours == REF.verify_with_flags(spk, amount, item.spending_tx, idx, flags), \
            case.name
        checked += 1
    assert checked == 26


def test_scalar_edge_cases_pin_u2_as_the_jax_package(corpora):
    """The scalar-edge lanes carry the reference's pins: u2 = r/s mod n of
    each case's signature is its target (LAMBDA from the port's glv)."""
    from bitcoinconsensus_tpu.crypto.glv import LAMBDA as J_LAMBDA
    from bitcoinconsensus_tpu_torch.crypto import secp_host as H
    from bitcoinconsensus_tpu_torch.crypto.glv import LAMBDA

    assert LAMBDA == J_LAMBDA
    got = {}
    for c in corpora[0]:
        if c.shape != "scalar_edge" or c.name.endswith("badsig") or "u1" in c.name:
            continue
        script_sig = Tx.deserialize(c.item.spending_tx).vin[0].script_sig
        der = script_sig[1:1 + script_sig[0]][:-1]  # the pushed signature, no hashtype
        r, s = H.parse_der_lax(der)
        got[c.name] = r * pow(s, H.N - 2, H.N) % H.N
    assert got["scalar-u2-one"] == 1
    assert got["scalar-u2-n-minus-1"] == H.N - 1
    assert got["scalar-u2-lambda"] == LAMBDA
    assert got["scalar-u2-lambda-plus-1"] == LAMBDA + 1
    assert got["scalar-u2-2p128-minus-1"] == (1 << 128) - 1
    assert got["scalar-u2-2p128"] == 1 << 128


# -------------------------------------------------------------- diff-fuzz


@pytest.mark.parametrize("s", range(5))
def test_mutants_are_byte_identical_to_the_jax_package(corpora, s):
    port, ref = corpora
    for t, j in zip(port, ref):
        tm, tk = TD.mutate(t.item, random.Random(s))
        jm, jk = JD.mutate(j.item, random.Random(s))
        assert tk == jk and _fields(tm) == _fields(jm), (t.name, s)
    assert TD.MUTATIONS == JD.MUTATIONS


def test_mutant_stream_is_the_jax_packages(corpora, mutants):
    """`fuzz_cases` draws the reference's `run_diff_fuzz` loop: the same
    (origin, mutation, bytes) for each seed."""
    ref = corpora[1]
    for s in SEEDS:
        rng = random.Random(s)
        items, meta = mutants[s]
        for it, (origin, kind) in zip(items, meta):
            i = rng.randrange(len(ref))
            jm, jk = JD.mutate(ref[i].item, rng)
            assert (origin, kind) == (ref[i].name, jk)
            assert _fields(it) == _fields(jm)


@pytest.mark.parametrize("seed", SEEDS)
def test_diff_fuzz_ci_seed_zero_divergence(seed):
    rep = TD.run_diff_fuzz(seed=seed, n_cases=FUZZ_N, device="cpu")
    assert rep["bit_identical"], rep["divergences"]
    assert rep["cases"] == FUZZ_N and sum(rep["mutations"].values()) == FUZZ_N
    assert rep["engines"] == (3 if native_bridge.available() else 2)


def test_fuzz_verdicts_equal_the_jax_packages(mutants):
    """The port's three engines on every CI mutant against the JAX
    package's `python_verdict` and (where its bridge builds) its
    `native_verdict`: equal triples, tolerance 0."""
    items = [it for s in SEEDS for it in mutants[s][0]]
    bat = TD.batch_verdicts(items, device="cpu")
    rejects = 0
    for it, b in zip(items, bat):
        want = JD.python_verdict(it)
        assert TD.python_verdict(it) == want
        assert b == want
        assert TD.native_verdict(it) == (want if native_bridge.available() else None)
        if J_NB.available():
            assert JD.native_verdict(it) == want
        rejects += not want[0]
    assert 0 < rejects < len(items)


def test_diff_fuzz_catches_lying_engine(monkeypatch):
    monkeypatch.setattr(TD, "python_verdict", lambda item: (True, "ERR_OK", None))
    rep = TD.run_diff_fuzz(seed=1, n_cases=LIAR_N, device="cpu")
    assert not rep["bit_identical"]
    assert rep["divergences"]


def test_backend_verdicts_names_every_engine(corpora):
    case = corpora[0][0]
    got = TD.backend_verdicts(case.item, device="cpu")
    assert got == {"python": case.expected(), "batch": case.expected(),
                   "native": case.expected() if native_bridge.available() else None}


# ----------------------------------------------------------------- replay


def _stream_bytes(blocks):
    return [(b.height, b.n_txs, b.expected_ok, [_fields(i) for i in b.block_items],
             [_fields(i) for i in b.mempool_items]) for b in blocks]


@pytest.mark.parametrize("cfg", STREAMS, ids=lambda c: f"seed{c[0]}")
def test_generate_stream_is_byte_identical_to_the_jax_package(cfg):
    seed, n_blocks, txs, max_in = cfg
    port = TR.generate_stream(TR.ReplayConfig(seed=seed, n_blocks=n_blocks,
                                              txs_per_block=txs, max_inputs=max_in))
    ref = JR.generate_stream(JR.ReplayConfig(seed=seed, n_blocks=n_blocks,
                                             txs_per_block=txs, max_inputs=max_in))
    assert _stream_bytes(port) == _stream_bytes(ref)


def test_replay_mix_has_one_definition():
    assert TR.DEFAULT_MIX is blockgen.DEFAULT_MIX
    assert TR._pick_kind is blockgen._pick_kind
    assert TR.ReplayConfig().mix == JR.DEFAULT_MIX == blockgen.DEFAULT_MIX


def test_mixed_items_draw_the_bytes_they_drew_before():
    """chip_smoke's main path draws its inputs with `mixed_items`: moving
    the mix's definition must not change one byte of them (digest taken
    before the move, and `mixed_items` byte-equal to the reference's
    builders, tests/test_torch_batch.py)."""
    items, bad = blockgen.mixed_items(40, seed=2026, corrupt_rate=0.05)
    h = hashlib.sha256()
    for it, b in zip(items, bad):
        h.update(it.spending_tx + it.input_index.to_bytes(4, "little") + bytes([b]))
        for amount, spk in it.spent_outputs:
            h.update(amount.to_bytes(8, "little") + spk)
    assert sum(bad) == 2
    assert h.hexdigest() == \
        "e4c8c0bda9604f8ce8e847bb157e5fb182f53c233206243e5a4f7f1094119c14"


@pytest.fixture
def jax_oracle(monkeypatch):
    """The runners' oracle held to the JAX package: the port's
    `_oracle` must give `JD.python_verdict`'s triple for every item, and
    the runner then holds the port's stream, server or cell to the JAX
    package's verdicts. Returns the items judged."""
    port_oracle = TR._oracle
    judged = []

    def oracle(items):
        ref = [JD.python_verdict(it) for it in items]
        assert port_oracle(items) == ref
        judged.extend(items)
        return ref

    monkeypatch.setattr(TR, "_oracle", oracle)
    return judged


def _distinct_items(cfg):
    blocks = TR.generate_stream(cfg)
    return {(it.spending_tx, it.input_index) for b in blocks for it in b.block_items}


def test_replay_bit_identical_and_cache_warm(jax_oracle):
    rep = TR.run_replay(REPLAY_CFG, device="cpu")
    assert rep["bit_identical"], rep["divergences"]
    assert rep["warmed"], rep
    assert rep["script_cache_hits"] >= rep["expected_warm_hits"] > 0
    assert rep["device"] == "cpu" and rep["oracle_workers"] == 1
    assert {(it.spending_tx, it.input_index) for it in jax_oracle} == \
        _distinct_items(REPLAY_CFG)


@pytest.mark.parametrize("mode", ("serve", "ingress"))
def test_replay_serving_all_accounted(jax_oracle, mode):
    rep = TR.run_replay_serving(SERVE_CFG, mode=mode, device="cpu",
                                slo_deadline_s=600.0)
    assert rep["bit_identical"], rep["divergences"]
    assert rep["all_accounted"] and rep["sheds_explicit_only"], rep["errors"]
    # Every item settled, so every verdict, the rejected spend's too, was
    # held to the JAX package's.
    assert rep["settled"] == rep["items"] == len(jax_oracle) > 0
    assert rep["sheds"] == 0
    assert not all(JD.python_verdict(it)[0] for it in jax_oracle)


def test_replay_cell_all_accounted(jax_oracle):
    rep = TR.run_replay_cell(SERVE_CFG, n_replicas=2, device="cpu",
                             slo_deadline_s=600.0)
    assert rep["bit_identical"], rep["divergences"]
    assert rep["all_accounted"] and rep["sheds_explicit_only"], rep["errors"]
    assert rep["device"] == "cpu" and rep["replicas"] == 2
    assert rep["settled"] == rep["items"] == len(jax_oracle) > 0


def test_large_replays_spread_the_oracle():
    assert TR.oracle_workers(TR.ORACLE_PARALLEL_MIN - 1) == 1
    assert 1 <= TR.oracle_workers(TR.ORACLE_PARALLEL_MIN) <= 7


@pytest.mark.slow
def test_replay_serving_overload_sheds_explicitly():
    rep = TR.run_replay_serving(
        TR.ReplayConfig(seed=9, n_blocks=2, txs_per_block=2),
        mode="serve", overload=True, device="cpu", slo_deadline_s=600.0,
    )
    assert rep["bit_identical"], rep["divergences"]
    assert rep["all_accounted"], rep["errors"]
    assert rep["sheds_happened"] and rep["sheds_explicit_only"]


def test_runners_default_to_the_card():
    """`device=None` means cuda:0 and raises without CUDA; nothing carries
    on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = TR.ReplayConfig(seed=1, n_blocks=1, txs_per_block=1)
    for fn in (lambda: TC.run_corpus_check(),
               lambda: TD.run_diff_fuzz(seed=1, n_cases=1),
               lambda: TD.batch_verdicts([]),
               lambda: TR.run_replay(cfg),
               lambda: TR.run_replay_serving(cfg),
               lambda: TR.run_replay_cell(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


# ------------------------------------------------------------------ utils


@pytest.mark.parametrize("text", [
    "0 IF 0x02 0x0100 ENDIF 1",
    "'abc' DUP HASH160 -1 16 17 NOP10 RESERVED OP_CHECKSIGADD",
    "9223372036854775808 -9223372036854775809 1000 -5",
])
def test_script_asm_equals_the_jax_packages(text):
    assert T_ASM.parse_asm(text) == J_ASM.parse_asm(text)


def test_script_asm_rejects_what_the_jax_package_rejects():
    for text in ("0x0", "NOTANOP", "OP_0"):
        with pytest.raises(J_ASM.ScriptParseError):
            J_ASM.parse_asm(text)
        with pytest.raises(T_ASM.ScriptParseError):
            T_ASM.parse_asm(text)


def test_refbridge_is_absent_without_the_reference_build(tmp_path):
    assert load_reference_lib(str(tmp_path / "missing.so")) is None
