"""The checked verify launch's epilogue on the CPU.

`csrc/verify_tiles.cu`'s checked launch (`vt_verify_checked_kernel`) runs
the lane program and then, per warp, the sums of `vt_epilogue_terms`: the
count and position-weighted sum of the reference's `_verdict_checksum`
(`bitcoinconsensus_tpu/crypto/jax_backend.py:380`) and the failure count of
its sharded `local_step` (`bitcoinconsensus_tpu/parallel/mesh.py:210`). The
kernel runs only on the card; its epilogue's arithmetic is compiled here by
g++ as `vt_host_epilogue` (`csrc/verify_tiles_host.cpp`, beside
`vt_host_recode`) and held, on seeded buffers at every width and shard
layout below, to the JAX package's sums run on the CPU and to the port's
plain versions (`verdict_checksum_reference`, `shard_epilogue_reference`,
`epilogue_reference` and `verify_tiles_checked_reference`), tolerance 0.
The guards that read the partials are checked end to end too: a CPU
`TorchSecpVerifier` and a CPU mesh catch a flipped verdict by the checksum
the epilogue carries.

Run: JAX_PLATFORMS=cpu python -m pytest tests/test_torch_verify_epilogue.py
"""

import ctypes
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.crypto.jax_backend import _verdict_checksum
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.obs import get_registry
from bitcoinconsensus_tpu_torch.ops import _build
from bitcoinconsensus_tpu_torch.ops import shard_step as SS
from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.parallel import mesh as M
from bitcoinconsensus_tpu_torch.resilience import faults as F
from bitcoinconsensus_tpu_torch.resilience import guards as G
from bitcoinconsensus_tpu_torch.utils import blockgen as B

torch.set_num_threads(1)

WIDTHS = (1, 31, 63, 64, 65, 2048, 8191)
LAYOUTS = ((4, 16), (4, 2048))


@pytest.fixture(scope="module")
def host_epilogue():
    """`vt_host_epilogue` of the g++ build: (ok, needs, live or None) numpy
    buffers -> the (3, ceil(n / 32)) int32 per-warp partials."""
    fn = ctypes.CDLL(str(_build.build(_build.VT_HOST).path)).vt_host_epilogue
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]

    def run(ok, needs, live):
        n = len(ok)
        ok32 = np.ascontiguousarray(ok, dtype=np.int32)
        nd32 = np.ascontiguousarray(needs, dtype=np.int32)
        lv = None if live is None else np.ascontiguousarray(live, dtype=np.uint8)
        out = np.full((3, -(-n // 32)), -1, dtype=np.int32)
        fn(ok32.ctypes.data, nd32.ctypes.data, None if lv is None else lv.ctypes.data,
           out.ctypes.data, n)
        return out

    return run


def _buffers(n: int, seed: int):
    """Seeded (ok, needs, live) bool buffers of n lanes; every combination
    of the three occurs at the larger widths."""
    rng = np.random.default_rng([16, n, seed])
    return rng.random(n) < 0.6, rng.random(n) < 0.1, rng.random(n) < 0.9


def _reference_triple(ok, needs, live):
    """The JAX package's (count, weighted sum) of `_verdict_checksum` and
    `local_step`'s failure count, run on the CPU."""
    cnt, wsum = _verdict_checksum(jnp.asarray(ok))
    ok_j, needs_j, live_j = (jnp.asarray(x) for x in (ok, needs, live))
    fails = jnp.sum(jnp.where(live_j & ~ok_j & ~needs_j, 1, 0))
    return int(cnt), int(wsum), int(fails)


@pytest.mark.parametrize("n", WIDTHS)
def test_host_partials_sum_to_the_reference_checksum_and_failures(host_epilogue, n):
    ok, needs, live = _buffers(n, 0)
    parts = host_epilogue(ok, needs, live)
    triple = VT.epilogue_sums(parts)
    assert triple == _reference_triple(ok, needs, live)
    t = [torch.from_numpy(x) for x in (ok, needs, live)]
    assert list(triple[:2]) == VC.verdict_checksum_reference(t[0]).tolist()
    assert list(triple) == SS.shard_epilogue_reference(*t, 1)[:, 0].tolist()
    # The port's plain epilogue, warp by warp; without `live` no failure.
    _ok, _needs, plain = VT.epilogue_reference(*t)
    assert np.array_equal(parts, plain.numpy())
    bare = host_epilogue(ok, needs, None)
    assert np.array_equal(bare[:2], parts[:2]) and not bare[2].any()
    # Each warp's sums stay inside the bounds the prover holds.
    assert parts.min() >= 0 and parts[0].max() <= 32 and parts[1].max() <= 32 * 251


@pytest.mark.parametrize("d,rows", LAYOUTS)
def test_host_shard_triples_equal_the_reference_local_step(host_epilogue, d, rows):
    """One launch a shard: the weights restart at every shard, as the
    reference checksums a shard's slice."""
    ok, needs, live = _buffers(d * rows, 1)
    got, want = [], []
    for s in range(d):
        sl = slice(s * rows, (s + 1) * rows)
        got.append(VT.epilogue_sums(host_epilogue(ok[sl], needs[sl], live[sl])))
        want.append(_reference_triple(ok[sl], needs[sl], live[sl]))
    assert got == want
    t = [torch.from_numpy(x) for x in (ok, needs, live)]
    assert got == [tuple(c) for c in SS.shard_epilogue_reference(*t, d).T.tolist()]


def test_epilogue_sums_refuses_other_shapes():
    with pytest.raises(ValueError):
        VT.epilogue_sums(np.zeros((2, 4), dtype=np.int32))


# -- the plain verify, memoised per lane row ---------------------------------------


class _MemoRows:
    """`verify_tiles_reference` with each distinct packed lane row run once:
    the module's function, patched, so that `verify_tiles_checked` on the
    CPU keeps its own route (checks, epilogue, buffers) around it."""

    def __init__(self, plain):
        self.plain, self.memo, self.runs = plain, {}, 0

    def __call__(self, *args):
        arrs = [a.numpy() for a in args]
        keys = [b"".join(a[i].tobytes() for a in arrs) for i in range(len(arrs[0]))]
        todo = {}
        for i, k in enumerate(keys):
            if k not in self.memo and k not in todo:
                todo[k] = i
        if todo:
            idx = torch.tensor(list(todo.values()))
            ok, needs = self.plain(*(a[idx].contiguous() for a in args))
            self.memo.update((k, (bool(ok[j]), bool(needs[j])))
                             for j, k in enumerate(todo))
            self.runs += 1
        got = [self.memo[k] for k in keys]
        return (torch.tensor([g[0] for g in got], dtype=torch.bool),
                torch.tensor([g[1] for g in got], dtype=torch.bool))


def _checks():
    """Valid and invalid ECDSA and Schnorr checks."""
    out = []
    for i in range(3):
        sk = B._sk(f"epilogue/ecdsa{i}")
        msg = hashlib.sha256(b"epi-e%d" % i).digest()
        sig = B.sign_ecdsa(sk, msg)
        out.append(SigCheck("ecdsa", (B.pubkey_create(sk), sig, msg if i else b"\1" * 32)))
    for i in range(2):
        sk = B._sk(f"epilogue/schnorr{i}")
        msg = hashlib.sha256(b"epi-s%d" % i).digest()
        xpk, _ = B.xonly_pubkey_create(sk)
        out.append(SigCheck("schnorr", (xpk, B.sign_schnorr(sk, msg), msg)))
    return out


CHECKS = _checks()


@pytest.fixture(scope="module")
def memo():
    """The plain verify memoised, warmed by one run over every lane the tests
    dispatch: the checks, the four sentinel templates and a pad row."""
    memo = _MemoRows(VT.verify_tiles_reference)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VT, "verify_tiles_reference", memo)
        v = TorchSecpVerifier(device="cpu", engine="python", min_batch=16)
        n = len(CHECKS)
        args = v._pack_lanes(v._prep_lanes(CHECKS))
        G.install_sentinels_at(args, list(range(n, n + len(G._sentinel_templates()))),
                               rotation=0)
        memo(*(torch.from_numpy(a) for a in args))
        yield memo


def test_checked_reference_on_real_lanes_equals_the_host_epilogue(memo, host_epilogue):
    """`verify_tiles_checked_reference` and the wrapper's CPU route on packed
    lanes (real checks, sentinels, pad), with a live mask: the verdicts of
    the plain verify, the partials of the host twin, the triple of the
    reference."""
    v = TorchSecpVerifier(device="cpu", engine="python", min_batch=16)
    n = len(CHECKS)
    args = v._pack_lanes(v._prep_lanes(CHECKS))
    G.install_sentinels_at(args, list(range(n, n + 4)), rotation=0)
    t = tuple(torch.from_numpy(a) for a in args)
    live = torch.from_numpy(np.arange(len(args[0])) < n + 2)
    ok, needs, parts = VT.verify_tiles_checked_reference(*t, live=live)
    want_ok, want_needs = memo(*t)
    assert torch.equal(ok, want_ok) and torch.equal(needs, want_needs)
    assert ok[:n].tolist() == [v._host_check(c) for c in CHECKS]
    host = host_epilogue(ok.numpy(), needs.numpy(), live.numpy())
    assert np.array_equal(parts.numpy(), host)
    assert VT.epilogue_sums(parts) == _reference_triple(ok.numpy(), needs.numpy(),
                                                        live.numpy())
    # The wrapper's CPU route, into caller buffers: the same words, int32.
    ok_out, needs_out = torch.empty_like(ok), torch.empty_like(needs)
    buf = torch.full(tuple(parts.shape), -1, dtype=torch.int32)
    got = VT.verify_tiles_checked(*t, live=live, ok_out=ok_out, needs_out=needs_out,
                                  partials=buf)
    assert got[0] is ok_out and got[1] is needs_out and got[2] is buf
    assert torch.equal(ok_out, ok) and torch.equal(buf.long(), parts)
    assert VT.verify_tiles_checked(*t, partials=False)[2] is None
    for bad in (dict(partials=torch.zeros((3, 2), dtype=torch.int32)),
                dict(partials=torch.zeros(tuple(parts.shape), dtype=torch.int64)),
                dict(live=live.to(torch.int32)), dict(ok_out=ok_out[:-1])):
        with pytest.raises(ValueError):
            VT.verify_tiles_checked(*t, **bad)


class _FlipOnce:
    """`faults.corrupt_verdict` that flips lane 0 (a real lane, which no
    sentinel sees) the first time it settles each of `sites`."""

    def __init__(self, *sites):
        self.todo = set(sites)

    def __call__(self, site, arr):
        out = np.array(arr)
        if site in self.todo:
            self.todo.discard(site)
            out[0] = not out[0]
        return out


def _checksum_anomalies(site: str) -> int:
    snap = get_registry().snapshot().get("consensus_resilience_guard_anomalies_total",
                                         {"samples": []})
    return sum(s["value"] for s in snap["samples"]
               if s["labels"] == {"site": site, "reason": "checksum"})


def test_cpu_verifier_catches_a_flip_by_the_epilogue_checksum(memo, monkeypatch):
    """A flip of a real lane is caught by the checksum the checked launch
    carries, and the retry answers right; the fault harness's own flip is
    caught too."""
    v = TorchSecpVerifier(device="cpu")
    oracle = [v._host_check(c) for c in CHECKS]
    before = _checksum_anomalies("torch_backend")
    monkeypatch.setattr(F, "corrupt_verdict", _FlipOnce("torch_backend.verdict"))
    assert v.verify_checks(CHECKS).tolist() == oracle
    assert _checksum_anomalies("torch_backend") == before + 1 and v.stats["retries"] == 1
    monkeypatch.undo()
    with F.inject(F.FaultPlan([F.FaultSpec("torch_backend.verdict", "flip")])) as inj:
        assert v.verify_checks(CHECKS).tolist() == oracle
    assert inj.total_fired() == 1 and v.stats["retries"] == 2


def test_cpu_mesh_catches_a_flip_by_the_epilogue_checksum(memo, monkeypatch):
    """A one-entry CPU mesh settles through the base seam, where the
    `torch_backend.verdict` flip is caught by the launch's checksum; a
    4-entry CPU mesh convicts the flipped shard by the checksum its own
    launch carried and dispatches its lanes again. Both answer right."""
    monkeypatch.setattr(F, "corrupt_verdict",
                        _FlipOnce("torch_backend.verdict", "mesh.shard.1"))
    for entries, site in ((1, "mesh"), (4, "mesh.shard.1")):
        v = M.ShardedSecpVerifier(mesh=M.make_mesh(devices=["cpu"] * entries))
        oracle = [v._host_check(c) for c in CHECKS]
        before = _checksum_anomalies(site)
        res, all_ok = v.verify_checks_with_verdict(CHECKS)
        assert res.tolist() == oracle and all_ok == all(oracle)
        assert _checksum_anomalies(site) == before + 1
        if entries == 4:
            assert v.stats["mesh_dispatches"] == 2  # the flipped shard's lanes again
        else:
            assert v.stats["retries"] == 1
