"""The port's sharded verifier (`parallel/mesh.py`) held against the JAX
package's, on the CPU.

- layout: `_shard_positions`, `_pad`, `lane_capacity` and `_build_layout`
  (positions, scattered buffers, sentinel rows, expected answers) equal the
  reference's for n in {1, 7, 13, 100} and d in {2, 3, 6, 8}, with the
  sentinel rotation pinned equal;
- the epilogue (`ops/shard_step.py`): its plain version, the wrapper on CPU
  tensors and its launch contract's plain walk equal the reference's
  `_verdict_checksum` over each shard's slice and its failure count, on
  seeded buffers; the contract is proven; tolerance 0;
- the stub harness: the reference's in-process cases
  (`tests/test_parallel.py`) run on both packages with the same checks,
  seed and `FaultPlan`. The reference's step and kernel are its host-exact
  stand-ins; the port runs its real step and epilogue (plain versions)
  around a host-exact `verify_tiles` keyed by packed lane bytes. Results,
  block verdicts, the mesh after evictions and the `consensus_mesh_*`
  deltas must be equal;
- the divergences, on the port alone: a shard that fails again answers on
  the `device` rung (the reference's `xla`); a fault on every shard, and a
  stale layout after an eviction;
- the real plain kernels on a 4-entry CPU mesh: verdicts equal the
  single-device verifier's and the JAX package's host oracle; and the
  entry points (`verify_batch`, `verify_batch_stream`, `connect_block`)
  through the mesh equal the single-device verifier's;
- `slow`: the JAX `make_sharded_step` on the forced 8-device CPU mesh
  against the port's step on an 8-entry CPU mesh, output for output, in a
  fresh subprocess.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import *  # noqa: F401,F403 (env setup: 8 virtual CPU devices)

from bitcoinconsensus_tpu.crypto import secp_host as JH
from bitcoinconsensus_tpu.crypto.jax_backend import _verdict_checksum
from bitcoinconsensus_tpu.obs import get_registry as j_registry
from bitcoinconsensus_tpu.parallel import mesh as JM
from bitcoinconsensus_tpu.resilience import degrade as JD
from bitcoinconsensus_tpu.resilience import faults as JF
from bitcoinconsensus_tpu.resilience import guards as JG
from bitcoinconsensus_tpu_torch.analysis import registry
from bitcoinconsensus_tpu_torch.crypto import torch_backend as TB
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import verify_batch, verify_batch_stream
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.models.validate import connect_block
from bitcoinconsensus_tpu_torch.native_bridge import NativeCoinsView
from bitcoinconsensus_tpu_torch.obs import get_registry as t_registry
from bitcoinconsensus_tpu_torch.ops import shard_step as SS
from bitcoinconsensus_tpu_torch.ops.contract import run_contract
from bitcoinconsensus_tpu_torch.parallel import mesh as M
from bitcoinconsensus_tpu_torch.resilience import degrade as D
from bitcoinconsensus_tpu_torch.resilience import faults as F
from bitcoinconsensus_tpu_torch.resilience import guards as G
from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed
from bitcoinconsensus_tpu_torch.utils import blockgen as B

from test_parallel import _fd_checks, _mesh_stub_verifier as _ref_stub
from test_torch_resilience import PlainRows
from torch_serving_common import checked

torch.set_num_threads(1)


# -- layout ----------------------------------------------------------------------------


def _packed(rng, size, n):
    fields = rng.integers(0, 256, (size, 4, 32), dtype=np.uint8)
    flags = [rng.integers(lo, 2, size).astype(np.int32) for lo in (0, -1, 0, 0, 0)]
    valid = np.zeros(size, dtype=bool)
    valid[:n] = rng.integers(0, 2, n).astype(bool)
    return (fields, *flags, valid)


@pytest.mark.parametrize("d", [2, 3, 6, 8])
def test_layout_equals_the_reference(d):
    jv = JM.ShardedSecpVerifier(mesh=JM.make_mesh(d), min_batch=8)
    tv = M.ShardedSecpVerifier(mesh=M.make_mesh(devices=["cpu"] * d), min_batch=8)
    assert tv.lane_capacity == jv.lane_capacity == (1 << 13) - d
    assert tv._min_batch == jv._min_batch
    rng = np.random.default_rng(d)
    for n in (1, 7, 13, 100):
        padded = tv._pad(n)
        assert padded == jv._pad(n)
        shard = padded // d
        assert np.array_equal(M._shard_positions(n, shard), JM._shard_positions(n, shard))
        base = _packed(rng, padded, n)
        got = {}
        for name, v, guards in (("ref", jv, JG), ("port", tv, G)):
            args = tuple(a.copy() for a in base)
            guards._rotation = 1
            got[name] = (v._build_layout(args, n), args)
        (jl, jargs), (tl, targs) = got["ref"], got["port"]
        assert jl is not None and tl is not None
        assert (tl.n, tl.padded, tl.n_shards, tl.shard_size) == \
            (jl.n, jl.padded, jl.n_shards, jl.shard_size) == (n, padded, d, shard)
        assert np.array_equal(tl.positions, jl.positions)
        assert np.array_equal(tl.flat_sset.positions, jl.flat_sset.positions)
        assert np.array_equal(tl.flat_sset.expected, jl.flat_sset.expected)
        for ts, js in zip(tl.ssets, jl.ssets, strict=True):
            assert np.array_equal(ts.positions, js.positions)
            assert np.array_equal(ts.expected, js.expected)
        for a, b in zip(targs, jargs, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        live = tl.live.numpy()
        assert live.sum() == n and live[tl.positions].all()
        assert tl.ids == tuple(str(i) for i in range(d)) and tl.views is targs
    # A buffer one row short of n + d cannot carry the layout, in either.
    short = _packed(rng, 8 * d, 8 * d - d + 1)
    assert tv._build_layout(tuple(a.copy() for a in short), 8 * d - d + 1) is None
    assert jv._build_layout(tuple(a.copy() for a in short), 8 * d - d + 1) is None


# -- the epilogue ------------------------------------------------------------------------


def _reference_triples(ok, needs, live, d):
    """The reference's per-shard triple: `_verdict_checksum` over the shard's
    slice, and `local_step`'s failure count (mesh.py:211-212)."""
    rows = ok.shape[0] // d
    out = []
    for s in range(d):
        sl = slice(s * rows, (s + 1) * rows)
        cnt, wsum = _verdict_checksum(ok[sl])
        fails = np.sum(np.where(live[sl] & ~ok[sl] & ~needs[sl], 1, 0))
        out.append((int(cnt), int(wsum), int(fails)))
    return np.asarray(out, dtype=np.int64).T


@pytest.mark.parametrize("d,rows", [(1, 1), (4, 2048), (8, 1024), (3, 5), (2, 253)])
def test_epilogue_equals_the_reference(d, rows):
    rng = np.random.default_rng([d, rows])
    cases = [rng.integers(0, 2, (3, d * rows)).astype(bool),
             np.ones((3, d * rows), dtype=bool), np.zeros((3, d * rows), dtype=bool)]
    for ok, needs, live in cases:
        want = _reference_triples(ok, needs, live, d)
        t = [torch.from_numpy(x.copy()) for x in (ok, needs, live)]
        got = SS.shard_epilogue(*t, d)
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, d)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(SS.shard_epilogue_reference(*t, d).numpy(), want)
        if d * rows <= 8192:
            walked = run_contract(SS.SHARD_EPILOGUE_CONTRACT,
                                  *(x.view(d, rows) for x in t))
            assert np.array_equal(walked.numpy(), want)


def test_epilogue_weights_restart_at_every_shard():
    """A kernel weighting by the global row passes every clean run and
    convicts no flip on shards 1 and up: the weights here are shard-local."""
    ok = torch.zeros(2 * 300, dtype=torch.bool)
    ok[300 + 7] = True  # shard 1, local row 7
    z = torch.zeros_like(ok)
    got = SS.shard_epilogue(ok, z, z, 2).numpy()
    assert got[:, 1].tolist() == [1, 8, 0]
    assert got[:, 0].tolist() == [0, 0, 0]


def test_epilogue_contract_is_proven_and_checks_its_inputs():
    rep = registry.get_kernel("cuda.shard_step").analyze()
    assert rep.ok, rep.violations
    t = torch.zeros(8, dtype=torch.bool)
    for bad in ((t, t, t, 3), (t, t, t.to(torch.int32), 2), (t, t, torch.zeros(16, dtype=torch.bool)[::2], 2),
                (t, t, torch.zeros(4, dtype=torch.bool), 2), (t, t, t, 0)):
        with pytest.raises(ValueError):
            SS.shard_epilogue(*bad)
    with pytest.raises(ValueError, match="at most"):
        big = torch.zeros(SS.MAX_LANES + 1, dtype=torch.bool)
        SS.shard_epilogue(big, big, big, 1)


# -- make_mesh and the ladder --------------------------------------------------------


def test_make_mesh_needs_cuda_or_devices_and_refuses_oversubscription(monkeypatch):
    with pytest.raises(ValueError, match="requested 9 devices"):
        JM.make_mesh(9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh()
    with pytest.raises(RuntimeError):
        M.ShardedSecpVerifier()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices but only 1"):
        M.make_mesh(n_devices=2)
    assert M.make_mesh(n_devices=1).devices == (torch.device("cuda", 0),)
    mesh = M.make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.ids == ("0", "1", "2") and mesh.axis_names == ("batch",)
    with pytest.raises(ValueError):
        M.Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        M.Mesh([])


def _ladder_script(mod):
    lad = mod.ShardLadder(["0", "1", "2"], evict_after=2, reprobe_after=3)
    out = [lad.report_shard("1", ok=False), lad.report_shard("1", ok=False)]
    lad.evict("1")
    out.append(lad.healthy())
    out += [lad.report_shard("0", ok=False), lad.report_shard("0", ok=True),
            lad.report_shard("0", ok=False), lad.note_clean_dispatch()]
    lad.report_shard("2", ok=False)
    out += [lad.note_clean_dispatch() for _ in range(3)]
    lad.repromote("1")
    out.append(lad.healthy())
    one = mod.ShardLadder(["0"], evict_after=1)
    out.append(one.report_shard("0", ok=False))  # never empties the mesh
    return out


def test_shard_ladder_equals_the_reference(monkeypatch):
    assert _ladder_script(D) == _ladder_script(JD)
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_MESH_EVICT_AFTER", "5")
    assert D.ShardLadder(["0"]).evict_after == JD.ShardLadder(["0"]).evict_after == 5
    with pytest.raises(ValueError):
        D.ShardLadder(["0"], evict_after=0)


def test_mesh_fault_kinds_fire_as_the_reference():
    seen = {}
    for name, mod in (("port", F), ("ref", JF)):
        plan = mod.FaultPlan([mod.FaultSpec("mesh.shard.1", "device-loss"),
                              mod.FaultSpec("mesh.shard.1", "straggle", value=9),
                              mod.FaultSpec("mesh.probe", "raise")])
        out = []
        with mod.inject(plan) as inj:
            for site in ("mesh.shard.0", "mesh.shard.1", "mesh.shard.1", "mesh.probe"):
                try:
                    mod.maybe_raise(site)
                    out.append(None)
                except mod.InjectedFault as e:
                    out.append((type(e).__name__, e.site, e.kind))
            out += [mod.shard_delay("mesh.shard.1"), mod.shard_delay("mesh.shard.1")]
        seen[name] = (out, inj.fired)
        assert mod.shard_delay("mesh.shard.1") == 0.0  # disarmed
    assert seen["port"] == seen["ref"]
    assert seen["port"][0][1] == ("InjectedDeviceLoss", "mesh.shard.1", "device-loss")
    assert seen["port"][0][4:] == [9.0, 0.0]


# -- the stub harness: the reference's in-process cases on both packages ------------------

_BY_RAW = {raw: exp for raw, *_rest, exp in G._sentinel_templates()}


def _stub_verify_tiles(fields, want_odd, parity, has_t2, neg1, neg2, valid):
    """Host-exact `verify_tiles` stand-in keyed by packed lane bytes (a
    scatter layout moves lanes, so a positional key would be wrong)."""
    f, va = fields.numpy(), valid.numpy()
    ok = np.array([bool(va[i]) and _BY_RAW.get(f[i].tobytes(), False)
                   for i in range(len(f))], dtype=bool)
    return torch.from_numpy(ok), torch.zeros(len(ok), dtype=torch.bool)


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(M, "verify_tiles_checked", checked(_stub_verify_tiles))
    monkeypatch.setattr(TB, "verify_tiles_checked", checked(_stub_verify_tiles))
    return _port_stub


def _port_stub(checks, n_devices=8, evict_after=None):
    v = M.ShardedSecpVerifier(mesh=M.make_mesh(devices=["cpu"] * n_devices),
                              min_batch=8, evict_after=evict_after)
    oracle = np.asarray([v._host_check(c) for c in checks], dtype=bool)
    packed = v._pack_lanes(v._prep_lanes(checks))
    for i in range(len(checks)):
        _BY_RAW[packed[0][i].tobytes()] = bool(oracle[i])
    return v, oracle


def _port_checks(checks):
    return [SigCheck(c.kind, c.data) for c in checks]


class _Pkg:
    """One package's side of a case: its stub verifier, fault harness and
    registry."""

    def __init__(self, name):
        self.name = name
        ref = name == "ref"
        self.F = JF if ref else F
        self.M = JM if ref else M
        self.registry = j_registry if ref else t_registry

    def make(self, checks, n_devices=8, evict_after=None):
        if self.name == "ref":
            return _ref_stub(checks, n_devices, evict_after)
        return _port_stub(_port_checks(checks), n_devices, evict_after)

    def checks(self, checks):
        return checks if self.name == "ref" else _port_checks(checks)

    def size(self, v):
        return int(v.mesh.devices.size) if self.name == "ref" else v.mesh.size


def _mesh_samples(registry):
    """{(metric, labels): value} of the consensus_mesh_* metrics (a
    histogram as (count, sum, bucket counts))."""
    out = {}
    for name, m in registry().snapshot().items():
        if not name.startswith("consensus_mesh_"):
            continue
        for s in m["samples"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = ((s["count"], s["sum"], tuple(c for _le, c in s["buckets"]))
                        if m["kind"] == "histogram" else s["value"])
    return out


def _mesh_delta(before, after):
    """Counters and histograms as deltas, gauges as their value after."""
    out = {}
    for key, v in after.items():
        old = before.get(key)
        if key[0] in ("consensus_mesh_devices", "consensus_mesh_healthy_devices"):
            out[key] = v
        elif isinstance(v, tuple):
            old = old or (0, 0, (0,) * len(v[2]))
            d = (v[0] - old[0], v[1] - old[1], tuple(a - b for a, b in zip(v[2], old[2])))
            if d[0]:
                out[key] = d
        elif v - (old or 0):
            out[key] = v - (old or 0)
    return out


def _case_flip(pkg):
    checks = pkg.checks(_fd_checks(13))
    v, oracle = pkg.make(_fd_checks(13))
    with pkg.F.inject(pkg.F.FaultPlan([pkg.F.FaultSpec("mesh.shard.2", "flip")])) as inj:
        res, verdict = v.verify_checks_with_verdict(checks)
    return [(res.tolist(), verdict, inj.total_fired())], v, oracle


def _case_clean(pkg):
    out = []
    for checks in (_fd_checks(13), _fd_checks(9, bad_last=False)):
        v, oracle = pkg.make(checks)
        res, verdict = v.verify_checks_with_verdict(pkg.checks(checks))
        out.append((res.tolist(), verdict, oracle.tolist()))
    return out, v, oracle


def _case_straggle(pkg):
    checks = _fd_checks(9, bad_last=False)
    v, oracle = pkg.make(checks)
    out = []
    for _ in range(2):  # unarmed at a new width, armed at a seen one
        plan = pkg.F.FaultPlan([pkg.F.FaultSpec("mesh.shard.0", "straggle", value=9e9)])
        with pkg.F.inject(plan) as inj:
            res, verdict = v.verify_checks_with_verdict(pkg.checks(checks))
        out.append((res.tolist(), verdict, inj.total_fired()))
    return out, v, oracle


def _case_device_loss(pkg):
    checks = _fd_checks(13)
    v, oracle = pkg.make(checks, evict_after=1)
    plan = pkg.F.FaultPlan([pkg.F.FaultSpec("mesh.shard.1", "device-loss")])
    with pkg.F.inject(plan) as inj:
        res, verdict = v.verify_checks_with_verdict(pkg.checks(checks))
    out = [(res.tolist(), verdict, inj.total_fired(), pkg.size(v),
            list(v._shard_device_ids))]
    res2, verdict2 = v.verify_checks_with_verdict(pkg.checks(checks))
    out.append((res2.tolist(), verdict2, pkg.size(v)))
    return out, v, oracle


def _case_probe(pkg, passes):
    checks = _fd_checks(9, bad_last=False)
    v, oracle = pkg.make(checks, evict_after=1)
    with pkg.F.inject(pkg.F.FaultPlan([pkg.F.FaultSpec("mesh.shard.3", "raise")])):
        v.verify_checks_with_verdict(pkg.checks(checks))
    out = [pkg.size(v)]
    v._probe_device = lambda dev_id: passes
    v._shard_ladder.reprobe_after = 1
    for _ in range(2):
        res, verdict = v.verify_checks_with_verdict(pkg.checks(checks))
        out.append((res.tolist(), verdict, pkg.size(v), list(v._shard_device_ids)))
    return out, v, oracle


def _case_out_of_order(pkg, fault):
    checks = _fd_checks(13 if fault else 9, bad_last=fault)
    v, oracle = pkg.make(checks)
    plan = pkg.F.FaultPlan([pkg.F.FaultSpec("mesh.shard.4", "garbage")] if fault else [])
    with pkg.F.inject(plan) as inj:
        h1 = v.verify_checks_begin(pkg.checks(checks))
        h2 = v.verify_checks_begin(pkg.checks(checks))
        out2 = v.verify_checks_finish(h2).tolist()
        out1 = v.verify_checks_finish(h1).tolist()
    return [(out1, out2, inj.total_fired(), v._inflight.depth)], v, oracle


def _case_no_poison(pkg):
    checks = _fd_checks(9, bad_last=False)
    v, oracle = pkg.make(checks)

    def boom(_checks):
        v._verdict_acc = False
        v._dispatched = 3
        v._fixup_failed = True
        raise RuntimeError("mid-verify explosion")

    v.verify_checks = boom
    with pytest.raises(RuntimeError, match="mid-verify explosion"):
        v.verify_checks_with_verdict(pkg.checks(checks))
    del v.verify_checks
    res, verdict = v.verify_checks_with_verdict(pkg.checks(checks))
    return [(res.tolist(), verdict)], v, oracle


CASES = {
    "stub_matches_oracle_and_verdict": _case_clean,
    "single_shard_flip_convicted_by_checksum": _case_flip,
    "straggler_deadline_armed_after_first_dispatch": _case_straggle,
    "device_loss_evicts_rebuilds_and_continues": _case_device_loss,
    "evicted_device_repromoted_after_clean_probe": lambda p: _case_probe(p, True),
    "failed_probe_keeps_device_quarantined": lambda p: _case_probe(p, False),
    "out_of_order_shard_settlement": lambda p: _case_out_of_order(p, False),
    "out_of_order_settlement_with_shard_fault": lambda p: _case_out_of_order(p, True),
    "failed_verify_does_not_poison_next_verdict": _case_no_poison,
}


def _both(case):
    got = {}
    for name in ("ref", "port"):
        pkg = _Pkg(name)
        before = _mesh_samples(pkg.registry)
        record, v, oracle = case(pkg)
        got[name] = (record, _mesh_delta(before, _mesh_samples(pkg.registry)), oracle.tolist())
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_stub_case_equals_the_reference(stub, case):
    got = _both(CASES[case])
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
    assert got["port"][2] == got["ref"][2]
    # Every case answers the oracle, whatever it injected.
    record, delta, oracle = got["port"]
    for row in record:
        if isinstance(row, tuple) and isinstance(row[0], list) and len(row[0]) == len(oracle):
            assert row[0] == oracle


def test_flip_convicts_only_its_shard_and_redispatches_its_lanes(stub):
    got = _both(_case_flip)
    delta = got["port"][1]
    fails = {k: v for k, v in delta.items() if k[0] == "consensus_mesh_shard_failures_total"}
    assert fails == {("consensus_mesh_shard_failures_total",
                      (("device", "2"), ("reason", "checksum"))): 1}
    # 14 lanes over 8 shards of 4 rows: 3 real lanes on shard 2.
    assert delta[("consensus_mesh_redispatch_lanes_total", (("level", "mesh"),))] == 3


@pytest.mark.parametrize("seed", range(3))
def test_chaos_soak_equals_the_reference(stub, seed):
    """Every shard-scoped fault class on shards 0, 2 and 7, and a raise at the
    sharded launch: a faulted shard costs a re-dispatch, an eviction or a
    retry, in both packages alike; the verdicts stay the oracle's."""
    kinds = [(f"mesh.shard.{s}", k) for s in (0, 2, 7)
             for k in ("flip", "invert", "garbage", "shape", "raise", "timeout",
                       "device-loss")]
    kinds += [("mesh.dispatch", "raise")]
    checks = _fd_checks(13)
    for site, kind in kinds:
        got = {}
        for name in ("ref", "port"):
            pkg = _Pkg(name)
            before = _mesh_samples(pkg.registry)
            v, oracle = pkg.make(checks)
            plan = pkg.F.FaultPlan([pkg.F.FaultSpec(site, kind)])
            with pkg.F.inject(plan, seed=seed) as inj:
                res, verdict = v.verify_checks_with_verdict(pkg.checks(checks))
            got[name] = (res.tolist(), verdict, inj.total_fired(), pkg.size(v),
                         _mesh_delta(before, _mesh_samples(pkg.registry)))
            assert res.tolist() == oracle.tolist() and not verdict, (site, kind, name)
            assert inj.total_fired() >= 1, (site, kind, name)
        assert got["port"] == got["ref"], (site, kind, seed)


# -- the divergences, on the port alone -------------------------------------------------------


def _port_delta(fn):
    before = _mesh_samples(t_registry)
    out = fn()
    return out, _mesh_delta(before, _mesh_samples(t_registry))


def test_a_shard_that_fails_again_answers_on_the_device_rung(stub):
    """Where the reference answers the lanes of a shard that fails again on
    its `xla` rung, the port answers them in one launch of the base kernel:
    the `device` label."""
    checks = _fd_checks(13)
    v, oracle = _port_stub(_port_checks(checks))
    plan = F.FaultPlan([F.FaultSpec("mesh.shard.2", "flip", count=2)])
    with F.inject(plan) as inj:
        (res, verdict), delta = _port_delta(
            lambda: v.verify_checks_with_verdict(_port_checks(checks)))
    assert inj.total_fired() == 2 and np.array_equal(res, oracle) and not verdict
    assert delta[("consensus_mesh_redispatch_lanes_total", (("level", "device"),))] == 3
    assert ("consensus_mesh_redispatch_lanes_total", (("level", "mesh"),)) not in delta


def test_every_shard_failing_raises_dispatch_failed_and_evicts_nothing(stub):
    checks = _fd_checks(9, bad_last=False)
    v, _oracle = _port_stub(_port_checks(checks), n_devices=4)
    plan = F.FaultPlan([F.FaultSpec(f"mesh.shard.{s}", "flip", count=64) for s in range(4)])
    with F.inject(plan):
        with pytest.raises(DispatchFailed) as err:
            v.verify_checks(_port_checks(checks))
    assert isinstance(err.value.__cause__, G.VerdictAnomaly)
    assert err.value.__cause__.reason == "all-shards"
    assert v.stats["retries"] == 3 and v.mesh.size == 4 and v.in_flight == 0
    # The next call is clean: nothing stale in the accounting or the queue.
    res, verdict = v.verify_checks_with_verdict(_port_checks(checks))
    assert res.all() and verdict


def test_stale_layout_relaunches_on_the_single_device_rung(stub):
    """A ticket launched before an eviction and retried after it no longer
    lines up with the shards: it relaunches on the single-device rung and
    settles under the flat sentinels and the global checksum."""
    checks = _fd_checks(13)
    v, oracle = _port_stub(_port_checks(checks), n_devices=4, evict_after=1)
    h1 = v.verify_checks_begin(_port_checks(checks))
    with F.inject(F.FaultPlan([F.FaultSpec("mesh.shard.1", "device-loss")])):
        h2 = v.verify_checks_begin(_port_checks(checks))
        assert np.array_equal(v.verify_checks_finish(h2), oracle)
    assert v.mesh.size == 3 and v._mesh_epoch == 1
    torch_before = TB._DISPATCH_TOTAL.value(backend="torch")
    plan = F.FaultPlan([F.FaultSpec(f"mesh.shard.{s}", "flip") for s in range(4)])
    with F.inject(plan):
        assert np.array_equal(v.verify_checks_finish(h1), oracle)
    assert v.stats["retries"] == 1
    assert TB._DISPATCH_TOTAL.value(backend="torch") == torch_before + 1


def test_one_entry_mesh_dispatches_as_the_base_verifier(stub):
    checks = _fd_checks(13)
    v, oracle = _port_stub(_port_checks(checks), n_devices=1)
    res, verdict = v.verify_checks_with_verdict(_port_checks(checks))
    assert np.array_equal(res, oracle) and not verdict
    assert not v.stats["mesh_dispatches"] and not v.stats["mesh_unsharded"]
    assert v.lane_capacity == v.chunk - 1 and v.pad(7) == TorchSecpVerifier(device="cpu").pad(7)


# -- the real plain kernels on a CPU mesh -------------------------------------------------------


def _real_checks():
    """ECDSA, Schnorr and tweak checks, a bad signature, a lane the host
    rejects before dispatch, and the crafted collision lane the kernel
    defers to the host."""
    out = []
    for i in range(12):
        sk = (i * 2654435761 + 99) % (JH.N - 1) + 1
        msg = hashlib.sha256(b"mesh-real-%d" % i).digest()
        if i % 3 == 0:
            out.append(SigCheck("ecdsa", (B.pubkey_create(sk), B.sign_ecdsa(sk, msg), msg)))
        elif i % 3 == 1:
            xpk, _ = B.xonly_pubkey_create(sk)
            out.append(SigCheck("schnorr", (xpk, B.sign_schnorr(sk, msg), msg)))
        else:
            xpk, par = B.xonly_pubkey_create(sk)
            eff = sk if par == 0 else JH.N - sk
            t = int.from_bytes(msg, "big") % (JH.N - 1) + 1
            q, q_par = B.xonly_pubkey_create((eff + t) % JH.N)
            out.append(SigCheck("tweak", (q, q_par, xpk, t.to_bytes(32, "big"))))
    pk, sig, msg = out[0].data
    out.append(SigCheck("ecdsa", (pk, sig, hashlib.sha256(b"other").digest())))
    out.append(SigCheck("ecdsa", (pk, b"\x30\x02", msg)))  # no DER: rejected on the host
    qx, qy = B._g_mul(2)
    out.append(SigCheck("tweak", (qx.to_bytes(32, "big"), qy & 1,
                                  JH.G_X.to_bytes(32, "big"), (1).to_bytes(32, "big"))))
    return out


def test_real_plain_kernels_on_a_cpu_mesh_equal_the_single_device_and_the_oracle(
        monkeypatch):
    """Each of the 4 shards runs the plain verify kernel on its own rows;
    the single-device verifier then reads the same rows' answers from a
    per-row record of those runs (its own rows are the mesh's, sentinels
    included), so the file stays cheap."""
    checks = _real_checks()
    fns = {"ecdsa": JH.verify_ecdsa, "schnorr": JH.verify_schnorr,
           "tweak": JH.xonly_tweak_add_check}
    oracle = [fns[c.kind](*c.data) for c in checks]
    plain = PlainRows()
    monkeypatch.setattr(TB, "verify_tiles_checked", checked(plain))
    monkeypatch.setattr(M, "verify_tiles_checked", checked(plain))
    v = M.ShardedSecpVerifier(mesh=M.make_mesh(devices=["cpu"] * 4))
    res, verdict = v.verify_checks_with_verdict(checks)
    runs = plain.runs
    single = TorchSecpVerifier(device="cpu").verify_checks(checks)
    assert runs == 4 and plain.runs == 4  # a run a shard, none for the single device
    assert res.tolist() == single.tolist() == oracle
    assert not verdict and v.stats["mesh_dispatches"] == 1 and v.stats["fixups"] == 1
    assert sum(v.last_shard_lanes) == len(checks)


@pytest.fixture
def memo(monkeypatch):
    plain = PlainRows()
    monkeypatch.setattr(TB, "verify_tiles_checked", checked(plain))
    monkeypatch.setattr(M, "verify_tiles_checked", checked(plain))
    return plain


def test_entry_points_through_the_mesh_equal_the_single_device(memo):
    """`verify_batch` (index mode), `verify_batch_stream` and `connect_block`
    with a 4-entry CPU mesh as the verifier: the single-device verifier's
    results, item for item (the plain version shared through a per-row
    memo, run first by the single-device verifier)."""
    items, bad = B.mixed_items(16, seed=13, corrupt_rate=0.2)
    assert any(bad)
    one = TorchSecpVerifier(device="cpu")
    mesh = M.ShardedSecpVerifier(mesh=M.make_mesh(devices=["cpu"] * 4))

    def batch(v):
        return [(r.ok, r.error, r.script_error) for r in verify_batch(
            items, verifier=v, sig_cache=SigCache(), script_cache=ScriptExecutionCache())]

    def stream(v):
        return [[(r.ok, r.error, r.script_error) for r in out]
                for out in verify_batch_stream(iter([items[:9], items[9:]]), verifier=v,
                                               sig_cache=SigCache(),
                                               script_cache=ScriptExecutionCache(),
                                               depth=2)]

    coins, funded = B.make_funded_view(8, seed="mesh-block")
    block = B.build_block([B.build_spend_tx(funded[:4]), B.build_spend_tx(funded[4:])],
                          710_000, fees=2000)
    entries = [(t, n, c.out.value, c.height, c.coinbase, c.out.script_pubkey)
               for (t, n), c in coins._map.items()]

    def block_run(v):
        view = NativeCoinsView()
        view.add_coins_batch(entries)
        r = connect_block(block, view, 710_000, verifier=v,
                          pow_limit=B.REGTEST_POW_LIMIT, sig_cache=SigCache(),
                          script_cache=ScriptExecutionCache())
        return (r.ok, r.reason, None if r.input_results is None
                else [(x.ok, x.error) for x in r.input_results])

    want = (batch(one), stream(one), block_run(one))
    got = (batch(mesh), stream(mesh), block_run(mesh))
    assert got == want and want[2][0]
    assert mesh.stats["mesh_dispatches"] >= 3 and not mesh.stats["mesh_unsharded"]


# -- slow: the JAX sharded step against the port's, output for output --------------------------


def _compare_steps() -> None:
    """Run in a fresh process: one batch laid out by the reference's
    `_build_layout` on its forced 8-device CPU mesh, through the JAX
    `make_sharded_step` (XLA kernel) and the port's step on an 8-entry CPU
    mesh; every output equal. The crafted collision lane is left out: the
    XLA kernel's complete adds answer it, where the port's kernel (as the
    reference's Pallas kernel) defers it to the host."""
    from bitcoinconsensus_tpu.crypto.jax_backend import SigCheck as JSigCheck

    checks = _real_checks()[:-1]
    jv = JM.ShardedSecpVerifier(mesh=JM.make_mesh(8), min_batch=8)
    n = len(checks)
    args = jv._pack_lanes(jv._prep_lanes([JSigCheck(c.kind, c.data) for c in checks]))
    args = tuple(np.array(a) for a in args)
    layout = jv._build_layout(args, n)
    live = np.zeros(layout.padded, dtype=bool)
    live[layout.positions] = True
    step = JM.make_sharded_step(jv.mesh, use_pallas=False)
    want = [np.asarray(x) for x in step(*args, live)]
    port_step = M.make_sharded_step(M.make_mesh(devices=["cpu"] * 8))
    got = port_step(*(torch.from_numpy(a.copy()) for a in args), torch.from_numpy(live))
    got = got.settle()
    names = ("per_lane", "needs_host", "all_ok", "counts", "wsums")
    for name, g, w in zip(names, got, want, strict=True):
        assert np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64)), name
    print("steps equal:", {k: np.asarray(w).tolist() for k, w in zip(names[2:], want[2:])})


@pytest.mark.slow
def test_jax_sharded_step_equals_the_port_step_in_a_fresh_process():
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "compare-steps"],
                          capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    assert "steps equal" in proc.stdout


if __name__ == "__main__" and sys.argv[1:] == ["compare-steps"]:
    _compare_steps()
