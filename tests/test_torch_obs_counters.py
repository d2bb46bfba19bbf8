"""The port's counters against the JAX package's recorders, on the same
seeded inputs; and the caches' public methods (`contains`/`add`,
`contains_check`/`add_check`, `contains_input`/`add_input`) and
`native_bridge.available()`, held to the reference's.

About 40 inputs of the port's `blockgen.mixed_items` (a few corrupted) and
three transport failures go through the port's `verify_batch` in index
mode, through the wire driver and on the Python engine, each with caches of
its own label and the port's CPU verifier, cold and then warm (a replay
with the same caches). The reference's own `verify_batch` runs the same
inputs with the same verifier and salts, in index mode and in the wire
driver. Each run's counter deltas are read from its package's registry.

Input-determined, so equal across the packages: items, the batch-size
histogram, results by outcome, rejections by `Error` and `ScriptError`,
and the caches' lookups, hits, misses and insertions, cold and warm; for
the same driver also the deduplicated checks and the fixpoint rounds; and
verify calls by entry for the per-input api.

Allowed to differ, and not compared:
- `consensus_dispatch_total{backend}`, `_lanes_total`,
  `_padded_lanes_total`, `_fill_ratio`, `_new_shapes_total` and
  `consensus_checks_total`: the reference's driver here runs the port's
  verifier, which counts in the port's registry (backend `torch` on the
  CPU, `cuda` on the card; the reference's labels are its XLA backends),
  and the padded widths are the verifier's;
- `consensus_uniq_checks_total` and `consensus_fixpoint_rounds` between
  drivers: index mode dispatches the native core's speculative
  CHECKMULTISIG pairings, which the Python engine never records, and the
  drivers count rounds each their own way;
- timings (`consensus_span_duration_seconds`, the phase histograms).
"""

import os
import threading

import pytest
import torch

from bitcoinconsensus_tpu import api as JAPI
from bitcoinconsensus_tpu import native_bridge as JNB
from bitcoinconsensus_tpu.models import batch as JBATCH
from bitcoinconsensus_tpu.models import sigcache as JSC
from bitcoinconsensus_tpu.obs import get_registry as j_registry
from bitcoinconsensus_tpu_torch import api as TAPI
from bitcoinconsensus_tpu_torch import native_bridge as TNB
from bitcoinconsensus_tpu_torch.core.flags import VERIFY_TAPROOT
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models import batch as TBATCH
from bitcoinconsensus_tpu_torch.models import sigcache as TSC
from bitcoinconsensus_tpu_torch.obs import get_registry as t_registry
from bitcoinconsensus_tpu_torch.utils import blockgen as B

torch.set_num_threads(1)

SALT = bytes(range(32))
INPUT_COUNTERS = ("consensus_batch_items_total", "consensus_batch_size",
                  "consensus_batch_results_total", "consensus_verify_reject_total",
                  "consensus_script_reject_total")
CACHE_COUNTERS = ("lookups", "hits", "misses", "insertions")
DRIVER_COUNTERS = ("consensus_uniq_checks_total", "consensus_fixpoint_rounds")


def _items():
    items, bad = B.mixed_items(40, seed=29, corrupt_rate=0.12)
    assert any(bad) and not all(bad)
    good = items[0]
    items.append(TBATCH.BatchItem(good.spending_tx, 99, good.flags,
                                  spent_outputs=good.spent_outputs))  # ERR_TX_INDEX
    items.append(TBATCH.BatchItem(b"\x01junk", 0, good.flags,
                                  spent_outputs=good.spent_outputs))  # ERR_TX_DESERIALIZE
    spk = good.spent_outputs[good.input_index][1]
    items.append(TBATCH.BatchItem(good.spending_tx, 0, VERIFY_TAPROOT,
                                  spent_output_script=spk, amount=1))  # ERR_INVALID_FLAGS
    return items


ITEMS = _items()


def _samples(snap, name):
    """{label tuple: value} of one metric (a histogram as (count, sum))."""
    m = snap.get(name)
    if m is None:
        return {}
    out = {}
    for s in m["samples"]:
        key = tuple(sorted(s["labels"].items()))
        out[key] = (s["count"], s["sum"]) if m["kind"] == "histogram" else s["value"]
    return out


def _delta(before, after, name, only=None):
    b, a = _samples(before, name), _samples(after, name)
    out = {}
    for key, v in a.items():
        if only is not None and dict(key).get("cache") != only:
            continue
        old = b.get(key, (0, 0) if isinstance(v, tuple) else 0)
        d = tuple(x - y for x, y in zip(v, old)) if isinstance(v, tuple) else v - old
        if d not in (0, (0, 0)) and d != (0, 0.0):
            out[key] = d
    return out


def _norm(results):
    return [(r.ok, int(r.error), None if r.script_error is None else int(r.script_error))
            for r in results]


def _run(pkg, driver, monkeypatch):
    """Cold then warm `verify_batch` of `pkg` over ITEMS in `driver` ("index",
    "wire" or "python"): (verdicts, cold deltas, warm deltas)."""
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_IDX", "0" if driver == "wire" else "1")
    engine = "python" if driver == "python" else "native"
    v = TorchSecpVerifier(device="cpu", engine=engine)
    label = f"cnt-{driver}"
    if pkg == "port":
        reg, mod, items = t_registry, TBATCH, ITEMS
        sig = TSC.SigCache(cache_label=label + "-sig")
        script = TSC.ScriptExecutionCache(cache_label=label + "-script")
        kw = {"engine": engine}
    else:
        reg, mod, kw = j_registry, JBATCH, {}
        items = [JBATCH.BatchItem(**vars(it)) for it in ITEMS]
        sig = JSC.SigCache(cache_label=label + "-sig")
        script = JSC.ScriptExecutionCache(cache_label=label + "-script")
    sig._salt = script._salt = SALT
    snaps = [reg().snapshot()]
    verdicts = []
    for _pass in ("cold", "warm"):
        verdicts.append(_norm(mod.verify_batch(items, verifier=v, sig_cache=sig,
                                               script_cache=script, **kw)))
        snaps.append(reg().snapshot())
    assert verdicts[0] == verdicts[1]
    deltas = []
    for before, after in zip(snaps, snaps[1:]):
        d = {name: _delta(before, after, name) for name in INPUT_COUNTERS + DRIVER_COUNTERS}
        for c in CACHE_COUNTERS:
            for role in ("sig", "script"):
                d[f"{c}/{role}"] = sum(_delta(
                    before, after, f"consensus_cache_{c}_total",
                    only=f"{label}-{role}").values())
        deltas.append(d)
    return verdicts[0], deltas


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for pkg, driver in (("port", "index"), ("ref", "index"), ("port", "wire"),
                            ("ref", "wire"), ("port", "python")):
            out[(pkg, driver)] = _run(pkg, driver, mp)
    finally:
        mp.undo()
    return out


def _want():
    out = []
    for it in ITEMS:
        try:
            if it.spent_outputs is not None and it.flags != VERIFY_TAPROOT:
                JAPI.verify_with_spent_outputs(it.spending_tx, it.input_index,
                                               it.spent_outputs, it.flags)
            else:
                JAPI.verify_with_flags(it.spent_output_script, it.amount,
                                       it.spending_tx, it.input_index, it.flags)
        except JAPI.ConsensusError as e:
            out.append((False, int(e.code),
                        None if e.script_error is None else int(e.script_error)))
            continue
        out.append((True, 0, 0))
    return out


@pytest.mark.parametrize("driver", ["index", "wire", "python"])
def test_verdicts_equal_the_reference_api(runs, driver):
    want = _want()
    assert runs[("port", driver)][0] == want
    assert sum(not w[0] for w in want) >= 4  # corrupted and transport failures


@pytest.mark.parametrize("phase", [0, 1], ids=["cold", "warm"])
@pytest.mark.parametrize("driver", ["index", "wire", "python"])
def test_input_determined_counters_equal_the_reference(runs, driver, phase):
    ref_driver = "wire" if driver == "python" else driver
    port = runs[("port", driver)][1][phase]
    ref = runs[("ref", ref_driver)][1][phase]
    keys = list(INPUT_COUNTERS) + [f"{c}/{r}" for c in CACHE_COUNTERS
                                   for r in ("sig", "script")]
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    items = port["consensus_batch_items_total"][()]
    assert items == len(ITEMS)
    results = port["consensus_batch_results_total"]
    assert sum(results.values()) == len(ITEMS)


@pytest.mark.parametrize("driver", ["index", "wire"])
def test_driver_counters_equal_the_reference_in_the_same_driver(runs, driver):
    port = runs[("port", driver)][1]
    ref = runs[("ref", driver)][1]
    for phase in (0, 1):
        assert {k: port[phase][k] for k in DRIVER_COUNTERS} == \
            {k: ref[phase][k] for k in DRIVER_COUNTERS}
    assert port[0]["consensus_uniq_checks_total"]  # the cold run dispatched


def test_warm_replay_hits_the_script_cache_for_every_success(runs):
    cold, warm = runs[("port", "index")][1]
    n_ok = sum(w[0] for w in _want())
    assert warm["hits/script"] == n_ok and warm["insertions/script"] == 0
    assert cold["insertions/script"] == n_ok and cold["hits/script"] == 0
    # A cold sig cache is not probed (every probe would miss); warm, only
    # the rejected inputs are interpreted again and probe it.
    assert cold["lookups/sig"] == 0 < warm["lookups/sig"]


def test_verify_calls_by_entry_equal_the_reference():
    """The per-input api over the same inputs: calls by entry, rejections by
    code and by ScriptError, equal in both registries."""
    names = ("consensus_verify_calls_total", "consensus_verify_reject_total",
             "consensus_script_reject_total")
    deltas = {}
    for name, api, reg in (("port", TAPI, t_registry), ("ref", JAPI, j_registry)):
        before = reg().snapshot()
        for it in ITEMS[:12] + ITEMS[-3:]:
            try:
                if it.spent_outputs is not None and it.flags != VERIFY_TAPROOT:
                    api.verify_with_spent_outputs(it.spending_tx, it.input_index,
                                                  it.spent_outputs, it.flags)
                elif it.flags == VERIFY_TAPROOT:
                    api.verify_with_flags(it.spent_output_script, it.amount,
                                          it.spending_tx, it.input_index, it.flags)
                api.verify(b"\x51", 0, it.spending_tx, it.input_index)
            except api.ConsensusError:
                pass
        after = reg().snapshot()
        deltas[name] = {n: _delta(before, after, n) for n in names}
    assert deltas["port"] == deltas["ref"]
    assert deltas["port"]["consensus_verify_calls_total"]


# -- the caches' public methods (tests/test_sigcache.py:97-190) -----------------------


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_add_check_returns_none_and_contains_check_then_true(pkg):
    mod = TSC if pkg == "port" else JSC
    c = mod.SigCache()
    assert c.add_check("ecdsa", (b"pk", b"sig", b"m")) is None
    assert c.contains_check("ecdsa", (b"pk", b"sig", b"m"))
    assert not c.contains_check("ecdsa", (b"pk", b"sig", b"m2"))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_lru_bound(pkg):
    mod = TSC if pkg == "port" else JSC
    sig = mod.SigCache(max_entries=4)
    for i in range(10):
        sig.add_check("ecdsa", (b"pk%d" % i, b"sig", b"m"))
    assert len(sig) == 4
    assert sig.contains_check("ecdsa", (b"pk9", b"sig", b"m"))
    assert not sig.contains_check("ecdsa", (b"pk0", b"sig", b"m"))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_registry_metrics_mirror_cache_counters(pkg):
    mod, reg = (TSC, t_registry) if pkg == "port" else (JSC, j_registry)
    label = "invtest-" + os.urandom(4).hex()

    def m(name):
        return reg().get(f"consensus_cache_{name}").value(cache=label)

    sig = mod.SigCache(max_entries=4, cache_label=label)
    for i in range(10):
        sig.add_check("ecdsa", (b"pk%d" % i, b"sig", b"m"))
    assert m("insertions_total") == sig.insertions == 10
    assert m("evictions_total") == sig.evictions == 6
    assert m("entries") == len(sig) == 4
    for i in range(10):
        assert sig.contains_check("ecdsa", (b"pk%d" % i, b"sig", b"m")) == (i >= 6)
    assert m("lookups_total") == 10
    assert m("hits_total") == sig.hits == 4 and m("misses_total") == sig.misses == 6
    assert sig.contains_check("ecdsa", (b"pk9", b"sig", b"m"), erase=True)
    assert not sig.contains_check("ecdsa", (b"pk9", b"sig", b"m"))
    assert m("erases_total") == sig.erases == 1 and m("entries") == len(sig) == 3
    assert m("insertions_total") - m("evictions_total") - m("erases_total") == len(sig)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_concurrent_hammer_preserves_accounting_invariant(pkg):
    mod = TSC if pkg == "port" else JSC
    sig = mod.SigCache(max_entries=64, cache_label=f"hammer-{pkg}")
    n_threads, n_ops = 8, 300
    barrier = threading.Barrier(n_threads)
    errors = []

    def worker(tid):
        try:
            barrier.wait()
            for i in range(n_ops):
                data = (b"pk%d" % (i % 97), b"sig%d" % (tid % 3), b"m")
                op = (tid + i) % 4
                if op == 0:
                    sig.add_check("ecdsa", data)
                elif op == 1:
                    sig.contains_check("ecdsa", data, erase=True)
                elif op == 2:
                    sig.contains_check("ecdsa", data)
                else:
                    sig.discard_key(sig._key(sig._parts("ecdsa", data)))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sig.insertions - sig.evictions - sig.erases == len(sig) <= 64
    sig.add_check("ecdsa", (b"post", b"hammer", b"m"))
    assert sig.contains_check("ecdsa", (b"post", b"hammer", b"m"))
    assert sig.insertions - sig.evictions - sig.erases == len(sig)


def test_public_methods_give_the_reference_keys_and_counts():
    """The same sequence of `add`/`contains`, `add_check`/`contains_check`
    and `add_input`/`contains_input` on both packages' caches, salts pinned
    equal: the same answers, entries, counts and keys."""
    out = {}
    wtxid, digest = b"\x11" * 32, TSC.ScriptExecutionCache.spent_digest([(5, b"\x51")])
    assert digest == JSC.ScriptExecutionCache.spent_digest([(5, b"\x51")])
    for name, mod in (("port", TSC), ("ref", JSC)):
        sig = mod.SigCache(max_entries=3, cache_label=f"pub-{name}")
        script = mod.ScriptExecutionCache(cache_label=f"pub-s-{name}")
        sig._salt = script._salt = SALT
        seq = []
        for i in range(5):
            sig.add_check("schnorr", (b"k%d" % i, b"s", b"m"))
            sig.add((b"raw", b"%d" % i))
        seq += [sig.contains_check("schnorr", (b"k%d" % i, b"s", b"m")) for i in range(5)]
        seq += [sig.contains((b"raw", b"%d" % i), erase=(i == 4)) for i in range(5)]
        script.add_input(wtxid, 0, 7, digest)
        seq += [script.contains_input(wtxid, 0, 7, digest),
                script.contains_input(wtxid, 1, 7, digest)]
        out[name] = (seq, sorted(sig._set), sorted(script._set), sig.hits, sig.misses,
                     sig.insertions, sig.evictions, sig.erases, script.hits)
    assert out["port"] == out["ref"]
    assert out["port"][0][-2:] == [True, False]


def test_native_bridge_available_matches_the_reference():
    assert "available" in TNB.__all__ and "available" in JNB.__all__
    assert TNB.available() is True and TNB.available() == JNB.available()


# -- the stats gate on the CPU ---------------------------------------------------------


class _PlainRows:
    """The plain version of the verify kernel, memoised per packed lane: the
    stats workload dispatches the same few checks many times, and each
    plain run costs seconds on the CPU. Results are the plain version's."""

    def __init__(self):
        self.memo = {}

    def __call__(self, *args):
        from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

        arrs = [a.numpy() for a in args]
        keys = [b"".join(a[i].tobytes() for a in arrs) for i in range(len(arrs[0]))]
        todo = {}
        for i, k in enumerate(keys):
            if k not in self.memo and k not in todo:
                todo[k] = i
        if todo:
            idx = torch.tensor(list(todo.values()))
            ok, needs = VT.verify_tiles(*(a[idx].contiguous() for a in args))
            for j, k in enumerate(todo):
                self.memo[k] = (bool(ok[j]), bool(needs[j]))
        got = [self.memo[k] for k in keys]
        return (torch.tensor([g[0] for g in got], dtype=torch.bool),
                torch.tensor([g[1] for g in got], dtype=torch.bool))


def test_stats_gate_passes_on_the_cpu(monkeypatch, capsys):
    """`obs.stats --check --device cpu`: the workload through every ported
    layer lights every required metric but the device-truth group, which
    needs the card."""
    from bitcoinconsensus_tpu_torch.crypto import torch_backend as TB
    from bitcoinconsensus_tpu_torch.obs import stats
    from bitcoinconsensus_tpu_torch.parallel import mesh as TM

    from torch_serving_common import checked

    plain = _PlainRows()
    monkeypatch.setattr(TB, "verify_tiles_checked", checked(plain))
    monkeypatch.setattr(TM, "verify_tiles_checked", checked(plain))
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_FLIGHT_DIR",
                       os.path.join(os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))), "build", "flight"))
    assert stats.main(["--check", "--device", "cpu", "--format", "prom"]) == 0
    err = capsys.readouterr().err
    assert "0 problems" in err
    cpu, cuda = stats.required_metrics("cpu"), stats.required_metrics("cuda")
    assert set(cuda) - set(cpu) == set(stats.REQUIRED_METRICS["device-truth"])
    assert "consensus_resilience_level" not in cuda
    assert set(stats.REQUIRED_METRICS["mesh"]) <= set(cpu)
    for group, prefix in (("serving", "consensus_serving_"),
                          ("ingress", "consensus_ingress_"),
                          ("sigstore", "consensus_sigstore_"),
                          ("cell", "consensus_cell_")):
        names = stats.REQUIRED_METRICS[group]
        assert names and all(n.startswith(prefix) for n in names)
        assert set(names) <= set(cpu)
    gauntlet = stats.REQUIRED_METRICS["gauntlet"]
    assert len(gauntlet) == 5 and set(gauntlet) <= set(cpu)
    assert all(n.startswith("consensus_gauntlet_") for n in gauntlet)


# -- which of the reference's resilience metrics the port registers -------------------

# Registered: they mean something without a host rung.
PORTED_RESILIENCE = (
    "consensus_resilience_guard_anomalies_total",
    "consensus_resilience_sentinel_lanes_total",
    "consensus_resilience_sentinel_skipped_total",
    "consensus_resilience_cache_poison_caught_total",
    "consensus_resilience_writable_copies_total",
    "consensus_resilience_faults_injected_total",
    "consensus_resilience_retries_total",
)
# Not registered: the port has no degradation ladder and no host rung (the
# deliberate divergences of the port), so each would stay empty for good.
NOT_PORTED_RESILIENCE = (
    "consensus_resilience_level",  # the ladder's current level
    "consensus_resilience_demotions_total",  # ladder demotions
    "consensus_resilience_repromotions_total",  # ladder re-promotions
    "consensus_resilience_probes_total",  # re-promotion probes
    "consensus_resilience_host_exact_lanes_total",  # lanes demoted to the host
    "consensus_resilience_contained_total",  # faults contained on the host
)


def test_resilience_metrics_registered_as_the_port_needs():
    import bitcoinconsensus_tpu_torch.resilience  # noqa: F401 (registers)
    from bitcoinconsensus_tpu.resilience import degrade as _jd  # noqa: F401

    port, ref = t_registry(), j_registry()
    for name in PORTED_RESILIENCE:
        p, r = port.get(name), ref.get(name)
        assert p is not None and r is not None, name
        assert (p.kind, p.labelnames) == (r.kind, r.labelnames), name
    for name in NOT_PORTED_RESILIENCE:
        assert ref.get(name) is not None, name
        assert port.get(name) is None, name


def _reference_required():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "consensus_stats.py")
    spec = importlib.util.spec_from_file_location("_ref_consensus_stats", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REQUIRED_METRICS


def test_stats_gate_requires_the_reference_metrics_of_the_ported_layers():
    """Every name of the reference's `REQUIRED_METRICS` is required by the
    port's gate, the gauntlet's among them, but the ladder's gauge; and every metric both registries hold has the same kind and
    label names."""
    from bitcoinconsensus_tpu_torch.obs import stats
    import bitcoinconsensus_tpu_torch.models.validate  # noqa: F401 (registers)
    import bitcoinconsensus_tpu.models.validate  # noqa: F401
    import bitcoinconsensus_tpu_torch.cell.replica  # noqa: F401 (registers)
    import bitcoinconsensus_tpu_torch.cell.router  # noqa: F401
    import bitcoinconsensus_tpu_torch.models.sigstore  # noqa: F401
    import bitcoinconsensus_tpu_torch.serving  # noqa: F401
    import bitcoinconsensus_tpu.cell.replica  # noqa: F401
    import bitcoinconsensus_tpu.cell.router  # noqa: F401
    import bitcoinconsensus_tpu.models.sigstore  # noqa: F401
    import bitcoinconsensus_tpu.serving  # noqa: F401

    import bitcoinconsensus_tpu_torch.workloads  # noqa: F401 (registers)
    import bitcoinconsensus_tpu.workloads  # noqa: F401

    ref = [n for n in _reference_required() if n != "consensus_resilience_level"]
    assert set(ref) <= set(stats.required_metrics("cuda"))
    port, jref = t_registry(), j_registry()
    shared = set(port.names()) & set(jref.names())
    # Each is registered at import but the certificates' counter, which (as
    # in the reference) registers at the first certificate.
    assert set(stats.required_metrics("cuda")) - {"consensus_scalar_certificates"} <= \
        set(port.names())
    for name in shared:
        p, r = port.get(name), jref.get(name)
        assert (p.kind, p.labelnames) == (r.kind, r.labelnames), name
