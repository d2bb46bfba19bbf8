"""Package rules of the port: it imports neither jax nor the JAX package,
runs with jax unavailable, its entry points default to the card, and it
exports the reference's public surface (held to the JAX package's here)."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import bitcoinconsensus_tpu
import bitcoinconsensus_tpu_torch
from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bitcoinconsensus_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "bitcoinconsensus_tpu"}


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_imports(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_walk_covers_the_block_and_index_mode_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("models/validate.py", "models/batch.py", "core/block.py",
                "core/tx_check.py", "utils/profiling.py", "utils/blockgen.py",
                "native_bridge.py", "crypto/torch_backend.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel


def test_walk_covers_the_surface_and_analysis_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("api.py", "crypto/recovery.py", "crypto/bip32.py",
                "analysis/scalar_check.py", "analysis/host_lint.py",
                "analysis/registry.py", "analysis/lint.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel


def test_walk_covers_the_resilience_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("resilience/__init__.py", "resilience/faults.py",
                "resilience/guards.py", "resilience/degrade.py",
                "resilience/inflight.py", "ops/verdict_checksum.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel


def test_walk_covers_the_obs_modules_and_regions():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("obs/__init__.py", "obs/metrics.py", "obs/spans.py",
                "obs/exposition.py", "obs/perf.py", "obs/flight.py",
                "obs/xprof.py", "obs/stats.py", "ops/regions.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel


def test_walk_covers_the_parallel_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("parallel/__init__.py", "parallel/mesh.py", "ops/shard_step.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel
    assert "parallel" in bitcoinconsensus_tpu_torch.__all__


def test_walk_covers_the_serving_cell_and_sigstore_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("serving/__init__.py", "serving/queue.py", "serving/shedding.py",
                "serving/server.py", "serving/ingress.py", "serving/client.py",
                "cell/__init__.py", "cell/hashring.py", "cell/sigtier.py",
                "cell/router.py", "cell/replica.py", "cell/cell.py",
                "models/sigstore.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel


def test_walk_covers_the_workloads_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for mod in ("workloads/__init__.py", "workloads/__main__.py",
                "workloads/corpus.py", "workloads/diff_fuzz.py",
                "workloads/replay.py", "utils/refbridge.py", "utils/script_asm.py"):
        assert os.path.join("bitcoinconsensus_tpu_torch", mod) in rel


def test_workloads_export_the_reference_names():
    from bitcoinconsensus_tpu import workloads as ref
    from bitcoinconsensus_tpu_torch import workloads as port

    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_workloads_import_with_jax_unavailable():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.path.insert(0, {REPO!r})
        from bitcoinconsensus_tpu_torch import workloads
        from bitcoinconsensus_tpu_torch.workloads import __main__ as cli
        from bitcoinconsensus_tpu_torch.workloads import corpus, diff_fuzz, replay
        from bitcoinconsensus_tpu_torch.utils import refbridge, script_asm
        assert len(corpus.build_corpus()) == 26
        assert script_asm.parse_asm("1 DUP") == bytes([0x51, 0x76])
        assert len(cli.ci_fuzz_seeds()) == 5
        assert not any(m == "bitcoinconsensus_tpu" or m.startswith("bitcoinconsensus_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_serving_and_cell_export_the_reference_names():
    from bitcoinconsensus_tpu import cell as ref_cell
    from bitcoinconsensus_tpu import serving as ref_serving
    from bitcoinconsensus_tpu_torch import cell, serving

    assert set(serving.__all__) == set(ref_serving.__all__)
    assert set(cell.__all__) == set(ref_cell.__all__)
    for mod in (serving, cell):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name
    assert int(bitcoinconsensus_tpu_torch.Error.ERR_OVERLOADED) == \
        int(bitcoinconsensus_tpu.Error.ERR_OVERLOADED) == 7


def test_serving_and_cell_import_with_jax_unavailable():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.path.insert(0, {REPO!r})
        from bitcoinconsensus_tpu_torch import cell, serving
        from bitcoinconsensus_tpu_torch.cell import ServingCell, StubReplica
        from bitcoinconsensus_tpu_torch.models.sigstore import PersistentSigCache
        from bitcoinconsensus_tpu_torch.serving import ingress
        assert cell.HashRing(["a", "b"]).lookup("t") in ("a", "b")
        assert ingress.decode_header(ingress.encode_frame(1, b"xy")[:5]) == (1, 2)
        assert not any(m == "bitcoinconsensus_tpu" or m.startswith("bitcoinconsensus_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_obs_exports_the_reference_names():
    from bitcoinconsensus_tpu import obs as ref
    from bitcoinconsensus_tpu_torch import obs as port

    assert set(port.__all__) == set(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_obs_and_regions_import_with_jax_unavailable():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.path.insert(0, {REPO!r})
        from bitcoinconsensus_tpu_torch import obs
        from bitcoinconsensus_tpu_torch.obs import exposition, flight, perf, stats, xprof
        from bitcoinconsensus_tpu_torch.ops import regions
        with obs.span("no-jax"):
            obs.counter("no_jax_total").inc()
        snap = obs.get_registry().snapshot()
        assert snap["no_jax_total"]["samples"][0]["value"] == 1
        assert exposition.to_prometheus_text(snap)
        assert regions.KERNEL_REGIONS["vt_verify_kernel"] == "verify_tiles"
        assert perf.provenance()["torch"]
        assert not any(m == "bitcoinconsensus_tpu" or m.startswith("bitcoinconsensus_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_resilience_exports_the_reference_names_but_the_ladder():
    from bitcoinconsensus_tpu import resilience as ref

    port = bitcoinconsensus_tpu_torch.resilience
    assert "resilience" in bitcoinconsensus_tpu_torch.__all__
    assert set(port.__all__) - {"DispatchFailed"} == set(ref.__all__) - {"Ladder"}
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert not hasattr(port, "Ladder")


def test_all_covers_the_reference_surface():
    missing = set(bitcoinconsensus_tpu.__all__) - set(bitcoinconsensus_tpu_torch.__all__)
    assert not missing, missing
    for name in bitcoinconsensus_tpu_torch.__all__:
        assert hasattr(bitcoinconsensus_tpu_torch, name), name


def test_version_and_flag_constants_equal_the_reference():
    port, ref = bitcoinconsensus_tpu_torch, bitcoinconsensus_tpu
    assert port.version() == ref.version() == 1
    assert port.api.API_VERSION == ref.api.API_VERSION
    assert port.VERIFY_ALL_LIBCONSENSUS == ref.VERIFY_ALL_LIBCONSENSUS
    assert port.VERIFY_ALL_EXTENDED == ref.VERIFY_ALL_EXTENDED
    assert port.flags.__all__ == ref.flags.__all__
    consts = [n for n in ref.flags.__all__ if n != "height_to_flags"]
    assert [getattr(port.flags, n) for n in consts] == \
        [getattr(ref.flags, n) for n in consts]


def _heights():
    from bitcoinconsensus_tpu_torch.core import flags as F

    acts = [F.HEIGHT_P2SH, F.HEIGHT_DERSIG, F.HEIGHT_CLTV, F.HEIGHT_CSV,
            F.HEIGHT_SEGWIT, F.HEIGHT_TAPROOT]
    return sorted({0, 710_000, 2**31 - 1} | {h + d for h in acts for d in (-1, 0, 1)})


@pytest.mark.parametrize("extended", [False, True])
def test_height_to_flags_equals_the_reference(extended):
    for h in _heights():
        assert bitcoinconsensus_tpu_torch.height_to_flags(h, extended) == \
            bitcoinconsensus_tpu.height_to_flags(h, extended), h


def test_runs_with_jax_unavailable():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.path.insert(0, {REPO!r})
        import torch
        torch.set_num_threads(1)
        from bitcoinconsensus_tpu_torch import TorchSecpVerifier, SigCheck
        from bitcoinconsensus_tpu_torch.utils import blockgen as B
        import hashlib
        sk = 12345
        msg = hashlib.sha256(b"no-jax").digest()
        xpk, _ = B.xonly_pubkey_create(sk)
        good = SigCheck("schnorr", (xpk, B.sign_schnorr(sk, msg), msg))
        bad = SigCheck("schnorr", (xpk, B.sign_schnorr(sk, msg)[:-1] + b"\\0", msg))
        out = TorchSecpVerifier(device="cpu").verify_checks([good, bad])
        assert out.tolist() == [True, False], out
        from bitcoinconsensus_tpu_torch import native_bridge
        assert native_bridge._lib is not None  # the lanes were packed natively
        from bitcoinconsensus_tpu_torch import NativeCoinsView, connect_block
        from bitcoinconsensus_tpu_torch import verify_batch_stream  # noqa: F401
        coins, funded = B.make_funded_view(2, seed="no-jax")
        block = B.build_block([B.build_spend_tx(funded)], 710_000, fees=1000)
        view = NativeCoinsView()
        view.add_coins_batch([(t, n, c.out.value, c.height, c.coinbase,
                               c.out.script_pubkey) for (t, n), c in coins._map.items()])
        res = connect_block(block, view, 710_000, check_scripts=False,
                            pow_limit=B.REGTEST_POW_LIMIT)
        assert res.ok and len(view) == 3, res  # 2 spent; 2 coinbase outputs, 1 spend
        assert not any(m == "bitcoinconsensus_tpu" or m.startswith("bitcoinconsensus_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_verifier_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchSecpVerifier()
    assert TorchSecpVerifier(device="cpu").device.type == "cpu"


def test_wrapper_checks_its_inputs():
    B = 4
    good = [torch.zeros(B, 4, 32, dtype=torch.uint8)] + \
        [torch.zeros(B, dtype=torch.int32)] * 5 + [torch.zeros(B, dtype=torch.bool)]
    assert VT._check(good[0], good[1:6], good[6]) == B
    bad_cases = [
        (good[0].to(torch.int32), good[1:6], good[6]),
        (good[0][:, :3], good[1:6], good[6]),
        (good[0], [good[1].to(torch.int64)] + good[2:6], good[6]),
        (good[0], good[1:6], good[6].to(torch.int32)),
        (good[0], [torch.zeros(2 * B, dtype=torch.int32)[::2]] + good[2:6], good[6]),
    ]
    for fields, flags, valid in bad_cases:
        with pytest.raises(ValueError):
            VT._check(fields, flags, valid)
