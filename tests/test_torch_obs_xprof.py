"""The port's device-truth observatory on the CPU: region naming against the
reference's, trace parsing of the reference's fixture (to the reference's
attribution) and of a torch-format fixture (exact regions, copies,
unattributed time, busy share and idle gaps with their host spans), the
drift gate, the region-coverage lint, and a capture that refuses to run
without a card.

`tests/data/torch_xprof_fixture.trace.json` is hand-written in the format
`torch.profiler.export_chrome_trace` gives on the card machine (torch
2.11.0+cu128): host `user_annotation` ranges (the capture's own
`xprof.capture`, obs spans, `region:` scopes), a `gpu_user_annotation`
`region:dispatch` on the stream's track, kernels with demangled signatures,
copies and a memset, one torch kernel launched inside the dispatch range,
one kernel outside every region, and a zero-length event. Its expected
numbers below are worked out by hand from the event times.
"""

import gzip
import json
import os

import pytest
import torch

from bitcoinconsensus_tpu.obs import xprof as JX
from bitcoinconsensus_tpu.ops import regions as JR
from bitcoinconsensus_tpu_torch.analysis import host_lint
from bitcoinconsensus_tpu_torch.obs import get_registry
from bitcoinconsensus_tpu_torch.obs import spans as S
from bitcoinconsensus_tpu_torch.obs import xprof as X
from bitcoinconsensus_tpu_torch.ops import regions as R

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(name):
    with open(os.path.join(DATA, name)) as fh:
        return json.load(fh)["traceEvents"]


# -- ops/regions -------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "jit_f/region:scalar_mult/region:fe_mul/mul.3", "jit_f/transpose/mul.3",
    "no regions here", "region:a", 'x "region:b" y', "region:/region:c,d",
])
def test_region_naming_matches_the_reference(text):
    assert R.region_name("fe_mul") == JR.region_name("fe_mul") == "region:fe_mul"
    assert R.REGION_PREFIX == JR.REGION_PREFIX
    assert R.extract_regions(text) == JR.extract_regions(text)
    assert R.extract_region(text) == JR.extract_region(text)


@pytest.mark.parametrize("name,symbol", [
    ("vt_verify_kernel(unsigned int const*, int)", "vt_verify_kernel"),
    ("vc_checksum_kernel(unsigned char const*, int*, int)", "vc_checksum_kernel"),
    ("void tk_mul_kernel(int const*, int*, int)", "tk_mul_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
     "namespace)::F<int> >(int)", "vectorized_elementwise_kernel"),
    ("fusion.9", "fusion.9"),
])
def test_kernel_symbol_and_region(name, symbol):
    assert R.kernel_symbol(name) == symbol
    assert R.kernel_region(name) == R.KERNEL_REGIONS.get(symbol)


def test_kernel_regions_name_the_reference_regions():
    assert R.KERNEL_REGIONS["vt_verify_kernel"] == "verify_tiles"
    assert R.KERNEL_REGIONS["vc_checksum_kernel"] == "verdict_checksum"
    # The verify kernel's checked launch, whose epilogue carries the
    # checksum's partials, is the verify kernel's region too.
    assert R.KERNEL_REGIONS["vt_verify_checked_kernel"] == "verify_tiles"
    # The SHA-256 kernels keep the reference's two scopes: the compression,
    # the fixed-length hashes, the merkle tree and a merkle level share
    # `sha256_compress`, the challenge has `sighash_prep`. Every other kernel
    # has a region of its own.
    shared = ("sh_compress_kernel", "sh_fixed_kernel", "sh_merkle_level_kernel",
              "sh_merkle_tree_kernel")
    assert {R.KERNEL_REGIONS[k] for k in shared} == {"sha256_compress"}
    assert R.KERNEL_REGIONS["sh_challenge_kernel"] == "sighash_prep"
    rest = [v for k, v in R.KERNEL_REGIONS.items()
            if k not in shared + ("vt_verify_checked_kernel",)]
    assert len(set(rest)) == len(rest) and "sha256_compress" not in rest


def test_named_region_runs_inside_a_record_function(tmp_path):
    @R.named_region("toy_region")
    def f(x):
        return x * 2 + 1

    assert f.__consensus_region__ == "toy_region"
    with X.trace_session(str(tmp_path)) as prof:
        with S.span("obs.xprof.test"):
            assert int(f(torch.ones(4)).sum()) == 12
    (path,) = [os.path.join(tmp_path, p) for p in os.listdir(tmp_path)]
    assert path == prof.trace_path  # the session's own trace, by name
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]
             if e.get("cat") == "user_annotation"}
    # The span entered a range of its own name through the annotator.
    assert {"region:toy_region", "obs.xprof.test"} <= names
    assert S._annotator is None  # unset when the session ended


# -- trace parsing: the reference's fixture ----------------------------------------


def test_reference_fixture_gives_the_reference_attribution():
    ev = _events("xprof_fixture.trace.json")
    port, ref = X.parse_trace_events(ev), JX.parse_trace_events(ev)
    assert port["total_s"] == pytest.approx(ref["total_s"]) == pytest.approx(0.002)
    assert port["regions"].keys() == ref["regions"].keys()
    for k, v in ref["regions"].items():
        assert port["regions"][k] == pytest.approx(v)
    for k, v in ref["phases"].items():
        assert port["phases"][k] == pytest.approx(v)
    assert port["regions"]["fe_mul"] == pytest.approx(0.001)
    assert port["regions"][X.UNATTRIBUTED] == pytest.approx(0.00025)


def test_parse_trace_file_reads_plain_and_gzip(tmp_path):
    src = os.path.join(DATA, "torch_xprof_fixture.trace.json")
    with open(src, "rb") as fh, gzip.open(tmp_path / "b.trace.json.gz", "wb") as gz:
        gz.write(fh.read())
    plain, packed = X.parse_trace_file(src), X.parse_trace_file(str(tmp_path / "b.trace.json.gz"))
    assert plain == packed
    assert plain["regions"]["verify_tiles"] == pytest.approx(0.001)
    (tmp_path / "junk.trace.json").write_text("{not json")
    with pytest.raises(ValueError):
        X.parse_trace_file(str(tmp_path / "junk.trace.json"))


# -- trace parsing: the torch-format fixture ------------------------------------------


@pytest.fixture(scope="module")
def parsed():
    return X.parse_trace_events(_events("torch_xprof_fixture.trace.json"))


def test_torch_fixture_regions_and_phases(parsed):
    assert parsed["regions"] == pytest.approx({
        "verify_tiles": 1000e-6, "verdict_checksum": 2e-6,
        "dispatch": 1e-6,  # a torch kernel inside region:dispatch
        "copy": 15e-6,  # two copies and a memset
        X.UNATTRIBUTED: 5e-6})
    assert parsed["phases"] == pytest.approx({"dispatch": 1018e-6,
                                              X.UNATTRIBUTED: 5e-6})
    assert parsed["total_s"] == pytest.approx(1023e-6)
    assert parsed["copy_s"] == pytest.approx(15e-6)
    assert parsed["kernels"] == 4  # the zero-length event is dropped


def test_torch_fixture_symbols_and_unattributed(parsed):
    assert parsed["symbols"] == pytest.approx({
        "vt_verify_kernel": 1000e-6, "vectorized_elementwise_kernel": 1e-6,
        "vc_checksum_kernel": 2e-6, "some_unmapped_kernel": 5e-6})
    assert parsed["unattributed_symbols"] == pytest.approx({"some_unmapped_kernel": 5e-6})


def test_torch_fixture_busy_share_and_window(parsed):
    assert parsed["window_s"] == pytest.approx(0.01)  # the xprof.capture range
    assert parsed["device_busy_s"] == pytest.approx(1023e-6)
    assert parsed["device_busy_share"] == pytest.approx(0.1023)


def test_torch_fixture_gaps_with_their_host_spans(parsed):
    gaps = parsed["gaps"]
    assert [round(g["length_s"] * 1e6, 6) for g in gaps] == [4410, 2995, 1549, 10, 6]
    assert [round(g["start_s"] * 1e6, 6) for g in gaps] == [0, 7005, 5451, 4420, 5444]
    assert [g["host_span"] for g in gaps] == [
        "batch.interpret", "batch.results", "batch.results", "region:dispatch",
        "region:settle"]
    assert [[n for n, _s in g["host_spans"]] for g in gaps] == [
        ["batch.verify_batch", "batch.prepare", "batch.interpret"],
        ["batch.verify_batch", "batch.results"],
        ["batch.results", "batch.resolve", "region:settle"], [], []]
    assert gaps[2]["host_spans"][0][1] == pytest.approx(900e-6)


def test_finalize_sets_the_gauges_and_counts_the_capture(parsed):
    cap = get_registry().get("consensus_xprof_captures_total")
    before = cap.value(mode="trace")
    doc = X._finalize(parsed, [0.01], "test")
    assert doc["schema"] == X.SCHEMA and doc["mode"] == "trace"
    assert doc["named_share"] == pytest.approx(1018 / 1023)
    assert doc["unattributed_s"] == pytest.approx(5e-6)
    assert set(doc["regions"]) == {"verify_tiles", "verdict_checksum", "dispatch", "copy"}
    assert cap.value(mode="trace") == before + 1
    reg = get_registry()
    assert reg.get("consensus_kernel_region_seconds").value(
        region="verify_tiles") == pytest.approx(0.001)
    assert reg.get("consensus_xprof_busy_fraction").value(
        unit="device") == pytest.approx(0.1023)
    assert doc["provenance"]["cmd"] == "test"


def test_write_report_roundtrip(parsed, tmp_path):
    doc = X._finalize(parsed, [0.01], "test")
    path = tmp_path / "xprof.json"
    X.write_report(doc, str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))


# -- the drift gate -----------------------------------------------------------------


def _mk_report(regions, named_share=0.99, mode="trace", platform="cuda",
               device_kind="NVIDIA H100 80GB HBM3"):
    return {"schema": X.SCHEMA, "mode": mode,
            "provenance": {"platform": platform, "device_kind": device_kind},
            "regions": {k: {"seconds": v, "share": v} for k, v in regions.items()},
            "named_share": named_share}


@pytest.mark.parametrize("base,new,want", [
    ({"verify_tiles": 0.5, "copy": 0.5}, {"verify_tiles": 0.1, "copy": 0.9},
     ["verify_tiles", "copy"]),
    ({"verify_tiles": 0.50, "copy": 0.50}, {"verify_tiles": 0.45, "copy": 0.55}, []),
    ({"verify_tiles": 0.995, "tiny": 0.005}, {"verify_tiles": 0.999, "tiny": 0.0}, []),
], ids=["drift", "within", "sub-floor"])
def test_check_reports_matches_the_reference(base, new, want):
    port = X.check_reports(_mk_report(base), _mk_report(new))
    assert port == JX.check_reports(_mk_report(base), _mk_report(new))
    assert all(any(w in p for p in port) for w in want) and bool(port) == bool(want)
    assert (X.SHARE_FLOOR, X.SHARE_TOLERANCE) == (JX.SHARE_FLOOR, JX.SHARE_TOLERANCE)


def test_check_reports_flags_named_share_erosion_and_skips_mismatch():
    base = _mk_report({"verify_tiles": 1.0}, named_share=0.99)
    problems = X.check_reports(base, _mk_report({"verify_tiles": 1.0}, named_share=0.5))
    assert problems and any("coverage dropped" in p for p in problems)
    assert X.check_reports(base, _mk_report({"verify_tiles": 0.1},
                                            device_kind="cpu/x86_64-8c")) is None
    assert X.check_reports(base, _mk_report({"verify_tiles": 0.1}, mode="opwalk")) is None


# -- capture ------------------------------------------------------------------------


def test_capture_report_raises_with_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        X.capture_report(lambda: None)


def test_torch_trace_adapter_writes_a_capture(tmp_path, capsys):
    from bitcoinconsensus_tpu_torch.utils.profiling import torch_trace

    with torch_trace(str(tmp_path)):
        with S.span("adapter.span"):
            torch.ones(8).sum()
    assert f"torch trace written to {tmp_path}" in capsys.readouterr().out
    produced = [p for p in os.listdir(tmp_path) if p.endswith(".trace.json")]
    assert len(produced) == 1
    parsed = X.parse_trace_file(os.path.join(tmp_path, produced[0]))
    assert parsed["total_s"] == 0.0  # a CPU capture has no device track


# -- the region-coverage lint --------------------------------------------------------


def test_lint_kernel_regions_clean_on_the_tree():
    assert host_lint.lint_kernel_regions(REPO) == []


def test_lint_kernel_regions_finds_every_launcher_of_the_sources():
    with open(os.path.join(REPO, "bitcoinconsensus_tpu_torch", "csrc",
                           "toy_kernels.cu")) as fh:
        toys = host_lint.cuda_launchers(fh.read())
    assert toys["tk_mul"][0] == ["tk_mul_kernel"]
    assert toys["tk_double_write"][0] == toys["tk_oob_index_map"][0] == \
        ["tk_window_copy_kernel"]
    assert len(toys) == 9


def test_lint_kernel_regions_negative_fixture(tmp_path):
    """An unmapped kernel, the launcher that launches it, and a wrapper
    binding a launcher no source defines: each a finding."""
    src = ('__global__ void __launch_bounds__(64, 1) rogue_kernel(int* x) {}\n'
           'extern "C" int rogue(const int64_t* a) {\n'
           '  rogue_kernel<<<1, 64, 0, 0>>>(0);\n  return 0;\n}\n')
    wrapper = tmp_path / "wrapper.py"
    wrapper.write_text("from . import launch\n"
                       "fn = launch.bind('rogue', 'rogue')\n"
                       "gone = launch.bind('rogue', 'missing_launcher')\n")
    findings = host_lint.lint_kernel_regions(sources={"rogue": src},
                                             wrappers=[str(wrapper)])
    msgs = sorted(f.msg for f in findings)
    assert len(findings) == 3 and all(f.rule == "region" for f in findings)
    assert any("kernel `rogue_kernel` has no region" in m for m in msgs)
    assert any("launcher `rogue` launches `rogue_kernel`" in m for m in msgs)
    assert any("binds `missing_launcher`" in m for m in msgs)
    mapped = dict(R.KERNEL_REGIONS, rogue_kernel="rogue")
    assert host_lint.lint_kernel_regions(sources={"rogue": src}, wrappers=[],
                                         regions=mapped) == []
