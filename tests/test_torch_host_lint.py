"""The port's host lint (`bitcoinconsensus_tpu_torch/analysis/host_lint.py`)
held against the JAX package's (`analysis/host_lint.py`).

- the port's tree is clean under every rule the port runs, the ten raw
  clock reads of the batch driver and the verifier included;
- planted fixtures give the same (rule, line) from both lints: a float
  literal, `import random`, `time.time()`, an unregistered recoder, and a
  device-to-host copy in a dispatch function;
- what only the port has: the sanctioned settle seams of the `sync` rule,
  the `.cu` scan of the scalar-coverage rule and its stated exemption;
- the serving front end, the cell and the persistent store: the `sync`
  rule over `serving/ingress.py` and `models/sigstore.py` (the reference's
  targets), the clock rule over `serving/` and `cell/`, each clean under
  both lints and flagging a planted device copy or clock read.
"""

import os
import textwrap

import pytest

from bitcoinconsensus_tpu.analysis import host_lint as ref_hl
from bitcoinconsensus_tpu.analysis import scalar_check as ref_sc
from bitcoinconsensus_tpu_torch.analysis import host_lint as hl
from bitcoinconsensus_tpu_torch.analysis import lint as port_lint
from bitcoinconsensus_tpu_torch.analysis import scalar_check as sc
from bitcoinconsensus_tpu_torch.utils.profiling import accumulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bitcoinconsensus_tpu_torch")


def test_port_tree_is_clean():
    assert [str(f) for f in hl.lint_consensus_host(REPO)] == []
    assert [str(f) for f in hl.lint_scalar_recoders(REPO)] == []


def test_no_raw_clock_reads_in_models_or_crypto():
    found = hl.lint_paths([os.path.join(PKG, "models"), os.path.join(PKG, "crypto")],
                          rules=hl.TIMING_RULES)
    assert found == []
    # the same tree under the reference's rule
    assert ref_hl.lint_paths([os.path.join(PKG, "models"), os.path.join(PKG, "crypto")],
                             rules=ref_hl.TIMING_RULES) == []


def test_host_cli_exits_zero(capsys):
    assert port_lint.main(["--host"]) == 0
    assert "host lint: 0 findings" in capsys.readouterr().out


FIXTURES = {
    "float": ("x = 1\nfee = x * 1.5\n", "ALL_RULES"),
    "random": ("import os\nimport random\n", "ALL_RULES"),
    "clock": ("import time\n\n\ndef f():\n    return time.time()\n", "TIMING_RULES"),
    "sync": ("import numpy as np\n\n\nclass Verifier:\n"
             "    def dispatch(self, x):\n        return np.asarray(x.cpu())\n",
             "SYNC_RULES"),
}


def _found(findings):
    return {(f.rule, f.line) for f in findings}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_planted_fixture_gives_the_reference_rule_and_line(tmp_path, name):
    src, rules = FIXTURES[name]
    path = tmp_path / f"{name}.py"
    path.write_text(src)
    port = _found(hl.lint_paths([str(path)], rules=getattr(hl, rules)))
    ref = _found(ref_hl.lint_paths([str(path)], rules=getattr(ref_hl, rules)))
    assert port and port == ref


def test_unregistered_recoder_fixture_gives_the_reference_rule_and_line(tmp_path):
    path = tmp_path / "toy_ops.py"
    path.write_text(textwrap.dedent("""
        def shift_only(x):
            return x >> 3

        def nibble_windows(x, shift):
            return (x >> shift) & 15

        def _digits(x):
            return x
    """))
    port = hl.lint_scalar_recoders(paths=[str(path)],
                                   registered=sc.REGISTERED_RECODERS)
    ref = ref_hl.lint_scalar_recoders(paths=[str(path)],
                                      registered=ref_sc.REGISTERED_RECODERS)
    assert _found(port) == _found(ref) == {("scalar-coverage", 5)}


def test_sync_rule_allows_only_the_named_seams(tmp_path):
    path = tmp_path / "backend.py"
    path.write_text(textwrap.dedent("""
        import torch

        class TorchSecpVerifier:
            def __init__(self):
                torch.cuda.synchronize()

            def _materialize_guarded(self, p):
                return p.cpu().numpy()

            def _prepare_ticket(self, p):
                return p.numpy()

            def sync_lanes(self, p):
                p.item()
                event = torch.cuda.Event()
                event.synchronize()
    """))
    found = hl.lint_paths([str(path)], rules=hl.SYNC_RULES)
    assert _found(found) == {("sync", 15), ("sync", 17)}
    assert set(hl.SYNC_ALLOWED_FUNCS) == {
        "TorchSecpVerifier._materialize_guarded", "settle_array",
        "TorchSecpVerifier._prepare_ticket", "TorchSecpVerifier.__init__",
        "TorchSecpVerifier._guard_launch", "make_mesh",
        "ShardedSecpVerifier._prepare_ticket", "_ShardedLaunch.settle"}


def test_sync_rule_covers_the_inflight_queue(tmp_path):
    """A bare `.cpu()` planted in a copy of `resilience/inflight.py` is
    flagged; `settle_array` may copy to the host, as in the reference."""
    src = open(os.path.join(REPO, "bitcoinconsensus_tpu_torch", "resilience",
                            "inflight.py"), encoding="utf-8").read()
    anchor = "            self.stats[\"tickets\"] += 1\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, anchor + "            args[0].cpu()\n")
    line = planted[:planted.index("args[0].cpu()")].count("\n") + 1
    path = tmp_path / "inflight.py"
    path.write_text(planted)
    found = hl.lint_paths([str(path)], rules=hl.SYNC_RULES)
    assert _found(found) == {("sync", line)}
    assert hl.lint_paths([os.path.join(REPO, "bitcoinconsensus_tpu_torch",
                                       "resilience", "inflight.py")],
                         rules=hl.SYNC_RULES) == []


def test_cuda_scan_finds_recoders_and_their_callers(tmp_path):
    path = tmp_path / "toy.cu"
    path.write_text(textwrap.dedent("""
        #define VT_FN static inline
        VT_FN uint32_t nibble(const u128& b, int w) {
          return (uint32_t)(b.w0 >> w) & 15u;
        }
        VT_FN uint32_t ladder(const u128& b) {
          return nibble(b, 4) + 1u;
        }
        VT_FN uint32_t fold(uint32_t x) {
          return (x >> 8) & 255u;
        }
    """))
    names = {n for _, _, n in hl.scalar_recoder_functions([str(path)])}
    assert names == {"nibble", "ladder"}
    found = hl.lint_scalar_recoders(paths=[str(path)], registered={"ladder": "x"})
    assert [(f.rule, f.line) for f in found] == [("scalar-coverage", 3)]


def test_kernel_recoders_are_registered_and_window_span_is_exempt_with_reason():
    cu = os.path.join(PKG, "csrc", "verify_tiles.cu")
    names = {n for _, _, n in hl.cuda_recoder_functions(cu)}
    assert {"window5", "signed_carries", "signed_digit"} <= names
    assert names <= set(sc.REGISTERED_RECODERS)
    contract = os.path.join(PKG, "ops", "contract.py")
    hits = {n for _, _, n in hl.scalar_recoder_functions([contract])}
    assert "window_span" in hits
    assert hl.lint_scalar_recoders(paths=[contract], registered={}) == []
    assert "recodes no scalar" in hl.SCALAR_COVERAGE_EXEMPT[("ops/contract.py",
                                                               "window_span")]


def test_accumulate_adds_a_normal_exit_only():
    stats = {"lane_prep_s": 0.0}
    with accumulate(stats, "lane_prep_s"):
        pass
    first = stats["lane_prep_s"]
    assert first >= 0.0
    with pytest.raises(RuntimeError):
        with accumulate(stats, "lane_prep_s"):
            raise RuntimeError("x")
    assert stats["lane_prep_s"] == first


@pytest.mark.parametrize("rel, anchor, plant, rules", [
    ("serving/ingress.py", "        sess.pending[rid] = req\n",
     "        item.spending_tx.cpu()\n", "SYNC_RULES"),
    ("models/sigstore.py", "        self._set_tier_gauges()\n\n    def _set_tier_gauges",
     None, "SYNC_RULES"),
    ("serving/queue.py", "            self._total += 1\n",
     "            time.perf_counter()\n", "TIMING_RULES"),
    ("cell/replica.py", "        st.fail_streak += 1\n",
     "        time.monotonic()\n", "TIMING_RULES"),
])
def test_serving_cell_and_sigstore_are_linted(tmp_path, rel, anchor, plant, rules):
    """Each new target is clean under the port's rule and the reference's
    and flags what is planted in a copy of it (a planted clock read as the
    reference's rule flags it too)."""
    real = os.path.join(PKG, rel)
    assert hl.lint_paths([real], rules=getattr(hl, rules)) == []
    assert ref_hl.lint_paths([real], rules=getattr(ref_hl, rules)) == []
    src = open(real, encoding="utf-8").read()
    if plant is None:  # the store: a device copy at the end of a method
        anchor = "            self._set_tier_gauges()\n            entries = self._entries\n"
        plant = "            np.asarray(entries)\n"
    assert src.count(anchor) >= 1
    i = src.index(anchor) + len(anchor)
    planted = src[:i] + plant + src[i:]
    line = planted[:i].count("\n") + 1
    path = tmp_path / os.path.basename(rel)
    path.write_text(planted)
    found = _found(hl.lint_paths([str(path)], rules=getattr(hl, rules)))
    if rules == "SYNC_RULES":  # the port's banned calls are torch's
        assert found == {("sync", line)}
    else:
        assert found == {("time-dependence", line)} == _found(
            ref_hl.lint_paths([str(path)], rules=ref_hl.TIMING_RULES))
