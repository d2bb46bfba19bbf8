"""The port's gauntlet CLI (`python -m bitcoinconsensus_tpu_torch.workloads`)
on the CPU, held to `scripts/consensus_gauntlet.py` and to the gauntlet
sweep of `scripts/consensus_chaos.py`:

- `--device cpu --corpus --check` exits 0 and writes its `--report`;
- with no card and no `--device` it exits 2 with the CUDA message, before
  any work;
- it takes every flag of the reference's CLI, and reads the seed set of
  `fuzz/gauntlet_seeds.json`;
- the sweep (`--chaos`): a trial holds only where every hard criterion it
  carries holds and no input was wrongly accepted; the corpus trial under
  a verdict flip holds on the port's fault site.

The plain kernel runs through `torch_serving_common.PLAIN`.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_serving_common import patch_plain_rows

from bitcoinconsensus_tpu_torch.crypto.torch_backend import TorchSecpVerifier
from bitcoinconsensus_tpu_torch.resilience import FaultSpec
from bitcoinconsensus_tpu_torch.workloads import __main__ as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def plain(monkeypatch):
    torch.set_num_threads(1)
    return patch_plain_rows(monkeypatch)


def test_cli_corpus_check_on_the_cpu_writes_its_report(tmp_path, capsys):
    path = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--corpus", "--check",
                     "--report", str(path)]) == 0
    rep = json.loads(path.read_text())
    assert rep["device"] == "cpu" and rep["problems"] == []
    corpus = rep["legs"]["corpus"]
    assert corpus["ok"] and corpus["pinned"] and corpus["cases"] == 26
    assert "0 problems" in capsys.readouterr().err


def test_cli_without_a_card_and_without_device_exits_with_the_cuda_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "bitcoinconsensus_tpu_torch.workloads", "--corpus",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "CUDA is not available" in proc.stderr
    assert proc.stdout == ""


def _flags(text):
    return {w.strip(",[]") for w in text.split() if w.strip("[,").startswith("--")}


def test_cli_takes_the_reference_flags_and_device_and_chaos(capsys):
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        "consensus_gauntlet.py"), "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    ref = _flags(proc.stdout)
    assert ref == {"--seed", "--replay", "--cell", "--corpus", "--fuzz", "--blocks",
                   "--txs", "--check", "--report", "--help"}
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert _flags(capsys.readouterr().out) - ref == {"--device", "--chaos", "--fuzz-cases"}


def test_cli_reads_the_checked_in_seed_set():
    with open(os.path.join(REPO, "fuzz", "gauntlet_seeds.json"), encoding="utf-8") as fh:
        assert cli.ci_fuzz_seeds() == json.load(fh)["seeds"]
    assert len(cli.ci_fuzz_seeds()) == 5


@pytest.mark.parametrize("trial,held", [
    ({"bit_identical": True, "replay_warmed": True, "wrong_accepts": 0}, True),
    ({"bit_identical": True, "replay_warmed": False, "wrong_accepts": 0}, False),
    ({"bit_identical": True, "all_accounted": True, "sheds_happened": False,
      "wrong_accepts": 0}, False),
    ({"bit_identical": True, "poison_caught_by_audit": False, "wrong_accepts": 0}, False),
    ({"bit_identical": True, "corpus_pinned": True, "wrong_accepts": 1}, False),
])
def test_sweep_trial_holds_only_on_every_criterion(trial, held):
    assert cli._finish(dict(trial, trial="t"), None, [])["held"] is held


def test_sweep_counts_wrong_accepts():
    divergences = [
        {"got": (True, "ERR_OK", None), "want": (False, "ERR_SCRIPT", "EVAL_FALSE")},
        {"got": (False, "ERR_SCRIPT", "EVAL_FALSE"), "want": (True, "ERR_OK", None)},
        {"verdicts": {"python": [False, "ERR_SCRIPT", "SIG_DER"],
                      "batch": [True, "ERR_OK", None],
                      "native": [False, "ERR_SCRIPT", "SIG_DER"]}},
        {"verdicts": {"python": [True, "ERR_OK", None],
                      "batch": [False, "ERR_SCRIPT", "EVAL_FALSE"]}},
    ]
    assert cli._wrong_accepts(divergences) == 2


def test_sweep_corpus_trial_under_a_verdict_flip_holds():
    v = TorchSecpVerifier(device="cpu")
    trial = cli._corpus_trial("gauntlet-corpus-verdict-flip",
                              [FaultSpec("torch_backend.verdict", "flip")], 0, v)
    assert trial["held"], trial
    assert trial["fault_fired"] and trial["corpus_pinned"]
    assert trial["fired"] == {"torch_backend.verdict:flip": 1}
    assert v.stats["retries"] >= 1
