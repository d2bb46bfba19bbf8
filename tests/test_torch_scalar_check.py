"""The port's scalar-schedule prover (`bitcoinconsensus_tpu_torch/analysis/
scalar_check.py`) held against the JAX package's (`analysis/scalar_check.py`).

- theorems: every fast target is a THEOREM whose facts equal the
  reference's certificate of the same name, key for key, except the keys
  named below (a fact the port proves in addition, or one that waits for a
  port module);
- negatives: every planted-unsound schedule is REJECTED with `schedule`
  violations, and the negative names equal the reference's, with the
  port's own digest byte-order negative beside them;
- recoders: the carry automaton's 1,584 lanes and 10,000 seeded values give
  the same signed digits through the JAX package's
  `pallas_kernel._signed_digits128` (jitted on the CPU), the port's torch
  `_signed_digits128` and the `.cu`'s own recoder built with g++;
- the evaluator fails closed, and the ledger and the `.cu` source checks
  reject a planted schedule;
- registry and recoders map to real targets; the two ledger targets over
  the verify kernel are THEOREM (`slow`).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.analysis import scalar_check as ref_sc
from bitcoinconsensus_tpu.ops import pallas_kernel as PK
from bitcoinconsensus_tpu_torch.analysis import registry
from bitcoinconsensus_tpu_torch.analysis import scalar_check as sc
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT

FAST = sorted(sc.all_targets(include_heavy=False))
# Facts the port proves beyond the reference's certificate of the same name.
PORT_ONLY = {
    "scalar.bytes_to_limbs": {"int_to_limbs[panel]"},
    "scalar._signed_digits128": {"cu_host_enumeration", "cuda_enumeration"},
    "sha256.bytes_from_words": {"words_from_bytes[32B->8W]"},
}
# Facts of the reference not ported yet: the plane congruences of its
# interval domain (`_prove_cong_planes`), which the port's interval domain
# does not carry.
NOT_YET_PORTED = {"scalar._digits": {"cong_planes"}}


@pytest.mark.parametrize("name", FAST)
def test_fast_target_is_theorem_with_the_reference_facts(name):
    cert = sc.certify(name)
    assert cert.status == "THEOREM", cert.failures
    ref = ref_sc.certify(name)
    assert ref.status == "THEOREM", ref.failures
    skip = NOT_YET_PORTED.get(name, set())
    for key, fact in ref.facts.items():
        if key not in skip:
            assert cert.facts.get(key) == fact, key
    extra = set(cert.facts) - set(ref.facts)
    assert extra <= PORT_ONLY.get(name, set()), extra


def test_fast_targets_are_the_reference_names_the_port_has():
    assert set(FAST) == set(ref_sc.all_targets(include_heavy=False))


@pytest.mark.parametrize("name", sorted(sc.NEGATIVES))
def test_negative_rejected(name):
    rep = sc.analyze_negative(name)
    assert not rep.ok
    assert any(v.kind == "schedule" for v in rep.violations)


def test_negative_names_equal_the_reference():
    # The port plants one negative of its own: a little-endian digest unpack
    # against `sha256.bytes_from_words`.
    assert set(sc.NEGATIVES) == set(ref_sc.NEGATIVES) | {"scalar-sha256-byte-order"}


def test_toy_ladder_selftest_passes():
    cert = sc.toy_ladder_selftest()
    assert cert.status == "THEOREM", cert.failures


# -- the three recoders against the JAX package's ---------------------------


def _rand128(n, tag):
    return [int.from_bytes(hashlib.sha256(f"{tag}/{i}".encode()).digest()[:16],
                           "big") for i in range(n)]


def _jax_digits(xs):
    arr = np.zeros((10, len(xs)), dtype=np.int32)
    for j, x in enumerate(xs):
        for limb in range(10):
            arr[limb, j] = (x >> (13 * limb)) & 0x1FFF
    mag, sgn = jax.jit(PK._signed_digits128)(jnp.asarray(arr))
    return sc.signed_digits(np.asarray(mag).T, np.asarray(sgn).T)


def test_recoders_agree_with_the_jax_recoder_on_automaton_and_seeded_lanes():
    xs = [x for x, _, _, _ in sc.automaton_lanes()] + _rand128(10_000, "recode")
    assert len(xs) == 1584 + 10_000
    words = sc.values_to_words(xs)
    want = _jax_digits(xs)
    mag, sgn = VT._signed_digits128(VT.words_to_limbs10(torch.from_numpy(words)))
    torch_digits = sc.signed_digits(mag.T.numpy(), sgn.T.numpy())
    host_digits = sc.signed_digits(*sc.host_recode(words))
    np.testing.assert_array_equal(torch_digits, want)
    np.testing.assert_array_equal(host_digits, want)
    cpu_mag, cpu_sgn = VT.recode(torch.from_numpy(words))  # the wrapper's plain path
    np.testing.assert_array_equal(sc.signed_digits(cpu_mag.numpy(), cpu_sgn.numpy()), want)
    weights = np.array([32 ** w for w in range(26)], dtype=object)
    assert [int(v) for v in (want.astype(object) * weights).sum(axis=1)] == xs


def test_recode_wrapper_checks_its_input():
    good = torch.zeros((3, 4), dtype=torch.int32)
    mag, sgn = VT.recode(good)
    assert mag.shape == sgn.shape == (3, VT.SGLV_WINDOWS)
    for bad in (good.to(torch.int64), torch.zeros((3, 5), dtype=torch.int32),
                torch.zeros((4, 6), dtype=torch.int32)[:, :4]):
        with pytest.raises(ValueError):
            VT.recode(bad)


# -- fail-closed pieces -------------------------------------------------------


def test_an_op_outside_the_domain_is_fail_not_skip():
    facts, failures = {}, []
    sc._prove_digit_slices("compare", lambda l: (l >= 16).to(torch.int32),
                           sc._seed_limb_bits(2), 2, 13, facts, failures)
    assert not facts and failures
    assert "outside the bit-slice domain" in failures[0]


def test_ledger_rejects_swapped_windows_and_a_skip_of_a_live_point():
    def stream(order):
        out = []
        for w in order:
            out += [("double",)] * 5 + [("digit", 0, w, 1), ("add", 0)]
        return out

    failures = []
    good = sc._ledger(stream([2, 1, 0]), halves=1, count=3, width=5,
                      label="t", failures=failures)
    assert good is not None and good["values"] == [1 + 32 + 32 ** 2], failures
    assert sc._ledger(stream([0, 1, 2]), halves=1, count=3, width=5,
                      label="t", failures=failures) is None
    assert "window order" in failures[-1]
    live_skip = [("digit", 0, 1, 3), ("add", 0), ("skip", 5), ("digit", 0, 0, 1),
                 ("add", 0)]
    assert sc._ledger(live_skip, halves=1, count=2, width=5, label="t",
                      failures=failures) is None
    assert "not the identity" in failures[-1]


@pytest.mark.parametrize("old,new,check", [
    ("int slot = 2 * (d - 1);", "int slot = 2 * d;", "p_table_row"),
    ("uint32_t neg = sgn ^ (uint32_t)(h ? neg2 : neg1);", "uint32_t neg = sgn;",
     "sign_wiring"),
    ("if (h) sx = fe_mul(sx, fe_from(VT_BETA));", "sx = fe_mul(sx, fe_from(VT_BETA));",
     "beta"),
    ("VT_G_ENTRIES + d - 1) * 2) * 8;", "VT_G_ENTRIES + d) * 2) * 8;", "g_row"),
])
def test_cuda_source_checks_reject_a_planted_text(old, new, check):
    text = sc.VT_SOURCE.read_text()
    facts, failures = {}, []
    sc.cuda_source_checks(facts, failures, text)
    assert not failures and set(facts["source"]) == {
        c[0] for c in sc.CUDA_SOURCE_CHECKS}
    assert text.count(old) == 1
    facts, failures = {}, []
    sc.cuda_source_checks(facts, failures, text.replace(old, new))
    assert any(f.startswith(f"cuda source: {check}:") for f in failures), failures


# -- registration -------------------------------------------------------------


def test_registry_schedules_match_prover_targets():
    assert sorted(s.name for s in registry.all_schedules()) == sorted(sc.all_targets())
    assert {s.name for s in registry.all_schedules() if s.heavy} == sc.HEAVY_TARGETS


def test_registered_recoders_map_to_real_targets():
    for fn_name, target in sc.REGISTERED_RECODERS.items():
        assert target in sc.TARGETS, (fn_name, target)
    for name in ("window5", "signed_carries", "signed_digit"):
        assert sc.REGISTERED_RECODERS[name] == "scalar._signed_digits128"


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(sc.HEAVY_TARGETS))
def test_heavy_ledger_target_is_theorem(name):
    cert = sc.certify(name, quick=True)
    assert cert.status == "THEOREM", cert.failures
    assert cert.facts["signed_ladder"]["ledger"] == \
        "coeff(w) == 2^(width*w) for every window"
    assert cert.facts["differential"]["lanes"] == len(sc.SCHEDULE_LANES)
