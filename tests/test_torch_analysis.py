"""The port's kernel prover, `bitcoinconsensus_tpu_torch.analysis`.

(a) Live against the JAX prover: where the reference's interval proof still
    runs here, both provers prove the same function, and the port's derived
    output rows lie within the JAX entry's `out_within`.
(b) The reference's own assertions (`tests/test_pallas_check.py`),
    re-stated for launch contracts: each planted defect is rejected with the
    kind and phrase the reference pins, and the positive toy proves with its
    grid, shared bytes and per-row output bounds.
(c) The toys' plain versions on seeded inputs, and the CUDA source's
    per-element functions compiled for the host, against their references.
(d) Contract edge cases, the lint's exit codes, and (`slow`) the interval
    proof of the verify kernel's body on one block.

Every compared value and bound is held exactly (tolerance 0).
"""

import ctypes
import os
import shutil
import subprocess
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.analysis import registry as jax_registry
from bitcoinconsensus_tpu.ops import limbs as JL
from bitcoinconsensus_tpu_torch.analysis import interval as IV
from bitcoinconsensus_tpu_torch.analysis import kernel_check as K
from bitcoinconsensus_tpu_torch.analysis import lint, registry
from bitcoinconsensus_tpu_torch.ops import limbs as L
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.ops.contract import LaunchContract, Window, cdiv, run_contract

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kinds(rep):
    return {v.kind for v in rep.violations}


def _within(rows, hand):
    hand = [hand] * len(rows) if isinstance(hand, tuple) else list(hand)
    return len(rows) == len(hand) and all(
        hlo <= lo and hi <= hhi for (lo, hi), (hlo, hhi) in zip(rows, hand))


# -- (a) live against the JAX prover ---------------------------------------------


@pytest.mark.parametrize("name", [
    "limbs.fe_add", "limbs.fe_sub", "limbs.fe_mul", "limbs.fe_sqr",
    "limbs.fe_is_zero", "curve.jacobian_double"])
def test_port_and_jax_provers_agree(name):
    jax_spec = jax_registry.get_kernel(name)
    jax_rep = jax_spec.analyze()
    rep = registry.get_kernel(name).analyze()
    assert jax_rep.ok, jax_rep.violations[:3]
    assert rep.ok, rep.violations[:3]
    assert len(rep.out_bounds) == len(jax_rep.out_bounds)
    for i, hand in enumerate(jax_spec.out_within or []):
        assert _within(rep.out_bounds[i], hand), (
            f"output {i}: port rows {rep.out_bounds[i]} vs JAX out_within {hand} "
            f"(JAX derived {jax_rep.out_bounds[i]})")


def test_fe_canon_proves_against_the_jax_contract():
    """The JAX proof of `limbs.fe_canon` no longer runs under this jax (its
    trace holds a `jit` the reference's allowlist lacks), so the port is held
    to the JAX entry's contract: W2 rows in, canonical rows out."""
    jax_spec = jax_registry.get_kernel("limbs.fe_canon")
    fe = IV.TensorSpec((L.NLIMB, 2), torch.int32)
    rep = IV.analyze(L.fe_canon, [fe], "limbs.fe_canon",
                     in_bounds=jax_spec.in_bounds, out_within=jax_spec.out_within)
    assert rep.ok, rep.violations[:3]
    assert _within(rep.out_bounds[0], jax_spec.out_within[0])
    assert rep.out_bounds[0] == [(0, L.MASK)] * L.NLIMB


def test_tracing_leaves_limbs_caches_real():
    # limbs._fold_col once kept the fake tensor it made under make_fx, and
    # the next trace or eager call failed.
    fe = IV.TensorSpec((L.NLIMB, 3), torch.int32)
    x = torch.from_numpy(np.tile(np.asarray(L.W2, np.int32)[:, None], (1, 3)))
    want = L.fe_mul(x, x)
    L._FOLD_COLS.clear()
    for _ in range(2):
        assert IV.analyze(L.fe_mul, [fe, fe], "fe_mul", {0: (0, 8191), 1: (0, 8191)}).ok
    assert not L._FOLD_COLS
    assert torch.equal(L.fe_mul(x, x), want)
    assert all(type(c) is torch.Tensor for c in L._FOLD_COLS.values())
    assert IV.analyze(L.fe_mul, [fe, fe], "fe_mul", {0: (0, 8191), 1: (0, 8191)}).ok


def test_port_w2_equals_jax_w2():
    assert L.W2 == [int(w) for w in JL.W2]
    assert registry.w2_rows() == jax_registry.w2_rows()


# -- (b) the reference's assertions -------------------------------------------------


def test_oob_index_map_is_flagged():
    rep = K.analyze_negative("oob-index-map")
    assert not rep.ok and "grid" in _kinds(rep)
    v = next(v for v in rep.violations if v.kind == "grid")
    assert "input0" in v.where and "escapes the array extent" in v.msg
    assert "(1,)" in v.msg  # names the block that breaks


def test_read_before_write_scratch_is_flagged():
    rep = K.analyze_negative("read-before-write")
    assert not rep.ok and "ref" in _kinds(rep)
    v = next(v for v in rep.violations if v.kind == "ref")
    assert "scratch" in v.msg and "before any write" in v.msg
    assert "/body" in v.where and "add" in v.where  # the reading node


def test_mul_overflow_without_canon_is_flagged():
    rep = K.analyze_negative("mul-overflow-no-canon")
    assert not rep.ok and "overflow" in _kinds(rep)
    v = next(v for v in rep.violations if v.kind == "overflow")
    assert "/body" in v.where  # proven inside the kernel's body


def test_double_written_output_block_is_flagged():
    rep = K.analyze_negative("double-write")
    assert not rep.ok
    msgs = [v.msg for v in rep.violations if v.kind == "grid"]
    assert any("written exactly once" in m for m in msgs)
    assert any("never written" in m for m in msgs)


def test_f32_default_precision_dot_is_flagged():
    # The Hopper counterpart of a dot without Precision.HIGHEST: TF32.
    rep = K.analyze_negative("f32-default-precision-dot")
    assert not rep.ok and "float" in _kinds(rep)
    v = next(v for v in rep.violations if v.kind == "float")
    assert "Precision.HIGHEST" in v.msg and "TF32" in v.msg
    assert "/body" in v.where and "mm_tf32" in v.where  # inside the body


def test_f32_accum_overflow_is_flagged():
    # Every product exact, full float32: only the accumulated bound
    # K x max|a| x max|b| = 128 x 2^18 = 2^25 catches it.
    rep = K.analyze_negative("f32-accum-overflow")
    assert not rep.ok
    msgs = [v.msg for v in rep.violations if v.kind == "float"]
    assert any("2^24" in m and str(1 << 25) in m for m in msgs)


def test_f32_unvetted_roundtrip_demotes_with_source():
    rep = K.analyze_negative("f32-unvetted-roundtrip")
    assert not rep.ok
    msgs = [v.msg for v in rep.violations if v.kind == "float"]
    assert any("pow" in m and "vetted" in m for m in msgs)
    # the convert back to int32 cites the demotion site
    assert any("float->int" in m and "pow" in m for m in msgs)


def test_inexact_f32_output_write_is_flagged():
    # tests/test_pallas_check.py's inexact-VMEM-write fixture: (f32 x)**2
    # written to a float32 output.
    rep = K.check_contract(K.F32_WRITE_CONTRACT,
                           [IV.TensorSpec((8, 256), torch.int32)],
                           "toy.f32write", in_bounds={0: (0, 100)})
    assert not rep.ok
    assert any(v.kind == "float" and "written to output" in v.msg
               for v in rep.violations)


@pytest.mark.parametrize("case", ["dot-at-2^24", "dot-past-2^24", "cancel",
                                  "convert-past-2^24", "constant"])
def test_exact_float_edges(case):
    def dot(hi):
        return IV.analyze(lambda a, b: (a.float() @ b.float()).int(),
                          [IV.TensorSpec((1, 16), torch.int32),
                           IV.TensorSpec((16, 1), torch.int32)],
                          "dot", {0: (0, 1024), 1: (0, hi)})
    if case == "dot-at-2^24":  # 16 x 1024 x 1024 = 2^24 exactly: exact
        rep = dot(1024)
        assert rep.ok and rep.out_bounds == [[(0, 1 << 24)]]
        assert rep.n_float == 3 and all(e["exact"] for e in rep.exactness)
    elif case == "dot-past-2^24":
        rep = dot(1025)
        assert not rep.ok and _kinds(rep) == {"float"}
    elif case == "cancel":
        # Rows of -(2^24 - 1) and 2^24 - 1 sum to exactly 0, but a partial
        # sum of such terms may round: the accumulated bound is checked, not
        # the result's interval.
        rep = IV.analyze(lambda a: a.float().sum(0).int(),
                         [IV.TensorSpec((2, 1), torch.int32)], "sum",
                         {0: [(1 - (1 << 24), 1 - (1 << 24)), ((1 << 24) - 1, (1 << 24) - 1)]})
        assert not rep.ok and any("accumulated sum" in v.msg for v in rep.violations)
    elif case == "convert-past-2^24":
        rep = IV.analyze(lambda a: a.float().int(), [IV.TensorSpec((2,), torch.int32)],
                         "cvt", {0: (0, (1 << 24) + 1)})
        assert not rep.ok and any("2^24" in v.msg for v in rep.violations)
    else:  # a constant that is not an integer is not certified
        half = torch.full((2,), 0.5)
        rep = IV.analyze(lambda a: (a.float() + half).int(),
                         [IV.TensorSpec((2,), torch.int32)], "const", {0: (0, 9)})
        assert not rep.ok
        assert any("float->int" in v.msg and "not an integer" in v.msg
                   for v in rep.violations)


def test_tf32_rounding_is_nearest_ties_away():
    x = torch.tensor([1.0, 2047.0, 2049.0, 2051.0, -2051.0, 100.0, 3.0 * 2 ** 20 + 1])
    want = [1.0, 2047.0, 2050.0, 2052.0, -2052.0, 100.0, 3.0 * 2 ** 20]
    assert K.tf32_round(x).tolist() == want
    a = torch.tensor([[2049.0, 1.0]])
    assert K.mm_tf32(a, a.t()).item() == 2050.0 ** 2 + 1


def test_every_negative_fails():
    # What `lint --negative` relies on: no toy may rot into proving clean.
    assert set(K.NEGATIVES) == set(K.NEGATIVE_KINDS)
    for name in K.NEGATIVES:
        rep = K.analyze_negative(name)
        assert not rep.ok, f"negative toy {name} proved clean: gate is dead"
        assert K.NEGATIVE_KINDS[name] in _kinds(rep), (name, rep.violations)


def test_positive_toy_proves_with_contract_facts():
    rep = K.analyze_positive_toy()
    assert rep.ok, rep.violations[:3]
    assert rep.grid == (2,)
    assert 0 < rep.smem_peak_bytes <= 232448
    d = rep.to_dict()
    assert d["grid"] == [2] and d["smem_peak_bytes"] == rep.smem_peak_bytes
    # per-row bounds survive the shared-memory round trip: [0, 100] + 1
    assert rep.out_bounds[0] == [(1, 101)] * 8


def test_reports_without_contract_facts_omit_the_fields():
    d = registry.get_kernel("limbs.fe_add").analyze().to_dict()
    assert "grid" not in d and "smem_peak_bytes" not in d


def test_verify_tiles_contract_is_clean_at_main_path_widths():
    rep = registry.get_kernel("cuda.verify_tiles").analyze()
    assert rep.ok, rep.violations[:3]
    # The kernel's dynamic shared memory (its lanes' P tables, ratios and
    # chain slots) counts against the block's limit.
    assert rep.grid == (8192 // 64,) and rep.smem_peak_bytes == 96256
    assert VT.VERIFY_TILES_CONTRACT.dynamic_smem_bytes() == 96256
    assert rep.notes == ["contract checked at 8192 lanes",
                         "contract checked at 4908 lanes"]
    assert VT.VERIFY_TILES_CONTRACT.grid((4908, 4, 32)) == (77,)


def test_dynamic_shared_memory_counts_against_the_block_limit():
    import dataclasses

    big = dataclasses.replace(
        VT.VERIFY_TILES_CONTRACT,
        dynamic_smem=VT.VERIFY_TILES_CONTRACT.dynamic_smem * 3)  # 288,768 bytes
    rep = K.check_contract(big, registry.vt_specs(128), "vt.too_much_smem",
                           prove_body=False)
    assert not rep.ok and _kinds(rep) == {"smem"}
    assert "288768 bytes" in rep.violations[0].msg


# -- (c) the toys' plain versions and their CUDA arithmetic ----------------------


def _w2_limbs(rng, cols):
    return np.stack([rng.integers(0, w + 1, cols, dtype=np.int64)
                     for w in L.W2]).astype(np.int32)


def test_positive_plain_version_is_x_plus_one():
    rng = np.random.default_rng(11)
    for w in (1, 255, 256, 257):
        x = rng.integers(-(1 << 31), (1 << 31) - 1, (8, w), dtype=np.int64)
        x = np.clip(x, -(1 << 31), (1 << 31) - 2).astype(np.int32)
        got = K.toy_positive(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), x + 1)


def test_mul_plain_version_matches_jax_fe_mul():
    rng = np.random.default_rng(12)
    x = _w2_limbs(rng, 256)
    x[:, :4] = np.asarray(L.W2, dtype=np.int32)[:, None]  # the W2 corner
    x[:, 4] = 0
    got = K.toy_mul(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(JL.fe_mul)(jnp.asarray(x), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def _reference_dot_toy(x):
    """The Pallas f32 dot toys' kernel body in jnp, block by block
    (pallas_check.py:875-881 and :900-907, at Precision.HIGHEST)."""
    outs = []
    for b in range(x.shape[1] // 128):
        xf = jnp.asarray(x[:, 128 * b:128 * (b + 1)]).astype(jnp.float32)
        y = jax.lax.dot_general(xf, xf, (((1,), (1,)), ((), ())),
                                precision=jax.lax.Precision.HIGHEST)
        outs.append(jnp.broadcast_to(y.astype(jnp.int32)[:, :1], (8, 128)))
    return np.asarray(jnp.concatenate(outs, axis=1))


@pytest.mark.parametrize("toy,hi", [("f32_dot_tf32", 100), ("f32_dot", 1 << 9)])
def test_f32_dot_plain_versions_match_jax_on_exact_inputs(toy, hi):
    # Inside the declared bounds and, on this data, with every partial sum
    # below 2^24, both products are exact: TF32 keeps integers up to 2^11.
    rng = np.random.default_rng(14)
    x = rng.integers(0, hi + 1, (8, 256)).astype(np.int32)
    got = getattr(K, f"toy_{toy}")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _reference_dot_toy(x))


def test_f32_square_plain_versions_match_jax():
    rng = np.random.default_rng(15)
    x = rng.integers(0, 101, (8, 256)).astype(np.int32)
    xf = jnp.asarray(x).astype(jnp.float32) ** 2
    np.testing.assert_array_equal(K.toy_f32_square(torch.from_numpy(x)).numpy(),
                                  np.asarray(xf.astype(jnp.int32)))
    np.testing.assert_array_equal(K.toy_f32_write(torch.from_numpy(x)).numpy(),
                                  np.asarray(xf))


def test_checked_defects_plain_versions_show_the_provers_findings():
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.integers(-1000, 1000, (8, 256)).astype(np.int32))
    # Out of bounds: block (1,) escapes and writes nothing; block 0 copies
    # the window one block to the right.
    o, writes, faults = K.toy_oob_index_map(x)
    assert faults.tolist() == [[0, 0], [1, 0]]
    assert (writes[:, :128] == 1).all() and (writes[:, 128:] == 0).all()
    assert torch.equal(o[:, :128], x[:, 128:]) and (o[:, 128:] == 0).all()
    # Double write: output block 0 twice, block 1 never.
    o, writes, faults = K.toy_double_write(x)
    assert faults.tolist() == [[0, 0], [0, 0]]
    assert (writes[:, :128] == 2).all() and (writes[:, 128:] == 0).all()
    # Read before write: every block reads scratch no thread wrote.
    o, writes, faults = K.toy_read_before_write(x)
    assert faults.tolist() == [[0, 1], [0, 1]]
    assert (writes == 1).all() and torch.equal(o, x)


def test_checked_launch_offsets_come_from_the_index_maps():
    assert K._affine_cols(K.OOB_CONTRACT.ins[0], 2) == (128, 128)
    assert K._affine_cols(K.DOUBLE_WRITE_CONTRACT.outs[0], 2) == (0, 0)
    assert K._affine_cols(K.RBW_CONTRACT.ins[0], 3) == (128, 0)
    with pytest.raises(ValueError, match="not"):
        K._affine_cols(Window((8, 128), lambda b: (0, 128 * b[0] * b[0])), 3)


def test_unmasked_toys_refuse_a_ragged_width():
    with pytest.raises(ValueError, match="multiple of 128"):
        K.toy_f32_dot(torch.zeros(8, 200, dtype=torch.int32))


def test_mul_kernel_settle_schedule_is_limbs_schedule():
    # csrc/toy_kernels.cu::tk_fe_mul_col hard-codes this schedule.
    assert L._settle_plan(tuple(L._MUL_BOUNDS)) == (
        "pass:append", "pass:append", "fold", "pass:none", "fold",
        "pass:wrap", "pass:wrap", "pass:wrap")


_HARNESS = textwrap.dedent("""
    #include "{src}"
    extern "C" void host_positive(const int32_t* x, int32_t* o, int n) {{
      for (int i = 0; i < n; i++) o[i] = tk_positive_elem(x[i]);
    }}
    extern "C" void host_mul(const int32_t* x, int32_t* o, int cols) {{
      for (int c = 0; c < cols; c++) tk_fe_mul_col(x + c, x + c, cols, o + c);
    }}
    extern "C" void host_f32(const int32_t* x, int32_t* sq, float* wr, int n) {{
      for (int i = 0; i < n; i++) {{
        sq[i] = tk_f32_square_elem(x[i]);
        wr[i] = tk_f32_write_elem(x[i]);
      }}
    }}
    extern "C" void host_f32_dot(const int32_t* x, int32_t* o, int cols) {{
      for (int b = 0; b < cols / 128; b++) {{
        float t[8][128];
        for (int r = 0; r < 8; r++)
          for (int c = 0; c < 128; c++) t[r][c] = (float)x[r * cols + b * 128 + c];
        for (int r = 0; r < 8; r++) {{
          int32_t y = (int32_t)tk_dot_row(t[r], t[0], 128);
          for (int c = 0; c < 128; c++) o[r * cols + b * 128 + c] = y;
        }}
      }}
    }}
""")


def test_cuda_toy_arithmetic_matches_plain_versions_on_host(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the toys' arithmetic")
    src = os.path.join(REPO, "bitcoinconsensus_tpu_torch", "csrc", "toy_kernels.cu")
    harness = tmp_path / "toys.cpp"
    harness.write_text(_HARNESS.format(src=src))
    lib_path = tmp_path / "toys.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(harness)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    rng = np.random.default_rng(13)
    x = rng.integers(-1000, 1000, (8, 257)).astype(np.int32)
    o = np.zeros_like(x)
    lib.host_positive(ctypes.c_void_p(x.ctypes.data), ctypes.c_void_p(o.ctypes.data),
                      x.size)
    np.testing.assert_array_equal(o, K.toy_positive(torch.from_numpy(x)).numpy())
    m = np.ascontiguousarray(_w2_limbs(rng, 257))
    m[:, 0] = np.asarray(L.W2, dtype=np.int32)
    mo = np.zeros_like(m)
    lib.host_mul(ctypes.c_void_p(m.ctypes.data), ctypes.c_void_p(mo.ctypes.data), 257)
    np.testing.assert_array_equal(mo, K.toy_mul(torch.from_numpy(m)).numpy())
    f = rng.integers(0, 1 << 9, (8, 256)).astype(np.int32)
    sq, wr, dot = np.zeros_like(f), np.zeros(f.shape, np.float32), np.zeros_like(f)
    lib.host_f32(ctypes.c_void_p(f.ctypes.data), ctypes.c_void_p(sq.ctypes.data),
                 ctypes.c_void_p(wr.ctypes.data), f.size)
    lib.host_f32_dot(ctypes.c_void_p(f.ctypes.data), ctypes.c_void_p(dot.ctypes.data), 256)
    ft = torch.from_numpy(f)
    np.testing.assert_array_equal(sq, K.toy_f32_square(ft).numpy())
    np.testing.assert_array_equal(wr, K.toy_f32_write(ft).numpy())
    np.testing.assert_array_equal(dot, K.toy_f32_dot(ft).numpy())


# -- (d) contract edge cases, the lint, the heavy proof -------------------------------


def _copy_contract(masked):
    return LaunchContract(
        "copy", grid=lambda x: (cdiv(x[1], 128),), threads=128,
        ins=(Window((8, 128), lambda b: (0, 128 * b[0])),),
        outs=(Window((8, 128), lambda b: (0, 128 * b[0])),),
        out_arrays=lambda x: ((x, torch.int32),),
        body=lambda block, x: x + 0, masked_edge=masked)


def test_ragged_edge_is_rejected_unless_masked():
    spec = [IV.TensorSpec((8, 200), torch.int32)]
    rep = K.check_contract(_copy_contract(False), spec, "copy", {0: (0, 9)})
    assert not rep.ok
    assert any(v.kind == "grid" and "(1,)" in v.msg and "not masked" in v.msg
               for v in rep.violations)
    with pytest.raises(ValueError, match="escapes"):
        run_contract(_copy_contract(False), torch.zeros(8, 200, dtype=torch.int32))
    rep = K.check_contract(_copy_contract(True), spec, "copy", {0: (0, 9)})
    assert rep.ok, rep.violations
    assert rep.out_bounds[0] == [(0, 9)] * 8
    x = torch.arange(1600, dtype=torch.int32).reshape(8, 200)
    assert torch.equal(run_contract(_copy_contract(True), x), x)


def test_value_dependent_branch_is_a_determinism_violation():
    def fn(x):
        return x if bool((x > 0).all()) else -x

    rep = IV.analyze(fn, [IV.TensorSpec((4,), torch.int32)], "branch", {0: (0, 9)})
    assert not rep.ok and _kinds(rep) == {"determinism"}


def test_signed_recoder_digits_are_proven_in_range():
    # where(t >= 16, t - 32, t) is read branch by branch: each digit lies in
    # [-16, 15], so |digit| - 1 indexes the 16-row table of verify_tiles.
    rep = IV.analyze(VT._signed_digits128, [IV.TensorSpec((10, 2), torch.int32)],
                     "signed_digits128", {0: (0, L.MASK)})
    assert rep.ok, rep.violations[:3]
    assert rep.out_bounds == [[(0, 16)] * VT.SGLV_WINDOWS, [(0, 1)] * VT.SGLV_WINDOWS]
    rep = IV.analyze(lambda t: torch.where(t >= 16, t - 32, t) + (t > 100),
                     [IV.TensorSpec((3,), torch.int32)], "select", {0: (0, 20)})
    assert rep.ok and rep.out_bounds == [[(-16, 15)] * 3]


def test_lint_exit_codes(capsys):
    assert lint.main(["--quick"]) == 0
    assert "kernel lint: OK" in capsys.readouterr().out
    assert lint.main(["--negative", "oob-index-map"]) == 1
    assert "FAILED the gate (expected)" in capsys.readouterr().out
    assert lint.main(["--exactness", "--kernel", "limbs.fe_add"]) == 0
    out = capsys.readouterr().out
    assert "VACUOUS" in out and out.count("REJECTED") == 3
    assert "exact-float leg: OK" in out


@pytest.mark.slow
def test_verify_tiles_body_proves():
    rep = registry.get_kernel("cuda.verify_tiles.body").analyze()
    assert rep.ok, rep.violations[:5]
    assert rep.out_bounds[0] == [(0, 1), (0, 1)]
