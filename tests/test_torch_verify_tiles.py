"""The verify kernel's module, `bitcoinconsensus_tpu_torch.ops.verify_tiles`.

(a) The signed recoder matches `pallas_kernel._signed_digits128` digit for
    digit, edge ladders included.
(b) The plain version, on lanes made as `tests/pallas_equality_check.py`
    makes them plus Schnorr and tweak lanes, agrees on every lane with a
    host model of the lane contract built on the JAX package's `secp_host`.
(c) The crafted collision lane defers (ok=0, needs_host=1) and
    `verify_checks` resolves it on the host to the oracle's answer.
(d) The CUDA source's lane program, compiled for the host by a C++
    compiler, agrees with the plain version bit for bit (this is the
    kernel's arithmetic; only the launch needs the card, and
    `tests/test_torch_gpu.py` holds the launched kernel on a card).
(e) `slow`: the JAX package's XLA kernel on `check_small`'s lanes, in a
    fresh process, bit-identical to the plain version.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from bitcoinconsensus_tpu.crypto import secp_host as H
from bitcoinconsensus_tpu.ops import pallas_kernel as JP
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.ops.limbs import int_to_limbs

# The plain version runs thousands of tiny ops; intra-op threads only add
# contention at these widths.
torch.set_num_threads(1)

P, N = H.P, H.N
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- (a) the signed recoder -----------------------------------------------------

def _recoder_values():
    edge = [0, 1, 15, 16, 31, 32, (1 << 128) - 1, 1 << 127, (1 << 125) - 1]
    edge += [(1 << k) - 1 for k in range(1, 129, 5)] + [1 << k for k in range(0, 128, 7)]
    # The maximal carry chain: window 0 reads 16, windows 1..24 read 15 plus
    # the carry, the top window 6 plus the carry -> [-16]*25 + [7].
    chain = 16 + sum(15 << (5 * w) for w in range(1, 25)) + (6 << 125)
    rng = np.random.default_rng(23)
    rand = [int.from_bytes(rng.bytes(16), "little") for _ in range(64)]
    return edge + [chain] + rand, chain


def test_signed_digits128_matches_pallas_recoder():
    vals, chain = _recoder_values()
    limbs10 = np.stack([int_to_limbs(v, 10) for v in vals], axis=1)
    want = [np.asarray(x) for x in jax.jit(JP._signed_digits128)(limbs10)]
    got = [x.numpy() for x in VT._signed_digits128(torch.from_numpy(limbs10))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    mag, sgn = got
    for i, v in enumerate(vals):
        digits = [int(m) * (-1 if s else 1) for m, s in zip(mag[:, i], sgn[:, i])]
        assert sum(d << (5 * w) for w, d in enumerate(digits)) == v
        assert all(-16 <= d <= 15 for d in digits)
        if v == chain:
            assert digits == [-16] * 25 + [7]


# -- (b) the plain version against a host model of the lane contract ------------

def _host_model(fields, want_odd, parity, has_t2, neg1, neg2, valid):
    """ok per lane: R = a·G + (±b1 ± λ·b2)·P from the packed bytes, with the
    kernel's accept rule, on the JAX package's host group law."""
    out = []
    for i in range(fields.shape[0]):
        le = lambda b: int.from_bytes(b.tobytes(), "little")  # noqa: E731
        a = le(fields[i, 0])
        b1, b2 = le(fields[i, 1, :16]), le(fields[i, 1, 16:])
        px, t1 = le(fields[i, 2]), le(fields[i, 3])
        pt = H.lift_x(px % P, odd=bool(want_odd[i] == 1))
        if not valid[i] or pt is None:
            out.append(False)
            continue
        s1 = -b1 if neg1[i] == 1 else b1
        s2 = -b2 if neg2[i] == 1 else b2
        b = (s1 + LAMBDA * s2) % N
        aff = H.G.mul(a).add(H.PointJ.from_affine(*pt).mul(b)).to_affine()
        if aff is None:
            out.append(False)
            continue
        x, y = aff
        ok_x = x == t1 or (has_t2[i] == 1 and x == (t1 + N) % P)
        par_ok = parity[i] < 0 or ((y & 1) == 1) == (parity[i] == 1)
        out.append(bool(ok_x and par_ok))
    return np.asarray(out)


@functools.lru_cache(maxsize=1)
def _panel():
    """16 lanes: check_small's 8 ECDSA lanes and its five perturbations, plus
    Schnorr and tweak lanes from `_example_checks` packed by the port."""
    f, wo, par, h2, n1, n2, val = (np.array(a) for a in ge._example_arrays(8))
    f[3, 3, 0] ^= 1  # corrupt target
    val[5] = False  # structurally invalid
    f[7, 2, 0] ^= 1  # perturbed pubkey x
    wo[2] ^= 1  # wrong y parity
    n1[4] ^= 1  # flipped GLV half sign
    checks = [SigCheck(c.kind, c.data) for c in ge._example_checks(9)
              if c.kind != "ecdsa"]  # 6 Schnorr/tweak checks
    v = TorchSecpVerifier(device="cpu")
    extra = [a[: len(checks)] for a in v._pack_lanes(v._prep_lanes(checks))]
    f2, wo2, par2, h22, n12, n22, val2 = (np.array(a) for a in extra)
    par2[0] ^= 1  # Schnorr lane with the R.y parity rule flipped
    args = [np.concatenate(p) for p in zip(
        (f, wo, par, h2, n1, n2, val), (f2, wo2, par2, h22, n12, n22, val2))]
    # Two pad lanes as the packer makes them (invalid, parity -1).
    pad = v._pack_lanes([])
    args = [np.concatenate([a, p[:1], p[:1]]) for a, p in zip(args, pad)]
    return tuple(np.ascontiguousarray(a) for a in args), checks


@functools.lru_cache(maxsize=1)
def _reference():
    args, _ = _panel()
    ok, needs = VT.verify_tiles(*(torch.from_numpy(a) for a in args))
    return ok.numpy(), needs.numpy()


def test_reference_matches_host_lane_model():
    args, checks = _panel()
    assert args[0].shape == (16, 4, 32)
    ok, needs = _reference()
    np.testing.assert_array_equal(ok, _host_model(*args))
    assert not needs.any()
    # Unperturbed lanes agree with the oracle on their checks.
    assert ok[[0, 1, 6]].all() and not ok[[2, 3, 4, 5]].any()
    for j, chk in enumerate(checks):
        want = getattr(H, {"schnorr": "verify_schnorr",
                           "tweak": "xonly_tweak_add_check"}[chk.kind])(*chk.data)
        assert want
        assert bool(ok[8 + j]) == (j != 0)  # lane 8: parity rule flipped


# -- (c) the collision lane -----------------------------------------------------

def _collision_check():
    qx, qy = H.G.mul(2).to_affine()
    return SigCheck("tweak", (qx.to_bytes(32, "big"), qy & 1,
                              H.G_X.to_bytes(32, "big"), (1).to_bytes(32, "big")))


def test_collision_lane_defers_and_host_fixup_resolves_it():
    checks = [_collision_check()] + [SigCheck(c.kind, c.data)
                                     for c in ge._example_checks(7)[1:]]
    v = TorchSecpVerifier(device="cpu")
    args = v._pack_lanes(v._prep_lanes(checks))
    ok, needs = VT.verify_tiles(*(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in args))
    assert needs[0] and not ok[0], "collision lane must defer"
    assert not needs[1:].any() and ok[1:7].all(), "others unaffected"
    out = v.verify_checks(checks)
    assert out[0] == H.xonly_tweak_add_check(*checks[0].data) is True
    assert out.all() and v.stats["fixups"] == 1


# -- (d) the CUDA source's lane program on the host -------------------------------

_HARNESS = textwrap.dedent("""
    #include "{src}"
    extern "C" void vt_host(const uint8_t* fields, const int32_t* wo,
                            const int32_t* pr, const int32_t* h2,
                            const int32_t* n1, const int32_t* n2,
                            const uint8_t* valid, const uint32_t* gtab,
                            int32_t* out, int n) {{
      for (int i = 0; i < n; i++)
        verify_lane((const uint32_t*)(fields + 128 * (size_t)i), wo[i], pr[i],
                    h2[i], n1[i], n2[i], valid[i], gtab, out + i, out + n + i);
    }}
""")


def test_cuda_source_lane_program_matches_reference_on_host(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel's lane program")
    src = os.path.join(REPO, "bitcoinconsensus_tpu_torch", "csrc", "verify_tiles.cu")
    harness = tmp_path / "vt_host.cpp"
    harness.write_text(_HARNESS.format(src=src))
    lib_path = tmp_path / "vt_host.so"
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(harness)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))

    args, _ = _panel()
    f, wo, par, h2, n1, n2, val = (np.array(a) for a in args)
    # The collision lane, and lanes of random bytes with random flags: the
    # contract is bit-identity on every lane, not only on honest ones.
    v = TorchSecpVerifier(device="cpu")
    coll = v._pack_lanes(v._prep_lanes([_collision_check()]))
    rng = np.random.default_rng(29)
    f[14] = coll[0][0]
    wo[14], par[14], h2[14], n1[14], n2[14], val[14] = (a[0] for a in coll[1:])
    f[15] = rng.integers(0, 256, (4, 32), dtype=np.uint8)
    wo[15], par[15], h2[15], n1[15], n2[15], val[15] = 0, 1, 1, 1, 0, True
    f[13, 0] = f[1, 0]
    f[13, 2] = f[1, 2]  # a lane whose P is real but whose scalars are random
    val[13] = True
    tens = [torch.from_numpy(np.ascontiguousarray(a)) for a in (f, wo, par, h2, n1, n2, val)]
    ok, needs = VT.verify_tiles_reference(*tens)
    assert needs[14]

    gtab = VT.gtable_words("cpu").numpy()
    out = np.zeros((2, 16), dtype=np.int32)
    keep = [np.ascontiguousarray(a) for a in (f, wo, par, h2, n1, n2,
                                              val.astype(np.uint8), gtab, out)]
    lib.vt_host(*(ctypes.c_void_p(a.ctypes.data) for a in keep), 16)
    np.testing.assert_array_equal(out[0] != 0, ok.numpy())
    np.testing.assert_array_equal(out[1] != 0, needs.numpy())


# -- (e) the JAX package's XLA kernel, in a fresh process ---------------------------

_JAX_KERNEL = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import __graft_entry__ as ge
    from bitcoinconsensus_tpu.crypto.jax_backend import _verify_kernel
    f, wo, par, h2, n1, n2, val = (np.array(a) for a in ge._example_arrays(8))
    f[3, 3, 0] ^= 1
    val[5] = False
    f[7, 2, 0] ^= 1
    wo[2] ^= 1
    n1[4] ^= 1
    ok = np.asarray(_verify_kernel(f, wo, par, h2, n1, n2, val))
    np.save({out!r}, ok)
""")


@pytest.mark.slow
def test_jax_xla_kernel_matches_reference_in_subprocess(tmp_path):
    """The same 8 lanes as `pallas_equality_check.check_small` (a fresh
    process: large XLA:CPU compiles crash long-lived pytest processes, see
    tests/conftest.py)."""
    out = tmp_path / "ok.npy"
    code = _JAX_KERNEL.format(repo=REPO, out=str(out))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(out)
    ok, needs = _reference()
    np.testing.assert_array_equal(ok[:8], want)
    assert not needs[:8].any()
