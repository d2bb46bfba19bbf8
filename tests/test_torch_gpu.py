"""The port on a CUDA card: the hand-written kernels against their plain
versions, and the verifier and `verify_batch` on the device.

Every test here carries the `gpu` marker and skips without a card. The file
imports nothing of JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest configures JAX.)
"""

import hashlib

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu_torch import api
from bitcoinconsensus_tpu_torch.analysis import kernel_check as K
from bitcoinconsensus_tpu_torch.crypto import secp_host as H
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.ops import limbs as L
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.ops.contract import run_contract
from bitcoinconsensus_tpu_torch.utils import blockgen as B


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


def _checks(n: int):
    """n valid mixed checks, ECDSA / Schnorr / taproot tweak in turn."""
    out = []
    for i in range(n):
        sk = (i * 2654435761 + 777) % (H.N - 1) + 1
        msg = hashlib.sha256(b"gpu-check-%d" % i).digest()
        if i % 3 == 0:
            out.append(SigCheck("ecdsa", (B.pubkey_create(sk), B.sign_ecdsa(sk, msg), msg)))
        elif i % 3 == 1:
            xpk, _ = B.xonly_pubkey_create(sk)
            out.append(SigCheck("schnorr", (xpk, B.sign_schnorr(sk, msg), msg)))
        else:
            xpk, par = B.xonly_pubkey_create(sk)
            eff = sk if par == 0 else H.N - sk
            t = int.from_bytes(msg, "big") % (H.N - 1) + 1
            q, q_par = B.xonly_pubkey_create((eff + t) % H.N)
            out.append(SigCheck("tweak", (q, q_par, xpk, t.to_bytes(32, "big"))))
    return out


def _collision():
    qx, qy = B._g_mul(2)
    return SigCheck("tweak", (qx.to_bytes(32, "big"), qy & 1,
                              H.G_X.to_bytes(32, "big"), (1).to_bytes(32, "big")))


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_cuda():
    _need_cuda()
    v = TorchSecpVerifier()
    checks = [_collision()] + _checks(70)
    f, wo, par, h2, n1, n2, val = (np.array(a) for a in v._pack_lanes(v._prep_lanes(checks)))
    n = len(checks)
    # Lane k holds checks[k]: lane 0 the collision, then ECDSA, Schnorr and
    # tweak in turn.
    f[1, 3, 0] ^= 1  # ECDSA target
    f[2, 2, 0] ^= 1  # Schnorr pubkey x
    wo[3] ^= 1  # y parity of the tweak's internal key
    n1[4] ^= 1  # ECDSA GLV half sign
    par[5] ^= 1  # Schnorr R.y parity rule
    val[6] = False
    rng = np.random.default_rng(3)
    f[n:] = rng.integers(0, 256, f[n:].shape, dtype=np.uint8)  # garbage lanes
    val[n:] = True
    args = v.to_device((f, wo, par, h2, n1, n2, val))
    before = VT.verify_tiles.launches
    ok, needs = VT.verify_tiles(*args)
    torch.cuda.synchronize()
    assert VT.verify_tiles.launches == before + 1
    want_ok, want_needs = VT.verify_tiles_reference(*args)
    assert torch.equal(ok, want_ok) and torch.equal(needs, want_needs)
    ok, needs = ok.cpu().numpy(), needs.cpu().numpy()
    assert needs[0] and not ok[0] and not needs[1:].any()
    assert not ok[1:7].any() and ok[7:n].all()


@pytest.mark.gpu
def test_kernel_ragged_width():
    _need_cuda()
    v = TorchSecpVerifier()
    checks = _checks(5)
    args = [np.ascontiguousarray(a[:5]) for a in v._pack_lanes(v._prep_lanes(checks))]
    ok, needs = VT.verify_tiles(*v.to_device(args))
    assert ok.shape == (5,) and ok.all().item() and not needs.any().item()


@pytest.mark.gpu
def test_verifier_on_cuda_resolves_collision():
    _need_cuda()
    v = TorchSecpVerifier()
    assert v.device.type == "cuda"
    checks = [_collision()] + _checks(7)
    assert v.verify_checks(checks).all() and v.stats["fixups"] == 1
    assert v.stats["kernel_ms"] > 0


@pytest.mark.gpu
def test_verify_batch_on_cuda_matches_api():
    _need_cuda()
    items, bad = B.mixed_items(30, seed=9, corrupt_rate=0.05)
    got = verify_batch(items, sig_cache=SigCache(), script_cache=ScriptExecutionCache())
    for it, r, b in zip(items, got, bad):
        try:
            api.verify_with_spent_outputs(it.spending_tx, it.input_index,
                                          it.spent_outputs, it.flags)
            want = (True, api.Error.ERR_OK)
        except api.ConsensusError as e:
            want = (False, e.code, e.script_error)
        assert (r.ok, r.error) == want[:2] and r.ok == (not b)
        if not r.ok:
            assert r.script_error == want[2]


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 255, 256, 257])
def test_toy_positive_kernel_matches_plain_version(width):
    _need_cuda()
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (K.TOY_ROWS, width))
                         .astype(np.int32)).cuda()
    before = K.toy_positive.launches
    got = K.toy_positive(x)
    torch.cuda.synchronize()
    assert K.toy_positive.launches == before + 1
    assert torch.equal(got, run_contract(K.POSITIVE_CONTRACT, x))
    assert torch.equal(got, x + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 255, 257])
def test_toy_mul_kernel_matches_plain_version(width):
    _need_cuda()
    rng = np.random.default_rng(width)
    w2 = np.asarray(L.W2, dtype=np.int64)[:, None]
    x = rng.integers(0, w2 + 1, (L.NLIMB, width)).astype(np.int32)
    x[:, 0] = L.W2
    x = torch.from_numpy(x).cuda()
    before = K.toy_mul.launches
    got = K.toy_mul(x)
    torch.cuda.synchronize()
    assert K.toy_mul.launches == before + 1
    assert torch.equal(got, run_contract(K.MUL_CONTRACT, x))


@pytest.mark.gpu
@pytest.mark.parametrize("toy,hi", [("f32_dot_tf32", 100), ("f32_dot", 1 << 9),
                                    ("f32_square", 100), ("f32_write", 100)])
@pytest.mark.parametrize("width", [128, 256, 1024])
def test_f32_toy_kernels_match_plain_versions(toy, hi, width):
    _need_cuda()
    rng = np.random.default_rng(width + hi)
    x = torch.from_numpy(rng.integers(0, hi + 1, (K.TOY_ROWS, width))
                         .astype(np.int32)).cuda()
    wrapper = getattr(K, f"toy_{toy}")
    before = wrapper.launches
    got = wrapper(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, wrapper(x.cpu()).cuda())


@pytest.mark.gpu
@pytest.mark.parametrize("toy", ["oob_index_map", "read_before_write", "double_write"])
@pytest.mark.parametrize("width", [256, 384])
def test_checked_defect_kernels_show_the_plain_versions_faults(toy, width):
    _need_cuda()
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.integers(-1000, 1000, (K.TOY_ROWS, width))
                         .astype(np.int32)).cuda()
    wrapper = getattr(K, f"toy_{toy}")
    before = wrapper.launches
    o, writes, faults = wrapper(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    po, pwrites, pfaults = wrapper(x.cpu())
    assert torch.equal(faults.cpu(), pfaults) and torch.equal(writes.cpu(), pwrites)
    once = pwrites == 1  # elements two blocks race on have no defined value
    assert torch.equal(o.cpu()[once], po[once])
