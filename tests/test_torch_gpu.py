"""The port on a CUDA card: the hand-written kernels against their plain
versions, and the verifier and `verify_batch` on the device.

Every test here carries the `gpu` marker and skips without a card. The file
imports nothing of JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(`--noconftest`: the suite's conftest configures JAX.)
"""

import ctypes
import hashlib
import re

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu_torch import api, native_bridge
from bitcoinconsensus_tpu_torch.analysis import kernel_check as K
from bitcoinconsensus_tpu_torch.crypto import secp_host as H
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.batch import verify_batch
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.ops import _build, launch
from bitcoinconsensus_tpu_torch.ops import limbs as L
from bitcoinconsensus_tpu_torch.ops import sha256 as SH
from bitcoinconsensus_tpu_torch.ops import verdict_checksum as VC
from bitcoinconsensus_tpu_torch.ops import verify_tiles as VT
from bitcoinconsensus_tpu_torch.resilience import faults as F
from bitcoinconsensus_tpu_torch.resilience.degrade import DispatchFailed
from bitcoinconsensus_tpu_torch.ops.contract import run_contract
from bitcoinconsensus_tpu_torch.utils import blockgen as B
from bitcoinconsensus_tpu_torch.utils.hashes import tagged_hash


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


def _panel_lanes(width: int, seed: int):
    """`width` lanes: 128 mixed checks tiled, then chip_smoke's perturbations
    (`blockgen.perturbed_panel`: the collision lane at 0, five perturbed
    sets)."""
    v = TorchSecpVerifier()
    packed = [np.array(a[:128]) for a in v._pack_lanes(v._prep_lanes(_checks(128)))]
    reps = width // 128 + 1
    tiled = [np.concatenate([a] * reps)[:width] for a in packed]
    args, _ = B.perturbed_panel(v, tiled, width, np.random.default_rng(seed))
    return v, args


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 63, 65, 4908, 8192])
def test_redesigned_kernel_bit_identical_at_ragged_widths(width):
    _need_cuda()
    v, args = _panel_lanes(width, seed=width)
    dev = v.to_device(args)
    before = VT.verify_tiles.launches
    ok, needs = VT.verify_tiles(*dev)
    torch.cuda.synchronize()
    assert VT.verify_tiles.launches == before + 1
    want_ok, want_needs = VT.verify_tiles_reference(*dev)
    assert torch.equal(ok, want_ok) and torch.equal(needs, want_needs)
    assert bool(needs[0]) and not bool(ok[0])  # the collision lane defers
    if width >= 4908:
        assert int(ok.sum()) > width // 2  # most lanes are honest


@pytest.mark.gpu
def test_launch_other_than_the_contract_is_refused():
    _need_cuda()
    v, args = _panel_lanes(65, seed=1)
    dev = v.to_device(args)
    fn = launch.bind("verify_tiles", "vt_verify_tiles")
    gtab = VT.gtable_words(dev[0].device)
    out = torch.zeros((2, 65), dtype=torch.int32, device=dev[0].device)
    ptrs = [t.data_ptr() for t in dev] + [gtab.data_ptr(), out.data_ptr()]
    c = VT.VERIFY_TILES_CONTRACT
    smem = c.dynamic_smem_bytes()
    stream = torch.cuda.current_stream().cuda_stream

    def raw(*vals):  # the launcher's packed arguments, the stream last
        return fn((ctypes.c_int64 * 16)(*vals))

    for grid, threads, nbytes in [(2, 64, 0), (2, 64, smem - 4), (1, 128, smem),
                                  (3, 64, smem), (2, 32, smem)]:
        assert raw(*ptrs, 65, grid, threads, nbytes, stream) != 0, (grid, threads, nbytes)
    torch.cuda.synchronize()
    assert not out.any()  # nothing ran
    assert raw(*ptrs, 65, 2, 64, smem, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out[0] != 0, VT.verify_tiles_reference(*dev)[0])


@pytest.mark.gpu
def test_kernel_attributes_match_the_contract():
    """ptxas's report of the kernel: no stack frame and no spills (the lane
    lives in registers, its indexed slots in shared memory), no static
    shared memory; and a launch with the contract's dynamic bytes runs."""
    _need_cuda()
    log = _build.build("verify_tiles").log
    lines = log.splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Function properties for" in ln and "vt_verify_kernel" in ln]
    assert at, "ptxas -v printed nothing for vt_verify_kernel"
    props = " ".join(lines[at[0] + 1:at[0] + 3])
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", props)
    assert m and (int(m[1]), int(m[2]), int(m[3])) == (0, 0, 0), props
    m = re.search(r"(\d+) bytes smem", props)
    assert m is None or int(m[1]) == 0, props
    smem = VT.VERIFY_TILES_CONTRACT.dynamic_smem_bytes()
    assert smem == 96256
    v, args = _panel_lanes(1, seed=2)
    dev = v.to_device(args)
    assert torch.equal(VT.verify_tiles(*dev)[0], VT.verify_tiles_reference(*dev)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("op,k", [("mul", 0), ("sqr", 0), ("add", 0), ("sub", 0),
                                  ("mul_int", 3), ("canon", 0), ("is_zero", 0)])
def test_field_layer_on_cuda_matches_integer_model(op, k):
    _need_cuda()
    p = 2**256 - 0x1000003D1
    edge = [0, 1, p - 1, p, p + 1, 2**256 - 1, 2**255, 0x1000003D1]
    rng = np.random.default_rng(len(op))
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(300)]
    a = [x for x in edge for _ in edge] + rand
    b = [y for _ in edge for y in edge] + rand[::-1]
    aw = torch.from_numpy(VT.ints_to_words(a).copy())
    bw = torch.from_numpy(VT.ints_to_words(b).copy())
    got = VT.field_op(op, aw.cuda(), bw.cuda(), k).cpu()
    assert torch.equal(got, VT.field_op(op, aw, bw, k))


@pytest.mark.gpu
def test_recode_on_cuda_matches_plain_version_on_automaton_lanes():
    _need_cuda()
    from bitcoinconsensus_tpu_torch.analysis import scalar_check as SC

    xs = [x for x, _, _, _ in SC.automaton_lanes()] + [0, (1 << 128) - 1]
    words = torch.from_numpy(SC.values_to_words(xs))
    mag, sgn = VT.recode(words.cuda())
    assert mag.is_cuda and mag.shape == (len(xs), VT.SGLV_WINDOWS)
    pmag, psgn = VT.recode(words)
    assert torch.equal(mag.cpu(), pmag)
    np.testing.assert_array_equal(
        SC.signed_digits(mag.cpu().numpy(), sgn.cpu().numpy()),
        SC.signed_digits(pmag.numpy(), psgn.numpy()))


@pytest.mark.gpu
def test_carry_automaton_drives_the_kernel_recoder_on_cuda():
    _need_cuda()
    from bitcoinconsensus_tpu_torch.analysis import scalar_check as SC

    cert = SC.certify("scalar._signed_digits128")
    assert cert.status == "THEOREM", cert.failures
    assert cert.facts["cuda_enumeration"]["lanes"] == 1584


@pytest.mark.gpu
def test_toy_positive_lean_path_counts_and_checks():
    _need_cuda()
    x = torch.arange(8 * 256, dtype=torch.int32).reshape(8, 256).cuda()
    before = K.toy_positive.launches
    outs = [K.toy_positive(x) for _ in range(3)]
    torch.cuda.synchronize()
    assert K.toy_positive.launches == before + 3
    for o in outs:
        assert torch.equal(o, x + 1)
    with pytest.raises(ValueError):
        K.toy_positive(x.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        K.toy_positive(x.to(torch.int64))
    with pytest.raises(ValueError):
        K.toy_positive(x[:4])
    assert K.toy_positive.launches == before + 3


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
def test_verify_batch_engines_agree_on_cuda():
    """The native and the Python host engine, each with its own verifier on
    cuda:0 and fresh caches, give equal verdicts on ~500 mixed inputs; both
    launch the kernel."""
    _need_cuda()
    items, bad = B.mixed_items(500, seed=21, corrupt_rate=0.05)
    got = {}
    for engine in ("native", "python"):
        v = TorchSecpVerifier(engine=engine)
        before = VT.verify_tiles_checked.launches
        got[engine] = [(r.ok, r.error, r.script_error) for r in verify_batch(
            items, verifier=v, sig_cache=SigCache(),
            script_cache=ScriptExecutionCache(), engine=engine)]
        assert VT.verify_tiles_checked.launches > before
    assert got["native"] == got["python"]
    assert [not g[0] for g in got["native"]] == bad


@pytest.mark.gpu
def test_native_packed_lanes_through_the_kernel():
    """`prep_pack`'s lanes and `_pack_lanes`' lanes are byte-equal and give
    the kernel's equal verdicts, pad lanes included."""
    _need_cuda()
    v = TorchSecpVerifier()
    checks = _checks(300) + [_collision()]
    size = v._pad(len(checks))
    py = v._pack_lanes(v._prep_lanes(checks))
    nat = native_bridge.prep_pack(checks, size)
    for a, b in zip(py, nat, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ok_p, nd_p = VT.verify_tiles(*v.to_device(py))
    ok_n, nd_n = VT.verify_tiles(*v.to_device(nat))
    assert torch.equal(ok_p, ok_n) and torch.equal(nd_p, nd_n)
    assert bool(ok_n[:300].all()) and bool(nd_n[300])


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


# -- the asynchronous seams, the block driver and the stream on the card --------------


@pytest.mark.gpu
def test_dispatch_lanes_returns_before_the_kernel_finishes():
    """A 32,768-lane dispatch returns while its kernel still runs (its end
    event not yet reached: nothing synchronised), and `sync_lanes` then
    gives `verify_checks`'s verdicts on the same checks."""
    _need_cuda()
    v = TorchSecpVerifier()
    base = _checks(96) + [_collision()]
    checks = (base * (32_767 // len(base) + 1))[:32_767]
    lanes = native_bridge.prep_pack(checks, v.pad(len(checks)))
    assert len(lanes[0]) == 32_768
    torch.cuda.synchronize()
    pending = v.dispatch_lanes(lanes, len(checks))
    kernel_end = pending.result.events[1]
    running = not kernel_end.query()
    assert v.in_flight == 1
    ok, needs = v.sync_lanes(pending, len(checks))
    assert running, "dispatch_lanes waited for the kernel"
    assert v.in_flight == 0 and kernel_end.query()
    fixed = ok.copy()
    for i in np.nonzero(needs)[0]:
        fixed[i] = v._host_check(checks[i])
    assert np.array_equal(fixed, v.verify_checks(checks))
    assert needs[96] and fixed.all()


def _block_200(corrupt=None):
    coins, funded = B.make_funded_view(
        200, kinds=("p2wpkh", "p2tr", "p2wpkh", "p2wsh_multisig"), seed="gpu-block")
    txs = [B.build_spend_tx(funded[i:i + 8], fee=800,
                            corrupt_input=3 if i == corrupt else None)
           for i in range(0, 200, 8)]
    block = B.build_block(txs, 710_000, fees=800 * len(txs))
    entries = [(t, n, c.out.value, c.height, c.coinbase, c.out.script_pubkey)
               for (t, n), c in coins._map.items()]
    return block, entries


@pytest.mark.gpu
@pytest.mark.parametrize("corrupt", [None, 96])
def test_connect_block_on_cuda_equals_the_cpu(corrupt):
    """A 200-input block through `connect_block` on a NativeCoinsView: the
    card's result, per input, equals the plain version's on the CPU."""
    _need_cuda()
    from bitcoinconsensus_tpu_torch.models.validate import connect_block

    block, entries = _block_200(corrupt)
    got = {}
    for device in ("cuda:0", "cpu"):
        view = native_bridge.NativeCoinsView()
        view.add_coins_batch(entries)
        before = VT.verify_tiles_checked.launches
        res = connect_block(block, view, 710_000, pow_limit=B.REGTEST_POW_LIMIT,
                            verifier=TorchSecpVerifier(device=device, min_batch=512,
                                                       pad_step=2048),
                            sig_cache=SigCache(), script_cache=ScriptExecutionCache())
        if device == "cuda:0":
            assert VT.verify_tiles_checked.launches > before
        got[device] = (res.ok, res.reason, res.fees, res.sigop_cost, len(view),
                       [(r.ok, r.error, r.script_error) for r in res.input_results])
    assert got["cuda:0"] == got["cpu"]
    assert got["cuda:0"][0] == (corrupt is None)


@pytest.mark.gpu
def test_stream_closed_midway_leaves_the_device_clean():
    _need_cuda()
    from bitcoinconsensus_tpu_torch.models.batch import verify_batch_stream

    items, _bad = B.mixed_items(300, seed=77, corrupt_rate=0.05)
    batches = [items[i:i + 60] for i in range(0, 300, 60)]
    v = TorchSecpVerifier()
    want = [verify_batch(b, verifier=v, sig_cache=SigCache(),
                         script_cache=ScriptExecutionCache()) for b in batches]
    gen = verify_batch_stream(iter(batches), verifier=v, sig_cache=SigCache(),
                              script_cache=ScriptExecutionCache(), depth=3)
    assert next(gen) == want[0]
    assert v.in_flight >= 1
    gen.close()
    assert v.in_flight == 0
    torch.cuda.synchronize()
    assert list(verify_batch_stream(iter(batches), verifier=v, sig_cache=SigCache(),
                                    script_cache=ScriptExecutionCache())) == want
    assert v.in_flight == 0


@pytest.mark.gpu
def test_single_check_wrappers_and_default_verifier_on_cuda():
    _need_cuda()
    from bitcoinconsensus_tpu_torch.crypto.torch_backend import default_verifier

    v = default_verifier()
    assert v is default_verifier() and v.device.type == "cuda"
    ecdsa, schnorr, tweak = (c.data for c in _checks(3))
    assert v.verify_ecdsa(*ecdsa) and v.verify_schnorr(*schnorr) and v.tweak_add_check(*tweak)
    bad = ecdsa[2][:-1] + bytes([ecdsa[2][-1] ^ 1])
    assert not v.verify_ecdsa(ecdsa[0], ecdsa[1], bad)


# -- the guards on the card ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 31, 32, 33, 250, 251, 1023, 1024, 1025, 8192,
                                   32768])
def test_verdict_checksum_kernel_matches_plain_version(width):
    _need_cuda()
    rng = np.random.default_rng(width)
    for ok in (rng.integers(0, 2, width).astype(bool), np.ones(width, bool)):
        dev = torch.from_numpy(ok).cuda()
        before = VC.verdict_checksum.launches
        got = VC.verdict_checksum(dev)
        assert VC.verdict_checksum.launches == before + 1
        assert got.is_cuda and got.dtype == torch.int32
        assert got.cpu().tolist() == VC.verdict_checksum_reference(dev).tolist()


@pytest.mark.gpu
def test_verdict_checksum_launcher_refuses_other_launches():
    _need_cuda()
    fn = launch.bind("verdict_checksum", "vc_verdict_checksum")
    ok = torch.zeros(64, dtype=torch.bool, device="cuda")
    out = torch.empty(2, dtype=torch.int32, device="cuda")
    for grid, threads, n in ((2, 1024, 64), (1, 512, 64), (1, 1024, VC.MAX_LANES + 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch.call(fn, 0, ok.data_ptr(), out.data_ptr(), n, grid, threads)


@pytest.mark.gpu
@pytest.mark.parametrize("site,kind", [("torch_backend.verdict", "flip"),
                                       ("torch_backend.verdict", "invert"),
                                       ("torch_backend.dispatch", "raise")])
def test_guarded_dispatch_on_cuda_absorbs_a_transient_fault(site, kind):
    """Every dispatch carries sentinels and the checksum partials of its one
    checked launch; a transient fault costs one retry on the same kernel, a
    persistent one raises."""
    _need_cuda()
    v = TorchSecpVerifier()
    checks = _checks(40) + [_collision()]
    want = TorchSecpVerifier(device="cpu").verify_checks(checks)
    vt0, vc0 = VT.verify_tiles.launches, VC.verdict_checksum.launches
    ck0, cs0 = VT.verify_tiles_checked.launches, VT.verify_tiles_checked.checksummed
    with F.inject(F.FaultPlan([F.FaultSpec(site, kind)]), seed=5):
        got = v.verify_checks(checks)
    assert np.array_equal(got, want) and v.stats["retries"] == 1
    assert v.stats["tickets"] == 1 and v.stats["sentinel_lanes"] == 4
    assert VT.verify_tiles_checked.checksummed - cs0 == \
        VT.verify_tiles_checked.launches - ck0 >= 1
    assert VT.verify_tiles.launches == vt0 and VC.verdict_checksum.launches == vc0
    with F.inject(F.FaultPlan([F.FaultSpec(site, kind, count=64)])):
        with pytest.raises(DispatchFailed):
            v.verify_checks(checks)
    assert v.in_flight == 0
    assert np.array_equal(v.verify_checks(checks), want)


@pytest.mark.gpu
def test_capture_charges_the_port_kernels_to_their_regions(tmp_path):
    """A torch.profiler capture around one warmed `verify_batch` on cuda:0
    charges the checked launch, `vt_verify_checked_kernel`, to
    `verify_tiles`, shows no standalone `vc_checksum_kernel`, leaves no
    kernel of the port unattributed, and reads a busy share in (0, 1] with
    the gaps labelled by host spans."""
    from bitcoinconsensus_tpu_torch.obs import xprof

    _need_cuda()
    items, _bad = B.mixed_items(300, seed=33, corrupt_rate=0.02)
    v = TorchSecpVerifier()

    def run():
        verify_batch(items, verifier=v, sig_cache=SigCache(),
                     script_cache=ScriptExecutionCache())

    run()
    rep = xprof.capture_report(run, log_dir=str(tmp_path))
    assert rep["symbols"]["vt_verify_checked_kernel"] > 0
    assert not rep["symbols"].get("vc_checksum_kernel")
    assert not rep["symbols"].get("vt_verify_kernel")
    assert rep["regions"]["verify_tiles"]["seconds"] == \
        pytest.approx(rep["symbols"]["vt_verify_checked_kernel"])
    assert not [s for s in rep["unattributed_symbols"]
                if s.startswith(("vt_", "vc_", "tk_"))]
    assert 0.0 < rep["device_busy_share"] <= 1.0
    assert rep["gaps"] and all(g["host_span"] for g in rep["gaps"])
    assert rep["provenance"]["platform"] == "cuda"


@pytest.mark.gpu
def test_stats_gate_passes_on_cuda():
    """`python -m bitcoinconsensus_tpu_torch.obs.stats --check --device cuda`
    exits 0: every required metric of the ported layers has samples."""
    import os
    import subprocess
    import sys

    _need_cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "bitcoinconsensus_tpu_torch.obs.stats", "--check",
         "--device", "cuda", "--format", "prom"],
        cwd=repo, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "0 problems" in proc.stderr


# -- SHA-256 on the card ------------------------------------------------------------


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _digests(t):
    return [r.tobytes() for r in t.cpu().numpy()]


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 255, 256, 257, 4097])
def test_sha256_kernels_match_plain_versions_and_hashlib(width):
    """csrc/sha256.cu's compression, fixed hash, challenge and merkle level
    kernels against their plain versions on the
    card (tolerance 0) and against hashlib on a sample of lanes, each launch
    counted on its wrapper."""
    _need_cuda()
    rng = np.random.default_rng(width)
    before = {k: w.launches for k, w in SH.WRAPPERS.items()}
    pick = sorted(set(rng.integers(0, width, 8).tolist()) | {0, width - 1})
    state = torch.from_numpy(rng.integers(0, 1 << 32, (8, width), dtype=np.uint32)).cuda()
    block = torch.from_numpy(rng.integers(0, 1 << 32, (16, width), dtype=np.uint32)).cuda()
    got = SH.sha256_compress(state, block)
    assert got.is_cuda and got.dtype == torch.uint32
    assert np.array_equal(got.cpu().numpy(),
                          SH.sha256_compress_reference(state, block).cpu().numpy())
    th = hashlib.sha256(b"TapSighash").digest()
    ms = SH.tag_midstate("TapSighash")
    for length in (0, 55, 64, 80, 119, 200):
        host = _u8(rng, width, length)
        data = torch.from_numpy(host).cuda()
        for fn, plain in ((SH.sha256_fixed, SH.sha256_fixed_reference),
                          (SH.sha256d_fixed, SH.sha256d_fixed_reference)):
            out = _digests(fn(data))
            assert out == _digests(plain(data)), (fn.__name__, length)
            for i in pick:
                h = hashlib.sha256(host[i].tobytes()).digest()
                assert out[i] == (h if fn is SH.sha256_fixed else hashlib.sha256(h).digest())
        lanes = torch.from_numpy(np.repeat(ms[:, None], width, axis=1)).cuda()
        for midstate in (ms, lanes):
            out = _digests(SH.sha256_fixed(data, midstate=midstate, prefix_len=64))
            for i in pick:
                assert out[i] == hashlib.sha256(th + th + host[i].tobytes()).digest()
    r, p, m = (_u8(rng, width, 32) for _ in range(3))
    dev = [torch.from_numpy(x).cuda() for x in (r, p, m)]
    out = _digests(SH.bip340_challenge(*dev))
    assert out == _digests(SH.bip340_challenge_reference(*dev))
    for i in pick:
        assert out[i] == tagged_hash("BIP0340/challenge", r[i].tobytes()
                                     + p[i].tobytes() + m[i].tobytes())
    level = _u8(rng, 2 * width + 1, 32)
    level[2 * (width // 2) + 1] = level[2 * (width // 2)]  # one equal sibling pair
    dev_level = torch.from_numpy(level).cuda()
    flag, plain_flag = (torch.zeros(1, dtype=torch.int32, device="cuda") for _ in range(2))
    out = _digests(SH.merkle_level(dev_level, flag))
    assert out == _digests(SH.merkle_level_reference(dev_level, plain_flag))
    assert flag.item() == plain_flag.item() == 1
    rows = [x.tobytes() for x in level] + [level[-1].tobytes()]
    assert out[-1] == hashlib.sha256(hashlib.sha256(rows[-2] + rows[-1]).digest()).digest()
    after = {k: w.launches for k, w in SH.WRAPPERS.items()}
    assert after["sh_compress_kernel"] - before["sh_compress_kernel"] == 1
    assert after["sh_fixed_kernel"] - before["sh_fixed_kernel"] == 6 * 4
    assert after["sh_challenge_kernel"] - before["sh_challenge_kernel"] == 1
    assert after["sh_merkle_level_kernel"] - before["sh_merkle_level_kernel"] == 1


@pytest.mark.gpu
def test_sha256_launchers_refuse_other_launches():
    _need_cuda()
    fn = launch.bind("sha256", "sh_challenge")
    x = torch.zeros((300, 32), dtype=torch.uint8, device="cuda")
    out = torch.empty_like(x)
    for lanes, grid, threads in ((300, 1, 256), (300, 2, 512), (0, 0, 256)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch.call(fn, 0, x.data_ptr(), x.data_ptr(), x.data_ptr(),
                        out.data_ptr(), lanes, grid, threads)
    fixed = launch.bind("sha256", "sh_fixed")
    ms = torch.zeros((8, 1), dtype=torch.uint32, device="cuda")
    for prefix, grid, threads in ((32, 5, 64), (0, 2, 256), (0, 4, 64)):
        with pytest.raises(RuntimeError, match="CUDA error"):  # prefix_len % 64, grid
            launch.call(fixed, 0, x.data_ptr(), 32, ms.data_ptr(), 1, prefix, 0,
                        out.data_ptr(), 300, grid, threads)
    tree = launch.bind("sha256", "sh_merkle_tree")
    work = torch.zeros(SH.tree_work_bytes(300) + 16, dtype=torch.uint8, device="cuda")
    for n, grid, threads, off in ((300, 2, 256, 0), (300, 1, 128, 0), (0, 0, 256, 0),
                                  (300, 1, 256, 4)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch.call(tree, 0, x.data_ptr(), n, work.data_ptr() + off, grid, threads)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_sha256d_fixed_on_a_misaligned_view_matches_hashlib(offset):
    """A contiguous (B, L) view that starts `offset` bytes past an aligned
    address hashes right on the card: the kernel reads it in aligned words
    and byte-permutes, launched once a call like the aligned rows."""
    _need_cuda()
    rng = np.random.default_rng(100 + offset)
    width = 257
    for length in (0, 1, 32, 55, 56, 64, 80, 119, 200):
        host = _u8(rng, width, length)
        buf = torch.zeros(width * length + 64, dtype=torch.uint8, device="cuda")
        data = buf[offset:offset + width * length].view(width, length)
        data.copy_(torch.from_numpy(host))
        assert data.is_contiguous() and (length == 0 or data.data_ptr() % 4 == offset)
        before = SH.sha256_fixed.launches
        out = _digests(SH.sha256d_fixed(data))
        assert SH.sha256_fixed.launches == before + 1
        assert out == _digests(SH.sha256d_fixed_reference(data.cpu()))
        for i in (0, width // 2, width - 1):
            want = hashlib.sha256(hashlib.sha256(host[i].tobytes()).digest()).digest()
            assert out[i] == want, (length, i)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 513, 4097])
def test_merkle_tree_kernel_matches_plain_version(n):
    """`merkle_tree` on the card (one launch, any number of chunks and a
    ragged tail chunk) against `merkle_tree_reference`, root and flag."""
    _need_cuda()
    rng = np.random.default_rng(n)
    leaves = _u8(rng, n, 32)
    if n > 4:
        leaves[n - 1] = leaves[n - 2]  # the odd tail equal to its neighbour: no flag
    for dup in (None, 600 if n > 600 else 0):
        if dup is not None and n > 1:
            leaves[dup + 1] = leaves[dup]
        dev = torch.from_numpy(leaves).cuda()
        before = SH.merkle_tree.launches
        root, flag = SH.merkle_tree(dev)
        assert SH.merkle_tree.launches == before + 1
        want_root, want_flag = SH.merkle_tree_reference(torch.from_numpy(leaves))
        assert bytes(root.cpu().numpy()) == bytes(want_root.numpy())
        assert flag.item() == want_flag.item() == int(dup is not None and n > 1)


@pytest.mark.gpu
def test_merkle_root_device_on_cuda_matches_the_host():
    from bitcoinconsensus_tpu_torch.core.block import merkle_root, merkle_root_device

    _need_cuda()
    rng = np.random.default_rng(77)
    sets = [[bytes(_u8(rng, 32)) for _ in range(n)]
            for n in (1, 2, 3, 5, 33, 512, 513, 4097)]
    sets.append([b"\x11" * 32, b"\x11" * 32, b"\x22" * 32, b"\x33" * 32])
    sets.append([b"\x44" * 32, b"\x55" * 32, b"\x55" * 32])
    across = [bytes(_u8(rng, 32)) for _ in range(1024)]
    across[512:] = across[:512]  # two equal chunk roots: siblings one round up
    sets.append(across)
    for leaves in sets:
        before = SH.merkle_tree.launches, SH.merkle_level.launches
        assert merkle_root_device(leaves) == merkle_root(leaves)
        # One tree launch a root of two or more leaves, no level launch.
        assert (SH.merkle_tree.launches - before[0],
                SH.merkle_level.launches - before[1]) == (int(len(leaves) > 1), 0)
    assert merkle_root(across)[1]
    assert merkle_root_device([]) == (b"\x00" * 32, False)


@pytest.mark.gpu
def test_device_challenge_on_cuda_matches_the_host_hash_path():
    _need_cuda()
    checks = _checks(90) + [_collision()]
    sig = bytearray(checks[4].data[1])
    sig[40] ^= 1
    checks[4] = SigCheck("schnorr", (checks[4].data[0], bytes(sig), checks[4].data[2]))
    want = TorchSecpVerifier(device="cpu", engine="python").verify_checks(checks)
    v = TorchSecpVerifier(engine="python", device_challenge=True)
    before = SH.bip340_challenge.launches
    got = v.verify_checks(checks)
    assert np.array_equal(got, want) and not got[4]
    assert SH.bip340_challenge.launches - before == 1
    assert v.stats["challenge_lanes"] == sum(c.kind == "schnorr" for c in checks)


@pytest.mark.gpu
@pytest.mark.parametrize("corrupt", [None, 96])
def test_connect_block_with_device_sha_on_cuda_equals_the_native_block(corrupt):
    """The 200-input block on the Python block layer with the merkle root and
    the challenges on the card equals the native block layer's result."""
    _need_cuda()
    from bitcoinconsensus_tpu_torch.models.validate import Coin, CoinsView, connect_block
    from bitcoinconsensus_tpu_torch.core.tx import OutPoint, TxOut

    block, entries = _block_200(corrupt)
    view = native_bridge.NativeCoinsView()
    view.add_coins_batch(entries)
    kw = dict(pow_limit=B.REGTEST_POW_LIMIT, sig_cache=SigCache(),
              script_cache=ScriptExecutionCache())
    nat = connect_block(block, view, 710_000, verifier=TorchSecpVerifier(), **kw)
    plain = CoinsView()
    for t, n, value, h, cb, spk in entries:
        plain.add(OutPoint(t, n), Coin(TxOut(value, spk), h, cb))
    before = {k: w.launches for k, w in SH.WRAPPERS.items()}
    kw.update(sig_cache=SigCache(), script_cache=ScriptExecutionCache())
    dev = connect_block(block, plain, 710_000, engine="python", device_merkle=True,
                        verifier=TorchSecpVerifier(engine="python",
                                                   device_challenge=True), **kw)
    assert SH.merkle_tree.launches > before["sh_merkle_tree_kernel"]
    assert SH.merkle_level.launches == before["sh_merkle_level_kernel"]
    assert SH.bip340_challenge.launches > before["sh_challenge_kernel"]

    def tup(res):
        return (res.ok, res.reason, res.fees, res.sigop_cost,
                [(r.ok, r.error, r.script_error) for r in res.input_results])

    assert tup(dev) == tup(nat) and nat.ok == (corrupt is None)
    assert len(plain) == len(view)


# -- the mesh on one card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("d,rows", [(1, 1), (2, 4096), (4, 2048), (8, 1024), (4, 16),
                                    (3, 5), (2, 1025)])
def test_shard_epilogue_kernel_matches_plain_version(d, rows):
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    _need_cuda()
    rng = np.random.default_rng([d, rows])
    bufs = [rng.integers(0, 2, (3, d * rows)).astype(bool), np.ones((3, d * rows), bool),
            np.zeros((3, d * rows), bool)]
    for ok, needs, live in bufs:
        dev = [torch.from_numpy(x.copy()).cuda() for x in (ok, needs, live)]
        before = SS.shard_epilogue.launches
        got = SS.shard_epilogue(*dev, d)
        assert SS.shard_epilogue.launches == before + 1
        assert got.is_cuda and got.dtype == torch.int32 and tuple(got.shape) == (3, d)
        assert got.cpu().tolist() == SS.shard_epilogue_reference(*dev, d).cpu().tolist()


@pytest.mark.gpu
def test_shard_epilogue_launcher_refuses_other_launches():
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    _need_cuda()
    fn = launch.bind("shard_step", "ss_shard_epilogue")
    t = torch.zeros(64, dtype=torch.bool, device="cuda")
    out = torch.empty(3, 2, dtype=torch.int32, device="cuda")
    for rows, n, grid, threads in ((32, 2, 1, 1024), (32, 2, 2, 512), (32, 0, 0, 1024),
                                   (SS.MAX_LANES + 1, 1, 1, 1024)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch.call(fn, 0, t.data_ptr(), t.data_ptr(), t.data_ptr(), out.data_ptr(),
                        rows, n, grid, threads)


def _mesh4(**kw):
    from bitcoinconsensus_tpu_torch.parallel import ShardedSecpVerifier, make_mesh

    return ShardedSecpVerifier(mesh=make_mesh(devices=["cuda:0"] * 4), **kw)


@pytest.mark.gpu
def test_cuda_mesh_equals_the_single_device_verifier():
    """A 4-entry mesh over cuda:0: each dispatch makes one checked verify
    launch a shard (its partials the shard's checksum and failures) and
    launches nothing else of the port; verdicts, the block verdict and
    `verify_batch` equal the single-device verifier's."""
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    _need_cuda()
    checks = [_collision()] + _checks(70)
    pk, sig, msg = checks[1].data
    checks.append(SigCheck("ecdsa", (pk, sig, hashlib.sha256(b"wrong").digest())))
    want = TorchSecpVerifier().verify_checks(checks)
    v = _mesh4()
    ck0, vt0, ss0, vc0 = (VT.verify_tiles_checked.launches, VT.verify_tiles.launches,
                          SS.shard_epilogue.launches, VC.verdict_checksum.launches)
    got, verdict = v.verify_checks_with_verdict(checks)
    assert np.array_equal(got, want) and not verdict
    assert v.stats["mesh_dispatches"] == 1 and v.stats["fixups"] == 1
    assert (VT.verify_tiles_checked.launches - ck0, VT.verify_tiles.launches - vt0,
            SS.shard_epilogue.launches - ss0,
            VC.verdict_checksum.launches - vc0) == (4, 0, 0, 0)
    clean = [c for c, w in zip(checks, want) if w]
    got2, verdict2 = v.verify_checks_with_verdict(clean)
    assert got2.all() and verdict2 and v.in_flight == 0
    items, _bad = B.mixed_items(120, seed=41, corrupt_rate=0.05)
    runs = [[(r.ok, r.error, r.script_error) for r in verify_batch(
        items, verifier=verifier, sig_cache=SigCache(), script_cache=ScriptExecutionCache())]
        for verifier in (TorchSecpVerifier(), _mesh4())]
    assert runs[0] == runs[1]


@pytest.mark.gpu
def test_cuda_mesh_device_loss_evicts_and_continues():
    _need_cuda()
    checks = _checks(60)
    want = TorchSecpVerifier().verify_checks(checks)
    v = _mesh4(evict_after=1)
    with F.inject(F.FaultPlan([F.FaultSpec("mesh.shard.1", "device-loss")])) as inj:
        got, verdict = v.verify_checks_with_verdict(checks)
    assert inj.total_fired() == 1 and np.array_equal(got, want) and verdict
    assert v.mesh.size == 3 and "1" not in v.mesh.ids
    got2, verdict2 = v.verify_checks_with_verdict(checks)
    assert np.array_equal(got2, want) and verdict2 and len(v.last_shard_lanes) == 3


# -- the checked launch: the verify kernel with its epilogue -------------------------


EPILOGUE_WIDTHS = (1, 31, 63, 64, 65, 2048, 8191)


def _port_launches():
    """Every launch counter of the port's kernel wrappers."""
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    out = {"checked": VT.verify_tiles_checked.launches, "verify": VT.verify_tiles.launches,
           "checksum": VC.verdict_checksum.launches, "epilogue": SS.shard_epilogue.launches}
    out.update({k: w.launches for k, w in SH.WRAPPERS.items()})
    out.update({w.__name__: w.launches for w in K.TOY_WRAPPERS})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("width", EPILOGUE_WIDTHS)
def test_verify_epilogue_matches_the_unchecked_and_standalone_kernels(width):
    """The checked launch against `vt_verify_tiles`, the standalone checksum
    kernel and the plain version, bit for bit: verdicts on every lane (the
    plain version's at up to 65 lanes), the summed partials against
    `verdict_checksum`, each warp's against `epilogue_reference`."""
    _need_cuda()
    v, args = _panel_lanes(width, seed=width + 16)
    dev = v.to_device(args)
    before = VT.verify_tiles_checked.launches
    ok, needs, parts = VT.verify_tiles_checked(*dev)
    torch.cuda.synchronize()
    assert VT.verify_tiles_checked.launches == before + 1
    assert ok.dtype == torch.bool and parts.dtype == torch.int32
    assert tuple(parts.shape) == (3, -(-width // 32))
    want_ok, want_needs = VT.verify_tiles(*dev)
    assert torch.equal(ok, want_ok) and torch.equal(needs, want_needs)
    if width <= 65:
        plain = VT.verify_tiles_checked_reference(*dev)
        assert torch.equal(ok, plain[0]) and torch.equal(needs, plain[1])
        assert torch.equal(parts.long(), plain[2])
    count, wsum, fails = VT.epilogue_sums(parts.cpu())
    assert [count, wsum] == VC.verdict_checksum(ok).cpu().tolist() == \
        VC.verdict_checksum_reference(ok).cpu().tolist() and fails == 0
    assert torch.equal(parts.cpu().long(), VT.epilogue_reference(ok, needs)[2].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("d,rows", [(1, 8192), (4, 2048), (8, 1024), (4, 16)])
def test_verify_epilogue_shard_triples_match_the_shard_epilogue(d, rows):
    """One checked launch a shard into views of a card's group buffers, with
    a live mask: each shard's summed partials equal the `shard_epilogue`
    kernel's and its plain version's triple, the verdicts the unchecked
    kernel's."""
    from bitcoinconsensus_tpu_torch.ops import shard_step as SS

    _need_cuda()
    v, args = _panel_lanes(d * rows, seed=d * rows)
    dev = v.to_device(args)
    live = torch.from_numpy(np.random.default_rng([d, rows]).random(d * rows) < 0.9).cuda()
    ok_g = torch.empty(d * rows, dtype=torch.bool, device="cuda")
    needs_g = torch.empty_like(ok_g)
    parts = torch.empty((d, 3, -(-rows // 32)), dtype=torch.int32, device="cuda")
    for s in range(d):
        sl = slice(s * rows, (s + 1) * rows)
        got = VT.verify_tiles_checked(*(a[sl] for a in dev), live=live[sl],
                                      ok_out=ok_g[sl], needs_out=needs_g[sl],
                                      partials=parts[s])
        assert got[0].data_ptr() == ok_g[sl].data_ptr()
        assert got[2].data_ptr() == parts[s].data_ptr()
    trips = parts.sum(dim=2).T.cpu().tolist()
    assert trips == SS.shard_epilogue(ok_g, needs_g, live, d).cpu().tolist() == \
        SS.shard_epilogue_reference(ok_g, needs_g, live, d).cpu().tolist()
    want_ok, want_needs = VT.verify_tiles(*dev)
    assert torch.equal(ok_g, want_ok) and torch.equal(needs_g, want_needs)


@pytest.mark.gpu
@pytest.mark.parametrize("checksum", ["1", "0"])
def test_verify_epilogue_one_port_kernel_per_dispatch(checksum, monkeypatch):
    """A single-card dispatch launches exactly one kernel of the port, the
    checked launch (with its partials unless the checksum is off), and on
    the card the profiler sees no other kernel: no `!=`, no checksum. The
    profiler records a warm-up call first and throws it away: a capture
    that records at once can lose its first launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    _need_cuda()
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_CHECKSUM", checksum)
    v = TorchSecpVerifier()
    checks = _checks(50)
    want = v.verify_checks(checks)
    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _step in range(2):
            before, partials0 = _port_launches(), VT.verify_tiles_checked.checksummed
            d0 = v.stats["dispatches"]
            got = v.verify_checks(checks)
            torch.cuda.synchronize()
            prof.step()
    after = _port_launches()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    dispatches = v.stats["dispatches"] - d0
    assert np.array_equal(got, want) and dispatches == 1
    assert moved == {"checked": 1}
    assert VT.verify_tiles_checked.checksummed - partials0 == (checksum == "1")
    kernels = {e.key.split("(")[0]: e.count for e in traces[-1]
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith(("Memcpy", "Memset", "region:"))}
    assert kernels == {"vt_verify_checked_kernel": 1}, kernels


@pytest.mark.gpu
def test_verify_epilogue_launcher_refuses_other_launches():
    """`vt_verify_tiles_checked` refuses any grid, thread count, shared size
    or width other than its contract's, and a missing verdict buffer; what
    it refuses never runs."""
    _need_cuda()
    v, args = _panel_lanes(65, seed=3)
    dev = v.to_device(args)
    fn = launch.bind("verify_tiles", "vt_verify_tiles_checked")
    gtab = VT.gtable_words(dev[0].device)
    ok = torch.zeros(65, dtype=torch.bool, device="cuda")
    needs = torch.zeros_like(ok)
    parts = torch.full((3, 3), -7, dtype=torch.int32, device="cuda")
    ptrs = [t.data_ptr() for t in dev] + [gtab.data_ptr()]
    smem = VT.VERIFY_TILES_CHECKED_CONTRACT.dynamic_smem_bytes()
    stream = torch.cuda.current_stream().cuda_stream

    def raw(ok_p, needs_p, n, grid, threads, nbytes):
        return fn((ctypes.c_int64 * 17)(*ptrs, ok_p, needs_p, 0, parts.data_ptr(), n,
                                        grid, threads, nbytes, stream))

    good = (ok.data_ptr(), needs.data_ptr())
    for case in [(*good, 65, 1, 64, smem), (*good, 65, 3, 64, smem),
                 (*good, 65, 2, 128, smem), (*good, 65, 2, 64, smem - 4),
                 (*good, VT.MAX_CHECKED_LANES + 64, VT.MAX_CHECKED_LANES // 64 + 1, 64,
                  smem), (*good, -1, 0, 64, smem),
                 (0, needs.data_ptr(), 65, 2, 64, smem), (ok.data_ptr(), 0, 65, 2, 64, smem)]:
        assert raw(*case) != 0, case
    torch.cuda.synchronize()
    assert not ok.any() and (parts == -7).all()  # nothing ran
    assert raw(*good, 65, 2, 64, smem) == 0
    torch.cuda.synchronize()
    want_ok, want_needs = VT.verify_tiles(*dev)
    assert torch.equal(ok, want_ok) and torch.equal(needs, want_needs)
    assert list(VT.epilogue_sums(parts.cpu()))[:2] == VC.verdict_checksum(ok).cpu().tolist()
    # ptxas's report of the checked kernel, as of the unchecked one: no
    # stack frame, no spills, no static shared memory.
    lines = _build.build("verify_tiles").log.splitlines()
    at = [i for i, ln in enumerate(lines)
          if "Function properties for" in ln and "vt_verify_checked_kernel" in ln]
    assert at, "ptxas -v printed nothing for vt_verify_checked_kernel"
    props = " ".join(lines[at[0] + 1:at[0] + 3])
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", props)
    assert m and (int(m[1]), int(m[2]), int(m[3])) == (0, 0, 0), props
    m = re.search(r"(\d+) bytes smem", props)
    assert m is None or int(m[1]) == 0, props
    assert smem == VT.VERIFY_TILES_CONTRACT.dynamic_smem_bytes() == 96256


# -- the serving front end and the cell on the card ------------------------------


@pytest.mark.gpu
def test_verify_server_on_cuda_equals_verify_batch():
    """`VerifyServer()` takes the port's default verifier on cuda:0: 256
    mixed inputs from 4 tenants settle to `verify_batch`'s verdicts, and the
    server launched the verify kernel."""
    _need_cuda()
    from bitcoinconsensus_tpu_torch.serving import VerifyServer

    items, _bad = B.mixed_items(256, seed=14, corrupt_rate=0.05)
    want = verify_batch(items, verifier=TorchSecpVerifier(), sig_cache=SigCache(),
                        script_cache=ScriptExecutionCache())
    VT.verify_tiles_checked.launches = 0
    with VerifyServer(sig_cache=SigCache(), script_cache=ScriptExecutionCache()) as srv:
        assert srv._verifier.device == torch.device("cuda:0")
        pend = [srv.submit(it, tenant=f"t{i % 4}") for i, it in enumerate(items)]
        got = [p.result(timeout=300) for p in pend]
    torch.cuda.synchronize()
    assert VT.verify_tiles_checked.launches > 0
    assert [(r.ok, r.error, r.script_error) for r in got] == \
        [(r.ok, r.error, r.script_error) for r in want]


@pytest.mark.gpu
def test_replica_process_on_the_default_device_answers_its_probe(tmp_path):
    """A `ReplicaProcess` with no device runs on cuda:0 and answers its
    known-answer pair (accept and reject) over the wire; its control channel
    reports launches of the verify and checksum kernels."""
    _need_cuda()
    from bitcoinconsensus_tpu_torch.cell import ReplicaProcess, make_probe_items, probe_replica

    r = ReplicaProcess("g0", store_dir=str(tmp_path / "g0"))
    assert r.device == "cuda:0"
    r.start()
    try:
        assert probe_replica(r.addr, make_probe_items(), timeout_s=120)
        stats = r.control({"cmd": "stats"})
        assert stats["pid"] == r.pid and stats["cuda_initialized"]
        assert stats["verify_tiles_launches"] > 0
        assert stats["checksum_launches"] == stats["verify_tiles_launches"]
    finally:
        r.kill()


@pytest.mark.gpu
def test_cell_entries_default_to_the_card_and_raise_without_it(monkeypatch, tmp_path):
    _need_cuda()
    from bitcoinconsensus_tpu_torch.cell import ServingCell, StubReplica

    assert StubReplica().device == "cuda:0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StubReplica()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingCell(stub=True, root_dir=str(tmp_path))


# -- the gauntlet (workloads/) on the card ---------------------------------------


@pytest.mark.gpu
def test_gauntlet_corpus_pins_hold_on_cuda():
    """The 26 pinned cases on the three engines with the batch leg on cuda:0
    (the runner's default): 0 mismatches, the native core present, and the
    batch leg launched the verify kernel."""
    _need_cuda()
    from bitcoinconsensus_tpu_torch.workloads.corpus import run_corpus_check

    rep = run_corpus_check()
    assert rep["pinned"], rep["mismatches"]
    assert rep["cases"] == 26 and rep["native_available"]
    assert rep["device"] == "cuda:0" and rep["batch_launches"] > 0


@pytest.mark.gpu
def test_gauntlet_diff_fuzz_on_cuda_zero_divergence():
    _need_cuda()
    from bitcoinconsensus_tpu_torch.workloads import run_diff_fuzz

    VT.verify_tiles_checked.launches = 0
    rep = run_diff_fuzz(seed=1, n_cases=12)
    torch.cuda.synchronize()
    assert rep["bit_identical"], rep["divergences"]
    assert rep["cases"] == 12 and rep["engines"] == 3
    assert VT.verify_tiles_checked.launches > 0


@pytest.mark.gpu
def test_gauntlet_tiny_replay_on_cuda_is_bit_identical_and_warm():
    _need_cuda()
    from bitcoinconsensus_tpu_torch.workloads import ReplayConfig, run_replay

    VT.verify_tiles_checked.launches = VT.verify_tiles_checked.checksummed = 0
    rep = run_replay(ReplayConfig(seed=3, n_blocks=2, txs_per_block=2, max_inputs=2))
    torch.cuda.synchronize()
    assert rep["bit_identical"], rep["divergences"]
    assert rep["warmed"] and rep["script_cache_hits"] >= rep["expected_warm_hits"] > 0
    assert rep["device"] == "cuda:0"
    assert VT.verify_tiles_checked.launches > 0
    assert VT.verify_tiles_checked.checksummed == VT.verify_tiles_checked.launches
