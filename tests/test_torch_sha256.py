"""The port's device SHA-256 (`bitcoinconsensus_tpu_torch/ops/sha256.py`,
`csrc/sha256.cu`) and its two paths, held to hashlib and to the JAX
package's `ops/sha256.py` and `core/block.py` on the CPU.

- plain versions: `sha256_fixed` / `sha256d_fixed` at lengths straddling
  every padding boundary, a midstate case, `sha256_compress`, the BIP340
  challenge, the helpers and the tag midstates;
- the CUDA source's lane functions compiled for the host by g++
  (`csrc/sha256_host.cpp`) against hashlib, and its constants against the
  module's;
- the merkle root on the CPU against the JAX package's device and host
  roots, the CVE-2012-2459 flag included, and `check_block(device_merkle=)`
  with the environment switch;
- the Python engine's lane prep with `device_challenge`: lanes byte-equal to
  the host-hash path, verdicts equal on the reference test's corruptions.

Every comparison is exact (tolerance 0). Inputs come from numpy seeds. The
JAX functions run eagerly on the CPU, so each is called at few shapes; the
prover's SHA-256 bodies are `slow`.
"""

import ctypes
import hashlib
import re

import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from bitcoinconsensus_tpu.core import block as JBLK
from bitcoinconsensus_tpu.ops import sha256 as JSH
from bitcoinconsensus_tpu_torch.core import block as BLK
from bitcoinconsensus_tpu_torch.crypto.torch_backend import SigCheck, TorchSecpVerifier
from bitcoinconsensus_tpu_torch.models.sigcache import ScriptExecutionCache, SigCache
from bitcoinconsensus_tpu_torch.models.validate import connect_block
from bitcoinconsensus_tpu_torch.ops import _build
from bitcoinconsensus_tpu_torch.ops import sha256 as SH
from bitcoinconsensus_tpu_torch.ops.contract import run_contract
from bitcoinconsensus_tpu_torch.utils import blockgen as B
from bitcoinconsensus_tpu_torch.utils.hashes import sha256d, tagged_hash

torch.set_num_threads(1)

LENGTHS = (0, 1, 31, 32, 55, 56, 63, 64, 65, 96, 119, 120, 128, 200)
HEIGHT = 710_000


def _bytes(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _rows(a) -> list:
    return [r.tobytes() for r in np.asarray(a)]


# -- plain versions ---------------------------------------------------------------


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_fixed_equals_hashlib_and_the_jax_package(length):
    data = _bytes(np.random.default_rng(length), 5, length)
    single = SH.sha256_fixed(torch.from_numpy(data))
    double = SH.sha256d_fixed(torch.from_numpy(data))
    assert single.dtype == double.dtype == torch.uint8
    assert _rows(single) == [hashlib.sha256(r).digest() for r in _rows(data)]
    assert _rows(double) == [sha256d(r) for r in _rows(data)]
    assert _rows(single) == _rows(JSH.sha256_fixed(data))
    if length in (0, 64, 200):
        assert _rows(double) == _rows(JSH.sha256d_fixed(data))


def test_plain_midstate_equals_the_prefix_hash():
    # The reference's own case (tests/test_ops_sha256.py): hashing
    # tag ‖ tag ‖ payload from scratch equals the midstate and the payload.
    data = _bytes(np.random.default_rng(3), 3, 100)
    ms = SH.tag_midstate("TapSighash")
    th = hashlib.sha256(b"TapSighash").digest()
    got = SH.sha256_fixed(torch.from_numpy(data), midstate=ms, prefix_len=64)
    assert _rows(got) == [hashlib.sha256(th + th + r).digest() for r in _rows(data)]
    assert _rows(got) == _rows(JSH.sha256_fixed(data, midstate=ms, prefix_len=64))
    # The same midstate as an (8, B) per-lane column block, and as a tensor.
    lanes = torch.from_numpy(np.repeat(ms[:, None], 3, axis=1))
    assert _rows(SH.sha256_fixed(torch.from_numpy(data), midstate=lanes,
                                 prefix_len=64)) == _rows(got)
    with pytest.raises(ValueError):
        SH.sha256_fixed(torch.from_numpy(data), midstate=ms, prefix_len=32)


def test_tag_midstates_equal_the_reference():
    assert SH.CHALLENGE_MIDSTATE.dtype == np.uint32
    assert np.array_equal(SH.CHALLENGE_MIDSTATE, JSH.CHALLENGE_MIDSTATE)
    for tag in ("TapSighash", "TapLeaf", "TapTweak", "BIP0340/nonce"):
        assert np.array_equal(SH.tag_midstate(tag), JSH.tag_midstate(tag))


def test_plain_compress_equals_the_jax_package():
    rng = np.random.default_rng(11)
    state = rng.integers(0, 1 << 32, (8, 6), dtype=np.uint32)
    block = rng.integers(0, 1 << 32, (16, 6), dtype=np.uint32)
    state[:, 0] = 0xFFFFFFFF  # every word at its top
    block[:, 0] = 0xFFFFFFFF
    got = SH.sha256_compress(torch.from_numpy(state), torch.from_numpy(block))
    assert got.dtype == torch.uint32 and tuple(got.shape) == (8, 6)
    assert np.array_equal(got.numpy(), np.asarray(JSH.sha256_compress(state, block)))
    # One compression of H0 over a padded 55-byte message is its SHA-256.
    msg = _bytes(rng, 55).tobytes()
    words = np.frombuffer(msg + SH._padding(55), dtype=">u4").astype(np.uint32)
    h0 = np.asarray(SH._H0, dtype=np.uint32)[:, None]
    out = SH.sha256_compress(torch.from_numpy(h0), torch.from_numpy(words[:, None].copy()))
    assert SH._bytes_from_words(out).numpy()[0].tobytes() == hashlib.sha256(msg).digest()


def test_plain_challenge_equals_tagged_hash_and_the_jax_package():
    rng = np.random.default_rng(4)
    r, p, m = (_bytes(rng, 6, 32) for _ in range(3))
    got = SH.bip340_challenge(*(torch.from_numpy(x) for x in (r, p, m)))
    assert _rows(got) == [tagged_hash("BIP0340/challenge", a + b + c)
                          for a, b, c in zip(_rows(r), _rows(p), _rows(m))]
    assert _rows(got) == _rows(JSH.bip340_challenge(r, p, m))


def test_helpers_equal_the_reference():
    for n in range(0, 201):
        assert SH._padding(n) == JSH._padding(n)
    rng = np.random.default_rng(9)
    data = _bytes(rng, 3, 64)
    assert np.array_equal(SH._words_from_bytes(torch.from_numpy(data)).numpy(),
                          np.asarray(JSH._words_from_bytes(data)).astype(np.int64))
    words = rng.integers(0, 1 << 32, (8, 3), dtype=np.uint32)
    assert np.array_equal(SH._bytes_from_words(torch.from_numpy(words)).numpy(),
                          np.asarray(JSH._bytes_from_words(words)))


def test_contracts_plain_versions_equal_the_wrappers_at_a_ragged_width():
    """`run_contract` cuts each kernel's launch into its blocks of 256 lanes
    (64 for the fixed hash; a ragged last block at 300) and must give the
    wrapper's result."""
    rng = np.random.default_rng(21)
    n = 300
    state = torch.from_numpy(rng.integers(0, 1 << 32, (8, n), dtype=np.uint32))
    block = torch.from_numpy(rng.integers(0, 1 << 32, (16, n), dtype=np.uint32))
    assert torch.equal(run_contract(SH.COMPRESS_CONTRACT, state, block),
                       SH.sha256_compress(state, block))
    rows = torch.from_numpy(_bytes(rng, n, 64))
    h0 = torch.from_numpy(np.asarray(SH._H0, dtype=np.uint32).reshape(8, 1))
    assert torch.equal(run_contract(SH.fixed_contract(64, double=True), rows, h0),
                       SH.sha256d_fixed(rows))
    r, p, m = (torch.from_numpy(_bytes(rng, n, 32)) for _ in range(3))
    assert torch.equal(run_contract(SH.CHALLENGE_CONTRACT, r, p, m),
                       SH.bip340_challenge(r, p, m))
    level = torch.from_numpy(_bytes(rng, 2 * n - 1, 32))
    assert torch.equal(run_contract(SH.MERKLE_LEVEL_CONTRACT, level),
                       SH.merkle_level(level, torch.zeros(1, dtype=torch.int32)))


# -- the CUDA source, compiled for the host -------------------------------------------


@pytest.fixture(scope="module")
def host_lib():
    lib = ctypes.CDLL(str(_build.build(_build.SH_HOST).path))
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    lib.sh_host_compress.argtypes = [p, p, p, i64]
    lib.sh_host_fixed.argtypes = [p, i64, p, i64, i64, ctypes.c_int, p, i64]
    lib.sh_host_challenge.argtypes = [p, p, p, p, i64]
    lib.sh_host_merkle_level.argtypes = [p, i64, p, p]
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data


def test_cuda_source_fixed_lanes_equal_hashlib(host_lib):
    rng = np.random.default_rng(31)
    h0 = np.asarray(SH._H0, dtype=np.uint32).reshape(8, 1)
    for length in LENGTHS:
        data = _bytes(rng, 4, length)
        for dbl in (0, 1):
            out = np.zeros((4, 32), np.uint8)
            host_lib.sh_host_fixed(_p(data), length, _p(h0), 1, 0, dbl, _p(out), 4)
            want = [hashlib.sha256(r).digest() for r in _rows(data)]
            assert _rows(out) == ([hashlib.sha256(w).digest() for w in want]
                                  if dbl else want), (length, dbl)
    # A midstate for every lane (one column) and per lane ((8, n) columns).
    data = _bytes(rng, 3, 100)
    th = hashlib.sha256(b"TapSighash").digest()
    want = [hashlib.sha256(th + th + r).digest() for r in _rows(data)]
    ms = SH.tag_midstate("TapSighash")
    for cols in (1, 3):
        block = np.ascontiguousarray(np.repeat(ms[:, None], cols, axis=1))
        out = np.zeros((3, 32), np.uint8)
        host_lib.sh_host_fixed(_p(data), 100, _p(block), cols, 64, 0, _p(out), 3)
        assert _rows(out) == want


def test_cuda_source_challenge_merkle_and_compress_lanes(host_lib):
    rng = np.random.default_rng(32)
    r, p, m = (_bytes(rng, 9, 32) for _ in range(3))
    out = np.zeros((9, 32), np.uint8)
    host_lib.sh_host_challenge(_p(r), _p(p), _p(m), _p(out), 9)
    assert _rows(out) == [tagged_hash("BIP0340/challenge", a + b + c)
                          for a, b, c in zip(_rows(r), _rows(p), _rows(m))]
    for n, dup in ((1, None), (2, 0), (3, None), (5, 2), (8, None), (33, 30)):
        level = _bytes(rng, n, 32)
        if dup is not None:
            level[dup + 1] = level[dup]
        if n == 3:
            level[2] = level[1]  # equal rows 1 and 2: not siblings
        out = np.zeros(((n + 1) // 2, 32), np.uint8)
        flag = np.zeros(1, np.int32)
        host_lib.sh_host_merkle_level(_p(level), n, _p(out), _p(flag))
        rows = _rows(level) + ([level[-1].tobytes()] if n & 1 else [])
        assert _rows(out) == [sha256d(rows[i] + rows[i + 1])
                              for i in range(0, len(rows), 2)]
        assert flag[0] == (dup is not None), n
    state = rng.integers(0, 1 << 32, (8, 5), dtype=np.uint32)
    block = rng.integers(0, 1 << 32, (16, 5), dtype=np.uint32)
    out = np.zeros((8, 5), np.uint32)
    host_lib.sh_host_compress(_p(state), _p(block), _p(out), 5)
    assert np.array_equal(out, np.asarray(JSH.sha256_compress(state, block)))


def test_cuda_source_constants_equal_the_module():
    text = (_build.CSRC / "sha256.cu").read_text()

    def table(name):
        body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", text, re.S).group(1)
        return [int(x, 16) for x in re.findall(r"0x([0-9A-F]{8})u", body)]

    assert table("SH_K") == list(SH._K)
    assert table("SH_H0") == list(SH._H0)
    assert table("SH_CHALLENGE_MIDSTATE") == [int(x) for x in JSH.CHALLENGE_MIDSTATE]
    assert f"#define SH_THREADS {SH.THREADS}" in text
    assert f"#define SH_FIXED_THREADS {SH.FIXED_THREADS}" in text
    assert f"#define SH_TREE_THREADS {SH.TREE_THREADS}" in text
    assert f"#define SH_TREE_CHUNK {SH.TREE_CHUNK}" in text
    assert f"#define SH_TREE_HEADER {SH.TREE_HEADER}" in text


# -- the merkle root ----------------------------------------------------------------------


def _leaves(rng, n):
    return _rows(_bytes(rng, n, 32)) if n else []


def _merkle_sets():
    rng = np.random.default_rng(41)
    sets = {n: _leaves(rng, n) for n in (0, 1, 2, 3, 4, 5, 7, 16, 33, 4097)}
    sets["dup_pair"] = [b"\x11" * 32, b"\x11" * 32, b"\x22" * 32, b"\x33" * 32]
    sets["odd_tail"] = [b"\x44" * 32, b"\x55" * 32, b"\x66" * 32]
    sets["odd_tail_equal"] = [b"\x44" * 32, b"\x55" * 32, b"\x55" * 32]
    deep = _leaves(rng, 4097)
    deep[4094] = deep[4095]  # a sibling pair deep in the first level
    sets["dup_4097"] = deep
    upper = _leaves(rng, 8)
    upper[4:8] = upper[0:4]  # equal subtrees: siblings equal one level up
    sets["dup_subtree"] = upper
    return sets


MERKLE_SETS = _merkle_sets()


@pytest.mark.parametrize("name", list(MERKLE_SETS))
def test_merkle_root_device_on_the_cpu_equals_the_host_roots(name):
    leaves = MERKLE_SETS[name]
    got = BLK.merkle_root_device(leaves, device="cpu")
    assert got == JBLK.merkle_root(leaves) == BLK.merkle_root(leaves)
    if name in ("dup_pair", "dup_4097", "dup_subtree"):
        assert got[1]
    elif name != 0:
        assert not got[1]


def test_merkle_root_device_equals_the_jax_device_root():
    # The JAX path runs eagerly on the CPU and compiles each level's shape,
    # seconds apiece, so it is held at one shape: one pair, equal or not
    # (the odd tails and deeper trees are held to its host root above).
    rng = np.random.default_rng(42)
    for leaves in (_leaves(rng, 1), _leaves(rng, 2), [b"\x11" * 32] * 2):
        assert BLK.merkle_root_device(leaves, device="cpu") == \
            JBLK.merkle_root_device(leaves)
    assert BLK.merkle_root_device([], device="cpu") == JBLK.merkle_root_device([])


def test_merkle_root_device_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BLK.merkle_root_device([b"\x01" * 32, b"\x02" * 32])


def _blocks():
    coins, funded = B.make_funded_view(2, seed="sha-merkle")
    t1, t2 = (B.build_spend_tx([f]) for f in funded)
    good = B.build_block([t1, t2], HEIGHT, fees=2000)
    mutated = B.build_block([t1, t2, t2], HEIGHT, fees=3000)
    return coins, good, mutated


def test_check_block_device_merkle_and_its_environment_switch(monkeypatch):
    coins, good, mutated = _blocks()
    kw = dict(pow_limit=B.REGTEST_POW_LIMIT, device="cpu")
    seen = []
    real = BLK.merkle_root_device

    def spy(hashes, device=None):
        seen.append(device)
        return real(hashes, device)

    monkeypatch.setattr(BLK, "merkle_root_device", spy)
    for device_merkle in (True, False):
        assert BLK.check_block(good, device_merkle=device_merkle, **kw) == (True, None)
        assert BLK.check_block(mutated, device_merkle=device_merkle, **kw) == \
            (False, "bad-txns-duplicate")
    assert seen == ["cpu", "cpu"]
    for env, used in (("1", True), ("on", True), ("0", False), ("", False)):
        monkeypatch.setenv("BITCOINCONSENSUS_TPU_DEVICE_MERKLE", env)
        seen.clear()
        assert BLK.check_block(good, **kw) == (True, None)
        assert bool(seen) == used, env
    # connect_block's Python block layer takes the verifier's device.
    monkeypatch.delenv("BITCOINCONSENSUS_TPU_DEVICE_MERKLE")
    seen.clear()
    res = connect_block(mutated, coins, HEIGHT, verifier=TorchSecpVerifier(
        device="cpu", engine="python"), pow_limit=B.REGTEST_POW_LIMIT,
        sig_cache=SigCache(), script_cache=ScriptExecutionCache(),
        check_scripts=False, engine="python", device_merkle=True)
    assert (res.ok, res.reason) == (False, "bad-txns-duplicate")
    assert seen == [torch.device("cpu")]


# -- the Python engine's challenges on the device ------------------------------------------


def _graft_checks():
    """The reference test's 24 mixed checks with one Schnorr signature and one
    Schnorr check corrupted (tests/test_ops_sha256.py)."""
    checks = [SigCheck(c.kind, c.data) for c in GE._example_checks(24)]
    for i in (1, 4):
        if checks[i].kind == "schnorr":
            pk, sig, msg = checks[i].data
            bad = bytearray(sig)
            bad[40] ^= 1
            checks[i] = SigCheck("schnorr", (pk, bytes(bad), msg))
    return checks


def test_device_challenge_lanes_and_verdicts_equal_the_host_hash_path():
    checks = _graft_checks()
    assert sum(c.kind == "schnorr" for c in checks) >= 4
    host_v = TorchSecpVerifier(device="cpu", engine="python", device_challenge=False)
    dev_v = TorchSecpVerifier(device="cpu", engine="python", device_challenge=True)
    host_packed = host_v._pack_lanes(host_v._prep_lanes(checks))
    dev_packed = dev_v._pack_lanes(dev_v._prep_lanes(checks))
    for a, b in zip(host_packed, dev_packed, strict=True):
        assert np.array_equal(a, b)
    assert dev_v.stats["challenge_lanes"] == sum(c.kind == "schnorr" for c in checks)
    assert "challenge_lanes" not in host_v.stats
    got_host = host_v.verify_checks(checks)
    got_dev = dev_v.verify_checks(checks)
    assert np.array_equal(got_host, got_dev)
    assert not got_dev[1] or checks[1].kind != "schnorr"
    assert got_dev.sum() >= len(checks) - 2


def test_device_challenge_reads_the_environment(monkeypatch):
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_DEVICE_SHA", "1")
    assert TorchSecpVerifier(device="cpu", engine="python").device_challenge
    assert not TorchSecpVerifier(device="cpu", engine="python",
                                 device_challenge=False).device_challenge
    monkeypatch.setenv("BITCOINCONSENSUS_TPU_DEVICE_SHA", "off")
    assert not TorchSecpVerifier(device="cpu", engine="python").device_challenge


# -- the prover's SHA-256 entries (tens of seconds of tracing) -------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", ["sha256.bip340_challenge", "cuda.sha256.bodies"])
def test_heavy_sha256_registry_entries_prove(name):
    from bitcoinconsensus_tpu_torch.analysis import registry

    rep = registry.get_kernel(name).analyze()
    assert rep.ok, rep.violations[:3]
