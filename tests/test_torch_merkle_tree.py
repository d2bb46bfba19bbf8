"""The port's one-launch merkle tree (`csrc/sha256.cu` `sh_merkle_tree_kernel`,
`ops/sha256.merkle_tree`) and the fixed hash's word assembly, held on the
CPU to the JAX package and to hashlib.

- the tree kernel's schedule (chunk bounds, the tail chunk's self-pairing up
  to the chunk height, the rounds over the chunk roots, the flag rule), run
  sequentially by the `.cu`'s host build (`sh_host_merkle_tree`, g++) at
  chunk sizes 2, 8 and the kernel's 512, for every n from 1 to 1,100, on
  seeded leaves and on leaves drawn from three values (many equal siblings
  and subtrees), against the JAX package's `core.block.merkle_root`: root
  and flag;
- the CVE-2012-2459 flag at each place a duplicate can sit relative to the
  chunks (the first pair, inside a chunk that is not the tail, across two
  chunk roots, in the tail chunk, two equal subtrees), and the places it
  must not fire (an odd tail equal to its neighbour, alone in its chunk or
  inside the tail chunk, and a tail chunk paired with itself up to the
  chunk height);
- the plain `merkle_tree_reference` (also on every flag case), the
  `merkle_tree` wrapper's CPU path, the tree's launch contract and
  `merkle_root_device(device="cpu")` against the same, and the JAX
  package's `merkle_root_device` at 2, 3, 7 and 401 leaves;
- `sh_host_fixed` (16-byte loads where rows are 16-byte aligned, aligned
  words and a byte permute otherwise, the padding built a word at a time)
  against hashlib at every length from 0 to 200, single and double, with
  and without the TapSighash midstate, from buffers 0, 1, 2 and 3 bytes
  past a 16-byte boundary;
- the design alternatives that `ops/sha256_designs.py` times on the card
  still apply to the source.

Every comparison is exact (tolerance 0); inputs come from numpy seeds.
"""

import ctypes
import hashlib

import numpy as np
import pytest
import torch

from bitcoinconsensus_tpu.core import block as JBLK
from bitcoinconsensus_tpu_torch.core import block as BLK
from bitcoinconsensus_tpu_torch.ops import _build
from bitcoinconsensus_tpu_torch.ops import sha256 as SH
from bitcoinconsensus_tpu_torch.ops import sha256_designs
from bitcoinconsensus_tpu_torch.ops.contract import run_contract

torch.set_num_threads(1)

CHUNKS = (2, 8, SH.TREE_CHUNK)
MAX_N = 1100


@pytest.fixture(scope="module")
def host_lib():
    lib = ctypes.CDLL(str(_build.build(_build.SH_HOST).path))
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.sh_host_fixed.argtypes = [p, i64, p, i64, i64, ctypes.c_int, p, i64]
    lib.sh_host_merkle_tree.argtypes = [p, i64, i64, p, p]
    return lib


def _host_tree(lib, leaves: np.ndarray, chunk: int):
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    root = np.zeros(32, np.uint8)
    flag = np.zeros(1, np.int32)
    lib.sh_host_merkle_tree(leaves.ctypes.data, len(leaves), chunk, root.ctypes.data,
                            flag.ctypes.data)
    return root.tobytes(), bool(flag[0])


def _rows(a) -> list:
    return [r.tobytes() for r in np.asarray(a)]


def _pool(kind: str) -> np.ndarray:
    rng = np.random.default_rng(1100)
    if kind == "seeded":
        return rng.integers(0, 256, (MAX_N, 32), dtype=np.uint8)
    values = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    return values[rng.integers(0, 3, MAX_N)]


POOLS = {kind: _pool(kind) for kind in ("seeded", "three_values")}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", list(POOLS))
@pytest.mark.parametrize("first", range(1, MAX_N + 1, 100))
def test_host_tree_equals_the_jax_merkle_root_for_every_n(host_lib, first, kind, chunk):
    """n = first .. first + 99 leaves of the pool: root and flag."""
    pool = POOLS[kind]
    flags = 0
    for n in range(first, first + 100):
        want = JBLK.merkle_root(_rows(pool[:n]))
        assert _host_tree(host_lib, pool[:n], chunk) == want, (n, chunk)
        flags += want[1]
    if kind == "three_values" and first > 1:
        assert flags > 0  # the pool does reach the flag


def _flag_cases(S: int):
    """(name, leaves, flag) at chunk size S: each place a duplicate sibling
    pair can sit relative to the chunks, and three that must not count."""
    rng = np.random.default_rng(S)

    def leaves(n):
        return rng.integers(0, 256, (n, 32), dtype=np.uint8)

    cases = []
    a = leaves(3 * S + 5)
    a[1] = a[0]
    cases.append(("first_pair", a, True))
    a = leaves(3 * S + 5)
    a[S + 2 * (S // 4) + 1] = a[S + 2 * (S // 4)]  # chunk 1 of 4, not the tail
    cases.append(("inside_a_full_chunk", a, True))
    a = leaves(2 * S + 3)
    a[S:2 * S] = a[:S]  # chunk roots 0 and 1 equal, siblings one round up
    cases.append(("across_chunk_roots", a, True))
    a = leaves(3 * S + max(2, S // 2 + 1))  # the last chunk ragged where S > 2
    a[3 * S + 1] = a[3 * S]  # siblings inside the last chunk
    cases.append(("in_the_tail_chunk", a, True))
    a = leaves(3 * S + 5)
    a[4:8] = a[0:4]  # two equal subtrees of four leaves
    cases.append(("equal_subtrees", a, True))
    a = leaves(2 * S + 1)
    a[-1] = a[-2]  # an odd tail, a chunk of its own, equal to its neighbour
    cases.append(("odd_tail_equal", a, False))
    a = leaves(S + 3)
    a[S + 2] = a[S + 1]  # the same inside the tail chunk
    cases.append(("odd_tail_equal_in_the_tail_chunk", a, False))
    a = leaves(S + 1)  # a tail chunk of one leaf, self-paired log2 S times
    cases.append(("self_paired_tail_chunk", a, False))
    return cases


FLAG_CASES = [(S, name) for S in CHUNKS for name, _, _ in _flag_cases(S)]


@pytest.mark.parametrize("chunk,name", FLAG_CASES)
def test_mutated_flag_at_every_place_relative_to_the_chunks(host_lib, chunk, name):
    leaves, flag = next((a, f) for n, a, f in _flag_cases(chunk) if n == name)
    want = JBLK.merkle_root(_rows(leaves))
    assert want[1] == flag
    assert _host_tree(host_lib, leaves, chunk) == want
    root, mutated = SH.merkle_tree_reference(torch.from_numpy(leaves))
    assert (bytes(root.numpy()), bool(mutated.item())) == want


@pytest.mark.parametrize("n", [1, 2, 3, 7, 401, 513])
def test_plain_tree_contract_and_cpu_device_root_equal_the_jax_root(host_lib, n):
    """The `merkle_tree` wrapper's CPU path (the plain version, its root and
    flag in the work bytes), the contract's chunk roots reduced further by
    the plain version, and the CPU `merkle_root_device`."""
    leaves = np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)
    if n > 3:
        leaves[n - 1] = leaves[n - 2]  # the odd tail equal to its neighbour
    t = torch.from_numpy(leaves)
    want = JBLK.merkle_root(_rows(leaves))
    work = torch.zeros(SH.tree_work_bytes(n), dtype=torch.uint8)
    root, flag = SH.merkle_tree(t, work)
    assert (bytes(work[:32].numpy()), bool(work[32:36].view(torch.int32).item())) == want
    assert root.data_ptr() == work.data_ptr() and flag.dtype == torch.int32
    chunk_roots = run_contract(SH.MERKLE_TREE_CONTRACT, t)
    assert chunk_roots.shape == (-(-n // SH.TREE_CHUNK), 32)
    top = chunk_roots[0] if len(chunk_roots) == 1 else \
        SH.merkle_tree_reference(chunk_roots)[0]
    assert bytes(top.numpy()) == want[0]
    assert BLK.merkle_root_device(_rows(leaves), device="cpu") == want
    assert _host_tree(host_lib, leaves, SH.TREE_CHUNK) == want


@pytest.mark.parametrize("n", [2, 3, 7, 401])
def test_host_tree_and_cpu_device_root_equal_the_jax_device_root(host_lib, n):
    # The JAX path runs eagerly on the CPU and compiles each level's shape.
    leaves = np.random.default_rng(7 * n).integers(0, 256, (n, 32), dtype=np.uint8)
    if n == 7:
        leaves[3] = leaves[2]
    want = JBLK.merkle_root_device(_rows(leaves))
    assert want[1] == (n == 7)
    assert BLK.merkle_root_device(_rows(leaves), device="cpu") == want
    assert _host_tree(host_lib, leaves, SH.TREE_CHUNK) == want


def _at_offset(data: np.ndarray, offset: int) -> np.ndarray:
    """data's bytes in a buffer that starts `offset` bytes past a 16-byte
    boundary, with aligned words of slack on both sides."""
    raw = np.zeros(data.size + 64, np.uint8)
    start = (16 - raw.ctypes.data % 16) % 16 + 16 + offset
    view = raw[start:start + data.size].reshape(data.shape)
    view[...] = data
    return view


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("tagged", [False, True])
def test_host_fixed_word_path_equals_hashlib_at_every_length(host_lib, offset, tagged):
    rng = np.random.default_rng(200 + 4 * offset + tagged)
    th = hashlib.sha256(b"TapSighash").digest()
    ms = (SH.tag_midstate("TapSighash") if tagged
          else np.asarray(SH._H0, dtype=np.uint32)).reshape(8, 1).copy()
    n = 3
    for length in range(0, 201):
        data = _at_offset(rng.integers(0, 256, (n, length), dtype=np.uint8), offset)
        if length:
            assert data.ctypes.data % 16 == offset
        want1 = [hashlib.sha256((th + th if tagged else b"") + r).digest()
                 for r in _rows(data)]
        for dbl in (0, 1):
            out = np.zeros((n, 32), np.uint8)
            host_lib.sh_host_fixed(data.ctypes.data, length, ms.ctypes.data, 1,
                                   64 if tagged else 0, dbl, out.ctypes.data, n)
            want = [hashlib.sha256(w).digest() for w in want1] if dbl else want1
            assert _rows(out) == want, (length, dbl)


@pytest.mark.parametrize("name", sorted(sha256_designs.DESIGNS))
def test_each_design_of_the_sha256_source_changes_what_it_names(name):
    """`ops/sha256_designs.py` builds each design from the source as it
    stands: its anchors must still be there, and each design changes only
    what its name says (a design that no longer applies would time the kept
    source twice)."""
    src = sha256_designs.SOURCE.read_text()
    text = sha256_designs.DESIGNS[name](src)
    assert sha256_designs.TREE_BOUNDS in src
    changed = {
        "kept": text == src,
        "fixed_staged": "st[SH_FIXED_THREADS * 20]" in text
        and text.count("sh_fixed_kernel(") == src.count("sh_fixed_kernel("),
        "tree_blocks3": "__launch_bounds__(SH_TREE_THREADS, 3)" in text,
        "tree_blocks4": "__launch_bounds__(SH_TREE_THREADS, 4)" in text,
        "rotate_multiply": text.count("sh_rotm(") == 7,
    }
    assert changed[name]
    assert (text == src) == (name == "kept")
