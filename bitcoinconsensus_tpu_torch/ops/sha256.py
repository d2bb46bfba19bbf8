"""Batched SHA-256 on the card: fixed-layout messages, one lane per message.

The port of `bitcoinconsensus_tpu/ops/sha256.py`, whose functions are XLA
programs the reference fuses into one device program each. Eager PyTorch
would run a compression as some two thousand elementwise launches, so here
each is a hand-written CUDA kernel (`csrc/sha256.cu`, built at first use by
`_build.py`, bound through `launch.py`) with its plain torch version beside
it. The public functions keep the reference's names, layouts and dtypes:

- `sha256_compress(state (8, B) uint32, block (16, B) uint32)`: one
  compression, word-major (lane i's word w at `[w, i]`);
- `sha256_fixed(data (B, L) uint8, midstate=None, prefix_len=0)` and
  `sha256d_fixed`: single and double SHA-256 of static-length messages,
  with an optional midstate (`(8,)` for every lane, or `(8, B)`) that has
  already consumed `prefix_len` bytes; `(B, 32)` uint8 digests;
- `bip340_challenge(r32, px32, m32)`: the BIP340 challenge
  tagged(r ‖ px ‖ m) from three `(B, 32)` uint8 tensors, two compressions a
  lane from `CHALLENGE_MIDSTATE`;
- `merkle_tree(leaves (n, 32) uint8, work=None)`: the whole txid merkle
  tree in one launch, the root and the CVE-2012-2459 flag in `work` (the
  port's own; the reference builds each level from `sha256d_fixed` in
  `core/block.merkle_root_device`);
- `merkle_level(level (n, 32) uint8, mutated (1,) int32)`: one level of that
  tree, `(ceil(n/2), 32)`, the odd tail duplicated, sibling equality ORed
  into `mutated` (on no path: the tree's standalone counterpart);
- `tag_midstate`, `CHALLENGE_MIDSTATE`, and the helpers `_padding`,
  `_words_from_bytes`, `_bytes_from_words`.

Each wrapper follows `verdict_checksum.py`: a CUDA tensor launches the
kernel (a launch that fails raises), counted in the wrapper's plain integer
`launches`; a CPU tensor runs the plain version (`*_reference`). The plain
versions compute in int64 with `& 0xFFFFFFFF` after the adds and shift only
masked, non-negative words: torch's `uint32` has no shifts, adds or `~`.
`_words_from_bytes` therefore returns its words as int64. Each kernel's
launch is declared as a `LaunchContract` (`*_CONTRACT`, `fixed_contract`)
for the prover (`analysis/registry.py`); the merkle level's `mutated` flag,
and the tree's ticket, flag and root, are accumulators outside the
contracts' windows.

Outputs are big-endian digest bytes, equal to hashlib's
(tests/test_torch_sha256.py).
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import launch
from .contract import LaunchContract, Window, cdiv

__all__ = [
    "sha256_compress",
    "sha256_fixed",
    "sha256d_fixed",
    "tag_midstate",
    "bip340_challenge",
    "merkle_level",
    "merkle_tree",
    "tree_work_bytes",
    "CHALLENGE_MIDSTATE",
    "sha256_compress_reference",
    "sha256_fixed_reference",
    "sha256d_fixed_reference",
    "bip340_challenge_reference",
    "merkle_level_reference",
    "merkle_tree_reference",
    "COMPRESS_CONTRACT",
    "CHALLENGE_CONTRACT",
    "MERKLE_LEVEL_CONTRACT",
    "MERKLE_TREE_CONTRACT",
    "fixed_contract",
    "THREADS",
    "FIXED_THREADS",
    "TREE_CHUNK",
]

M32 = 0xFFFFFFFF
THREADS = 256  # csrc/sha256.cu SH_THREADS: one thread per lane
FIXED_THREADS = 64  # SH_FIXED_THREADS: sh_fixed_kernel's blocks
TREE_THREADS = 256  # SH_TREE_THREADS
TREE_CHUNK = 512  # SH_TREE_CHUNK: the leaves a block of the tree reduces
TREE_HEADER = 48  # SH_TREE_HEADER: root (32), flag (4), ticket (4), 8 spare
MAX_LANES = (1 << 31) - 1  # csrc/sha256.cu SH_MAX_LANES

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)


# -- host constants ------------------------------------------------------------

def _py_rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def _py_compress(state: Sequence[int], block: bytes) -> List[int]:
    """One compression on Python ints (the host constants only)."""
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _py_rotr(w[i - 15], 7) ^ _py_rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _py_rotr(w[i - 2], 17) ^ _py_rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _py_rotr(e, 6) ^ _py_rotr(e, 11) ^ _py_rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        t1 = (h + S1 + ch + _K[i] + w[i]) & M32
        S0 = _py_rotr(a, 2) ^ _py_rotr(a, 13) ^ _py_rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + S0 + maj) & M32
    return [(x + y) & M32 for x, y in zip((a, b, c, d, e, f, g, h), state)]


def tag_midstate(tag: str) -> np.ndarray:
    """(8,) uint32 chaining state after SHA256(tag) ‖ SHA256(tag): the
    64-byte prefix every BIP340 tagged hash starts with (hash.cpp:89-96;
    the hardcoded equivalents at schnorrsig/main_impl.h:16-44)."""
    th = hashlib.sha256(tag.encode()).digest()
    return np.array(_py_compress(_H0, th + th), dtype=np.uint32)


CHALLENGE_MIDSTATE = tag_midstate("BIP0340/challenge")


def _padding(total_len: int) -> bytes:
    """Static SHA-256 padding for a hashed stream (any midstate-consumed
    prefix included) totalling `total_len` bytes."""
    pad = b"\x80" + b"\x00" * ((55 - total_len) % 64)
    return pad + struct.pack(">Q", total_len * 8)


# -- plain versions ------------------------------------------------------------

def _rotr(x, n: int):
    # x holds a word in [0, 2^32): both shifts see a non-negative value.
    return ((x >> n) | (x << (32 - n))) & M32


def _compress64(state, w):
    """One compression over int64 words: `state` 8 and `w` 16 tensors (or
    Python ints) holding values in [0, 2^32); returns the 8 new words."""
    w = list(w)
    for i in range(16, 64):
        x, y = w[i - 15], w[i - 2]
        s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
        s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)  # ~e is negative; & g keeps g's bits only
        t1 = (h + S1 + ch + _K[i] + w[i]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + S0 + maj) & M32)
    return [(x + y) & M32 for x, y in zip((a, b, c, d, e, f, g, h), state)]


def _words_from_bytes(data: torch.Tensor) -> torch.Tensor:
    """(..., 4k) uint8 -> (k, ...) big-endian words (word-major), as int64
    holding uint32 values."""
    u = data.to(torch.int64)
    w = (u[..., 0::4] << 24) | (u[..., 1::4] << 16) | (u[..., 2::4] << 8) | u[..., 3::4]
    return w.movedim(-1, 0)


def _bytes_from_words(words: torch.Tensor) -> torch.Tensor:
    """(8, ...) words (uint32, or int64 in [0, 2^32)) -> (..., 32) uint8
    big-endian digest bytes."""
    w = words.to(torch.int64).movedim(0, -1)  # (..., 8)
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=w.device)
    b = (w.unsqueeze(-1) >> shifts) & 0xFF
    return b.reshape(b.shape[:-2] + (32,)).to(torch.uint8)


def _initial_state(midstate, like: torch.Tensor) -> list:
    """The chaining words a hash starts from, as 8 int64 tensors of `like`'s
    shape (a word of the message): H0, an (8,) midstate for every lane, or
    an (8, ...) per-lane one."""
    if midstate is None:
        midstate = _H0
    if not isinstance(midstate, torch.Tensor):
        midstate = torch.from_numpy(np.asarray(midstate, dtype=np.int64))
    ms = midstate.to(device=like.device, dtype=torch.int64)
    zero = torch.zeros_like(like)
    return [zero + ms[i] for i in range(8)]


def sha256_compress_reference(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Plain version of `sha256_compress`: (8, ...) and (16, ...) uint32
    words -> the (8, ...) uint32 state after one compression."""
    s = state.to(torch.int64)
    m = block.to(torch.int64)
    out = _compress64([s[i] for i in range(8)], [m[i] for i in range(16)])
    return torch.stack(out).to(torch.uint32)


def sha256_fixed_reference(data: torch.Tensor, midstate=None,
                           prefix_len: int = 0) -> torch.Tensor:
    """Plain version of `sha256_fixed`: (..., L) uint8 -> (..., 32) uint8."""
    L = data.shape[-1]
    if prefix_len % 64:
        raise ValueError("prefix_len must be a multiple of 64")
    pad = _padding(prefix_len + L)
    batch = tuple(data.shape[:-1])
    padv = torch.tensor(list(pad), dtype=torch.uint8, device=data.device)
    stream = torch.cat([data, padv.expand(batch + (len(pad),))], dim=-1)
    words = _words_from_bytes(stream)
    state = _initial_state(midstate, words[0])
    for blk in range(stream.shape[-1] // 64):
        state = _compress64(state, [words[16 * blk + j] for j in range(16)])
    return _bytes_from_words(torch.stack(state))


def sha256d_fixed_reference(data: torch.Tensor, midstate=None,
                            prefix_len: int = 0) -> torch.Tensor:
    """Plain version of `sha256d_fixed` (CHash256, hash.h:24)."""
    return sha256_fixed_reference(sha256_fixed_reference(data, midstate, prefix_len))


def bip340_challenge_reference(r32: torch.Tensor, px32: torch.Tensor,
                               m32: torch.Tensor) -> torch.Tensor:
    """Plain version of `bip340_challenge`."""
    payload = torch.cat([r32, px32, m32], dim=-1)
    return sha256_fixed_reference(payload, midstate=CHALLENGE_MIDSTATE, prefix_len=64)


def _pair_digests(level: torch.Tensor) -> torch.Tensor:
    """sha256d of each pair of rows of (n, 32), the odd tail duplicated."""
    if level.shape[0] & 1:
        level = torch.cat([level, level[-1:]], dim=0)
    return sha256d_fixed_reference(level.reshape(level.shape[0] // 2, 64))


def merkle_level_reference(level: torch.Tensor, mutated: torch.Tensor) -> torch.Tensor:
    """Plain version of `merkle_level`. Sibling equality is taken over the
    first `n & ~1` rows, before the odd tail is duplicated
    (consensus/merkle.cpp:45-64), and ORed into `mutated` in place."""
    n = level.shape[0]
    even = n & ~1
    if even:
        eq = (level[0:even:2] == level[1:even:2]).all(dim=1).any()
        mutated.bitwise_or_(eq.to(torch.int32))
    return _pair_digests(level)


def merkle_tree_reference(leaves: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `merkle_tree`: the level loop of
    `merkle_level_reference` over (n >= 1, 32) leaves; (root (32,) uint8,
    mutated (1,) int32)."""
    mutated = torch.zeros(1, dtype=torch.int32, device=leaves.device)
    level = leaves
    while level.shape[0] > 1:
        level = merkle_level_reference(level, mutated)
    return level[0], mutated


def _chunk_root(rows: torch.Tensor, height: Optional[int]) -> torch.Tensor:
    """A chunk's root as the tree kernel's block computes it: levels of
    `_pair_digests` until one node is left, or `height` levels (a tail
    chunk's last node paired with itself until then)."""
    level = rows
    levels = 0
    while (level.shape[0] > 1) if height is None else (levels < height):
        level = _pair_digests(level)
        levels += 1
    return level


# -- launch contracts ------------------------------------------------------------

def _compress_body(block, state, words):
    return sha256_compress_reference(state, words)


# One thread per lane: block b reads lanes [256 b, 256 b + 256) of every word
# row and writes the same columns of the (8, B) state.
COMPRESS_CONTRACT = LaunchContract(
    "sha256_compress",
    grid=lambda s, m: (cdiv(s[1], THREADS),),
    threads=THREADS,
    ins=(Window((8, THREADS), lambda b: (0, THREADS * b[0])),
         Window((16, THREADS), lambda b: (0, THREADS * b[0]))),
    outs=(Window((8, THREADS), lambda b: (0, THREADS * b[0])),),
    out_arrays=lambda s, m: ((tuple(s), torch.uint32),),
    body=_compress_body,
    masked_edge=True,
)


def fixed_contract(length: int, double: bool = False) -> LaunchContract:
    """The launch of `sh_fixed_kernel` for messages of `length` bytes and one
    midstate for every lane, in blocks of 64 lanes: lane i reads row i of
    the (B, L) bytes and the (8, 1) midstate column and writes row i of the
    (B, 32) digests. (A per-lane midstate reads column i of (8, B) instead;
    a row that does not start 16-byte aligned is read in the aligned 4-byte
    words that hold it, beyond the window by at most 3 bytes at each end.)"""
    def body(block, data, ms):
        one = sha256_fixed_reference(data, midstate=ms)
        return sha256_fixed_reference(one) if double else one

    T = FIXED_THREADS
    return LaunchContract(
        f"sha256_fixed[{length}]",
        grid=lambda d, ms: (cdiv(d[0], T),),
        threads=T,
        ins=(Window((T, length), lambda b: (T * b[0], 0)),
             Window((8, 1), lambda b: (0, 0))),
        outs=(Window((T, 32), lambda b: (T * b[0], 0)),),
        out_arrays=lambda d, ms: (((d[0], 32), torch.uint8),),
        body=body,
        masked_edge=True,
    )


def _challenge_body(block, r32, px32, m32):
    return bip340_challenge_reference(r32, px32, m32)


_ROWS = Window((THREADS, 32), lambda b: (THREADS * b[0], 0))
CHALLENGE_CONTRACT = LaunchContract(
    "bip340_challenge",
    grid=lambda r, p, m: (cdiv(r[0], THREADS),),
    threads=THREADS,
    ins=(_ROWS, _ROWS, _ROWS),
    outs=(_ROWS,),
    out_arrays=lambda r, p, m: (((r[0], 32), torch.uint8),),
    body=_challenge_body,
    masked_edge=True,
)


def _merkle_body(block, rows):
    return _pair_digests(rows)


# Lane j hashes rows 2j and 2j + 1 (row 2j twice at an odd tail): block b
# reads rows [512 b, 512 b + 512) and writes output rows [256 b, 256 b + 256).
# The `mutated` flag is one int32 the kernel ORs into with atomicOr, from
# every block and every level: an accumulator, not a window.
MERKLE_LEVEL_CONTRACT = LaunchContract(
    "merkle_level",
    grid=lambda x: (cdiv(cdiv(x[0], 2), THREADS),),
    threads=THREADS,
    ins=(Window((2 * THREADS, 32), lambda b: (2 * THREADS * b[0], 0)),),
    outs=(_ROWS,),
    out_arrays=lambda x: (((cdiv(x[0], 2), 32), torch.uint8),),
    body=_merkle_body,
    masked_edge=True,
)


def _tree_body(block, rows):
    # Chunk 0 reduces to its root (it is full, or the only chunk); any later
    # chunk to the chunk's height, its tail paired with itself until then.
    height = None if block[0] == 0 else TREE_CHUNK.bit_length() - 1
    return _chunk_root(rows, height)


# Block b reads leaf rows [512 b, 512 b + 512) and writes chunk-root row b
# (the work rows after the header). The ticket, the flag and the root are
# accumulators outside the windows: every block adds to the ticket and ORs
# into the flag, and the block that draws the last ticket reduces the chunk
# roots (in rounds of 512) and writes the root.
MERKLE_TREE_CONTRACT = LaunchContract(
    "merkle_tree",
    grid=lambda x: (cdiv(x[0], TREE_CHUNK),),
    threads=TREE_THREADS,
    ins=(Window((TREE_CHUNK, 32), lambda b: (TREE_CHUNK * b[0], 0)),),
    outs=(Window((1, 32), lambda b: (b[0], 0)),),
    out_arrays=lambda x: (((cdiv(x[0], TREE_CHUNK), 32), torch.uint8),),
    body=_tree_body,
    masked_edge=True,
)


# -- wrappers ----------------------------------------------------------------------

def _on_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {t.device}")


def _need(t: torch.Tensor, dtype: torch.dtype, what: str, device) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


def _lanes(n: int) -> int:
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes: the kernels take at most {MAX_LANES}")
    return n


_ms_lock = threading.Lock()
_ms_cache: Dict[Tuple[str, bytes], torch.Tensor] = {}


def _midstate_words(midstate, device, lanes: int) -> Tuple[torch.Tensor, int]:
    """The midstate as uint32 words on `device` and its column count: (8, 1)
    for every lane (cached per device and value), or (8, lanes)."""
    if midstate is None:
        midstate = np.asarray(_H0, dtype=np.uint32)
    if isinstance(midstate, torch.Tensor) and midstate.dim() > 1:
        ms = midstate.reshape(8, -1)
        if ms.shape[1] != lanes:
            raise ValueError(f"a per-lane midstate has {ms.shape[1]} columns "
                             f"for {lanes} lanes")
        return ms.to(device=device, dtype=torch.uint32).contiguous(), lanes
    arr = np.asarray(midstate.cpu() if isinstance(midstate, torch.Tensor) else midstate)
    if arr.ndim > 1:
        arr = arr.reshape(8, -1)
        if arr.shape[1] != lanes:
            raise ValueError(f"a per-lane midstate has {arr.shape[1]} columns "
                             f"for {lanes} lanes")
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint32))
        return t.to(device), lanes
    arr = np.ascontiguousarray(arr, dtype=np.uint32).reshape(8)
    key = (str(device), arr.tobytes())
    with _ms_lock:
        t = _ms_cache.get(key)
        if t is None:
            t = _ms_cache[key] = torch.from_numpy(arr.reshape(8, 1).copy()).to(device)
    return t, 1


def sha256_compress(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression: state (8, ...) and block (16, ...) uint32 big-endian
    words -> the new (8, ...) uint32 state. CUDA tensors run
    `sh_compress_kernel` (or raise); CPU tensors the plain version."""
    if not state.is_cuda:
        _on_cpu(state, "sha256_compress")
        return sha256_compress_reference(state, block)
    _need(state, torch.uint32, "state", state.device)
    _need(block, torch.uint32, "block", state.device)
    if state.shape[0] != 8 or tuple(block.shape) != (16,) + tuple(state.shape[1:]):
        raise ValueError(f"state (8, ...) and block (16, ...) must share their "
                         f"lanes, got {tuple(state.shape)} and {tuple(block.shape)}")
    B = _lanes(state.numel() // 8)
    out = torch.empty_like(state)
    if B:
        fn = launch.bind("sha256", "sh_compress")
        launch.call(fn, state.get_device(), state.data_ptr(), block.data_ptr(),
                    out.data_ptr(), B, cdiv(B, THREADS), THREADS)
        sha256_compress.launches += 1
    return out


def _fixed(data: torch.Tensor, midstate, prefix_len: int, double: bool) -> torch.Tensor:
    if prefix_len < 0 or prefix_len % 64:
        raise ValueError("prefix_len must be a non-negative multiple of 64")
    _need(data, torch.uint8, "data", data.device)
    L = data.shape[-1]
    batch = tuple(data.shape[:-1])
    B = _lanes(int(np.prod(batch, dtype=np.int64)))
    out = torch.empty(batch + (32,), dtype=torch.uint8, device=data.device)
    if B:
        ms, ms_cols = _midstate_words(midstate, data.device, B)
        fn = launch.bind("sha256", "sh_fixed")
        launch.call(fn, data.get_device(), data.data_ptr(), L, ms.data_ptr(),
                    ms_cols, prefix_len, int(double), out.data_ptr(), B,
                    cdiv(B, FIXED_THREADS), FIXED_THREADS)
        sha256_fixed.launches += 1
    return out


def sha256_fixed(data: torch.Tensor, midstate=None, prefix_len: int = 0) -> torch.Tensor:
    """Batched SHA-256 of fixed-length messages: data (..., L) uint8 with a
    static L; `midstate` an optional (8,) or (8, ...) uint32 chaining state
    that already consumed `prefix_len` bytes (a multiple of 64). Returns
    (..., 32) uint8 digests. CUDA tensors run `sh_fixed_kernel` (or raise),
    which reads 16-byte aligned rows in 16-byte loads and any other layout,
    a view at an odd address included, in aligned 4-byte words; CPU tensors
    the plain version."""
    if not data.is_cuda:
        _on_cpu(data, "sha256_fixed")
        return sha256_fixed_reference(data, midstate, prefix_len)
    return _fixed(data, midstate, prefix_len, double=False)


def sha256d_fixed(data: torch.Tensor, midstate=None, prefix_len: int = 0) -> torch.Tensor:
    """Double SHA-256 (CHash256, hash.h:24) of fixed-length messages: on a
    card one launch of `sh_fixed_kernel`, whose second pass hashes each
    32-byte digest in one block (counted in `sha256_fixed.launches`)."""
    if not data.is_cuda:
        _on_cpu(data, "sha256d_fixed")
        return sha256d_fixed_reference(data, midstate, prefix_len)
    return _fixed(data, midstate, prefix_len, double=True)


def bip340_challenge(r32: torch.Tensor, px32: torch.Tensor, m32: torch.Tensor) -> torch.Tensor:
    """Batched BIP340 challenge tagged(r.x ‖ pk.x ‖ m): three (..., 32)
    uint8 tensors -> (..., 32) uint8 digests; the midstate skips the tag
    block, two compressions a lane (schnorrsig/main_impl.h:111-125). CUDA
    tensors run `sh_challenge_kernel`, which reads the three tensors in
    place (or raise); CPU tensors the plain version."""
    if not r32.is_cuda:
        _on_cpu(r32, "bip340_challenge")
        return bip340_challenge_reference(r32, px32, m32)
    for name, t in (("r32", r32), ("px32", px32), ("m32", m32)):
        _need(t, torch.uint8, name, r32.device)
        if t.shape != r32.shape or t.shape[-1] != 32:
            raise ValueError(f"{name} must be (..., 32) like r32, got {tuple(t.shape)}")
    B = _lanes(r32.numel() // 32)
    out = torch.empty(r32.shape, dtype=torch.uint8, device=r32.device)
    if B:
        fn = launch.bind("sha256", "sh_challenge")
        launch.call(fn, r32.get_device(), r32.data_ptr(), px32.data_ptr(),
                    m32.data_ptr(), out.data_ptr(), B, cdiv(B, THREADS), THREADS)
        bip340_challenge.launches += 1
    return out


def merkle_level(level: torch.Tensor, mutated: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One level of the merkle tree: (n, 32) uint8 hashes, n >= 1 -> the
    (ceil(n/2), 32) uint8 sha256d of each pair, the odd tail paired with
    itself; `mutated`, a (1,) int32 tensor on the same device, gets 1 ORed
    in when two siblings of the first `n & ~1` rows are equal. On a card
    `out` may name where the level goes (a contiguous (ceil(n/2), 32) uint8
    tensor, 4-byte aligned). CUDA tensors run `sh_merkle_level_kernel` (or
    raise); CPU tensors the plain version."""
    if not level.is_cuda:
        _on_cpu(level, "merkle_level")
        got = merkle_level_reference(level, mutated)
        if out is None:
            return got
        out.copy_(got)
        return out
    _need(level, torch.uint8, "level", level.device)
    _need(mutated, torch.int32, "mutated", level.device)
    n = level.shape[0]
    if level.dim() != 2 or level.shape[1] != 32 or n < 1 or mutated.numel() != 1:
        raise ValueError(f"level must be (n >= 1, 32) and mutated (1,), got "
                         f"{tuple(level.shape)} and {tuple(mutated.shape)}")
    m = _lanes(cdiv(n, 2))
    if out is None:
        out = torch.empty((m, 32), dtype=torch.uint8, device=level.device)
    else:
        _need(out, torch.uint8, "out", level.device)
        if tuple(out.shape) != (m, 32) or out.data_ptr() % 4:
            raise ValueError(f"out must be ({m}, 32) and 4-byte aligned")
    fn = launch.bind("sha256", "sh_merkle_level")
    launch.call(fn, level.get_device(), level.data_ptr(), n, out.data_ptr(),
                mutated.data_ptr(), cdiv(m, THREADS), THREADS)
    merkle_level.launches += 1
    return out


def tree_work_bytes(n: int) -> int:
    """Bytes of `merkle_tree`'s work buffer for n leaves: the root, the flag,
    the ticket and 8 spare bytes, then a 32-byte row a chunk."""
    return TREE_HEADER + 32 * cdiv(n, TREE_CHUNK)


def merkle_tree(leaves: torch.Tensor, work: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole merkle tree of (n >= 1, 32) uint8 leaves: (root (32,) uint8,
    mutated (1,) int32), views of `work` (a zeroed, contiguous uint8 tensor
    of at least `tree_work_bytes(n)` bytes on the leaves' device, made here
    when None): bytes [0, 32) the root, [32, 36) the flag. `mutated` is 1
    when two siblings of a level's first `n_l & ~1` nodes are equal (ORed
    in: the kernel sets the ticket back to 0, so `work` serves another
    launch, whose flag is then the OR of both). CUDA
    tensors run `sh_merkle_tree_kernel`, one launch (or raise; leaves and
    work 16-byte aligned); CPU tensors the plain version, whose result is
    written into `work` the same way."""
    n = leaves.shape[0]
    if leaves.dim() != 2 or leaves.shape[1] != 32 or n < 1:
        raise ValueError(f"leaves must be (n >= 1, 32), got {tuple(leaves.shape)}")
    if work is None:
        work = torch.zeros(tree_work_bytes(n), dtype=torch.uint8, device=leaves.device)
    root, flag = work[:32], work[32:36].view(torch.int32)
    if not leaves.is_cuda:
        _on_cpu(leaves, "merkle_tree")
        got, mutated = merkle_tree_reference(leaves)
        root.copy_(got)
        flag.copy_(mutated)
        return root, flag
    _need(leaves, torch.uint8, "leaves", leaves.device)
    _need(work, torch.uint8, "work", leaves.device)
    if work.numel() < tree_work_bytes(n) or (leaves.data_ptr() | work.data_ptr()) % 16:
        raise ValueError(f"work must hold {tree_work_bytes(n)} bytes, and work "
                         "and leaves must be 16-byte aligned")
    fn = launch.bind("sha256", "sh_merkle_tree")
    launch.call(fn, leaves.get_device(), leaves.data_ptr(), _lanes(n), work.data_ptr(),
                cdiv(n, TREE_CHUNK), TREE_THREADS)
    merkle_tree.launches += 1
    return root, flag


sha256_compress.launches = 0
sha256_fixed.launches = 0
bip340_challenge.launches = 0
merkle_level.launches = 0
merkle_tree.launches = 0

# The five wrappers, by the kernel each launches (chip_smoke and the tests
# set and read their counts together).
WRAPPERS = {
    "sh_compress_kernel": sha256_compress,
    "sh_fixed_kernel": sha256_fixed,
    "sh_challenge_kernel": bip340_challenge,
    "sh_merkle_level_kernel": merkle_level,
    "sh_merkle_tree_kernel": merkle_tree,
}
