"""Design alternatives of `csrc/sha256.cu`, built side by side and timed in
turns on the card:

    python -m bitcoinconsensus_tpu_torch.ops.sha256_designs

Each design is the source with one change, compiled by nvcc with
`ops/_build.py`'s flags into `build/torch_kernels/designs/`:

- `kept`: the source as it stands;
- `fixed_staged`: `sh_fixed_kernel` stages its block's rows through shared
  memory in coalesced 16-byte loads, one 64-byte message block of every
  row at a time (a row at an 80-byte stride), where rows start 16-byte
  aligned; `kept` has each lane read its own row in 16-byte loads;
- `tree_blocks3`, `tree_blocks4`: `sh_merkle_tree_kernel` held to three or
  four blocks an SM (`__launch_bounds__`), `kept` to two;
- `rotate_multiply`: the rotations of the compression's Σ0 and Σ1 as a
  multiply and a multiply-high by 2^(32-n), which could move them off the
  integer pipe onto the multiplier.

Printed: the card, each design's registers, stack and spills (ptxas), the
static instruction mix of the kept kernels (cuobjdump), and for each case
the designs' ms a call by CUDA events and a launch's device ms by
torch.profiler (a warm-up step thrown away), the designs in turns (in
order, then reversed). Every design's output must equal `kept`'s, and
`kept`'s hashlib or the host `merkle_root`; the exit code is 1 where one
differs. Needs a card and nvcc; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import _build

SOURCE = _build.CSRC / "sha256.cu"
OUT = _build.BUILD_DIR / "designs"
TREE_BOUNDS = "__launch_bounds__(SH_TREE_THREADS, 2)"

_STAGED = r'''
__global__ void __launch_bounds__(SH_FIXED_THREADS)
    sh_fixed_kernel(const uint8_t* __restrict__ data, int64_t len,
                    const uint32_t* __restrict__ ms, int64_t ms_cols,
                    int64_t prefix_len, int dbl, uint8_t* __restrict__ out,
                    int64_t n) {
  __shared__ __align__(16) uint32_t st[SH_FIXED_THREADS * 20];
  const int64_t row0 = (int64_t)blockIdx.x * SH_FIXED_THREADS;
  const int64_t i = row0 + threadIdx.x;
  const int64_t col = ms_cols == 1 ? 0 : i;
  uint32_t s[8];
  if (i < n) {
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w] = ms[w * ms_cols + col];
  }
  if ((((uintptr_t)data | (uintptr_t)len) & 15) != 0) {
    if (i >= n) return;
    sh_fixed_lane(s, data + i * len, len, prefix_len, dbl, 0);
  } else {
    const int rows = n - row0 < SH_FIXED_THREADS ? (int)(n - row0) : SH_FIXED_THREADS;
    const uint64_t bits = (uint64_t)(prefix_len + len) * 8u;
    const int64_t blocks = (len + 72) / 64;
    for (int64_t blk = 0; blk < blocks; ++blk) {
      const int64_t left = len - 64 * blk;
      const int q0 = left > 64 ? 68 : (int)left;
      for (int e = threadIdx.x; e < 4 * rows; e += SH_FIXED_THREADS) {
        const int r = e >> 2, c = e & 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (16 * c < q0) v = __ldg((const uint4*)(data + (row0 + r) * len + 64 * blk + 16 * c));
        *(uint4*)(st + 20 * r + 4 * c) = v;
      }
      __syncthreads();
      if (i < n) {
        uint32_t m[16];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 v = *(const uint4*)(st + 20 * threadIdx.x + 4 * c);
          m[4 * c] = sh_bswap(v.x), m[4 * c + 1] = sh_bswap(v.y);
          m[4 * c + 2] = sh_bswap(v.z), m[4 * c + 3] = sh_bswap(v.w);
        }
        const int last = blk == blocks - 1;
#pragma unroll
        for (int j = 0; j < 16; ++j) m[j] = sh_pad_word(m[j], q0 - 4 * j, last, j, bits);
        sh_compress(s, m);
      }
      __syncthreads();
    }
    if (i >= n) return;
    if (dbl) sh_rehash32(s);
  }
  uint4* o = (uint4*)(out + i * 32);
  o[0] = make_uint4(sh_bswap(s[0]), sh_bswap(s[1]), sh_bswap(s[2]), sh_bswap(s[3]));
  o[1] = make_uint4(sh_bswap(s[4]), sh_bswap(s[5]), sh_bswap(s[6]), sh_bswap(s[7]));
}

'''

_ROTATE_MULTIPLY = r'''
SH_FN uint32_t sh_rotm(uint32_t x, int n) {
  const uint32_t p = 1u << (32 - n);
  uint32_t lo, r;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(lo) : "r"(x), "r"(p));
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(p), "r"(lo));
  return r;
}

'''


def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"sha256_designs: {old[:60]!r} is not in {SOURCE.name}")
    return text.replace(old, new)


def _staged(text: str) -> str:
    start = text.index("// `out` rows are 16-byte aligned (the wrapper's own allocation).")
    end = text.index("__global__ void __launch_bounds__(SH_THREADS)\n    sh_challenge_kernel")
    return text[:start] + _STAGED + text[end:]


def _rotate_multiply(text: str) -> str:
    text = _swap(text, "// One compression: s (8 words)", _ROTATE_MULTIPLY + "// One compression: s (8 words)")
    for sigma in ("sh_rotr(e, 6) ^ sh_rotr(e, 11) ^ sh_rotr(e, 25)",
                  "sh_rotr(a, 2) ^ sh_rotr(a, 13) ^ sh_rotr(a, 22)"):
        text = _swap(text, sigma, sigma.replace("sh_rotr", "sh_rotm"))
    return text


DESIGNS = {
    "kept": lambda t: t,
    "fixed_staged": _staged,
    "tree_blocks3": lambda t: _swap(t, TREE_BOUNDS, "__launch_bounds__(SH_TREE_THREADS, 3)"),
    "tree_blocks4": lambda t: _swap(t, TREE_BOUNDS, "__launch_bounds__(SH_TREE_THREADS, 4)"),
    "rotate_multiply": _rotate_multiply,
}


def _build_design(name: str):
    """(name, library path, ptxas log, SASS text) of one design."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"sha256_{name}.cu"
    src.write_text(DESIGNS[name](SOURCE.read_text()))
    lib = OUT / f"sha256_{name}.so"
    nvcc = _build._nvcc()
    p = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {src} (rc={p.returncode}):\n{p.stderr[-4000:]}")
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    return name, lib, p.stderr, sass


def _ptxas(log: str) -> dict:
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?_kernel)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and cur is not None:
            cur["stack"], cur["spill_stores"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def _mix(sass: str) -> dict:
    """Static SASS opcode counts by kernel (the opcode before its first dot)."""
    mix, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : _Z\d+(\w+?_kernel)", line)
        if m:
            cur = mix.setdefault(m.group(1), {})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m and cur is not None:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return mix


def _line(**kv) -> None:
    print("[designs] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..core.block import merkle_root

    if not torch.cuda.is_available():
        print("sha256_designs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none",
          flush=True)
    with ThreadPoolExecutor(len(DESIGNS)) as ex:
        built = list(ex.map(_build_design, DESIGNS))
    libs = {}
    for name, path, log, sass in built:
        _line(design=name, ptxas=json.dumps(_ptxas(log), sort_keys=True))
        if name == "kept":
            for kernel, ops in sorted(_mix(sass).items()):
                top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:8])
                _line(kernel=kernel, static_ops=sum(ops.values()), mix=json.dumps(top))
        lib = ctypes.CDLL(str(path))
        for sym in ("sh_fixed", "sh_merkle_tree", "sh_compress"):
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    words = (ctypes.c_int64 * 16)()

    def call(fn, *args):
        words[:len(args)] = args
        words[len(args)] = torch.cuda.current_stream().cuda_stream
        err = fn(words)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")

    def events_ms(fn, reps):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps, kernel):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total = count = 0
        for e in got[-1] if got else ():
            if getattr(e, "device_type", None) == DeviceType.CUDA and kernel in e.key:
                total += e.self_device_time_total
                count += e.count
        return total / count / 1e3 if count else None

    h0 = torch.tensor([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
                       0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=torch.int64)
    h0 = h0.to(torch.uint32).view(8, 1).to(dev)
    cases = []  # (label, kernel, designs, run(lib), output, want bytes or None, reps)
    for n in (2, 401, 4097, 262144):
        host = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        leaves = torch.from_numpy(host).to(dev)
        work = torch.zeros(48 + 32 * -(-n // 512), dtype=torch.uint8, device=dev)
        cases.append((
            f"tree@{n}", "sh_merkle_tree_kernel", ("kept", "tree_blocks3", "tree_blocks4"),
            lambda lib, leaves=leaves, work=work, n=n: call(
                lib.sh_merkle_tree, leaves.data_ptr(), n, work.data_ptr(), -(-n // 512), 256),
            lambda work=work: bytes(work[:36].cpu().numpy()),
            merkle_root([r.tobytes() for r in host])[0], 200 if n < 10000 else 50))
    for n in (8192, 262144):
        host = rng.integers(0, 256, (n, 64), dtype=np.uint8)
        data = torch.from_numpy(host).to(dev)
        out = torch.zeros((n, 32), dtype=torch.uint8, device=dev)
        sample = (0, n // 2, n - 1)
        want = b"".join(hashlib.sha256(hashlib.sha256(host[i].tobytes()).digest()).digest()
                        for i in sample)
        cases.append((
            f"fixed@{n}", "sh_fixed_kernel", ("kept", "fixed_staged", "rotate_multiply"),
            lambda lib, data=data, out=out, n=n: call(
                lib.sh_fixed, data.data_ptr(), 64, h0.data_ptr(), 1, 0, 1, out.data_ptr(), n,
                -(-n // 64), 64),
            lambda out=out: bytes(out.cpu().numpy()),
            (want, sample), 200))
    n = 262144
    state = torch.from_numpy(rng.integers(0, 1 << 32, (8, n), dtype=np.uint32)).to(dev)
    block = torch.from_numpy(rng.integers(0, 1 << 32, (16, n), dtype=np.uint32)).to(dev)
    cout = torch.zeros((8, n), dtype=torch.uint32, device=dev)
    cases.append((
        f"compress@{n}", "sh_compress_kernel", ("kept", "rotate_multiply"),
        lambda lib: call(lib.sh_compress, state.data_ptr(), block.data_ptr(),
                         cout.data_ptr(), n, n // 256, 256),
        lambda: bytes(cout.cpu().numpy()), None, 200))

    bad = 0
    for label, kernel, names, run, output, want, reps in cases:
        got, ev, dv = {}, {}, {}
        for order in (names, names[::-1]):
            for name in order:
                fn = lambda lib=libs[name]: run(lib)  # noqa: E731
                fn()
                torch.cuda.synchronize()
                got.setdefault(name, output())
                ev.setdefault(name, []).append(events_ms(fn, reps))
                dv.setdefault(name, []).append(device_ms(fn, reps, kernel))
        same = all(got[name] == got["kept"] for name in names)
        if isinstance(want, tuple):  # the fixed hash: hashlib on sampled rows
            digests, rows = want
            right = b"".join(got["kept"][32 * i:32 * i + 32] for i in rows) == digests
        else:
            right = want is None or got["kept"][:32] == want
        bad += not (same and right)
        for name in names:
            _line(case=label, design=name, equal=same and right,
                  events_ms=json.dumps([round(x, 5) for x in ev[name]]),
                  device_ms=json.dumps([x if x is None else round(x, 6) for x in dv[name]]))
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
