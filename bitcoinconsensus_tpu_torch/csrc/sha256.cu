// Batched SHA-256, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the reference's device SHA-256, XLA programs (not Pallas
// kernels) that its Python paths fuse one each:
//
//   sh_compress_kernel      bitcoinconsensus_tpu/ops/sha256.py:80
//                           sha256_compress: one compression, word-major
//                           (8, B) and (16, B) uint32 -> (8, B)
//   sh_fixed_kernel         ops/sha256.py:130 and :164, sha256_fixed and
//                           sha256d_fixed: (B, L) bytes -> (B, 32) digests,
//                           an optional midstate, single or double
//   sh_challenge_kernel     ops/sha256.py:206 bip340_challenge: tagged(r ‖
//                           px ‖ m) from three (B, 32) tensors, two
//                           compressions from the challenge midstate
//   sh_merkle_level_kernel  bitcoinconsensus_tpu/core/block.py:158
//                           merkle_root_device, one level: (n, 32) ->
//                           (ceil(n/2), 32) and the CVE-2012-2459 flag
//
// Design: one thread per lane, 256 lanes a block, nothing shared between
// lanes. Lane i of a word-major tensor reads word w at w*B + i, so the loads
// of a warp coalesce; a lane of a row-major (B, L) tensor reads its own row
// byte by byte. The compression keeps its 16 schedule words in registers
// (the 64 rounds unrolled, so every index is a constant) and rotates with
// __funnelshift_r; digests leave as big-endian words through __byte_perm.
// sh_fixed_kernel derives the padding from prefix_len + L as it reads
// (`sh_stream_byte`), so the host builds no padded copy; its `dbl` flag
// hashes the 32-byte digest again in one block (sha256d_fixed).
// sh_merkle_level_kernel hashes each pair with three compressions (the
// 64-byte pair, its constant padding block, the digest), pairs the odd tail
// with itself, and ORs sibling equality over the first n & ~1 rows into one
// device int32 (__syncthreads_or, then one atomicOr a block): the equality
// is taken before the duplication (consensus/merkle.cpp:45-64), so the
// synthetic last pair never counts as a mutation.
//
// Bound on this card. A compression needs at least 1,384 32-bit
// instructions: 48 schedule words of 10 (two funnel shifts and a shift, one
// three-way xor as a LOP3, two three-input adds as IADD3s) and 64 rounds of
// 14 (six funnel shifts, one LOP3 each for Σ1, Σ0, ch and maj, four IADD3s),
// plus the 8 final adds; a padding-only block has a constant schedule and
// needs only its 904 round instructions. A challenge lane runs two
// compressions over 96 bytes in and 32 out; a merkle lane three (one of
// them padding-only) over 64 in and 32 out. The card starts at most one
// warp instruction a clock on each of an SM's four partitions: 128 lanes a
// clock, 3.35e13 a second at 1.98 GHz. So 262,144 challenge lanes need
// 7.3e8 instructions, 0.022 ms, against 33.5 MB, 0.010 ms at 3.35 TB/s: the
// instructions bound it. (Counted as algebraic operations, 2,296 a
// compression, over the 64-lane int32 rate, the "bound" would be 0.072 ms,
// and this kernel runs 262,144 challenge lanes in 0.043 ms on an H100 80GB
// HBM3 at 700 W: the instruction ceiling is the bound that holds.)
// This first version is simple and right, one thread per lane, and not yet
// fast: the byte loads of the row-major kernels, a warp's idle lanes at a
// small level, and one launch per merkle level are what a faster version
// would take on.
//
// The lane functions compile as plain C++ when __CUDACC__ is unset
// (csrc/sha256_host.cpp includes this file): the rotation and the byte swap
// then take portable shifts, and tests/test_torch_sha256.py holds that host
// build to hashlib. Built by `ops/_build.py` with nvcc into a shared
// library; each launcher runs on the caller's stream and returns
// cudaGetLastError().

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SH_FN __device__ __forceinline__
#define SH_CONST __constant__
#else
#define SH_FN static inline
#define SH_CONST static const
#endif

#define SH_THREADS 256
#define SH_MAX_LANES 2147483647LL

SH_CONST uint32_t SH_K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

SH_CONST uint32_t SH_H0[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

// tag_midstate("BIP0340/challenge"): the state after SHA256(tag) twice
// (ops/sha256.CHALLENGE_MIDSTATE; schnorrsig/main_impl.h:96-109).
SH_CONST uint32_t SH_CHALLENGE_MIDSTATE[8] = {
    0x9CECBA11u, 0x23925381u, 0x11679112u, 0xD1627E0Fu,
    0x97C87550u, 0x003CC765u, 0x90F61164u, 0x33E9B66Au,
};

SH_FN uint32_t sh_rotr(uint32_t x, int n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

// The big-endian word of four bytes, and back.
SH_FN uint32_t sh_bswap(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0, 0x0123);
#else
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
#endif
}

SH_FN uint32_t sh_load_be(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) |
         (uint32_t)p[3];
}

// One compression: s (8 words) advanced over the 16 big-endian words m.
SH_FN void sh_compress(uint32_t s[8], const uint32_t m[16]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = m[i];
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t x = w[(i - 15) & 15], y = w[(i - 2) & 15];
      const uint32_t s0 = sh_rotr(x, 7) ^ sh_rotr(x, 18) ^ (x >> 3);
      const uint32_t s1 = sh_rotr(y, 17) ^ sh_rotr(y, 19) ^ (y >> 10);
      wi = w[i & 15] = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t S1 = sh_rotr(e, 6) ^ sh_rotr(e, 11) ^ sh_rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + SH_K[i] + wi;
    const uint32_t S0 = sh_rotr(a, 2) ^ sh_rotr(a, 13) ^ sh_rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// s <- SHA-256 of the 32-byte digest s (the second pass of sha256d): one
// block, the digest's words, then 0x80, zeros and the length 256.
SH_FN void sh_rehash32(uint32_t s[8]) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = s[i];
  m[8] = 0x80000000u;
#pragma unroll
  for (int i = 9; i < 15; ++i) m[i] = 0;
  m[15] = 256;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = SH_H0[i];
  sh_compress(s, m);
}

// Byte k of the padded stream of a message of `len` bytes whose hash has
// already consumed a prefix: the message, 0x80, zeros, and the total length
// in bits as 8 big-endian bytes at the end of the stream's `slen` bytes.
SH_FN uint32_t sh_stream_byte(const uint8_t* row, int64_t len, int64_t k,
                              int64_t slen, uint64_t bits) {
  if (k < len) return row[k];
  if (k == len) return 0x80u;
  if (k >= slen - 8) return (uint32_t)(bits >> (8 * (slen - 1 - k))) & 0xFFu;
  return 0;
}

// One lane of sha256_fixed: s holds the starting state (H0 or a midstate
// that consumed prefix_len bytes) and leaves as the digest's words.
SH_FN void sh_fixed_lane(uint32_t s[8], const uint8_t* row, int64_t len,
                         int64_t prefix_len, int dbl) {
  const int64_t total = prefix_len + len;
  int64_t zeros = (55 - total) % 64;
  if (zeros < 0) zeros += 64;
  const int64_t slen = len + 1 + zeros + 8;
  const uint64_t bits = (uint64_t)total * 8u;
  for (int64_t blk = 0; blk < slen; blk += 64) {
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int64_t k = blk + 4 * j;
      m[j] = (sh_stream_byte(row, len, k, slen, bits) << 24) |
             (sh_stream_byte(row, len, k + 1, slen, bits) << 16) |
             (sh_stream_byte(row, len, k + 2, slen, bits) << 8) |
             sh_stream_byte(row, len, k + 3, slen, bits);
    }
    sh_compress(s, m);
  }
  if (dbl) sh_rehash32(s);
}

// One lane of bip340_challenge: from the challenge midstate, the block
// r ‖ px, then m with the padding of a 160-byte stream (64 bytes of tag
// prefix and 96 of payload: 1,280 bits).
SH_FN void sh_challenge_lane(uint32_t s[8], const uint8_t* r, const uint8_t* px,
                             const uint8_t* msg) {
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = SH_CHALLENGE_MIDSTATE[i];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = sh_load_be(r + 4 * j);
    m[8 + j] = sh_load_be(px + 4 * j);
  }
  sh_compress(s, m);
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = sh_load_be(msg + 4 * j);
  m[8] = 0x80000000u;
#pragma unroll
  for (int j = 9; j < 15; ++j) m[j] = 0;
  m[15] = 1280;
  sh_compress(s, m);
}

// One lane of a merkle level: s <- sha256d(left ‖ right); returns whether
// the two rows are equal.
SH_FN int sh_merkle_pair(uint32_t s[8], const uint8_t* left, const uint8_t* right) {
  uint32_t m[16];
  int eq = 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = sh_load_be(left + 4 * j);
    m[8 + j] = sh_load_be(right + 4 * j);
    eq &= m[j] == m[8 + j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = SH_H0[i];
  sh_compress(s, m);
  m[0] = 0x80000000u;  // the 64-byte message's padding block
#pragma unroll
  for (int j = 1; j < 15; ++j) m[j] = 0;
  m[15] = 512;
  sh_compress(s, m);
  sh_rehash32(s);
  return eq;
}

#ifdef __CUDACC__

SH_FN void sh_store_digest(uint8_t* out_row, const uint32_t s[8]) {
  uint32_t* o = (uint32_t*)out_row;  // rows of 32 bytes, 4-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = sh_bswap(s[i]);
}

__global__ void __launch_bounds__(SH_THREADS)
    sh_compress_kernel(const uint32_t* __restrict__ state,
                       const uint32_t* __restrict__ block,
                       uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * SH_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t s[8], m[16];
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w] = state[w * n + i];
#pragma unroll
  for (int w = 0; w < 16; ++w) m[w] = block[w * n + i];
  sh_compress(s, m);
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * n + i] = s[w];
}

__global__ void __launch_bounds__(SH_THREADS)
    sh_fixed_kernel(const uint8_t* __restrict__ data, int64_t len,
                    const uint32_t* __restrict__ ms, int64_t ms_cols,
                    int64_t prefix_len, int dbl, uint8_t* __restrict__ out,
                    int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * SH_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t col = ms_cols == 1 ? 0 : i;
  uint32_t s[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w] = ms[w * ms_cols + col];
  sh_fixed_lane(s, data + i * len, len, prefix_len, dbl);
  sh_store_digest(out + i * 32, s);
}

__global__ void __launch_bounds__(SH_THREADS)
    sh_challenge_kernel(const uint8_t* __restrict__ r, const uint8_t* __restrict__ px,
                        const uint8_t* __restrict__ msg, uint8_t* __restrict__ out,
                        int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * SH_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t s[8];
  sh_challenge_lane(s, r + i * 32, px + i * 32, msg + i * 32);
  sh_store_digest(out + i * 32, s);
}

// Every thread reaches __syncthreads_or: lanes past the level's end only
// vote 0.
__global__ void __launch_bounds__(SH_THREADS)
    sh_merkle_level_kernel(const uint8_t* __restrict__ in, int64_t n,
                           uint8_t* __restrict__ out, int32_t* __restrict__ mutated) {
  const int64_t j = (int64_t)blockIdx.x * SH_THREADS + threadIdx.x;
  const int64_t m = (n + 1) / 2;
  int eq = 0;
  if (j < m) {
    const int64_t right = 2 * j + 1 < n ? 2 * j + 1 : 2 * j;
    uint32_t s[8];
    eq = sh_merkle_pair(s, in + 2 * j * 32, in + right * 32) && right != 2 * j;
    sh_store_digest(out + j * 32, s);
  }
  if (__syncthreads_or(eq) && threadIdx.x == 0) atomicOr(mutated, 1);
}

// Launchers take their arguments packed as one array of 64-bit words
// (`ops/launch.py`), the stream last. Launch contracts (`ops/sha256.py`):
// a grid of cdiv(lanes, SH_THREADS) blocks of SH_THREADS threads, 1 <= lanes
// <= SH_MAX_LANES; any other launch is refused.
#define SH_PTR(a, i) ((void*)(intptr_t)(a)[i])
#define SH_GRID_OK(lanes, grid, threads)                                 \
  ((lanes) >= 1 && (lanes) <= SH_MAX_LANES && (threads) == SH_THREADS && \
   (grid) == ((lanes) + SH_THREADS - 1) / SH_THREADS)

// state, block, out, lanes, grid, threads, stream
extern "C" int sh_compress(const int64_t* a) {
  if (!SH_GRID_OK(a[3], a[4], a[5])) return (int)cudaErrorInvalidValue;
  sh_compress_kernel<<<(unsigned)a[4], SH_THREADS, 0, (cudaStream_t)SH_PTR(a, 6)>>>(
      (const uint32_t*)SH_PTR(a, 0), (const uint32_t*)SH_PTR(a, 1),
      (uint32_t*)SH_PTR(a, 2), a[3]);
  return (int)cudaGetLastError();
}

// data, len, midstate, midstate columns (1 or lanes), prefix_len, dbl, out,
// lanes, grid, threads, stream
extern "C" int sh_fixed(const int64_t* a) {
  const int64_t lanes = a[7];
  if (!SH_GRID_OK(lanes, a[8], a[9]) || a[1] < 0 || a[4] < 0 || a[4] % 64 ||
      (a[3] != 1 && a[3] != lanes) || (a[5] != 0 && a[5] != 1))
    return (int)cudaErrorInvalidValue;
  sh_fixed_kernel<<<(unsigned)a[8], SH_THREADS, 0, (cudaStream_t)SH_PTR(a, 10)>>>(
      (const uint8_t*)SH_PTR(a, 0), a[1], (const uint32_t*)SH_PTR(a, 2), a[3], a[4],
      (int)a[5], (uint8_t*)SH_PTR(a, 6), lanes);
  return (int)cudaGetLastError();
}

// r, px, m, out, lanes, grid, threads, stream
extern "C" int sh_challenge(const int64_t* a) {
  if (!SH_GRID_OK(a[4], a[5], a[6])) return (int)cudaErrorInvalidValue;
  sh_challenge_kernel<<<(unsigned)a[5], SH_THREADS, 0, (cudaStream_t)SH_PTR(a, 7)>>>(
      (const uint8_t*)SH_PTR(a, 0), (const uint8_t*)SH_PTR(a, 1),
      (const uint8_t*)SH_PTR(a, 2), (uint8_t*)SH_PTR(a, 3), a[4]);
  return (int)cudaGetLastError();
}

// in, n (rows in), out, mutated, grid, threads, stream
extern "C" int sh_merkle_level(const int64_t* a) {
  const int64_t n = a[1];
  if (n < 1 || !SH_GRID_OK((n + 1) / 2, a[4], a[5])) return (int)cudaErrorInvalidValue;
  sh_merkle_level_kernel<<<(unsigned)a[4], SH_THREADS, 0, (cudaStream_t)SH_PTR(a, 6)>>>(
      (const uint8_t*)SH_PTR(a, 0), n, (uint8_t*)SH_PTR(a, 2), (int32_t*)SH_PTR(a, 3));
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
