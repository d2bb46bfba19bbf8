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
//   sh_merkle_tree_kernel   bitcoinconsensus_tpu/core/block.py:158
//                           merkle_root_device, whole: (n, 32) leaves ->
//                           the root and the CVE-2012-2459 flag, one launch
//   sh_merkle_level_kernel  the same, one level: (n, 32) -> (ceil(n/2), 32)
//                           and the flag (on no path; the tree's standalone
//                           counterpart)
//
// Design: one thread per lane, nothing shared between lanes, except in
// the merkle tree. Lane i of a word-major tensor reads word w at w*B + i, so
// the loads of a warp coalesce. The compression keeps its 16 schedule words
// in registers (the 64 rounds unrolled, so every index is a constant) and
// rotates with __funnelshift_r; digests leave as big-endian words through
// __byte_perm.
//
// sh_fixed_kernel (64 lanes a block, so 8,192 lanes spread over 128 SMs)
// reads its row a message block at a time: where the launch's rows start
// 16-byte aligned (the data pointer and L both multiples of 16) in 16-byte
// vector loads, four a block, each word byte-swapped; otherwise in aligned
// 4-byte loads from the word below the row's start, each message word the
// __byte_perm of two loaded words at the row's byte offset, so a view at an
// odd address hashes right. The padding (0x80, zeros, the bit length of
// prefix_len + L) is built a word at a time from (L, prefix_len): a word is
// data, data cut by the 0x80 byte, 0x80 alone, zero, or a half of the
// length. No load reaches past the aligned word or 16 bytes that hold the
// row's last byte. The host builds no padded copy; `dbl` hashes the 32-byte
// digest again in one block (sha256d_fixed).
//
// sh_merkle_tree_kernel reduces the whole txid tree in one launch. Block b
// takes the aligned chunk of SH_TREE_CHUNK leaves [S b, S b + S), loads it
// into shared memory in coalesced 16-byte loads (as big-endian words, so a
// level's digests are the next level's message words as they stand), and
// reduces it level by level, one __syncthreads a level, between two
// buffers; a pair of nodes sits at a stride of 80 bytes, so a quarter
// warp's 16-byte loads of its pairs touch 32 distinct banks. The chunk's
// root goes to row b of the call's work rows. A tail chunk pairs its odd
// last node with itself at each level and, unless it is the only chunk,
// goes on to the chunk's height log2 S: below that height the global level
// holds (full chunks) S / 2^l + 1 nodes, an odd count, so the global tree
// duplicates that node there too. Then each block fences and draws a
// ticket; the block that draws the last one reduces the chunk roots by the
// same routine (in rounds of S while they exceed S) and writes the root.
// `mutated` is the OR of sibling equality over each level's first n_l & ~1
// nodes, taken before the duplication (consensus/merkle.cpp:45-64), so a
// self-pair never counts; aligned power-of-two chunks keep every sibling
// pair inside one block up to the chunk roots, and the chunk-root rounds
// count theirs. Blocks OR it in with one atomicOr each. The schedule (chunk
// bounds, levels, the right sibling, which pairs count) is in SH_FN
// functions that `sh_host_merkle_tree` runs sequentially at any
// power-of-two chunk size.
// sh_merkle_level_kernel is one level of that tree a launch (the first
// version of the merkle root, kept as the tree's standalone counterpart):
// each pair hashed with three compressions (the 64-byte pair, its constant
// padding block, the digest), the odd tail paired with itself, sibling
// equality over the first n & ~1 rows ORed into one device int32
// (__syncthreads_or, then one atomicOr a block).
//
// Bound on this card. A compression needs at least 1,384 32-bit
// instructions: 48 schedule words of 10 (two funnel shifts and a shift, one
// three-way xor as a LOP3, two three-input adds as IADD3s) and 64 rounds of
// 14 (six funnel shifts, one LOP3 each for Σ1, Σ0, ch and maj, four IADD3s),
// plus the 8 final adds; a padding-only block has a constant schedule and
// needs only its 904 round instructions. A challenge lane runs two
// compressions over 96 bytes in and 32 out; a merkle pair three (one of
// them padding-only) over 64 in and 32 out. The card starts at most one
// warp instruction a clock on each of an SM's four partitions: 128 lanes a
// clock, 3.35e13 a second at 1.98 GHz. So 262,144 challenge lanes need
// 7.3e8 instructions, 0.022 ms, against 33.5 MB, 0.010 ms at 3.35 TB/s: the
// instructions bound it. (Counted as algebraic operations, 2,296 a
// compression, over the 64-lane int32 rate, the "bound" would be 0.072 ms,
// and this kernel runs 262,144 challenge lanes in 0.043 ms on an H100 80GB
// HBM3 at 700 W: the instruction ceiling is the bound that holds.) What
// paces these kernels is narrower still: nearly all of a compression's
// instructions (funnel shifts, LOP3s, IADD3s) run on the integer pipe,
// which takes 16 lanes a clock on each partition, 64 an SM (NVIDIA's
// throughput table for compute capability 9.0), half that ceiling; ptxas
// moves little else to the multiplier, and a multiply by 2^k written in its
// place comes back as an integer-pipe LEA (`ops/sha256_designs.py` prints
// the SASS mix and times that design). A tree of n leaves also has a depth:
// about log2 n levels, each a chain of three dependent compressions, which
// bounds it from below at small n: a lone warp's chain at one integer
// instruction every two clocks.
//
// The lane functions compile as plain C++ when __CUDACC__ is unset
// (csrc/sha256_host.cpp includes this file): the rotation, the byte swap,
// the byte permute and the loads then take portable code, and
// tests/test_torch_sha256.py holds that host build to hashlib and to the
// reference's merkle root. Built by `ops/_build.py` with nvcc into a shared
// library; each launcher runs on the caller's stream and returns
// cudaGetLastError().

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SH_FN __device__ __forceinline__
#define SH_CONST __constant__
#else
#define SH_FN static inline
#define SH_CONST static const
#endif

#define SH_THREADS 256
#define SH_FIXED_THREADS 64
#define SH_TREE_THREADS 256
#define SH_TREE_CHUNK 512  // leaves a block reduces: two a thread
#define SH_TREE_PAIR_WORDS 20  // a pair of nodes in shared memory: 64 + 16 bytes
#define SH_TREE_HEADER 48  // work: root (32), flag (4), ticket (4), 8 spare
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

// The big-endian word of the four bytes that start at byte r (0-3) of the
// little-endian words lo, hi as they lie in memory.
SH_FN uint32_t sh_be_at(uint32_t lo, uint32_t hi, uint32_t r) {
#ifdef __CUDA_ARCH__
  return __byte_perm(lo, hi, 0x0123u + 0x1111u * r);
#else
  return sh_bswap((uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * r)));
#endif
}

// Aligned loads of memory words: 16 bytes at p (16-byte aligned) as four
// little-endian words, and 4 bytes at p (4-byte aligned).
SH_FN void sh_ld16(uint32_t w[4], const uint8_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg((const uint4*)p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
#else
  memcpy(w, p, 16);
#endif
}

SH_FN uint32_t sh_ld4(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg((const uint32_t*)p);
#else
  uint32_t w;
  memcpy(&w, p, 4);
  return w;
#endif
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

// Word j of a block of the padded stream, whose block holds q = (message
// bytes left at the block's start) - 4 j message bytes at the word: `data`
// (its message bytes as loaded) when q >= 4; the halves of the bit length
// as words 14 and 15 of the last block; else the message bytes, the 0x80
// byte after them, and zeros.
SH_FN uint32_t sh_pad_word(uint32_t data, int q, int last, int j, uint64_t bits) {
  if (q >= 4) return data;
  if (last && j >= 14) return j == 14 ? (uint32_t)(bits >> 32) : (uint32_t)bits;
  if (q <= 0) return q == 0 ? 0x80000000u : 0u;
  return (data & (0xFFFFFFFFu << (32 - 8 * q))) | (0x80000000u >> (8 * q));
}

// One lane of sha256_fixed: s holds the starting state (H0 or a midstate
// that consumed prefix_len bytes, a multiple of 64) and leaves as the
// digest's words. `vec`: the row starts 16-byte aligned and len is a
// multiple of 16, so it is read in 16-byte loads; else in 4-byte loads from
// the word below its start. Only words that hold a message byte are loaded.
SH_FN void sh_fixed_lane(uint32_t s[8], const uint8_t* row, int64_t len,
                         int64_t prefix_len, int dbl, int vec) {
  const uint64_t bits = (uint64_t)(prefix_len + len) * 8u;
  const int64_t blocks = (len + 72) / 64;  // len, 0x80 and 8 length bytes
  const uint32_t r = (uint32_t)((uintptr_t)row & 3);
  const uint8_t* row4 = row - r;
  for (int64_t blk = 0; blk < blocks; ++blk) {
    const int64_t left = len - 64 * blk;  // message bytes from the block's start
    const int q0 = left > 64 ? 68 : (int)left;
    uint32_t m[16];
    if (vec) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t w[4] = {0, 0, 0, 0};
        if (16 * c < q0) sh_ld16(w, row + 64 * blk + 16 * c);
#pragma unroll
        for (int k = 0; k < 4; ++k) m[4 * c + k] = sh_bswap(w[k]);
      }
    } else {
      uint32_t w[17];
#pragma unroll
      for (int k = 0; k < 17; ++k)
        w[k] = 4 * k < q0 + (int)r ? sh_ld4(row4 + 64 * blk + 4 * k) : 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) m[j] = sh_be_at(w[j], w[j + 1], r);
    }
    const int last = blk == blocks - 1;
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = sh_pad_word(m[j], q0 - 4 * j, last, j, bits);
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

// One merkle node: s <- sha256d(l ‖ r) of two digests as big-endian words;
// returns whether they are equal.
SH_FN int sh_merkle_node(uint32_t s[8], const uint32_t l[8], const uint32_t r[8]) {
  uint32_t m[16];
  int eq = 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = l[j];
    m[8 + j] = r[j];
    eq &= l[j] == r[j];
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

// One lane of a merkle level: s <- sha256d(left ‖ right) of two 32-byte
// rows; returns whether they are equal.
SH_FN int sh_merkle_pair(uint32_t s[8], const uint8_t* left, const uint8_t* right) {
  uint32_t l[8], r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    l[j] = sh_load_be(left + 4 * j);
    r[j] = sh_load_be(right + 4 * j);
  }
  return sh_merkle_node(s, l, r);
}

// The merkle tree's schedule. A level of n nodes is cut into aligned chunks
// of S (a power of two) nodes; chunk b holds nodes [S b, S b + rows).
// Counts fit an int: n <= SH_MAX_LANES.
SH_FN int sh_tree_chunks(int n, int S) { return n / S + (n % S != 0); }

SH_FN int sh_tree_rows(int n, int S, int b) {
  const int rows = n - S * b;
  return rows < S ? rows : S;
}

// The levels a chunk of `rows` nodes reduces: up to its root when it is the
// level's only chunk, else the chunk's height log2 S (a tail chunk's last
// node pairs with itself until then: the global level is odd there).
SH_FN int sh_tree_levels(int rows, int S, int alone) {
  int h = 0;
  while ((1 << h) < (alone ? rows : S)) ++h;
  return h;
}

// Pair j of a level of m nodes: its right node (itself past the end), and
// whether its sibling equality counts toward `mutated` (the first m & ~1
// nodes only: a self-pair never counts).
SH_FN int sh_tree_right(int j, int m) { return 2 * j + 1 < m ? 2 * j + 1 : 2 * j; }

SH_FN int sh_tree_counts(int j, int m) { return 2 * j + 1 < m; }

#ifdef __CUDACC__

// The tree's shared memory: two buffers, 0 for up to SH_TREE_CHUNK nodes and
// 1 for half as many; level l reads buffer l % 2 and writes the other. Node j
// of a buffer sits at word (j / 2) * 20 + (j % 2) * 8, so pair j is 16
// contiguous words at 20 j. Offsets are words of the one __shared__ array.
#define SH_TREE_HALF (SH_TREE_CHUNK / 2 * SH_TREE_PAIR_WORDS)  // buffer 1's offset
#define SH_TREE_WORDS (SH_TREE_HALF + SH_TREE_CHUNK / 4 * SH_TREE_PAIR_WORDS)

SH_FN int sh_tree_at(int buf, int j) {
  return buf * SH_TREE_HALF + (j >> 1) * SH_TREE_PAIR_WORDS + (j & 1) * 8;
}

// One block reduces the `rows` 32-byte rows at `in` (16-byte aligned) by
// `levels` levels, and thread 0 writes node 0 to the 32-byte row `out`;
// returns whether this thread saw a sibling pair that counts equal. Reads
// and writes of rows bypass L1 (__ldcg, __stcg): chunk roots come from
// other blocks.
SH_FN int sh_tree_reduce(const uint8_t* in, int rows, int levels, uint8_t* out,
                         uint32_t* sm) {
  const int t = threadIdx.x;
  int mut = 0;
  uint4 v[2 * SH_TREE_CHUNK / SH_TREE_THREADS];  // every load in flight at once
#pragma unroll
  for (int k = 0; k < 2 * SH_TREE_CHUNK / SH_TREE_THREADS; ++k)
    if (t + k * SH_TREE_THREADS < 2 * rows) v[k] = __ldcg((const uint4*)in + t + k * SH_TREE_THREADS);
#pragma unroll
  for (int k = 0; k < 2 * SH_TREE_CHUNK / SH_TREE_THREADS; ++k) {
    const int p = t + k * SH_TREE_THREADS;  // half p % 2 of node p / 2
    if (p < 2 * rows)
      *(uint4*)(sm + sh_tree_at(0, p >> 1) + 4 * (p & 1)) =
          make_uint4(sh_bswap(v[k].x), sh_bswap(v[k].y), sh_bswap(v[k].z), sh_bswap(v[k].w));
  }
  __syncthreads();
  int m = rows;
  for (int l = 0; l < levels; ++l) {
    const int pairs = (m + 1) >> 1;
    if (t < pairs) {
      uint32_t lw[8], rw[8], s[8];
      const uint32_t* lp = sm + sh_tree_at(l & 1, 2 * t);
      const uint32_t* rp = sm + sh_tree_at(l & 1, sh_tree_right(t, m));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 x = *(const uint4*)(lp + 4 * h), y = *(const uint4*)(rp + 4 * h);
        lw[4 * h] = x.x, lw[4 * h + 1] = x.y, lw[4 * h + 2] = x.z, lw[4 * h + 3] = x.w;
        rw[4 * h] = y.x, rw[4 * h + 1] = y.y, rw[4 * h + 2] = y.z, rw[4 * h + 3] = y.w;
      }
      if (sh_merkle_node(s, lw, rw) && sh_tree_counts(t, m)) mut = 1;
      uint32_t* d = sm + sh_tree_at((l & 1) ^ 1, t);
      *(uint4*)d = make_uint4(s[0], s[1], s[2], s[3]);
      *(uint4*)(d + 4) = make_uint4(s[4], s[5], s[6], s[7]);
    }
    __syncthreads();
    m = pairs;
  }
  if (t == 0) {
    const uint32_t* r = sm + sh_tree_at(levels & 1, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 x = *(const uint4*)(r + 4 * h);
      __stcg((uint4*)out + h,
             make_uint4(sh_bswap(x.x), sh_bswap(x.y), sh_bswap(x.z), sh_bswap(x.w)));
    }
  }
  __syncthreads();
  return mut;
}

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

// `out` rows are 16-byte aligned (the wrapper's own allocation).
__global__ void __launch_bounds__(SH_FIXED_THREADS)
    sh_fixed_kernel(const uint8_t* __restrict__ data, int64_t len,
                    const uint32_t* __restrict__ ms, int64_t ms_cols,
                    int64_t prefix_len, int dbl, uint8_t* __restrict__ out,
                    int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * SH_FIXED_THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t col = ms_cols == 1 ? 0 : i;
  uint32_t s[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w] = ms[w * ms_cols + col];
  const int vec = (((uintptr_t)data | (uintptr_t)len) & 15) == 0;
  sh_fixed_lane(s, data + i * len, len, prefix_len, dbl, vec);
  uint4* o = (uint4*)(out + i * 32);
  o[0] = make_uint4(sh_bswap(s[0]), sh_bswap(s[1]), sh_bswap(s[2]), sh_bswap(s[3]));
  o[1] = make_uint4(sh_bswap(s[4]), sh_bswap(s[5]), sh_bswap(s[6]), sh_bswap(s[7]));
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

// The whole tree in rounds. Round 0: block b reduces leaf chunk b into
// work row b. The block that draws the last ticket runs the later rounds
// alone, a chunk of rows at a time (row j of a round is written after the
// chunk that holds it was read). The round whose level has one chunk writes
// the root into the work's head; a tree of one chunk does so in round 0 and
// takes no ticket. `work` (16-byte aligned, zeroed by the caller): the root
// (32 bytes), the flag (int32), the ticket (uint32), 8 spare bytes, then one
// 32-byte row a chunk. The last block sets the ticket back to 0, so the same
// work serves another launch (the flag stays ORed in). The loop's state is
// the block's own, so every thread reaches each __syncthreads; it is a few
// ints (the rows' pointer follows from the round). Two blocks an SM, at most
// 128 registers: above the first levels each level is a lone warp's chain
// of three compressions, which runs fastest with registers to spare, and a
// block's txids (a few thousand at most) fit one wave; 262,144 leaves (512
// blocks) take two. (`ops/sha256_designs.py` times two, three and four
// blocks an SM.)
__global__ void __launch_bounds__(SH_TREE_THREADS, 2)
    sh_merkle_tree_kernel(const uint8_t* __restrict__ leaves, int64_t n,
                          uint8_t* __restrict__ work) {
  __shared__ __align__(16) uint32_t sm[SH_TREE_WORDS];
  __shared__ int last;
  int c = (int)n, g = gridDim.x, j = blockIdx.x, round = 0, mut = 0;
  for (;;) {
    const int rows = sh_tree_rows(c, SH_TREE_CHUNK, j);
    const uint8_t* in = round ? work + SH_TREE_HEADER : leaves;
    mut |= sh_tree_reduce(in + (int64_t)j * SH_TREE_CHUNK * 32, rows,
                          sh_tree_levels(rows, SH_TREE_CHUNK, g == 1),
                          g == 1 ? work : work + SH_TREE_HEADER + 32 * j, sm);
    if (g == 1) break;
    if (!round) {
      if (threadIdx.x == 0) {  // the thread that wrote row j
        __threadfence();
        last = atomicAdd((unsigned int*)(work + 36), 1u) == (unsigned int)(g - 1);
      }
      __syncthreads();
      if (!last) break;
      __threadfence();
      round = 1;
      j = g;  // starts the next round below
    } else {
      ++j;
    }
    if (j == g) {
      c = g;
      g = sh_tree_chunks(c, SH_TREE_CHUNK);
      j = 0;
    }
  }
  if (round && threadIdx.x == 0) *(unsigned int*)(work + 36) = 0;  // every ticket is drawn
  if (__syncthreads_or(mut) && threadIdx.x == 0) atomicOr((int32_t*)(work + 32), 1);
}

// Launchers take their arguments packed as one array of 64-bit words
// (`ops/launch.py`), the stream last. Launch contracts (`ops/sha256.py`):
// a grid of cdiv(lanes, SH_THREADS) blocks of SH_THREADS threads, 1 <= lanes
// <= SH_MAX_LANES; any other launch is refused.
#define SH_PTR(a, i) ((void*)(intptr_t)(a)[i])
#define SH_GRID_OK_AT(lanes, grid, threads, T)                  \
  ((lanes) >= 1 && (lanes) <= SH_MAX_LANES && (threads) == (T) && \
   (grid) == ((lanes) + (T) - 1) / (T))
#define SH_GRID_OK(lanes, grid, threads) SH_GRID_OK_AT(lanes, grid, threads, SH_THREADS)

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
  if (!SH_GRID_OK_AT(lanes, a[8], a[9], SH_FIXED_THREADS) || a[1] < 0 || a[4] < 0 || a[4] % 64 ||
      (a[3] != 1 && a[3] != lanes) || (a[5] != 0 && a[5] != 1))
    return (int)cudaErrorInvalidValue;
  sh_fixed_kernel<<<(unsigned)a[8], SH_FIXED_THREADS, 0, (cudaStream_t)SH_PTR(a, 10)>>>(
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

// leaves, n (leaves), work, grid, threads, stream: a grid of one block a
// chunk of SH_TREE_CHUNK leaves, SH_TREE_THREADS threads; leaves and work
// 16-byte aligned.
extern "C" int sh_merkle_tree(const int64_t* a) {
  const int64_t n = a[1];
  if (n < 1 || n > SH_MAX_LANES || a[4] != SH_TREE_THREADS ||
      a[3] != (n + SH_TREE_CHUNK - 1) / SH_TREE_CHUNK || ((a[0] | a[2]) & 15))
    return (int)cudaErrorInvalidValue;
  sh_merkle_tree_kernel<<<(unsigned)a[3], SH_TREE_THREADS, 0,
                          (cudaStream_t)SH_PTR(a, 5)>>>(
      (const uint8_t*)SH_PTR(a, 0), n, (uint8_t*)SH_PTR(a, 2));
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
