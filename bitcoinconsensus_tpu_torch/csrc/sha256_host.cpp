// Host build of `sha256.cu`'s lane functions, compiled by g++
// (`ops/_build.py`, name `sha256_host`): each kernel's per-lane work looped
// over the lanes on the CPU, with the same layouts as the launchers, so the
// tests hold the CUDA source's arithmetic, padding and byte order to
// hashlib without a card.
//
//   sh_host_compress      (8, n) and (16, n) words -> (8, n)
//   sh_host_fixed         (n, len) bytes, midstate (8, ms_cols), prefix_len,
//                         dbl -> (n, 32) digests
//   sh_host_challenge     three (n, 32) byte rows -> (n, 32) digests
//   sh_host_merkle_level  (n, 32) rows -> (ceil(n/2), 32), *mutated |= any
//                         equal sibling pair of the first n & ~1 rows
//   sh_host_merkle_tree   (n, 32) leaves -> the root, *mutated |= the flag,
//                         by the tree kernel's schedule at a chunk of
//                         chunk_leaves (a power of two >= 2): each chunk of
//                         a round, then the rounds over the chunk roots
//
// The fixed hash reads its rows as the kernel does: 16-byte loads where the
// data pointer and len are multiples of 16, else aligned 4-byte loads from
// the word below each row's start (so a caller's buffer must hold the
// aligned words around its rows).

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

#include "sha256.cu"

static void sh_host_store(uint8_t* out_row, const uint32_t s[8]) {
  for (int i = 0; i < 8; ++i) {
    out_row[4 * i] = (uint8_t)(s[i] >> 24);
    out_row[4 * i + 1] = (uint8_t)(s[i] >> 16);
    out_row[4 * i + 2] = (uint8_t)(s[i] >> 8);
    out_row[4 * i + 3] = (uint8_t)s[i];
  }
}

extern "C" void sh_host_compress(const uint32_t* state, const uint32_t* block,
                                 uint32_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t s[8], m[16];
    for (int w = 0; w < 8; ++w) s[w] = state[w * n + i];
    for (int w = 0; w < 16; ++w) m[w] = block[w * n + i];
    sh_compress(s, m);
    for (int w = 0; w < 8; ++w) out[w * n + i] = s[w];
  }
}

extern "C" void sh_host_fixed(const uint8_t* data, int64_t len, const uint32_t* ms,
                              int64_t ms_cols, int64_t prefix_len, int dbl,
                              uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t s[8];
    for (int w = 0; w < 8; ++w) s[w] = ms[w * ms_cols + (ms_cols == 1 ? 0 : i)];
    sh_fixed_lane(s, data + i * len, len, prefix_len, dbl,
                  (((uintptr_t)data | (uintptr_t)len) & 15) == 0);
    sh_host_store(out + i * 32, s);
  }
}

extern "C" void sh_host_challenge(const uint8_t* r, const uint8_t* px,
                                  const uint8_t* msg, uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t s[8];
    sh_challenge_lane(s, r + i * 32, px + i * 32, msg + i * 32);
    // The kernel's store: each word byte-swapped into a little-endian word.
    for (int w = 0; w < 8; ++w) {
      const uint32_t v = sh_bswap(s[w]);
      for (int b = 0; b < 4; ++b) out[i * 32 + 4 * w + b] = (uint8_t)(v >> (8 * b));
    }
  }
}

extern "C" void sh_host_merkle_level(const uint8_t* in, int64_t n, uint8_t* out,
                                     int32_t* mutated) {
  const int64_t m = (n + 1) / 2;
  for (int64_t j = 0; j < m; ++j) {
    const int64_t right = 2 * j + 1 < n ? 2 * j + 1 : 2 * j;
    uint32_t s[8];
    if (sh_merkle_pair(s, in + 2 * j * 32, in + right * 32) && right != 2 * j)
      *mutated |= 1;
    sh_host_store(out + j * 32, s);
  }
}

// One chunk of `rows` nodes (8 words each) at `nodes` reduced by `levels`
// levels in place, node 0 left holding its root; returns the flag.
static int sh_host_chunk(uint32_t* nodes, int rows, int levels) {
  int mut = 0, m = rows;
  for (int l = 0; l < levels; ++l) {
    const int pairs = (m + 1) / 2;
    for (int j = 0; j < pairs; ++j) {  // node j's slot is read by pair j / 2 < j
      uint32_t s[8];
      if (sh_merkle_node(s, nodes + 16 * j, nodes + 8 * sh_tree_right(j, m)) &&
          sh_tree_counts(j, m))
        mut = 1;
      for (int w = 0; w < 8; ++w) nodes[8 * j + w] = s[w];
    }
    m = pairs;
  }
  return mut;
}

extern "C" void sh_host_merkle_tree(const uint8_t* leaves, int64_t n, int64_t chunk_leaves,
                                    uint8_t* root, int32_t* mutated) {
  uint32_t* nodes = (uint32_t*)malloc(32 * (size_t)n);
  for (int64_t i = 0; i < 8 * n; ++i) nodes[i] = sh_load_be(leaves + 4 * i);
  int mut = 0;
  const int S = (int)chunk_leaves;
  for (int c = (int)n;;) {  // a round: the chunk phase, then the chunk roots'
    const int g = sh_tree_chunks(c, S);
    for (int b = 0; b < g; ++b) {
      const int rows = sh_tree_rows(c, S, b);
      uint32_t* chunk = nodes + 8 * (int64_t)S * b;
      mut |= sh_host_chunk(chunk, rows, sh_tree_levels(rows, S, g == 1));
      for (int w = 0; w < 8; ++w) nodes[8 * b + w] = chunk[w];  // row b <= S b
    }
    if (g == 1) break;
    c = g;
  }
  sh_host_store(root, nodes);
  if (mut) *mutated |= 1;
  free(nodes);
}
