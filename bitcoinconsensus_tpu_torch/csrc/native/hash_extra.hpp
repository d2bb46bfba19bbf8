// Verbatim copy of native/hash_extra.hpp, the JAX package's native host core, built by the port's ops/_build.py.
// RIPEMD-160 and SHA-1 for the native script machine (OP_RIPEMD160,
// OP_SHA1, OP_HASH160). Published-spec constants; reference parity:
// crypto/ripemd160.cpp, crypto/sha1.cpp (generic transforms).
#pragma once

#include <cstdint>
#include <cstring>

#include "sha256.hpp"

namespace nat {

// ---------------------------------------------------------------------------
// RIPEMD-160

struct Ripemd160 {
    static inline u32 rol(u32 x, int n) { return (x << n) | (x >> (32 - n)); }

    static void hash(const u8* data, size_t len, u8 out[20]) {
        u32 h0 = 0x67452301u, h1 = 0xEFCDAB89u, h2 = 0x98BADCFEu,
            h3 = 0x10325476u, h4 = 0xC3D2E1F0u;
        // message with padding
        u64 msgbits = (u64)len * 8;
        size_t padlen = ((len + 8) / 64 + 1) * 64;
        // process in chunks without allocating when possible
        u8 tail[128];
        size_t full = len / 64 * 64;

        auto compress = [&](const u8* p) {
            static const int R1[80] = {
                0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
                3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
                1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
                4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
            static const int R2[80] = {
                5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
                6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
                15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
                8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
                12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
            static const int S1[80] = {
                11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
                7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
                11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
                11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
                9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
            static const int S2[80] = {
                8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
                9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
                9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
                15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
                8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
            static const u32 K1[5] = {0x00000000u, 0x5A827999u, 0x6ED9EBA1u,
                                      0x8F1BBCDCu, 0xA953FD4Eu};
            static const u32 K2[5] = {0x50A28BE6u, 0x5C4DD124u, 0x6D703EF3u,
                                      0x7A6D76E9u, 0x00000000u};
            u32 x[16];
            for (int i = 0; i < 16; i++)
                x[i] = (u32)p[4 * i] | ((u32)p[4 * i + 1] << 8) |
                       ((u32)p[4 * i + 2] << 16) | ((u32)p[4 * i + 3] << 24);
            u32 a1 = h0, b1 = h1, c1 = h2, d1 = h3, e1 = h4;
            u32 a2 = h0, b2 = h1, c2 = h2, d2 = h3, e2 = h4;
            for (int j = 0; j < 80; j++) {
                int rnd = j / 16;
                u32 f1, f2;
                switch (rnd) {
                    case 0: f1 = b1 ^ c1 ^ d1; f2 = b2 ^ (c2 | ~d2); break;
                    case 1: f1 = (b1 & c1) | (~b1 & d1); f2 = (b2 & d2) | (c2 & ~d2); break;
                    case 2: f1 = (b1 | ~c1) ^ d1; f2 = (b2 | ~c2) ^ d2; break;
                    case 3: f1 = (b1 & d1) | (c1 & ~d1); f2 = (b2 & c2) | (~b2 & d2); break;
                    default: f1 = b1 ^ (c1 | ~d1); f2 = b2 ^ c2 ^ d2; break;
                }
                u32 t = rol(a1 + f1 + x[R1[j]] + K1[rnd], S1[j]) + e1;
                a1 = e1; e1 = d1; d1 = rol(c1, 10); c1 = b1; b1 = t;
                t = rol(a2 + f2 + x[R2[j]] + K2[rnd], S2[j]) + e2;
                a2 = e2; e2 = d2; d2 = rol(c2, 10); c2 = b2; b2 = t;
            }
            u32 t = h1 + c1 + d2;
            h1 = h2 + d1 + e2;
            h2 = h3 + e1 + a2;
            h3 = h4 + a1 + b2;
            h4 = h0 + b1 + c2;
            h0 = t;
        };

        for (size_t off = 0; off < full; off += 64) compress(data + off);
        size_t rem = len - full;
        if (rem) std::memcpy(tail, data + full, rem);
        tail[rem] = 0x80;
        size_t tail_len = (rem + 8 < 64) ? 64 : 128;
        std::memset(tail + rem + 1, 0, tail_len - rem - 1 - 8);
        for (int i = 0; i < 8; i++) tail[tail_len - 8 + i] = u8(msgbits >> (8 * i));
        compress(tail);
        if (tail_len == 128) compress(tail + 64);
        (void)padlen;
        u32 hs[5] = {h0, h1, h2, h3, h4};
        for (int i = 0; i < 5; i++)
            for (int j = 0; j < 4; j++) out[4 * i + j] = u8(hs[i] >> (8 * j));
    }
};

inline void ripemd160(const u8* data, size_t len, u8 out[20]) {
    Ripemd160::hash(data, len, out);
}

inline void hash160(const u8* data, size_t len, u8 out[20]) {
    u8 tmp[32];
    sha256(data, len, tmp);
    ripemd160(tmp, 32, out);
}

// ---------------------------------------------------------------------------
// SHA-1

inline void sha1(const u8* data, size_t len, u8 out[20]) {
    u32 h[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u, 0xC3D2E1F0u};
    auto rol = [](u32 x, int n) { return (x << n) | (x >> (32 - n)); };
    auto compress = [&](const u8* p) {
        u32 w[80];
        for (int i = 0; i < 16; i++)
            w[i] = ((u32)p[4 * i] << 24) | ((u32)p[4 * i + 1] << 16) |
                   ((u32)p[4 * i + 2] << 8) | (u32)p[4 * i + 3];
        for (int i = 16; i < 80; i++)
            w[i] = rol(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
        u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
        for (int i = 0; i < 80; i++) {
            u32 f, k;
            if (i < 20) { f = (b & c) | (~b & d); k = 0x5A827999u; }
            else if (i < 40) { f = b ^ c ^ d; k = 0x6ED9EBA1u; }
            else if (i < 60) { f = (b & c) | (b & d) | (c & d); k = 0x8F1BBCDCu; }
            else { f = b ^ c ^ d; k = 0xCA62C1D6u; }
            u32 t = rol(a, 5) + f + e + k + w[i];
            e = d; d = c; c = rol(b, 30); b = a; a = t;
        }
        h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
    };
    size_t full = len / 64 * 64;
    for (size_t off = 0; off < full; off += 64) compress(data + off);
    u8 tail[128];
    size_t rem = len - full;
    if (rem) std::memcpy(tail, data + full, rem);
    tail[rem] = 0x80;
    size_t tail_len = (rem + 8 < 64) ? 64 : 128;
    std::memset(tail + rem + 1, 0, tail_len - rem - 1 - 8);
    u64 msgbits = (u64)len * 8;
    for (int i = 0; i < 8; i++) tail[tail_len - 8 + i] = u8(msgbits >> (56 - 8 * i));
    compress(tail);
    if (tail_len == 128) compress(tail + 64);
    for (int i = 0; i < 5; i++)
        for (int j = 0; j < 4; j++) out[4 * i + j] = u8(h[i] >> (24 - 8 * j));
}

// MurmurHash3 x86_32 (hash.cpp:16-78 — compiled crate surface, used by
// Core's bloom filters; unused by the verify path but part of drop-in
// completeness). Standard smhasher algorithm; values asserted against the
// reference implementation's outputs in tests/test_core_basics.py.
inline u32 murmur3_32(u32 seed, const u8* data, size_t len) {
    u32 h1 = seed;
    const u32 c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
    auto rotl = [](u32 x, int r) { return (x << r) | (x >> (32 - r)); };
    size_t nblocks = len / 4;
    for (size_t i = 0; i < nblocks; i++) {
        const u8* p = data + i * 4;
        u32 k1 = (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) |
                 ((u32)p[3] << 24);
        k1 *= c1;
        k1 = rotl(k1, 15);
        k1 *= c2;
        h1 ^= k1;
        h1 = rotl(h1, 13);
        h1 = h1 * 5 + 0xe6546b64u;
    }
    const u8* tail = data + nblocks * 4;
    u32 k1 = 0;
    switch (len & 3) {
        case 3: k1 ^= (u32)tail[2] << 16; [[fallthrough]];
        case 2: k1 ^= (u32)tail[1] << 8; [[fallthrough]];
        case 1:
            k1 ^= tail[0];
            k1 *= c1;
            k1 = rotl(k1, 15);
            k1 *= c2;
            h1 ^= k1;
    }
    h1 ^= (u32)len;
    h1 ^= h1 >> 16;
    h1 *= 0x85ebca6bu;
    h1 ^= h1 >> 13;
    h1 *= 0xc2b2ae35u;
    h1 ^= h1 >> 16;
    return h1;
}

}  // namespace nat
