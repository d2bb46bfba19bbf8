// Verbatim copy of native/secp.hpp, the JAX package's native host core, built by the port's ops/_build.py.
// secp256k1 host core for the TPU framework: 4x64 field/scalar arithmetic
// over unsigned __int128, Jacobian group law, wNAF double-scalar
// multiplication, lax-DER parsing, and the three verify algebras
// (ECDSA / BIP340 Schnorr / x-only tweak-add).
//
// This is the NATIVE twin of the pure-Python oracle
// `bitcoinconsensus_tpu/crypto/secp_host.py` (itself differentially tested
// against the reference .so): same parse rules, same acceptance equations,
// different machine form. Reference spec anchors: pubkey.cpp:28-168
// (lax-DER), pubkey.cpp:191-207 (ECDSA verify glue),
// modules/schnorrsig/main_impl.h:190-237 (BIP340),
// modules/extrakeys/main_impl.h:109-129 (tweak-add),
// secp256k1/src/scalar_impl.h:60-178 (GLV split constants).
//
// Representation choice (deliberately NOT the reference's 5x52/10x26 lazy
// carry forms): limbs are plain 4x64 little-endian, every field/scalar
// value is kept fully reduced after each operation; products fold the
// high half through 2^256 ≡ C (mod p) with C = 2^32 + 977. Verify-only,
// so no constant-time discipline is needed.
#pragma once

#include <cstdint>
#include <cstring>

#include "sha256.hpp"

// Portability contract (documented non-goal, VERDICT r4 §9): this core
// requires unsigned __int128 (the 4x64 representation's 64x64->128
// multiply) and a little-endian host. The reference additionally ships
// 10x26/8x32 and big-endian (s390x) paths because it targets arbitrary
// consumers; TPU hosts are x86-64/aarch64 little-endian, so instead of
// carrying an untested fallback we make the assumption fail loudly at
// compile time.
#if !defined(__SIZEOF_INT128__)
#error "native/secp.hpp requires unsigned __int128 (64-bit compiler)"
#endif
#if defined(__BYTE_ORDER__) && (__BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__)
#error "native/secp.hpp requires a little-endian host (TPU hosts are LE)"
#endif

namespace nat {

using u128 = unsigned __int128;
using i64 = int64_t;
using i32 = int32_t;

// ---------------------------------------------------------------------------
// 256-bit little-endian limb helpers (generic, used by field and scalar).

struct U256 {
    u64 v[4];
};

inline U256 u256_from_be(const u8* b) {
    U256 r;
    for (int i = 0; i < 4; i++)
        r.v[3 - i] = (u64(b[8 * i]) << 56) | (u64(b[8 * i + 1]) << 48) |
                     (u64(b[8 * i + 2]) << 40) | (u64(b[8 * i + 3]) << 32) |
                     (u64(b[8 * i + 4]) << 24) | (u64(b[8 * i + 5]) << 16) |
                     (u64(b[8 * i + 6]) << 8) | u64(b[8 * i + 7]);
    return r;
}

inline void u256_to_be(const U256& a, u8* b) {
    for (int i = 0; i < 4; i++) {
        u64 w = a.v[3 - i];
        for (int j = 0; j < 8; j++) b[8 * i + j] = u8(w >> (56 - 8 * j));
    }
}

inline void u256_to_le(const U256& a, u8* b) {
    for (int i = 0; i < 4; i++) {
        u64 w = a.v[i];
        for (int j = 0; j < 8; j++) b[8 * i + j] = u8(w >> (8 * j));
    }
}

inline int u256_cmp(const U256& a, const U256& b) {
    for (int i = 3; i >= 0; i--) {
        if (a.v[i] < b.v[i]) return -1;
        if (a.v[i] > b.v[i]) return 1;
    }
    return 0;
}

inline bool u256_is_zero(const U256& a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

// a + b -> (sum, carry)
inline u64 u256_add(U256& r, const U256& a, const U256& b) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a.v[i] + b.v[i];
        r.v[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

// a - b -> (diff, borrow)
inline u64 u256_sub(U256& r, const U256& a, const U256& b) {
    u128 bw = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - bw;
        r.v[i] = (u64)d;
        bw = (d >> 64) ? 1 : 0;
    }
    return (u64)bw;
}

// ---------------------------------------------------------------------------
// Field mod p = 2^256 - 2^32 - 977.

inline const U256& FIELD_P() {
    static const U256 p = {{0xFFFFFFFEFFFFFC2Full, 0xFFFFFFFFFFFFFFFFull,
                            0xFFFFFFFFFFFFFFFFull, 0xFFFFFFFFFFFFFFFFull}};
    return p;
}
constexpr u64 FIELD_C = 0x1000003D1ull;  // 2^256 mod p

struct Fe {
    U256 n;  // always fully reduced: n < p
};

inline bool fe_is_zero(const Fe& a) { return u256_is_zero(a.n); }
inline bool fe_eq(const Fe& a, const Fe& b) { return u256_cmp(a.n, b.n) == 0; }
inline bool fe_is_odd(const Fe& a) { return a.n.v[0] & 1; }

inline Fe fe_from_u256(const U256& x) {  // x arbitrary 256-bit
    Fe r;
    r.n = x;
    if (u256_cmp(r.n, FIELD_P()) >= 0) u256_sub(r.n, r.n, FIELD_P());
    return r;
}

inline Fe fe_from_be(const u8* b) { return fe_from_u256(u256_from_be(b)); }

inline Fe fe_add(const Fe& a, const Fe& b) {
    Fe r;
    u64 c = u256_add(r.n, a.n, b.n);
    if (c || u256_cmp(r.n, FIELD_P()) >= 0) u256_sub(r.n, r.n, FIELD_P());
    return r;
}

inline Fe fe_sub(const Fe& a, const Fe& b) {
    Fe r;
    if (u256_sub(r.n, a.n, b.n)) u256_add(r.n, r.n, FIELD_P());
    return r;
}

inline Fe fe_neg(const Fe& a) {
    Fe r;
    if (fe_is_zero(a)) return a;
    u256_sub(r.n, FIELD_P(), a.n);
    return r;
}

// Fold a full 512-bit product (t[0..7]) with 2^256 ≡ C twice + tail.
inline Fe fe_reduce_512(const u64 t[8]) {
    u64 lo[5] = {t[0], t[1], t[2], t[3], 0};
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)t[4 + i] * FIELD_C + lo[i];
        lo[i] = (u64)c;
        c >>= 64;
    }
    lo[4] = (u64)c;  // <= ~2^34
    // fold lo[4] * C (fits well inside 128 bits)
    u128 c2 = (u128)lo[4] * FIELD_C + lo[0];
    U256 r;
    r.v[0] = (u64)c2;
    c2 >>= 64;
    c2 += lo[1];
    r.v[1] = (u64)c2;
    c2 >>= 64;
    c2 += lo[2];
    r.v[2] = (u64)c2;
    c2 >>= 64;
    c2 += lo[3];
    r.v[3] = (u64)c2;
    u64 c3 = (u64)(c2 >> 64);  // 0 or 1
    if (c3) {
        // one more wrap: add C
        u128 c4 = (u128)FIELD_C * c3 + r.v[0];
        r.v[0] = (u64)c4;
        c4 >>= 64;
        for (int i = 1; i < 4 && c4; i++) {
            c4 += r.v[i];
            r.v[i] = (u64)c4;
            c4 >>= 64;
        }
    }
    return fe_from_u256(r);
}

// Full 256x256 -> 512 product, then fold.
inline Fe fe_mul(const Fe& a, const Fe& b) {
    u64 t[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)a.n.v[i] * b.n.v[j] + t[i + j];
            t[i + j] = (u64)c;
            c >>= 64;
        }
        t[i + 4] = (u64)c;
    }
    return fe_reduce_512(t);
}

// Dedicated squaring: 10 partial products instead of 16 (the doubling
// formulas are squaring-heavy, ~35% of the ecmult field ops).
inline Fe fe_sqr(const Fe& a) {
    const u64 a0 = a.n.v[0], a1 = a.n.v[1], a2 = a.n.v[2], a3 = a.n.v[3];
    u64 t[8];
    u64 c0 = 0, c1 = 0, c2 = 0;
    // column accumulator: (c2:c1:c0) += product, twice for cross terms
    auto muladd = [&](u64 x, u64 y) {
        u128 p = (u128)x * y;
        u64 pl = (u64)p, ph = (u64)(p >> 64);
        c0 += pl;
        ph += (c0 < pl) ? 1 : 0;  // pl carry (ph < 2^64-1 before inc)
        c1 += ph;
        c2 += (c1 < ph) ? 1 : 0;
    };
    auto extract = [&](u64* out) {
        *out = c0;
        c0 = c1;
        c1 = c2;
        c2 = 0;
    };
    muladd(a0, a0);
    extract(&t[0]);
    muladd(a0, a1);
    muladd(a0, a1);
    extract(&t[1]);
    muladd(a0, a2);
    muladd(a0, a2);
    muladd(a1, a1);
    extract(&t[2]);
    muladd(a0, a3);
    muladd(a0, a3);
    muladd(a1, a2);
    muladd(a1, a2);
    extract(&t[3]);
    muladd(a1, a3);
    muladd(a1, a3);
    muladd(a2, a2);
    extract(&t[4]);
    muladd(a2, a3);
    muladd(a2, a3);
    extract(&t[5]);
    muladd(a3, a3);
    extract(&t[6]);
    t[7] = c0;
    return fe_reduce_512(t);
}

inline Fe fe_mul_small(const Fe& a, u64 k) {
    u128 c = 0;
    u64 lo[5];
    for (int i = 0; i < 4; i++) {
        c += (u128)a.n.v[i] * k;
        lo[i] = (u64)c;
        c >>= 64;
    }
    lo[4] = (u64)c;
    u128 c2 = (u128)lo[4] * FIELD_C + lo[0];
    U256 r;
    r.v[0] = (u64)c2;
    c2 >>= 64;
    for (int i = 1; i < 4; i++) {
        c2 += lo[i];
        r.v[i] = (u64)c2;
        c2 >>= 64;
    }
    if ((u64)c2) {
        u128 c4 = (u128)FIELD_C + r.v[0];
        r.v[0] = (u64)c4;
        c4 >>= 64;
        for (int i = 1; i < 4 && c4; i++) {
            c4 += r.v[i];
            r.v[i] = (u64)c4;
            c4 >>= 64;
        }
    }
    return fe_from_u256(r);
}

inline Fe fe_pow(const Fe& a, const U256& e) {
    Fe acc;
    acc.n = {{1, 0, 0, 0}};
    bool started = false;
    for (int i = 3; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) acc = fe_sqr(acc);
            if ((e.v[i] >> b) & 1) {
                if (!started) {
                    acc = a;
                    started = true;
                } else {
                    acc = fe_mul(acc, a);
                }
            }
        }
    }
    return acc;
}

inline Fe fe_inv(const Fe& a) {  // a^(p-2); 0 -> 0
    U256 e = FIELD_P();
    e.v[0] -= 2;
    return fe_pow(a, e);
}

// Candidate sqrt a^((p+1)/4); caller must verify candidate^2 == a.
inline Fe fe_sqrt_candidate(const Fe& a) {
    // (p+1)/4: add 1 then shift right by 2.
    U256 e = FIELD_P();
    u128 c = (u128)e.v[0] + 1;
    e.v[0] = (u64)c;  // no further carry: p's low limb + 1 doesn't overflow
    for (int i = 0; i < 3; i++) e.v[i] = (e.v[i] >> 2) | (e.v[i + 1] << 62);
    e.v[3] >>= 2;
    return fe_pow(a, e);
}

// ---------------------------------------------------------------------------
// Scalar mod n (group order).

inline const U256& ORDER_N() {
    static const U256 n = {{0xBFD25E8CD0364141ull, 0xBAAEDCE6AF48A03Bull,
                            0xFFFFFFFFFFFFFFFEull, 0xFFFFFFFFFFFFFFFFull}};
    return n;
}
// 2^256 - n (129 bits), little-endian limbs.
inline const u64* ORDER_NC() {
    static const u64 nc[3] = {0x402DA1732FC9BEBFull, 0x4551231950B75FC4ull, 1ull};
    return nc;
}

struct Sc {
    U256 n;  // always < order
};

inline bool sc_is_zero(const Sc& a) { return u256_is_zero(a.n); }

inline Sc sc_from_u256(const U256& x) {
    Sc r;
    r.n = x;
    if (u256_cmp(r.n, ORDER_N()) >= 0) u256_sub(r.n, r.n, ORDER_N());
    return r;
}

inline Sc sc_from_be(const u8* b) { return sc_from_u256(u256_from_be(b)); }

inline Sc sc_add(const Sc& a, const Sc& b) {
    Sc r;
    u64 c = u256_add(r.n, a.n, b.n);
    if (c || u256_cmp(r.n, ORDER_N()) >= 0) u256_sub(r.n, r.n, ORDER_N());
    return r;
}

inline Sc sc_sub(const Sc& a, const Sc& b) {
    Sc r;
    if (u256_sub(r.n, a.n, b.n)) u256_add(r.n, r.n, ORDER_N());
    return r;
}

inline Sc sc_neg(const Sc& a) {
    Sc r;
    if (sc_is_zero(a)) return a;
    u256_sub(r.n, ORDER_N(), a.n);
    return r;
}

// Reduce a multi-limb value mod n by repeated 2^256 ≡ NC folding.
inline Sc sc_reduce_wide(const u64* t, int limbs) {
    // value = sum t[i] 2^(64 i); fold everything above limb 3 via
    // 2^256 ≡ NC (129 bits) until it fits 4 limbs, then cond-subtract.
    u64 cur[9] = {0};
    int nl = limbs;
    for (int i = 0; i < limbs; i++) cur[i] = t[i];
    while (nl > 4) {
        int hi_limbs = nl - 4;
        u64 hi[5] = {0};
        for (int i = 0; i < hi_limbs; i++) hi[i] = cur[4 + i];
        // lo = cur[0..3]; acc = lo + hi * NC(3 limbs)
        u64 acc[9] = {cur[0], cur[1], cur[2], cur[3], 0, 0, 0, 0, 0};
        const u64* nc = ORDER_NC();
        for (int i = 0; i < hi_limbs; i++) {
            u128 c = 0;
            for (int j = 0; j < 3; j++) {
                c += (u128)hi[i] * nc[j] + acc[i + j];
                acc[i + j] = (u64)c;
                c >>= 64;
            }
            int k = i + 3;
            while (c) {
                c += acc[k];
                acc[k] = (u64)c;
                c >>= 64;
                k++;
            }
        }
        int top = hi_limbs + 3;  // highest possibly-nonzero limb index
        if (top > 8) top = 8;
        nl = top + 1;
        while (nl > 4 && acc[nl - 1] == 0) nl--;
        for (int i = 0; i < 9; i++) cur[i] = acc[i];
    }
    U256 r = {{cur[0], cur[1], cur[2], cur[3]}};
    Sc s;
    s.n = r;
    while (u256_cmp(s.n, ORDER_N()) >= 0) u256_sub(s.n, s.n, ORDER_N());
    return s;
}

inline Sc sc_mul(const Sc& a, const Sc& b) {
    u64 t[8] = {0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)a.n.v[i] * b.n.v[j] + t[i + j];
            t[i + j] = (u64)c;
            c >>= 64;
        }
        t[i + 4] = (u64)c;
    }
    return sc_reduce_wide(t, 8);
}

inline Sc sc_pow(const Sc& a, const U256& e) {
    Sc acc;
    acc.n = {{1, 0, 0, 0}};
    bool started = false;
    for (int i = 3; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            if (started) acc = sc_mul(acc, acc);
            if ((e.v[i] >> b) & 1) {
                if (!started) {
                    acc = a;
                    started = true;
                } else {
                    acc = sc_mul(acc, a);
                }
            }
        }
    }
    return acc;
}

inline Sc sc_inv(const Sc& a) {  // Fermat: a^(n-2); 0 -> 0
    U256 e = ORDER_N();
    e.v[0] -= 2;
    return sc_pow(a, e);
}

inline bool sc_is_high(const Sc& a) {  // a > n/2 ?
    static const U256 half = {{0xDFE92F46681B20A0ull, 0x5D576E7357A4501Dull,
                               0xFFFFFFFFFFFFFFFFull, 0x7FFFFFFFFFFFFFFFull}};
    return u256_cmp(a.n, half) > 0;
}

// ---------------------------------------------------------------------------
// Group: Jacobian coordinates, same formula content as secp_host.PointJ
// (dbl-2009-l / add-2007-bl with explicit special cases).

struct Ge {  // affine
    Fe x, y;
    bool infinity;
};

struct Gej {  // jacobian; infinity <=> z == 0
    Fe x, y, z;
};

inline Gej gej_infinity() {
    Gej r;
    r.x.n = {{1, 0, 0, 0}};
    r.y.n = {{1, 0, 0, 0}};
    r.z.n = {{0, 0, 0, 0}};
    return r;
}

inline bool gej_is_infinity(const Gej& a) { return fe_is_zero(a.z); }

inline Gej gej_from_ge(const Ge& a) {
    Gej r;
    r.x = a.x;
    r.y = a.y;
    r.z.n = {{1, 0, 0, 0}};
    if (a.infinity) r = gej_infinity();
    return r;
}

inline Gej gej_double(const Gej& p) {
    if (gej_is_infinity(p)) return p;
    Fe A = fe_sqr(p.x);
    Fe B = fe_sqr(p.y);
    Fe C = fe_sqr(B);
    Fe xb = fe_add(p.x, B);
    Fe D = fe_sub(fe_sub(fe_sqr(xb), A), C);
    D = fe_add(D, D);
    Fe E = fe_add(fe_add(A, A), A);
    Fe F = fe_sqr(E);
    Gej r;
    r.x = fe_sub(F, fe_add(D, D));
    Fe c8 = fe_add(C, C);
    c8 = fe_add(c8, c8);
    c8 = fe_add(c8, c8);
    r.y = fe_sub(fe_mul(E, fe_sub(D, r.x)), c8);
    Fe yz = fe_mul(p.y, p.z);
    r.z = fe_add(yz, yz);
    return r;
}

inline Gej gej_add(const Gej& p, const Gej& q) {
    if (gej_is_infinity(p)) return q;
    if (gej_is_infinity(q)) return p;
    Fe z1z1 = fe_sqr(p.z);
    Fe z2z2 = fe_sqr(q.z);
    Fe u1 = fe_mul(p.x, z2z2);
    Fe u2 = fe_mul(q.x, z1z1);
    Fe s1 = fe_mul(fe_mul(p.y, q.z), z2z2);
    Fe s2 = fe_mul(fe_mul(q.y, p.z), z1z1);
    if (fe_eq(u1, u2)) {
        if (!fe_eq(s1, s2)) return gej_infinity();
        return gej_double(p);
    }
    Fe h = fe_sub(u2, u1);
    Fe h2 = fe_add(h, h);
    Fe i = fe_sqr(h2);
    Fe j = fe_mul(h, i);
    Fe rr = fe_sub(s2, s1);
    rr = fe_add(rr, rr);
    Fe v = fe_mul(u1, i);
    Gej r;
    r.x = fe_sub(fe_sub(fe_sqr(rr), j), fe_add(v, v));
    Fe s1j = fe_mul(s1, j);
    r.y = fe_sub(fe_mul(rr, fe_sub(v, r.x)), fe_add(s1j, s1j));
    Fe zs = fe_add(p.z, q.z);
    r.z = fe_mul(fe_sub(fe_sub(fe_sqr(zs), z1z1), z2z2), h);
    return r;
}

inline Gej gej_add_ge(const Gej& p, const Ge& q) {
    Gej qj = gej_from_ge(q);
    return gej_add(p, qj);
}

inline Gej gej_neg(const Gej& p) {
    Gej r = p;
    r.y = fe_neg(r.y);
    return r;
}

inline bool gej_to_affine(const Gej& p, Fe* x, Fe* y) {
    if (gej_is_infinity(p)) return false;
    Fe zi = fe_inv(p.z);
    Fe zi2 = fe_sqr(zi);
    *x = fe_mul(p.x, zi2);
    *y = fe_mul(p.y, fe_mul(zi2, zi));
    return true;
}

// ---------------------------------------------------------------------------
// Curve constants + G odd-multiple table (computed once at startup).

inline const Ge& GEN() {
    static Ge g = [] {
        Ge r;
        static const u8 gx[32] = {0x79, 0xBE, 0x66, 0x7E, 0xF9, 0xDC, 0xBB,
                                  0xAC, 0x55, 0xA0, 0x62, 0x95, 0xCE, 0x87,
                                  0x0B, 0x07, 0x02, 0x9B, 0xFC, 0xDB, 0x2D,
                                  0xCE, 0x28, 0xD9, 0x59, 0xF2, 0x81, 0x5B,
                                  0x16, 0xF8, 0x17, 0x98};
        static const u8 gy[32] = {0x48, 0x3A, 0xDA, 0x77, 0x26, 0xA3, 0xC4,
                                  0x65, 0x5D, 0xA4, 0xFB, 0xFC, 0x0E, 0x11,
                                  0x08, 0xA8, 0xFD, 0x17, 0xB4, 0x48, 0xA6,
                                  0x85, 0x54, 0x19, 0x9C, 0x47, 0xD0, 0x8F,
                                  0xFB, 0x10, 0xD4, 0xB8};
        r.x = fe_from_be(gx);
        r.y = fe_from_be(gy);
        r.infinity = false;
        return r;
    }();
    return g;
}

// Odd multiples of G: {1, 3, 5, ..., 2*GTAB-1} * G, affine (w=7 -> 64).
constexpr int GTAB = 64;

inline const Ge* G_TABLE() {
    static Ge table[GTAB];
    static bool init = [] {
        Gej g = gej_from_ge(GEN());
        Gej g2 = gej_double(g);
        Gej cur = g;
        for (int i = 0; i < GTAB; i++) {
            Fe x = {}, y = {};  // always written (cur is never infinity)
            gej_to_affine(cur, &x, &y);
            table[i].x = x;
            table[i].y = y;
            table[i].infinity = false;
            cur = gej_add(cur, g2);
        }
        return true;
    }();
    (void)init;
    return table;
}

// wNAF encoding of a scalar: digits in {±1, ±3, ..., ±(2^(w-1)-1)}, at
// most 257 entries. Returns number of digits (little-endian order).
inline int wnaf(const Sc& a, int w, int* out) {
    // copy into a mutable multi-limb value (always positive here)
    u64 k[5] = {a.n.v[0], a.n.v[1], a.n.v[2], a.n.v[3], 0};
    auto is_zero = [&] {
        return (k[0] | k[1] | k[2] | k[3] | k[4]) == 0;
    };
    auto shr1 = [&] {
        for (int i = 0; i < 4; i++) k[i] = (k[i] >> 1) | (k[i + 1] << 63);
        k[4] >>= 1;
    };
    int len = 0;
    u64 mask = (1ull << w) - 1;
    u64 sign_bit = 1ull << (w - 1);
    while (!is_zero()) {
        int d = 0;
        if (k[0] & 1) {
            u64 low = k[0] & mask;
            if (low & sign_bit) {
                d = int(low) - int(1ull << w);
                // k -= d (d negative -> add |d|)
                u128 c = (u128)(u64)(-d) + k[0];
                k[0] = (u64)c;
                c >>= 64;
                for (int i = 1; i < 5 && c; i++) {
                    c += k[i];
                    k[i] = (u64)c;
                    c >>= 64;
                }
            } else {
                d = int(low);
                u128 bw = 0;
                u128 dd = (u128)k[0] - (u64)d;
                k[0] = (u64)dd;
                bw = (dd >> 64) ? 1 : 0;
                for (int i = 1; i < 5 && bw; i++) {
                    u128 e = (u128)k[i] - bw;
                    k[i] = (u64)e;
                    bw = (e >> 64) ? 1 : 0;
                }
            }
        }
        out[len++] = d;
        shr1();
    }
    return len;
}

// GLV scalar decomposition (defined with the GLV constants further
// down; declared here for ecmult).
struct GlvSplit {
    u64 a1[2];  // |k1| < 2^128, little-endian
    u64 a2[2];
    int neg1, neg2;
    bool ok;
};
inline GlvSplit split_lambda(const Sc& k);

// R = a*G + b*P, plain Strauss over the full 256-bit scalars. Kept as
// the (unreachable-in-practice) fallback for a failed GLV split.
inline Gej ecmult_full(const Sc& a, const Sc& b, const Ge& P) {
    int wa[260], wb[260];
    int la = sc_is_zero(a) ? 0 : wnaf(a, 7, wa);
    int lb = sc_is_zero(b) ? 0 : wnaf(b, 5, wb);
    // odd multiples of P: {1,3,...,15} * P (jacobian)
    Gej ptab[8];
    if (lb) {
        Gej pj = gej_from_ge(P);
        Gej p2 = gej_double(pj);
        ptab[0] = pj;
        for (int i = 1; i < 8; i++) ptab[i] = gej_add(ptab[i - 1], p2);
    }
    const Ge* gtab = G_TABLE();
    int len = la > lb ? la : lb;
    Gej r = gej_infinity();
    for (int i = len - 1; i >= 0; i--) {
        r = gej_double(r);
        if (i < la && wa[i]) {
            int d = wa[i];
            Ge t = gtab[(d > 0 ? d : -d) / 2];
            if (d < 0) t.y = fe_neg(t.y);
            r = gej_add_ge(r, t);
        }
        if (i < lb && wb[i]) {
            int d = wb[i];
            Gej t = ptab[(d > 0 ? d : -d) / 2];
            if (d < 0) t.y = fe_neg(t.y);
            r = gej_add(r, t);
        }
    }
    return r;
}

// GLV endomorphism: lambda*(x, y) = (BETA*x, y); beta^3 = 1 mod p.
// Same (lambda, beta) pairing as crypto/glv.py / ops/curve.py.
inline const Fe& GLV_BETA() {
    static const Fe b = [] {
        static const u8 bb[32] = {
            0x7a, 0xe9, 0x6a, 0x2b, 0x65, 0x7c, 0x07, 0x10,
            0x6e, 0x64, 0x47, 0x9e, 0xac, 0x34, 0x34, 0xe9,
            0x9c, 0xf0, 0x49, 0x75, 0x12, 0xf5, 0x89, 0x95,
            0xc1, 0x39, 0x6c, 0x28, 0x71, 0x95, 0x01, 0xee};
        return fe_from_be(bb);
    }();
    return b;
}

// lambda * (odd multiples of G): the G table with beta-transformed x.
inline const Ge* BETA_G_TABLE() {
    static Ge table[GTAB];
    static bool init = [] {
        const Ge* g = G_TABLE();
        for (int i = 0; i < GTAB; i++) {
            table[i].x = fe_mul(g[i].x, GLV_BETA());
            table[i].y = g[i].y;
            table[i].infinity = false;
        }
        return true;
    }();
    (void)init;
    return table;
}

// R = a*G + b*P via a 4-stream GLV Strauss: each scalar splits into two
// signed <=128-bit halves (k = k1 + lambda*k2), halving the shared
// doublings from ~257 to ~129 — the same endomorphism the pallas kernel
// and the reference's ecmult_impl.h use. Digit signs fold the halves'
// signs; the lambda streams read beta-transformed tables.
inline Gej ecmult(const Sc& a, const Sc& b, const Ge& P) {
    bool use_a = !sc_is_zero(a), use_b = !sc_is_zero(b);
    GlvSplit sa, sb;
    if (use_a) {
        sa = split_lambda(a);
        if (!sa.ok) return ecmult_full(a, b, P);
    }
    if (use_b) {
        sb = split_lambda(b);
        if (!sb.ok) return ecmult_full(a, b, P);
    }
    int w1[132], w2[132], w3[132], w4[132];
    int l1 = 0, l2 = 0, l3 = 0, l4 = 0;
    Sc h;
    h.n = {{0, 0, 0, 0}};
    if (use_a) {
        h.n.v[0] = sa.a1[0];
        h.n.v[1] = sa.a1[1];
        l1 = sc_is_zero(h) ? 0 : wnaf(h, 7, w1);
        h.n.v[0] = sa.a2[0];
        h.n.v[1] = sa.a2[1];
        l2 = sc_is_zero(h) ? 0 : wnaf(h, 7, w2);
    }
    if (use_b) {
        h.n.v[0] = sb.a1[0];
        h.n.v[1] = sb.a1[1];
        l3 = sc_is_zero(h) ? 0 : wnaf(h, 5, w3);
        h.n.v[0] = sb.a2[0];
        h.n.v[1] = sb.a2[1];
        l4 = sc_is_zero(h) ? 0 : wnaf(h, 5, w4);
    }
    // odd multiples {1,3,...,15} of P and lambda*P (x scaled by beta)
    Gej ptab[8], bptab[8];
    if (l3 | l4) {
        Gej pj = gej_from_ge(P);
        Gej p2 = gej_double(pj);
        ptab[0] = pj;
        for (int i = 1; i < 8; i++) ptab[i] = gej_add(ptab[i - 1], p2);
        for (int i = 0; i < 8; i++) {
            bptab[i].x = fe_mul(ptab[i].x, GLV_BETA());
            bptab[i].y = ptab[i].y;
            bptab[i].z = ptab[i].z;
        }
    }
    const Ge* gtab = G_TABLE();
    const Ge* bgtab = BETA_G_TABLE();
    int len = l1;
    if (l2 > len) len = l2;
    if (l3 > len) len = l3;
    if (l4 > len) len = l4;
    Gej r = gej_infinity();
    for (int i = len - 1; i >= 0; i--) {
        r = gej_double(r);
        if (i < l1 && w1[i]) {
            int d = sa.neg1 ? -w1[i] : w1[i];
            Ge t = gtab[(d > 0 ? d : -d) / 2];
            if (d < 0) t.y = fe_neg(t.y);
            r = gej_add_ge(r, t);
        }
        if (i < l2 && w2[i]) {
            int d = sa.neg2 ? -w2[i] : w2[i];
            Ge t = bgtab[(d > 0 ? d : -d) / 2];
            if (d < 0) t.y = fe_neg(t.y);
            r = gej_add_ge(r, t);
        }
        if (i < l3 && w3[i]) {
            int d = sb.neg1 ? -w3[i] : w3[i];
            Gej t = ptab[(d > 0 ? d : -d) / 2];
            if (d < 0) t.y = fe_neg(t.y);
            r = gej_add(r, t);
        }
        if (i < l4 && w4[i]) {
            int d = sb.neg2 ? -w4[i] : w4[i];
            Gej t = bptab[(d > 0 ? d : -d) / 2];
            if (d < 0) t.y = fe_neg(t.y);
            r = gej_add(r, t);
        }
    }
    return r;
}

// ---------------------------------------------------------------------------
// lift_x / pubkey parsing (secp_host.parse_pubkey semantics).

inline Fe fe_seven() {
    Fe s;
    s.n = {{7, 0, 0, 0}};
    return s;
}

inline bool lift_x(const U256& x_u, bool odd, Ge* out) {
    if (u256_cmp(x_u, FIELD_P()) >= 0) return false;
    Fe x;
    x.n = x_u;
    Fe rhs = fe_add(fe_mul(fe_sqr(x), x), fe_seven());
    Fe y = fe_sqrt_candidate(rhs);
    if (!fe_eq(fe_sqr(y), rhs)) return false;
    if (fe_is_odd(y) != odd) y = fe_neg(y);
    out->x = x;
    out->y = y;
    out->infinity = false;
    return true;
}

// Structural + on-curve validation of the 65-byte uncompressed/hybrid
// form (eckey_impl.h parse rules incl. the 0x06/0x07 parity commitment).
// Shared by the host-exact verify path and the lane-prep path so the
// hybrid rules can never diverge between them.
inline bool parse_uncompressed_pubkey(const u8* data, Fe* x_out, Fe* y_out) {
    U256 xu = u256_from_be(data + 1);
    U256 yu = u256_from_be(data + 33);
    if (u256_cmp(xu, FIELD_P()) >= 0 || u256_cmp(yu, FIELD_P()) >= 0)
        return false;
    Fe x, y;
    x.n = xu;
    y.n = yu;
    Fe rhs = fe_add(fe_mul(fe_sqr(x), x), fe_seven());
    if (!fe_eq(fe_sqr(y), rhs)) return false;
    bool y_odd = fe_is_odd(y);
    if (data[0] == 6 && y_odd) return false;
    if (data[0] == 7 && !y_odd) return false;
    *x_out = x;
    *y_out = y;
    return true;
}

inline bool parse_pubkey(const u8* data, size_t len, Ge* out) {
    if (len == 33 && (data[0] == 2 || data[0] == 3)) {
        return lift_x(u256_from_be(data + 1), data[0] == 3, out);
    }
    if (len == 65 && (data[0] == 4 || data[0] == 6 || data[0] == 7)) {
        Fe x, y;
        if (!parse_uncompressed_pubkey(data, &x, &y)) return false;
        out->x = x;
        out->y = y;
        out->infinity = false;
        return true;
    }
    return false;
}

// ---------------------------------------------------------------------------
// Lax-DER parse (pubkey.cpp:28-168 semantics, mirroring
// secp_host.parse_der_lax). Returns: 0 = structural failure, 1 = ok with
// (r, s) scalars (overflow of either -> both zeroed).

inline int parse_der_lax(const u8* sig, size_t inputlen, Sc* r_out, Sc* s_out) {
    size_t pos = 0;

    auto read_len = [&](i64* out_len) -> bool {
        if (pos == inputlen) return false;
        u32 lenbyte = sig[pos++];
        if (lenbyte & 0x80) {
            lenbyte -= 0x80;
            if (lenbyte > inputlen - pos) return false;
            while (lenbyte > 0 && sig[pos] == 0) {
                pos++;
                lenbyte--;
            }
            if (lenbyte >= 4) return false;
            i64 val = 0;
            while (lenbyte > 0) {
                val = (val << 8) + sig[pos];
                pos++;
                lenbyte--;
            }
            *out_len = val;
        } else {
            *out_len = lenbyte;
        }
        return true;
    };

    if (pos == inputlen || sig[pos] != 0x30) return 0;
    pos++;
    if (pos == inputlen) return 0;
    u32 lenbyte = sig[pos++];
    if (lenbyte & 0x80) {
        lenbyte -= 0x80;
        if (lenbyte > inputlen - pos) return 0;
        pos += lenbyte;
    }

    auto read_integer = [&](size_t* valpos, i64* vallen) -> bool {
        if (pos == inputlen || sig[pos] != 0x02) return false;
        pos++;
        if (!read_len(vallen)) return false;
        if (*vallen < 0 || (u64)*vallen > inputlen - pos) return false;
        *valpos = pos;
        pos += *vallen;
        return true;
    };

    size_t rpos, spos;
    i64 rlen, slen;
    if (!read_integer(&rpos, &rlen)) return 0;
    if (!read_integer(&spos, &slen)) return 0;

    auto extract = [&](size_t valpos, i64 vallen, U256* out) -> bool {
        while (vallen > 0 && sig[valpos] == 0) {
            valpos++;
            vallen--;
        }
        if (vallen > 32) return false;  // overflow
        u8 be[32] = {0};
        std::memcpy(be + 32 - vallen, sig + valpos, vallen);
        *out = u256_from_be(be);
        return true;
    };

    U256 r_u, s_u;
    bool r_ok = extract(rpos, rlen, &r_u);
    bool s_ok = extract(spos, slen, &s_u);
    if (!r_ok || !s_ok || u256_cmp(r_u, ORDER_N()) >= 0 ||
        u256_cmp(s_u, ORDER_N()) >= 0) {
        r_out->n = {{0, 0, 0, 0}};
        s_out->n = {{0, 0, 0, 0}};
        return 1;
    }
    r_out->n = r_u;
    s_out->n = s_u;
    return 1;
}

// ---------------------------------------------------------------------------
// Verify algebras.

inline bool verify_ecdsa(const u8* pub, size_t publen, const u8* sig,
                         size_t siglen, const u8* msg32) {
    Ge P;
    if (!parse_pubkey(pub, publen, &P)) return false;
    Sc r, s;
    if (!parse_der_lax(sig, siglen, &r, &s)) return false;
    if (sc_is_high(s)) s = sc_neg(s);
    if (sc_is_zero(r) || sc_is_zero(s)) return false;
    Sc m = sc_from_be(msg32);
    Sc sinv = sc_inv(s);
    Sc u1 = sc_mul(m, sinv);
    Sc u2 = sc_mul(r, sinv);
    Gej R = ecmult(u1, u2, P);
    if (gej_is_infinity(R)) return false;
    // accept iff R.x_affine mod n == r, compared in Jacobian space to
    // avoid the field inversion (ecdsa_impl.h:241-273 z^2 trick):
    // x_affine == c  <=>  x_jacobian == c * z^2, for c in {r, r + n}
    // (r + n only when it is still a valid x coordinate, < p).
    Fe z2 = fe_sqr(R.z);
    Fe rfe;
    rfe.n = r.n;  // r < n < p
    if (fe_eq(R.x, fe_mul(rfe, z2))) return true;
    U256 rn;
    u64 carry = u256_add(rn, r.n, ORDER_N());
    if (!carry && u256_cmp(rn, FIELD_P()) < 0) {
        Fe rn_fe;
        rn_fe.n = rn;
        return fe_eq(R.x, fe_mul(rn_fe, z2));
    }
    return false;
}

inline const TagMidstate& BIP340_CHALLENGE() {
    static TagMidstate t("BIP0340/challenge");
    return t;
}

inline bool verify_schnorr(const u8* pk32, const u8* sig64, const u8* msg32) {
    U256 px = u256_from_be(pk32);
    Ge P;
    if (!lift_x(px, false, &P)) return false;
    U256 r_u = u256_from_be(sig64);
    if (u256_cmp(r_u, FIELD_P()) >= 0) return false;
    U256 s_u = u256_from_be(sig64 + 32);
    if (u256_cmp(s_u, ORDER_N()) >= 0) return false;
    Sc s;
    s.n = s_u;
    u8 ch_in[96];
    std::memcpy(ch_in, sig64, 32);
    std::memcpy(ch_in + 32, pk32, 32);
    std::memcpy(ch_in + 64, msg32, 32);
    u8 e_b[32];
    BIP340_CHALLENGE().hash(ch_in, 96, e_b);
    Sc e = sc_from_be(e_b);
    Gej R = ecmult(s, sc_neg(e), P);
    Fe x, y;
    if (!gej_to_affine(R, &x, &y)) return false;
    if (fe_is_odd(y)) return false;
    return u256_cmp(x.n, r_u) == 0;
}

inline bool tweak_add_check(const u8* tweaked32, int parity, const u8* internal32,
                            const u8* tweak32) {
    Ge P;
    if (!lift_x(u256_from_be(internal32), false, &P)) return false;
    U256 t_u = u256_from_be(tweak32);
    if (u256_cmp(t_u, ORDER_N()) >= 0) return false;
    Sc t;
    t.n = t_u;
    Sc one;
    one.n = {{1, 0, 0, 0}};
    Gej Q = ecmult(t, one, P);
    Fe x, y;
    if (!gej_to_affine(Q, &x, &y)) return false;
    if (u256_cmp(x.n, u256_from_be(tweaked32)) != 0) return false;
    return (fe_is_odd(y) ? 1 : 0) == (parity & 1);
}

// ---------------------------------------------------------------------------
// GLV lambda split (crypto/glv.py semantics: exact rounded division).
// k -> (|k1|, neg1, |k2|, neg2) with |ki| < 2^128 and
// s1|k1| + lambda s2|k2| ≡ k (mod n).

inline const Sc& GLV_LAMBDA() {
    static const Sc l = [] {
        static const u8 be[32] = {0x53, 0x63, 0xad, 0x4c, 0xc0, 0x5c, 0x30,
                                  0xe0, 0xa5, 0x26, 0x1c, 0x02, 0x88, 0x12,
                                  0x64, 0x5a, 0x12, 0x2e, 0x22, 0xea, 0x20,
                                  0x81, 0x66, 0x78, 0xdf, 0x02, 0x96, 0x7c,
                                  0x1b, 0x23, 0xbd, 0x72};
        return sc_from_be(be);
    }();
    return l;
}

// |b1| = 0xE4437ED6010E88286F547FA90ABFE4C3 (b1 itself is negative),
// b2 = 0x3086D221A7D46BCDE86C90E49284EB15.
inline const u64* GLV_AB1() {
    static const u64 v[2] = {0x6F547FA90ABFE4C3ull, 0xE4437ED6010E8828ull};
    return v;
}
inline const u64* GLV_B2() {
    static const u64 v[2] = {0xE86C90E49284EB15ull, 0x3086D221A7D46BCDull};
    return v;
}

// floor((c128 * k256 + n/2) / n) for a 128-bit constant c and k < n.
// Exact via quotient-tracking fold reduction: while x >= 2^256, replace
// hi·2^256 with hi·NC (NC = 2^256 - n), crediting hi to the quotient —
// each fold shrinks x by ~127 bits, so 3 folds + a couple of final
// conditional subtracts give the exact floor. (Invariant: x + q·n is
// constant.) ~100 u64 ops per call.
inline void glv_round_div(const u64 c[2], const U256& k, U256* q_out) {
    // numerator x = c * k + n/2  (<= ~2^385), 7 limbs
    u64 x[8] = {0};
    for (int i = 0; i < 2; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            carry += (u128)c[i] * k.v[j] + x[i + j];
            x[i + j] = (u64)carry;
            carry >>= 64;
        }
        x[i + 4] = (u64)carry;
    }
    // + n/2 (floor)
    static const u64 half_n[4] = {0xDFE92F46681B20A0ull, 0x5D576E7357A4501Dull,
                                  0xFFFFFFFFFFFFFFFFull, 0x7FFFFFFFFFFFFFFFull};
    u128 cc = 0;
    for (int i = 0; i < 4; i++) {
        cc += (u128)x[i] + half_n[i];
        x[i] = (u64)cc;
        cc >>= 64;
    }
    for (int i = 4; i < 8 && cc; i++) {
        cc += x[i];
        x[i] = (u64)cc;
        cc >>= 64;
    }
    const u64* nc = ORDER_NC();
    u64 q[4] = {0};  // quotient accumulator (fits ~131 bits)
    auto hi_nonzero = [&] { return x[4] | x[5] | x[6] | x[7]; };
    while (hi_nonzero()) {
        u64 hi[4] = {x[4], x[5], x[6], x[7]};
        // q += hi
        u128 qc = 0;
        for (int i = 0; i < 4; i++) {
            qc += (u128)q[i] + hi[i];
            q[i] = (u64)qc;
            qc >>= 64;
        }
        // x = lo + hi * NC(3 limbs)
        u64 acc[8] = {x[0], x[1], x[2], x[3], 0, 0, 0, 0};
        for (int i = 0; i < 4; i++) {
            if (!hi[i]) continue;
            u128 ca = 0;
            for (int j = 0; j < 3; j++) {
                ca += (u128)hi[i] * nc[j] + acc[i + j];
                acc[i + j] = (u64)ca;
                ca >>= 64;
            }
            int t = i + 3;
            while (ca && t < 8) {
                ca += acc[t];
                acc[t] = (u64)ca;
                ca >>= 64;
                t++;
            }
        }
        for (int i = 0; i < 8; i++) x[i] = acc[i];
    }
    // x < 2^256 now; final conditional subtracts.
    U256 r = {{x[0], x[1], x[2], x[3]}};
    while (u256_cmp(r, ORDER_N()) >= 0) {
        u256_sub(r, r, ORDER_N());
        u128 qc = (u128)q[0] + 1;
        q[0] = (u64)qc;
        for (int i = 1; i < 4 && (qc >> 64); i++) {
            qc = (u128)q[i] + 1;
            q[i] = (u64)qc;
        }
    }
    q_out->v[0] = q[0];
    q_out->v[1] = q[1];
    q_out->v[2] = q[2];
    q_out->v[3] = q[3];
}

inline GlvSplit split_lambda(const Sc& k) {
    GlvSplit out;
    U256 c1, c2;
    glv_round_div(GLV_B2(), k.n, &c1);   // c1 = round(b2*k/n)
    glv_round_div(GLV_AB1(), k.n, &c2);  // c2 = round(|b1|*k/n) = round(-b1*k/n)
    Sc c1s = sc_from_u256(c1);
    Sc c2s = sc_from_u256(c2);
    Sc ab1, b2;
    ab1.n = {{GLV_AB1()[0], GLV_AB1()[1], 0, 0}};
    b2.n = {{GLV_B2()[0], GLV_B2()[1], 0, 0}};
    // k2 = -(c1*b1 + c2*b2) = c1*|b1| - c2*b2 (mod n)
    Sc k2 = sc_sub(sc_mul(c1s, ab1), sc_mul(c2s, b2));
    // k1 = k - k2*lambda (mod n)
    Sc k1 = sc_sub(k, sc_mul(k2, GLV_LAMBDA()));
    Sc h1 = k1, h2 = k2;
    out.neg1 = 0;
    out.neg2 = 0;
    Sc n1 = sc_neg(k1);
    if (u256_cmp(k1.n, n1.n) > 0) {
        h1 = n1;
        out.neg1 = 1;
    }
    Sc n2 = sc_neg(k2);
    if (u256_cmp(k2.n, n2.n) > 0) {
        h2 = n2;
        out.neg2 = 1;
    }
    out.a1[0] = h1.n.v[0];
    out.a1[1] = h1.n.v[1];
    out.a2[0] = h2.n.v[0];
    out.a2[1] = h2.n.v[1];
    out.ok = (h1.n.v[2] | h1.n.v[3] | h2.n.v[2] | h2.n.v[3]) == 0;
    return out;
}

}  // namespace nat
