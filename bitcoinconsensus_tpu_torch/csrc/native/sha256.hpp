// Verbatim copy of native/sha256.hpp, the JAX package's native host core, built by the port's ops/_build.py.
// SHA-256 for the native host core: streaming, midstate resume, sha256d,
// and BIP340 tagged hashing. Spec: FIPS 180-4 (constants are the published
// spec values, identical in every implementation). Reference parity:
// crypto/sha256.cpp (generic transform) + hash.cpp:89-96 TaggedHash +
// modules/schnorrsig/main_impl.h:96-109 (hardcoded tag midstates) — the
// midstate-resume API here serves the same amortization.
// A SHA-NI (x86 SHA extensions) transform is selected at runtime when the
// CPU supports it — same output, ~5x the scalar transform's throughput;
// the reference gates the equivalent specializations the same way
// (crypto/sha256.cpp SelfTest + cpuid dispatch).
#pragma once

#include <cstdint>
#include <cstring>

// __builtin_cpu_supports("sha") is only a valid feature string from
// GCC 11 (clang has carried it longer); older GCC rejects it at compile
// time, so the whole SHA-NI path is gated out there and the scalar
// transform below serves every call.
#if defined(__x86_64__) && defined(__GNUC__) && \
    (defined(__clang__) || __GNUC__ >= 11)
#define NAT_SHA_NI_POSSIBLE 1
#include <immintrin.h>
#endif

namespace nat {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;

#ifdef NAT_SHA_NI_POSSIBLE
// One-block compression via the SHA-NI instructions. State layout note:
// the SHA-NI registers hold (ABEF, CDGH); the wrappers below shuffle to
// and from the linear a..h word order.
__attribute__((target("sha,sse4.1"))) inline void sha_ni_transform(
    u32 s[8], const u8* p) {
    __m128i STATE0, STATE1, MSG, TMP, MSG0, MSG1, MSG2, MSG3;
    const __m128i MASK =
        _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

    TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&s[0]));
    STATE1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&s[4]));
    TMP = _mm_shuffle_epi32(TMP, 0xB1);        // CDAB
    STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);  // EFGH
    STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);  // ABEF
    STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);  // CDGH

    const __m128i ABEF_SAVE = STATE0;
    const __m128i CDGH_SAVE = STATE1;

#define NAT_SHA_RND(M, K0, K1)                                        \
    MSG = _mm_add_epi32(M, _mm_set_epi64x((long long)(K1), (long long)(K0))); \
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);              \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                               \
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG)

    MSG0 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 0)), MASK);
    NAT_SHA_RND(MSG0, 0x71374491428a2f98ULL, 0xe9b5dba5b5c0fbcfULL);
    MSG1 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 16)), MASK);
    NAT_SHA_RND(MSG1, 0x59f111f13956c25bULL, 0xab1c5ed5923f82a4ULL);
    MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);
    MSG2 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 32)), MASK);
    NAT_SHA_RND(MSG2, 0x12835b01d807aa98ULL, 0x550c7dc3243185beULL);
    MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);
    MSG3 = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 48)), MASK);
    NAT_SHA_RND(MSG3, 0x80deb1fe72be5d74ULL, 0xc19bf1749bdc06a7ULL);

    for (int i = 0; i < 3; i++) {
        static const u64 KS[3][8] = {
            {0xefbe4786e49b69c1ULL, 0x240ca1cc0fc19dc6ULL,
             0x4a7484aa2de92c6fULL, 0x76f988da5cb0a9dcULL,
             0xa831c66d983e5152ULL, 0xbf597fc7b00327c8ULL,
             0xd5a79147c6e00bf3ULL, 0x1429296706ca6351ULL},
            {0x2e1b213827b70a85ULL, 0x53380d134d2c6dfcULL,
             0x766a0abb650a7354ULL, 0x92722c8581c2c92eULL,
             0xa81a664ba2bfe8a1ULL, 0xc76c51a3c24b8b70ULL,
             0xd6990624d192e819ULL, 0x106aa070f40e3585ULL},
            {0x1e376c0819a4c116ULL, 0x34b0bcb52748774cULL,
             0x4ed8aa4a391c0cb3ULL, 0x682e6ff35b9cca4fULL,
             0x78a5636f748f82eeULL, 0x8cc7020884c87814ULL,
             0xa4506ceb90befffaULL, 0xc67178f2bef9a3f7ULL},
        };
        const u64* K = KS[i];
        MSG0 = _mm_sha256msg2_epu32(
            _mm_add_epi32(MSG0, _mm_alignr_epi8(MSG3, MSG2, 4)), MSG3);
        MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);
        MSG = _mm_add_epi32(MSG0, _mm_set_epi64x((long long)K[1], (long long)K[0]));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG1 = _mm_sha256msg2_epu32(
            _mm_add_epi32(MSG1, _mm_alignr_epi8(MSG0, MSG3, 4)), MSG0);
        MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);
        MSG = _mm_add_epi32(MSG1, _mm_set_epi64x((long long)K[3], (long long)K[2]));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG2 = _mm_sha256msg2_epu32(
            _mm_add_epi32(MSG2, _mm_alignr_epi8(MSG1, MSG0, 4)), MSG1);
        MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);
        MSG = _mm_add_epi32(MSG2, _mm_set_epi64x((long long)K[5], (long long)K[4]));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
        MSG3 = _mm_sha256msg2_epu32(
            _mm_add_epi32(MSG3, _mm_alignr_epi8(MSG2, MSG1, 4)), MSG2);
        MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);
        MSG = _mm_add_epi32(MSG3, _mm_set_epi64x((long long)K[7], (long long)K[6]));
        STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
        MSG = _mm_shuffle_epi32(MSG, 0x0E);
        STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
    }
#undef NAT_SHA_RND

    STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
    STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
    TMP = _mm_shuffle_epi32(STATE0, 0x1B);        // FEBA
    STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);     // DCHG
    STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);  // DCBA
    STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);     // HGFE
    _mm_storeu_si128(reinterpret_cast<__m128i*>(&s[0]), STATE0);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(&s[4]), STATE1);
}

inline bool sha_ni_available() {
    static const bool ok = __builtin_cpu_supports("sha") &&
                           __builtin_cpu_supports("sse4.1");
    return ok;
}
#endif  // NAT_SHA_NI_POSSIBLE

struct Sha256 {
    u32 s[8];
    u8 buf[64];
    u64 bytes;

    Sha256() { reset(); }

    void reset() {
        static const u32 init[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                                    0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                                    0x1f83d9abu, 0x5be0cd19u};
        std::memcpy(s, init, sizeof(s));
        bytes = 0;
    }

    // Resume from a known 8-word state that already absorbed `absorbed`
    // bytes (a multiple of 64) — the tagged-hash midstate trick.
    void resume(const u32 state[8], u64 absorbed) {
        std::memcpy(s, state, sizeof(s));
        bytes = absorbed;
    }

    static inline u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

    void transform(const u8* p) {
#ifdef NAT_SHA_NI_POSSIBLE
        if (sha_ni_available()) {
            sha_ni_transform(s, p);
            return;
        }
#endif
        transform_scalar(p);
    }

    void transform_scalar(const u8* p) {
        static const u32 K[64] = {
            0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
            0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
            0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
            0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
            0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
            0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
            0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
            0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
            0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
            0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
            0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
            0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
            0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
        u32 w[64];
        for (int i = 0; i < 16; i++)
            w[i] = (u32(p[4 * i]) << 24) | (u32(p[4 * i + 1]) << 16) |
                   (u32(p[4 * i + 2]) << 8) | u32(p[4 * i + 3]);
        for (int i = 16; i < 64; i++) {
            u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
            u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
            w[i] = w[i - 16] + s0 + w[i - 7] + s1;
        }
        u32 a = s[0], b = s[1], c = s[2], d = s[3];
        u32 e = s[4], f = s[5], g = s[6], h = s[7];
        for (int i = 0; i < 64; i++) {
            u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
            u32 ch = (e & f) ^ (~e & g);
            u32 t1 = h + S1 + ch + K[i] + w[i];
            u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
            u32 maj = (a & b) ^ (a & c) ^ (b & c);
            u32 t2 = S0 + maj;
            h = g; g = f; f = e; e = d + t1;
            d = c; c = b; b = a; a = t1 + t2;
        }
        s[0] += a; s[1] += b; s[2] += c; s[3] += d;
        s[4] += e; s[5] += f; s[6] += g; s[7] += h;
    }

    Sha256& write(const u8* data, size_t len) {
        size_t fill = bytes % 64;
        bytes += len;
        if (fill) {
            size_t take = 64 - fill;
            if (take > len) take = len;
            std::memcpy(buf + fill, data, take);
            data += take;
            len -= take;
            if (fill + take == 64) transform(buf);
            else return *this;
        }
        while (len >= 64) {
            transform(data);
            data += 64;
            len -= 64;
        }
        if (len) std::memcpy(buf, data, len);
        return *this;
    }

    void finalize(u8 out[32]) {
        u64 msgbits = bytes * 8;
        u8 pad = 0x80;
        write(&pad, 1);
        u8 zero = 0;
        while (bytes % 64 != 56) write(&zero, 1);
        u8 lenb[8];
        for (int i = 0; i < 8; i++) lenb[i] = u8(msgbits >> (56 - 8 * i));
        write(lenb, 8);
        for (int i = 0; i < 8; i++) {
            out[4 * i] = u8(s[i] >> 24);
            out[4 * i + 1] = u8(s[i] >> 16);
            out[4 * i + 2] = u8(s[i] >> 8);
            out[4 * i + 3] = u8(s[i]);
        }
    }
};

inline void sha256(const u8* data, size_t len, u8 out[32]) {
    Sha256 h;
    h.write(data, len);
    h.finalize(out);
}

inline void sha256d(const u8* data, size_t len, u8 out[32]) {
    u8 tmp[32];
    sha256(data, len, tmp);
    sha256(tmp, 32, out);
}

// Midstate after absorbing sha256(tag)||sha256(tag) — one 64-byte block.
struct TagMidstate {
    u32 s[8];

    explicit TagMidstate(const char* tag) {
        u8 th[32];
        sha256(reinterpret_cast<const u8*>(tag), std::strlen(tag), th);
        Sha256 h;
        h.write(th, 32);
        h.write(th, 32);
        // exactly one block absorbed; state is the midstate
        std::memcpy(s, h.s, sizeof(s));
    }

    void hash(const u8* data, size_t len, u8 out[32]) const {
        Sha256 h;
        h.resume(s, 64);
        h.write(data, len);
        h.finalize(out);
    }
};

}  // namespace nat
