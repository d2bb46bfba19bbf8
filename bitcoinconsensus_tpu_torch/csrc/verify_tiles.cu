// Batched secp256k1 verify: R = a·G + (±b1 ± λ·b2)·P per lane, accept on
// R.x against a target. Hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bitcoinconsensus_tpu/ops/pallas_kernel.py
// ::verify_tiles` (body `_kernel_body`, :228-428). It keeps that kernel's
// schedule exactly: y-lift of P, the {1..16}·P table at one global Z (one
// doubling, 14 flagged mixed adds, then a multiplication-only rescale), 26
// signed 5-bit windows of 5 doublings plus 2 flagged mixed adds (the λ half
// as x·β, y negated by digit sign xor GLV sign), 32 8-bit G windows, and the
// same flagged join. The flags it raises (`needs_host` on an equal-points
// case, infinity on a cancellation) are group equalities of this schedule,
// independent of coordinates, so (ok, needs_host) is bit-identical to the
// plain version `ops/verify_tiles.py::verify_tiles_reference` on every lane.
//
// What bounds it on this card. A lane moves about 150 bytes and runs about
// 2,900 field multiplies, each one thread's dependent chain of integer
// multiply-adds. At the main path's 8,192 lanes in 64-thread blocks that is
// 128 blocks on 132 SMs, one or two warps per SM: the card is bound by one
// thread's latency, not by the integer rate. So the design shortens that
// thread's chain:
//
// - One thread per lane, everything inline (`VT_FN`, __forceinline__): field
//   elements are values in registers, passed by reference to locals or
//   returned by value, never through a call's stack. __launch_bounds__(64, 1)
//   lets ptxas take up to 255 registers. The outer loops (26 windows, 32 G
//   windows, the squaring runs) stay rolled to bound code size and nvcc time.
// - Field elements are 8x32-bit words reduced lazily: every operation returns
//   a value in [0, 2^256) congruent to the exact result mod p, and only the
//   comparisons (the H and R zero tests, the square-root check, the parity
//   bits, the final x compare) canonicalise. The 512-bit product runs on PTX
//   carry chains (mad.lo.cc / madc.hi.cc / addc), and a square takes each
//   cross product once (36 multiplies of 32x32 bits instead of 64): over
//   half of a lane's multiplies are squares, and the integer multiply pipe,
//   not the chains' latency, is what the lane waits on (splitting the
//   product into two independent chain sets measured no faster). A portable
//   C++ twin takes the same steps (the square's cross sum, doubling and
//   diagonal included) on uint64_t carries and gives the same words; it
//   serves the host build. The PTX statements themselves run only on the
//   card, where `vt_field_op` holds them to the same integer model.
// - The per-lane working set that is indexed by data (the {1..16}·P table,
//   the rescale ratios, the addition chains' saved powers) lives in dynamic
//   shared memory laid out [slot][word][lane] (`vt_slots`): a warp reading
//   one word of any slot touches 32 consecutive words, one per bank, whatever
//   its digits. 47 slots x 8 words x 64 lanes x 4 bytes = 96,256 bytes a
//   block (`VT_SMEM_BYTES`, declared in VERIFY_TILES_CONTRACT). The scalar
//   digits are recoded on the fly from registers, so nothing is indexed
//   through the local-memory stack.
// - The G table (32 x 255 x 2 x 8 words, 522 KB) stays in global memory,
//   read through the read-only path; it is L2-resident and every lane reads
//   a different entry.
// - The cross-lane batch inverse of the TPU kernel is a per-lane Fermat
//   inverse; the inverse and the square root share one table-driven
//   addition chain (`fe_pow_chain`).
//
// 64-thread blocks stay: the shared bytes allow two blocks per SM, so a
// smaller block would not add lanes in flight at the main path's width, and
// a larger one would leave SMs idle at 8,192 lanes. Left for later: a thread
// team per lane (limbs spread over threads, carries across them) to put more
// warps on each SM, and wider dispatches than 8,192 lanes.
//
// Built by `ops/_build.py` with nvcc into a shared library whose C entry
// point `vt_verify_tiles` launches on the caller's stream and returns
// cudaGetLastError(); `vt_verify_tiles_checked` launches the same lane
// program with an epilogue (the verdicts as bytes and the verdict
// checksum's per-warp partials, in the one launch the verifier's dispatch
// makes); `vt_field_op` runs the field layer alone and `vt_recode` the
// scalar recoder alone.
//
// Schedule hooks (`VT_TRACE`). A host build may define VT_TRACE(ev, a, b, c,
// d) before including this file (`csrc/verify_tiles_host.cpp`): the lane
// program then reports each doubling, mixed add and join, each doubling it
// skips while R is infinity, each digit with its effective sign, and each P-
// and G-table read, from which `analysis/scalar_check.py` builds its weight
// ledger. Everywhere else, and always under nvcc, a hook is nothing.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define VT_FN __device__ __forceinline__
#define VT_CONST __constant__ const
#define VT_UNROLL _Pragma("unroll")
#define VT_ROLLED _Pragma("unroll 1")
#undef VT_TRACE
#define VT_TRACE(ev, a, b, c, d) ((void)0)
#else
// Host build of the lane program, for checking its arithmetic without a
// card: a C++ compiler sees plain inline functions.
#define VT_FN static inline
#define VT_CONST static const
#define VT_UNROLL
#define VT_ROLLED
#ifndef VT_TRACE
#define VT_TRACE(ev, a, b, c, d) ((void)0)
#endif
#endif

// Hook events (arguments a, b, c, d; unused ones 0).
#define VT_EV_DOUBLE 1        // pt_double
#define VT_EV_MADD 2          // pt_madd_flagged
#define VT_EV_JOIN 3          // pt_add_flagged
#define VT_EV_TABLE_ROW 4     // P table: a = entry k (holds (k+1)·P), b = slot
#define VT_EV_WINDOW 5        // signed window loop: a = iteration, b = window
#define VT_EV_SKIP_DOUBLES 6  // a = doublings skipped, b = R is infinity
#define VT_EV_DIGIT 7         // a = half, b = window, c = |digit|, d = sign
#define VT_EV_PREAD 8         // P table read: a = half, b = window, c = slot
#define VT_EV_GWINDOW 9       // G window loop: a = window, b = digit
#define VT_EV_GREAD 10        // G table read: a = window, b = row

struct fe {
  uint32_t v[8];  // little-endian words; a value in [0, 2^256), lazily mod p
};

VT_CONST uint32_t VT_P[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                             0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
VT_CONST uint32_t VT_N[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                             0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
VT_CONST uint32_t VT_GX[8] = {0x16F81798u, 0x59F2815Bu, 0x2DCE28D9u, 0x029BFCDBu,
                              0xCE870B07u, 0x55A06295u, 0xF9DCBBACu, 0x79BE667Eu};
VT_CONST uint32_t VT_GY[8] = {0xFB10D4B8u, 0x9C47D08Fu, 0xA6855419u, 0xFD17B448u,
                              0x0E1108A8u, 0x5DA4FBFCu, 0x26A3C465u, 0x483ADA77u};
VT_CONST uint32_t VT_BETA[8] = {0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u,
                                0xAC3434E9u, 0x6E64479Eu, 0x657C0710u, 0x7AE96A2Bu};

#define VT_SGLV_WINDOWS 26
#define VT_SGLV_WIDTH 5
#define VT_G_WINDOWS 32
#define VT_G_ENTRIES 255
#define VT_THREADS 64
// Shared slots of one lane: table entry e's x at 2e, y at 2e + 1 (e < 16);
// ratio k (1..15) at 31 + k. The addition chains reuse slots 0..6 while the
// table is not live (before it is built, after the windows).
#define VT_SLOTS 47
#define VT_SMEM_BYTES (VT_SLOTS * 8 * VT_THREADS * 4)
#define VT_RATIO_SLOT(k) (31 + (k))

// ---------------------------------------------------------------------------
// Field arithmetic mod p = 2^256 - K, K = 0x1000003D1 = 2^32 + 977.
// Inputs and outputs of every operation are in [0, 2^256); the bounds of the
// intermediates are stated where they are used.

VT_FN fe fe_from(const uint32_t* w) {
  fe r;
  VT_UNROLL for (int i = 0; i < 8; i++) r.v[i] = w[i];
  return r;
}

VT_FN fe fe_small(uint32_t x) {
  fe r;
  r.v[0] = x;
  VT_UNROLL for (int i = 1; i < 8; i++) r.v[i] = 0;
  return r;
}

VT_FN bool fe_eq_words(const fe& a, const uint32_t* w) {
  uint32_t d = 0;
  VT_UNROLL for (int i = 0; i < 8; i++) d |= a.v[i] ^ w[i];
  return d == 0;
}

// The canonical representative: a < 2^256 < 2p, so at most one p comes off.
// a >= p iff a + K carries out of 2^256, and then a - p = a + K - 2^256.
VT_FN fe fe_canon(const fe& a) {
  fe s;
  uint64_t c = (uint64_t)a.v[0] + 977u;
  s.v[0] = (uint32_t)c;
  c = (c >> 32) + a.v[1] + 1u;
  s.v[1] = (uint32_t)c;
  VT_UNROLL for (int i = 2; i < 8; i++) {
    c = (c >> 32) + a.v[i];
    s.v[i] = (uint32_t)c;
  }
  return (c >> 32) ? s : a;
}

// a ≡ 0 mod p: a is 0 or p (a < 2^256 < 2p).
VT_FN bool fe_is_zero(const fe& a) {
  uint32_t z = 0, q = 0;
  VT_UNROLL for (int i = 0; i < 8; i++) {
    z |= a.v[i];
    q |= a.v[i] ^ VT_P[i];
  }
  return z == 0 || q == 0;
}

// -- carry-chain primitives: PTX on the card, uint64_t on the host ----------

#ifdef __CUDACC__

// r += (top + top2·2^32)·K with top2·2^32 + top < 2^32 + 979, then once more
// with the carry out, whose sum cannot carry: the first add leaves a value
// below 2^256 + 2^67, so a carry leaves words below 2^67 and K more fits.
VT_FN void fe_fold(fe& r, uint32_t top, uint32_t top2) {
  uint32_t e0 = top * 977u;
  uint64_t s = (uint64_t)__umulhi(top, 977u) + top + (uint64_t)top2 * 977u;
  uint32_t e1 = (uint32_t)s, e2 = (uint32_t)(s >> 32) + top2, f;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
        "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(f)
      : "r"(e0), "r"(e1), "r"(e2));
  if (!f) return;  // the second fold is rare: skip its chain
  uint32_t k0 = f * 977u;
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
        "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7])
      : "r"(k0), "r"(f));
}

// t[i..i+8] = t[i..i+7] + lo(a_i·b_j)·2^(32j): row i's low halves; t[i+8]
// (not yet written) takes the carry, 0 or 1.
#define VT_ROW_LO(i)                                                        \
  asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"                                  \
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"                                 \
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"                                 \
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"                                 \
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"                                 \
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"                                 \
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"                                 \
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"                                 \
      "addc.u32 %8, 0, 0;"                                                  \
      : "+r"(t[i]), "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]),         \
        "+r"(t[i + 4]), "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]),     \
        "=r"(t[i + 8])                                                      \
      : "r"(a.v[i]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),   \
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]))

// t[i+1..i+8] += hi(a_i·b_j)·2^(32(j+1)): row i's high halves. The sum of
// rows 0..i is below 2^(32(i+9)), so nothing carries out of t[i+8].
#define VT_ROW_HI(i)                                                        \
  asm("mad.hi.cc.u32 %0, %8, %9, %0;\n\t"                                   \
      "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"                                 \
      "madc.hi.cc.u32 %2, %8, %11, %2;\n\t"                                 \
      "madc.hi.cc.u32 %3, %8, %12, %3;\n\t"                                 \
      "madc.hi.cc.u32 %4, %8, %13, %4;\n\t"                                 \
      "madc.hi.cc.u32 %5, %8, %14, %5;\n\t"                                 \
      "madc.hi.cc.u32 %6, %8, %15, %6;\n\t"                                 \
      "madc.hi.u32 %7, %8, %16, %7;"                                        \
      : "+r"(t[i + 1]), "+r"(t[i + 2]), "+r"(t[i + 3]), "+r"(t[i + 4]),     \
        "+r"(t[i + 5]), "+r"(t[i + 6]), "+r"(t[i + 7]), "+r"(t[i + 8])      \
      : "r"(a.v[i]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),   \
        "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]))

// The exact 512-bit product, operand-scanning on carry chains.
VT_FN void fe_mul_wide(uint32_t t[16], const fe& a, const fe& b) {
  VT_UNROLL for (int j = 0; j < 8; j++) t[j] = a.v[0] * b.v[j];
  t[8] = 0;
  VT_ROW_HI(0);
  VT_ROW_LO(1); VT_ROW_HI(1);
  VT_ROW_LO(2); VT_ROW_HI(2);
  VT_ROW_LO(3); VT_ROW_HI(3);
  VT_ROW_LO(4); VT_ROW_HI(4);
  VT_ROW_LO(5); VT_ROW_HI(5);
  VT_ROW_LO(6); VT_ROW_HI(6);
  VT_ROW_LO(7); VT_ROW_HI(7);
}

// lo + hi·K for t = lo + hi·2^256: below 2^256·(2^32 + 978), so r plus a
// top of 33 bits (top2 is its bit 32; top2 = 1 forces top < 978), folded.
VT_FN fe fe_reduce_wide(const uint32_t t[16]) {
  fe r;
  uint32_t top, top2, k = 977u;
  asm("mad.lo.cc.u32 %0, %9, %17, %18;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %19;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %20;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %21;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %22;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %23;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %24;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %25;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]),
        "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7]), "=r"(top)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]),
        "r"(t[14]), "r"(t[15]), "r"(k), "r"(t[0]), "r"(t[1]), "r"(t[2]),
        "r"(t[3]), "r"(t[4]), "r"(t[5]), "r"(t[6]), "r"(t[7]));
  // hi(t[8+j]·977) into word j+1; top stays below 1 + 976 + 1.
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %7;"
      : "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "+r"(top)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]),
        "r"(t[14]), "r"(t[15]), "r"(k));
  // hi·2^32: t[8+j] into word j+1, the carry past the top into top2.
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "+r"(top), "=r"(top2)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]), "r"(t[13]),
        "r"(t[14]), "r"(t[15]));
  fe_fold(r, top, top2);
  return r;
}

// a^2 with each cross product a_i·a_j (i < j) taken once: the cross sum
// (rows i = 0..6 of a_i·a_{i+1..7}, below 2^480 so in words 0..14), doubled
// by funnel shifts, plus the squares a_i^2 on one carry chain. Row i's high
// chain cannot carry out of word i+8: rows 0..i sum below 2^(32(i+9)).
VT_FN fe fe_sqr(const fe& a) {
  uint32_t c[15], t[16];
  c[0] = 0;
  VT_UNROLL for (int j = 1; j < 8; j++) c[j] = a.v[0] * a.v[j];
  c[8] = 0;
  asm("mad.hi.cc.u32 %0, %7, %8, %0;\n\t"
      "madc.hi.cc.u32 %1, %7, %9, %1;\n\t"
      "madc.hi.cc.u32 %2, %7, %10, %2;\n\t"
      "madc.hi.cc.u32 %3, %7, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, %7, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %7, %13, %5;\n\t"
      "madc.hi.u32 %6, %7, %14, %6;"
      : "+r"(c[2]), "+r"(c[3]), "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]), "+r"(c[8])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
      "madc.lo.cc.u32 %1, %7, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %7, %10, %2;\n\t"
      "madc.lo.cc.u32 %3, %7, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %7, %12, %4;\n\t"
      "madc.lo.cc.u32 %5, %7, %13, %5;\n\t"
      "addc.u32 %6, 0, 0;"
      : "+r"(c[3]), "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]), "+r"(c[8]), "=r"(c[9])
      : "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.hi.cc.u32 %0, %6, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %6, %8, %1;\n\t"
      "madc.hi.cc.u32 %2, %6, %9, %2;\n\t"
      "madc.hi.cc.u32 %3, %6, %10, %3;\n\t"
      "madc.hi.cc.u32 %4, %6, %11, %4;\n\t"
      "madc.hi.u32 %5, %6, %12, %5;"
      : "+r"(c[4]), "+r"(c[5]), "+r"(c[6]), "+r"(c[7]), "+r"(c[8]), "+r"(c[9])
      : "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %6, %7, %0;\n\t"
      "madc.lo.cc.u32 %1, %6, %8, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %9, %2;\n\t"
      "madc.lo.cc.u32 %3, %6, %10, %3;\n\t"
      "madc.lo.cc.u32 %4, %6, %11, %4;\n\t"
      "addc.u32 %5, 0, 0;"
      : "+r"(c[5]), "+r"(c[6]), "+r"(c[7]), "+r"(c[8]), "+r"(c[9]), "=r"(c[10])
      : "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.hi.cc.u32 %0, %5, %6, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %8, %2;\n\t"
      "madc.hi.cc.u32 %3, %5, %9, %3;\n\t"
      "madc.hi.u32 %4, %5, %10, %4;"
      : "+r"(c[6]), "+r"(c[7]), "+r"(c[8]), "+r"(c[9]), "+r"(c[10])
      : "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
      "madc.lo.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %5, %8, %2;\n\t"
      "madc.lo.cc.u32 %3, %5, %9, %3;\n\t"
      "addc.u32 %4, 0, 0;"
      : "+r"(c[7]), "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "=r"(c[11])
      : "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.hi.cc.u32 %0, %4, %5, %0;\n\t"
      "madc.hi.cc.u32 %1, %4, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %4, %7, %2;\n\t"
      "madc.hi.u32 %3, %4, %8, %3;"
      : "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11])
      : "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
      "madc.lo.cc.u32 %1, %4, %6, %1;\n\t"
      "madc.lo.cc.u32 %2, %4, %7, %2;\n\t"
      "addc.u32 %3, 0, 0;"
      : "+r"(c[9]), "+r"(c[10]), "+r"(c[11]), "=r"(c[12])
      : "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.hi.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %5, %1;\n\t"
      "madc.hi.u32 %2, %3, %6, %2;"
      : "+r"(c[10]), "+r"(c[11]), "+r"(c[12])
      : "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
      "madc.lo.cc.u32 %1, %3, %5, %1;\n\t"
      "addc.u32 %2, 0, 0;"
      : "+r"(c[11]), "+r"(c[12]), "=r"(c[13])
      : "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.hi.cc.u32 %0, %2, %3, %0;\n\t"
      "madc.hi.u32 %1, %2, %4, %1;"
      : "+r"(c[12]), "+r"(c[13])
      : "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
      "addc.u32 %1, 0, 0;"
      : "+r"(c[13]), "=r"(c[14])
      : "r"(a.v[6]), "r"(a.v[7]));
  asm("mad.hi.u32 %0, %1, %2, %0;"
      : "+r"(c[14])
      : "r"(a.v[6]), "r"(a.v[7]));

  t[0] = 0;
  VT_UNROLL for (int k = 1; k < 15; k++) t[k] = __funnelshift_l(c[k - 1], c[k], 1);
  t[15] = c[14] >> 31;
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  return fe_reduce_wide(t);
}

// a + b < 2^257: the carry (0 or 1) folds once.
VT_FN fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint32_t c;
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]),
        "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7]), "=r"(c)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  fe_fold(r, c, 0);
  return r;
}

// r - m·K (mod 2^256) for a mask m of 0 or all ones; returns the new borrow
// mask.
VT_FN uint32_t fe_sub_k_masked(fe& r, uint32_t m) {
  uint32_t k0 = m & 977u, k1 = m & 1u, bw;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 %8, 0, 0;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
        "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "=r"(bw)
      : "r"(k0), "r"(k1));
  return bw;
}

// a - b: on a borrow the wrapped value a - b + 2^256 loses K (that is,
// a - b + p); if that borrows again (a - b < -p, possible for a
// non-canonical b) it loses K once more (a - b + 2p), which cannot borrow.
VT_FN fe fe_sub(const fe& a, const fe& b) {
  fe r;
  uint32_t bw;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]),
        "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7]), "=r"(bw)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  bw = fe_sub_k_masked(r, bw);
  if (bw) fe_sub_k_masked(r, bw);
  return r;
}

// a·k for k <= 8: below 2^259, so a top word below 8 folds once.
VT_FN fe fe_mul_int(const fe& a, uint32_t k) {
  fe r;
  uint32_t top;
  VT_UNROLL for (int i = 0; i < 8; i++) r.v[i] = a.v[i] * k;
  asm("mad.hi.cc.u32 %0, %8, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %16, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %16, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %16, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %16, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %16, %6;\n\t"
      "madc.hi.u32 %7, %15, %16, %17;"
      : "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]), "+r"(r.v[5]),
        "+r"(r.v[6]), "+r"(r.v[7]), "=r"(top)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(k), "r"(0u));
  fe_fold(r, top, 0);
  return r;
}

#else  // the portable twin: the same values by uint64_t carries

VT_FN void fe_fold(fe& r, uint32_t top, uint32_t top2) {
  // tt·K = tt·977 + tt·2^32 as three words e0, e1, e2, added; then the
  // carry's K.
  uint64_t tt = (uint64_t)top + ((uint64_t)top2 << 32);  // < 2^32 + 979
  uint64_t m = tt * 977u;  // < 2^43, exact
  uint64_t e0 = m & 0xFFFFFFFFu;
  uint64_t hi = (m >> 32) + tt;  // < 2^34
  uint64_t e1 = hi & 0xFFFFFFFFu, e2 = hi >> 32;
  uint64_t c = (uint64_t)r.v[0] + e0;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + r.v[1] + e1;
  r.v[1] = (uint32_t)c;
  c = (c >> 32) + r.v[2] + e2;
  r.v[2] = (uint32_t)c;
  for (int i = 3; i < 8; i++) {
    c = (c >> 32) + r.v[i];
    r.v[i] = (uint32_t)c;
  }
  uint32_t f = (uint32_t)(c >> 32);
  c = (uint64_t)r.v[0] + f * 977u;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + r.v[1] + f;
  r.v[1] = (uint32_t)c;
  for (int i = 2; i < 8; i++) {
    c = (c >> 32) + r.v[i];
    r.v[i] = (uint32_t)c;
  }
}

VT_FN void fe_mul_wide(uint32_t t[16], const fe& a, const fe& b) {
  for (int i = 0; i < 16; i++) t[i] = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.v[i] * b.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
}

VT_FN fe fe_reduce_wide(const uint32_t t[16]) {
  fe r;
  uint64_t c = 0, h = 0;  // c: the running sum; h: hi(t[7+i]·977) owed
  for (int i = 0; i < 8; i++) {
    uint64_t m = (uint64_t)t[8 + i] * 977u;
    c += (uint64_t)t[i] + (m & 0xFFFFFFFFu) + h;
    if (i > 0) c += t[7 + i];
    h = m >> 32;
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  c += h + t[15];  // < 2^32 + 979
  fe_fold(r, (uint32_t)c, (uint32_t)(c >> 32));
  return r;
}

VT_FN fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, (uint32_t)c, 0);
  return r;
}

VT_FN uint32_t fe_sub_k_masked(fe& r, uint32_t m) {
  int64_t c = (int64_t)r.v[0] - (m & 977u);
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + r.v[1] - (m & 1u);
  r.v[1] = (uint32_t)c;
  for (int i = 2; i < 8; i++) {
    c = (c >> 32) + r.v[i];
    r.v[i] = (uint32_t)c;
  }
  return (c >> 32) ? 0xFFFFFFFFu : 0u;
}

VT_FN fe fe_sub(const fe& a, const fe& b) {
  fe r;
  int64_t c = 0;
  for (int i = 0; i < 8; i++) {
    c += (int64_t)a.v[i] - (int64_t)b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: 0 or -1
  }
  uint32_t bw = c ? 0xFFFFFFFFu : 0u;
  bw = fe_sub_k_masked(r, bw);
  if (bw) fe_sub_k_masked(r, bw);
  return r;
}

VT_FN fe fe_mul_int(const fe& a, uint32_t k) {
  fe r;
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] * k;
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, (uint32_t)c, 0);
  return r;
}

#endif  // __CUDACC__

VT_FN fe fe_mul(const fe& a, const fe& b) {
  uint32_t t[16];
  fe_mul_wide(t, a, b);
  return fe_reduce_wide(t);
}

#ifndef __CUDACC__
// The card's square in portable form, the same steps: the cross sum of
// a_i·a_j (i < j) row by row (below 2^480, words 0..14), doubled by one-bit
// funnel shifts, plus the diagonal a_i^2 on one carry pass. The 512-bit
// square is exact, so its words, and the reduced result, are fe_mul(a, a)'s.
VT_FN fe fe_sqr(const fe& a) {
  uint32_t c[15], t[16];
  for (int k = 0; k < 15; k++) c[k] = 0;
  for (int i = 0; i < 7; i++) {
    uint64_t cy = 0;
    for (int j = i + 1; j < 8; j++) {
      cy += (uint64_t)a.v[i] * a.v[j] + c[i + j];
      c[i + j] = (uint32_t)cy;
      cy >>= 32;
    }
    c[i + 8] = (uint32_t)cy;  // rows 0..i sum below 2^(32(i+9))
  }
  t[0] = 0;
  for (int k = 1; k < 15; k++) t[k] = (c[k] << 1) | (c[k - 1] >> 31);
  t[15] = c[14] >> 31;
  uint64_t cy = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t d = (uint64_t)a.v[i] * a.v[i];
    cy += (uint64_t)t[2 * i] + (uint32_t)d;
    t[2 * i] = (uint32_t)cy;
    cy = (cy >> 32) + (uint64_t)t[2 * i + 1] + (d >> 32);
    t[2 * i + 1] = (uint32_t)cy;
    cy >>= 32;  // 0 after the last word: the square is below 2^512
  }
  return fe_reduce_wide(t);
}
#endif

VT_FN fe fe_neg(const fe& a) { return fe_sub(fe_small(0), a); }

// The field layer on its own, one operation per lane (the host tests build
// the same function from the portable twin): 0 mul, 1 sqr, 2 add, 3 sub,
// 4 mul_int by k, 5 canon, 6 is_zero (1 or 0 in word 0).
VT_FN fe fe_apply(int op, const fe& a, const fe& b, uint32_t k) {
  switch (op) {
    case 0: return fe_mul(a, b);
    case 1: return fe_sqr(a);
    case 2: return fe_add(a, b);
    case 3: return fe_sub(a, b);
    case 4: return fe_mul_int(a, k);
    case 5: return fe_canon(a);
    default: return fe_small(fe_is_zero(a) ? 1u : 0u);
  }
}

// ---------------------------------------------------------------------------
// A lane's shared slots: word w of slot k at p[(8k + w)·stride]. On the card
// p is the block's dynamic shared memory offset by the lane, stride the
// block's threads; on the host a local array with stride 1.

struct vt_slots {
  uint32_t* p;
  int stride;
};

VT_FN fe slot_get(const vt_slots& s, int k) {
  fe r;
  VT_UNROLL for (int w = 0; w < 8; w++) r.v[w] = s.p[(8 * k + w) * s.stride];
  return r;
}

VT_FN void slot_put(const vt_slots& s, int k, const fe& a) {
  VT_UNROLL for (int w = 0; w < 8; w++) s.p[(8 * k + w) * s.stride] = a.v[w];
}

// The addition chains a^(p-2) (inverse; 0 -> 0) and a^((p+1)/4) (a square
// root when one exists), after libsecp256k1's field chains: each step
// squares the running value `nsqr` times, multiplies by a saved power
// (slot `mul`; 7: none) and saves the result (slot `save`; 7: none). Slots:
// 0 a, 1 x2, 2 x3, 3 x11, 4 x22, 5 x44, 6 x88, where xk = a^(2^k - 1).
struct vt_step {
  uint8_t nsqr, mul, save;
};

#define VT_CHAIN_HEAD                                                         \
  {1, 0, 1}, {1, 0, 2}, {3, 2, 7}, {3, 2, 7}, {2, 1, 3}, {11, 3, 4},           \
      {22, 4, 5}, {44, 5, 6}, {88, 6, 7}, {44, 5, 7}, {3, 2, 7}, {23, 4, 7}
VT_CONST vt_step VT_INV_CHAIN[15] = {VT_CHAIN_HEAD, {5, 0, 7}, {3, 1, 7},
                                     {2, 0, 7}};
VT_CONST vt_step VT_SQRT_CHAIN[14] = {VT_CHAIN_HEAD, {6, 1, 7}, {2, 7, 7}};

VT_FN fe fe_pow_chain(const fe& a, bool inverse, const vt_slots& s) {
  const vt_step* steps = inverse ? VT_INV_CHAIN : VT_SQRT_CHAIN;
  int n = inverse ? 15 : 14;
  slot_put(s, 0, a);
  fe t = a;
  VT_ROLLED for (int i = 0; i < n; i++) {
    vt_step st = steps[i];
    VT_ROLLED for (int k = 0; k < st.nsqr; k++) t = fe_sqr(t);
    if (st.mul != 7) t = fe_mul(t, slot_get(s, st.mul));
    if (st.save != 7) slot_put(s, st.save, t);
  }
  return t;
}

// ---------------------------------------------------------------------------
// Group law on Jacobian points (X, Y, Z); infinity is tracked by the caller
// as a flag, exactly as the TPU kernel carries its masks.

struct pt {
  fe X, Y, Z;
};

VT_FN pt pt_inf() {
  pt p;
  p.X = fe_small(1);
  p.Y = fe_small(1);
  p.Z = fe_small(0);
  return p;
}

// dbl-2009-l (a = 0).
VT_FN pt pt_double(const pt& p) {
  VT_TRACE(VT_EV_DOUBLE, 0, 0, 0, 0);
  fe A = fe_sqr(p.X);
  fe B = fe_sqr(p.Y);
  fe C = fe_sqr(B);
  fe t = fe_sqr(fe_add(p.X, B));
  fe D = fe_mul_int(fe_sub(t, fe_add(A, C)), 2);
  fe E = fe_mul_int(A, 3);
  fe F = fe_sqr(E);
  pt r;
  r.Z = fe_mul_int(fe_mul(p.Y, p.Z), 2);
  r.X = fe_sub(F, fe_mul_int(D, 2));
  r.Y = fe_sub(fe_mul(E, fe_sub(D, r.X)), fe_mul_int(C, 8));
  return r;
}

// Flagged mixed addition R + (x2, y2), madd-2007-bl, R known finite. Sets
// h_zero / r_zero (H = U2 - X1 ≡ 0, S2 - Y1 ≡ 0). On h_zero && !r_zero
// (R = -Q) the result is infinity; on h_zero && r_zero (R = Q) it is garbage
// and the caller defers the lane. `ratio` receives 2H = Z3/Z1.
VT_FN pt pt_madd_core(const pt& p, const fe& x2, const fe& y2, bool& h_zero,
                      bool& r_zero, fe& ratio) {
  fe Z1Z1 = fe_sqr(p.Z);
  fe U2 = fe_mul(x2, Z1Z1);
  fe S2 = fe_mul(y2, fe_mul(p.Z, Z1Z1));
  fe H = fe_sub(U2, p.X);
  fe Rs = fe_sub(S2, p.Y);
  h_zero = fe_is_zero(H);
  r_zero = fe_is_zero(Rs);
  ratio = fe_mul_int(H, 2);
  fe HH = fe_sqr(H);
  fe I = fe_mul_int(HH, 4);
  fe J = fe_mul(H, I);
  fe rr = fe_mul_int(Rs, 2);
  fe V = fe_mul(p.X, I);
  pt r;
  r.X = fe_sub(fe_sqr(rr), fe_add(J, fe_mul_int(V, 2)));
  r.Y = fe_sub(fe_mul(rr, fe_sub(V, r.X)), fe_mul_int(fe_mul(p.Y, J), 2));
  r.Z = fe_sub(fe_sqr(fe_add(p.Z, H)), fe_add(Z1Z1, HH));
  if (h_zero && !r_zero) r = pt_inf();
  return r;
}

// R += (x2, y2) with R's infinity flag `inf`; ORs the equal-points case
// into `needs` (only when R was finite).
VT_FN void pt_madd_flagged(pt& R, bool& inf, const fe& x2, const fe& y2,
                           bool& needs) {
  VT_TRACE(VT_EV_MADD, 0, 0, 0, 0);
  if (inf) {
    R.X = x2;
    R.Y = y2;
    R.Z = fe_small(1);
    inf = false;
    return;
  }
  bool h0, r0;
  fe unused;
  R = pt_madd_core(R, x2, y2, h0, r0, unused);
  inf = h0 && !r0;
  needs = needs || (h0 && r0);
}

// The flagged join R1 + R2 (add-2007-bl) with both infinity flags.
VT_FN void pt_add_flagged(pt& R, bool& inf1, const pt& Q, bool inf2,
                          bool& needs) {
  VT_TRACE(VT_EV_JOIN, 0, 0, 0, 0);
  if (inf2) return;  // result R1, infinity flag unchanged
  if (inf1) {
    R = Q;
    inf1 = false;
    return;
  }
  fe Z1Z1 = fe_sqr(R.Z);
  fe Z2Z2 = fe_sqr(Q.Z);
  fe U1 = fe_mul(R.X, Z2Z2);
  fe U2 = fe_mul(Q.X, Z1Z1);
  fe S1 = fe_mul(R.Y, fe_mul(Q.Z, Z2Z2));
  fe S2 = fe_mul(Q.Y, fe_mul(R.Z, Z1Z1));
  fe H = fe_sub(U2, U1);
  fe Rs = fe_sub(S2, S1);
  bool h0 = fe_is_zero(H), r0 = fe_is_zero(Rs);
  needs = needs || (h0 && r0);
  if (h0 && !r0) {
    R = pt_inf();
    inf1 = true;
    return;
  }
  fe I = fe_sqr(fe_mul_int(H, 2));
  fe J = fe_mul(H, I);
  fe rr = fe_mul_int(Rs, 2);
  fe V = fe_mul(U1, I);
  pt r;
  r.X = fe_sub(fe_sqr(rr), fe_add(J, fe_mul_int(V, 2)));
  r.Y = fe_sub(fe_mul(rr, fe_sub(V, r.X)), fe_mul_int(fe_mul(S1, J), 2));
  fe t = fe_sub(fe_sqr(fe_add(R.Z, Q.Z)), fe_add(Z1Z1, Z2Z2));
  r.Z = fe_mul(t, H);
  R = r;
}

// ---------------------------------------------------------------------------
// Scalar recoding, from registers.

struct u128 {
  uint32_t w0, w1, w2, w3;
};

VT_FN uint32_t u128_word(const u128& b, int i) {
  return i == 0 ? b.w0 : i == 1 ? b.w1 : i == 2 ? b.w2 : i == 3 ? b.w3 : 0u;
}

// Bits 5w..5w+4 of b; bits past 127 read as zero.
VT_FN uint32_t window5(const u128& b, int w) {
  int pos = 5 * w, wi = pos >> 5, sh = pos & 31;
  uint64_t v = (uint64_t)u128_word(b, wi) | ((uint64_t)u128_word(b, wi + 1) << 32);
  return (uint32_t)(v >> sh) & 31u;
}

// Signed 5-bit windows of a value < 2^128 (`pallas_kernel.py::
// _signed_digits128`): digit w is window5 + its carry-in, minus 32 when that
// reaches 16. Returns the carry-ins as a bit mask; the top window never
// carries out (bits 125..127 + carry <= 8 < 16).
VT_FN uint32_t signed_carries(const u128& b) {
  uint32_t mask = 0, carry = 0;
  VT_ROLLED for (int w = 0; w < VT_SGLV_WINDOWS; w++) {
    mask |= carry << w;
    carry = window5(b, w) + carry >= 16u;
  }
  return mask;
}

// |digit| and its sign at window w.
VT_FN uint32_t signed_digit(const u128& b, uint32_t carries, int w,
                            uint32_t& neg) {
  uint32_t t = window5(b, w) + ((carries >> w) & 1u);
  neg = t >= 16u;
  return neg ? 32u - t : t;
}

// ---------------------------------------------------------------------------
// One lane. `w` points at the lane's 32 packed words: a, |b1|‖|b2|, px, t1
// (each 8 little-endian words). gtab: (32, 255, 2, 8) canonical affine words;
// row d - 1 of window i holds d·256^i·G.

VT_FN size_t gtab_offset(int i, int d) {
  return ((size_t)(i * VT_G_ENTRIES + d - 1) * 2) * 8;
}

#ifdef __CUDACC__
VT_FN void gtab_entry(const uint32_t* __restrict__ gtab, int i, int d, fe& gx,
                      fe& gy) {
  const uint4* e = reinterpret_cast<const uint4*>(gtab + gtab_offset(i, d));
  uint4 q0 = __ldg(e), q1 = __ldg(e + 1), q2 = __ldg(e + 2), q3 = __ldg(e + 3);
  gx.v[0] = q0.x; gx.v[1] = q0.y; gx.v[2] = q0.z; gx.v[3] = q0.w;
  gx.v[4] = q1.x; gx.v[5] = q1.y; gx.v[6] = q1.z; gx.v[7] = q1.w;
  gy.v[0] = q2.x; gy.v[1] = q2.y; gy.v[2] = q2.z; gy.v[3] = q2.w;
  gy.v[4] = q3.x; gy.v[5] = q3.y; gy.v[6] = q3.z; gy.v[7] = q3.w;
}
#else
VT_FN void gtab_entry(const uint32_t* gtab, int i, int d, fe& gx, fe& gy) {
  VT_TRACE(VT_EV_GREAD, gtab_offset(i, d) / 16 / VT_G_ENTRIES,
           gtab_offset(i, d) / 16 % VT_G_ENTRIES, 0, 0);
  const uint32_t* e = gtab + gtab_offset(i, d);
  gx = fe_from(e);
  gy = fe_from(e + 8);
}
#endif

VT_FN void verify_lane_slots(const uint32_t* w, int32_t want_odd,
                             int32_t parity_req, int32_t has_t2, int32_t neg1,
                             int32_t neg2, uint8_t valid_in,
                             const uint32_t* gtab, const vt_slots& s,
                             int32_t* ok_out, int32_t* needs_out) {
  const u128 b1 = {w[8], w[9], w[10], w[11]};
  const u128 b2 = {w[12], w[13], w[14], w[15]};
  const uint32_t c1 = signed_carries(b1), c2 = signed_carries(b2);

  // -- lift P's y from (x, parity): y = sqrt(x^3 + 7) ------------------------
  fe x = fe_from(w + 16);  // raw words: only their value mod p matters
  fe rhs = fe_add(fe_mul(fe_sqr(x), x), fe_small(7));
  fe y = fe_canon(fe_pow_chain(rhs, false, s));
  bool sq_ok = fe_eq_words(fe_canon(fe_sqr(y)), fe_canon(rhs).v);
  bool odd = (y.v[0] & 1u) != 0;
  if (odd != (want_odd == 1)) y = fe_neg(y);
  bool valid = valid_in != 0 && sq_ok;
  if (!valid) {  // sanitise to G; the verdict stays masked by `valid`
    x = fe_from(VT_GX);
    y = fe_from(VT_GY);
  }

  // -- {1..16}·P at one global Z, in the shared slots -------------------------
  bool needs = false;
  VT_TRACE(VT_EV_TABLE_ROW, 0, 0, 0, 0);
  slot_put(s, 0, x);
  slot_put(s, 1, y);
  slot_put(s, VT_RATIO_SLOT(1), fe_mul_int(y, 2));  // Z_1 = 2·y·Z_0, Z_0 = 1
  pt R;
  R.X = x;
  R.Y = y;
  R.Z = fe_small(1);
  R = pt_double(R);
  VT_TRACE(VT_EV_TABLE_ROW, 1, 2, 0, 0);
  slot_put(s, 2, R.X);
  slot_put(s, 3, R.Y);
  VT_ROLLED for (int k = 2; k < 16; k++) {
    bool h0, r0;
    fe ratio;
    R = pt_madd_core(R, x, y, h0, r0, ratio);
    needs = needs || (h0 && r0);
    VT_TRACE(VT_EV_TABLE_ROW, k, 2 * k, 0, 0);
    slot_put(s, 2 * k, R.X);
    slot_put(s, 2 * k + 1, R.Y);
    slot_put(s, VT_RATIO_SLOT(k), ratio);
  }
  // Rescale rows 14..0 to row 15's Z: c_k = prod_{j=k+1..15} ratio_j.
  fe c = slot_get(s, VT_RATIO_SLOT(15));
  VT_ROLLED for (int k = 14; k >= 0; k--) {
    if (k < 14) c = fe_mul(c, slot_get(s, VT_RATIO_SLOT(k + 1)));
    fe c2 = fe_sqr(c);
    fe c3 = fe_mul(c2, c);
    slot_put(s, 2 * k, fe_mul(slot_get(s, 2 * k), c2));
    slot_put(s, 2 * k + 1, fe_mul(slot_get(s, 2 * k + 1), c3));
  }
  const fe global_z = c;

  // -- (±b1 ± λ·b2)·P: 26 signed windows on the global-Z (isomorphic) curve
  bool r_inf = true;
  R = pt_inf();
  VT_ROLLED for (int i = 0; i < VT_SGLV_WINDOWS; i++) {
    int wdw = VT_SGLV_WINDOWS - 1 - i;
    VT_TRACE(VT_EV_WINDOW, i, wdw, 0, 0);
    if (!r_inf) {  // doublings of infinity stay infinity
      VT_ROLLED for (int k = 0; k < VT_SGLV_WIDTH; k++) R = pt_double(R);
    } else {
      VT_TRACE(VT_EV_SKIP_DOUBLES, VT_SGLV_WIDTH, r_inf, 0, 0);
    }
    // The b1 half, then the λ·b2 half: one mixed add each.
    VT_ROLLED for (int h = 0; h < 2; h++) {
      uint32_t sgn;
      uint32_t d = h ? signed_digit(b2, c2, wdw, sgn) : signed_digit(b1, c1, wdw, sgn);
      uint32_t neg = sgn ^ (uint32_t)(h ? neg2 : neg1);
      VT_TRACE(VT_EV_DIGIT, h, wdw, (int)d, (int)neg);
      if (d > 0) {
        int slot = 2 * (d - 1);
        VT_TRACE(VT_EV_PREAD, h, wdw, slot, 0);
        fe sx = slot_get(s, slot);
        fe sy = slot_get(s, slot + 1);
        if (h) sx = fe_mul(sx, fe_from(VT_BETA));  // λ·(x, y) = (β·x, y)
        if (neg == 1u) sy = fe_neg(sy);
        pt_madd_flagged(R, r_inf, sx, sy, needs);
      }
    }
  }
  R.Z = fe_mul(R.Z, global_z);  // back to the true curve

  // -- a·G: 32 windows of 8 bits against the affine table --------------------
  // The scalar's words shift right one byte per window, so window i reads
  // the low byte of word 0.
  fe a = fe_from(w);
  pt Rg = pt_inf();
  bool rg_inf = true;
  VT_ROLLED for (int i = 0; i < VT_G_WINDOWS; i++) {
    int da = (int)(a.v[0] & 0xFFu);
    VT_UNROLL for (int j = 0; j < 7; j++) a.v[j] = (a.v[j] >> 8) | (a.v[j + 1] << 24);
    a.v[7] >>= 8;
    VT_TRACE(VT_EV_GWINDOW, i, da, 0, 0);
    if (da > 0) {
      fe gx, gy;
      gtab_entry(gtab, i, da, gx, gy);
      pt_madd_flagged(Rg, rg_inf, gx, gy, needs);
    }
  }
  pt_add_flagged(R, r_inf, Rg, rg_inf, needs);
  needs = needs && valid;  // invalid lanes never defer (sanitised to G)

  // -- affine + accept ---------------------------------------------------------
  bool ok = false;
  if (valid && !r_inf && !needs) {
    fe zi = fe_pow_chain(R.Z, true, s);
    fe zi2 = fe_sqr(zi);
    fe ax = fe_canon(fe_mul(R.X, zi2));
    fe ay = fe_canon(fe_mul(R.Y, fe_mul(zi2, zi)));
    // t1 ships raw: a target >= p never equals a canonical x. t1 + n is
    // compared mod p, and only when has_t2.
    const uint32_t* t1 = w + 24;
    bool ok_x = fe_eq_words(ax, t1);
    if (!ok_x && has_t2 == 1) {
      fe t1n = fe_canon(fe_add(fe_from(t1), fe_from(VT_N)));
      ok_x = fe_eq_words(ax, t1n.v);
    }
    bool y_odd = (ay.v[0] & 1u) != 0;
    bool par_ok = parity_req < 0 || (y_odd == (parity_req == 1));
    ok = ok_x && par_ok;
  }
  *ok_out = ok ? 1 : 0;
  *needs_out = needs ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The checked launch's epilogue (`vt_verify_checked_kernel`). Lane i of a
// launch of n lanes adds three int32 terms to its warp's partials, from the
// verdicts the lane program just stored:
//
//     count = ok        wsum = ok · (i % 251 + 1)      fails = live ∧ ¬ok ∧ ¬needs
//
// the verdict checksum pair of `verdict_checksum.cu` and the failure count
// of `shard_step.cu`, with i the lane's index within the launch (each shard
// of the mesh is a launch of its own, so the weights restart at every
// shard, as the reference's `local_step` checksums a shard's slice). A lane
// at or past n, or a launch without `live`, adds 0 where it has no value.
// A warp's sum stays below 32 · 251, inside int32.
#define VT_CHECK_MOD 251
#define VT_CHECKED_MAX_LANES (1 << 23)  // the summed weights stay inside int32

VT_FN void vt_epilogue_terms(int i, int n, int32_t ok, int32_t needs,
                             const uint8_t* live, int32_t t[3]) {
  const int32_t in = i < n;
  const int32_t v = in & (ok != 0);
  t[0] = v;
  t[1] = v * (i % VT_CHECK_MOD + 1);
  t[2] = (live != nullptr && in) ? (int32_t)(live[i] != 0 && !v && needs == 0) : 0;
}

#ifndef __CUDACC__
// The host entry of the lane program: its slots in a local array.
VT_FN void verify_lane(const uint32_t* w, int32_t want_odd, int32_t parity_req,
                       int32_t has_t2, int32_t neg1, int32_t neg2,
                       uint8_t valid_in, const uint32_t* gtab, int32_t* ok_out,
                       int32_t* needs_out) {
  uint32_t slots[VT_SLOTS * 8];
  vt_slots s = {slots, 1};
  verify_lane_slots(w, want_odd, parity_req, has_t2, neg1, neg2, valid_in, gtab,
                    s, ok_out, needs_out);
}
#endif

#ifdef __CUDACC__

__global__ void __launch_bounds__(VT_THREADS, 1)
    vt_verify_kernel(const uint32_t* __restrict__ fields,
                     const int32_t* __restrict__ want_odd,
                     const int32_t* __restrict__ parity_req,
                     const int32_t* __restrict__ has_t2,
                     const int32_t* __restrict__ neg1,
                     const int32_t* __restrict__ neg2,
                     const uint8_t* __restrict__ valid,
                     const uint32_t* __restrict__ gtab,
                     int32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t vt_smem[];
  int i = blockIdx.x * VT_THREADS + threadIdx.x;
  if (i >= n) return;  // lanes share no data: no barrier follows
  uint32_t w[32];
  const uint4* src = reinterpret_cast<const uint4*>(fields + 32 * (size_t)i);
  VT_UNROLL for (int k = 0; k < 8; k++) {
    uint4 q = src[k];
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
  vt_slots s = {vt_smem + threadIdx.x, VT_THREADS};
  verify_lane_slots(w, want_odd[i], parity_req[i], has_t2[i], neg1[i], neg2[i],
                    valid[i], gtab, s, out + i, out + n + i);
}

// Launchers take their arguments packed as one array of 64-bit words
// (`ops/launch.py`: ctypes converts one pointer instead of each argument).
#define VT_PTR(a, i) ((void*)(intptr_t)(a)[i])

// Launch contract (VERIFY_TILES_CONTRACT): one 64-thread block per 64 lanes
// and VT_SMEM_BYTES of dynamic shared memory; any other launch is refused.
// Arguments: fields, want_odd, parity_req, has_t2, neg1, neg2, valid, gtab,
// out, n, grid, threads, shared bytes, stream. The shared-memory ceiling is
// raised once per device.
extern "C" int vt_verify_tiles(const int64_t* a) {
  static bool smem_raised[64];
  int n = (int)a[9], grid = (int)a[10], threads = (int)a[11];
  int smem_bytes = (int)a[12];
  if (threads != VT_THREADS || grid != (n + VT_THREADS - 1) / VT_THREADS ||
      smem_bytes != VT_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_raised[dev]) {
    err = cudaFuncSetAttribute(vt_verify_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               VT_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_raised[dev] = true;
  }
  if (n > 0) {
    vt_verify_kernel<<<grid, threads, smem_bytes, (cudaStream_t)VT_PTR(a, 13)>>>(
        (const uint32_t*)VT_PTR(a, 0), (const int32_t*)VT_PTR(a, 1),
        (const int32_t*)VT_PTR(a, 2), (const int32_t*)VT_PTR(a, 3),
        (const int32_t*)VT_PTR(a, 4), (const int32_t*)VT_PTR(a, 5),
        (const uint8_t*)VT_PTR(a, 6), (const uint32_t*)VT_PTR(a, 7),
        (int32_t*)VT_PTR(a, 8), n);
  }
  return (int)cudaGetLastError();
}

// The checked launch: the lane program above, unchanged, then its epilogue,
// so that one launch carries a dispatch's verdicts and its guard's sums.
// Each lane stores its verdicts as bytes (0 or 1) into the caller's bool
// buffers `ok_out` and `needs_out` (on the mesh, views of a card's group
// buffers); given `partials`, a (3, n_warps) int32 buffer with n_warps =
// ceil(n / 32), each warp sums its lanes' `vt_epilogue_terms` with
// shuffles and its lane 0 writes column `warp` of the three rows once. No
// shared memory, barrier or atomic is added: concurrent launches (the
// mesh's shard streams, the in-flight queue) share nothing, and the host
// sums a launch's warps. Threads past n skip the lane program but reach the
// shuffles with zeros, so every shuffle runs under a full mask; a warp
// wholly past n (the last block's second warp when n % 64 is 1..32) writes
// nothing.
__global__ void __launch_bounds__(VT_THREADS, 1)
    vt_verify_checked_kernel(const uint32_t* __restrict__ fields,
                             const int32_t* __restrict__ want_odd,
                             const int32_t* __restrict__ parity_req,
                             const int32_t* __restrict__ has_t2,
                             const int32_t* __restrict__ neg1,
                             const int32_t* __restrict__ neg2,
                             const uint8_t* __restrict__ valid,
                             const uint32_t* __restrict__ gtab,
                             uint8_t* __restrict__ ok_out,
                             uint8_t* __restrict__ needs_out,
                             const uint8_t* __restrict__ live,
                             int32_t* __restrict__ partials, int n) {
  extern __shared__ uint32_t vt_smem[];
  const int i = blockIdx.x * VT_THREADS + threadIdx.x;
  int32_t ok = 0, needs = 0;
  if (i < n) {  // no early return: the whole warp reaches the epilogue
    uint32_t w[32];
    const uint4* src = reinterpret_cast<const uint4*>(fields + 32 * (size_t)i);
    VT_UNROLL for (int k = 0; k < 8; k++) {
      uint4 q = src[k];
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
    vt_slots s = {vt_smem + threadIdx.x, VT_THREADS};
    verify_lane_slots(w, want_odd[i], parity_req[i], has_t2[i], neg1[i],
                      neg2[i], valid[i], gtab, s, &ok, &needs);
    ok_out[i] = (uint8_t)ok;
    needs_out[i] = (uint8_t)needs;
  }
  if (partials == nullptr) return;  // the same for every thread of the launch
  int32_t t[3];
  vt_epilogue_terms(i, n, ok, needs, live, t);
  VT_UNROLL for (int off = 16; off > 0; off >>= 1) {
    t[0] += __shfl_down_sync(0xffffffffu, t[0], off);
    t[1] += __shfl_down_sync(0xffffffffu, t[1], off);
    t[2] += __shfl_down_sync(0xffffffffu, t[2], off);
  }
  const int warp = i >> 5, n_warps = (n + 31) >> 5;
  if ((threadIdx.x & 31) == 0 && warp < n_warps) {
    partials[warp] = t[0];
    partials[n_warps + warp] = t[1];
    partials[2 * n_warps + warp] = t[2];
  }
}

// Launch contract (VERIFY_TILES_CHECKED_CONTRACT): as `vt_verify_tiles`'s,
// one 64-thread block per 64 lanes and VT_SMEM_BYTES of dynamic shared
// memory, with 0 <= n <= VT_CHECKED_MAX_LANES and both verdict buffers
// given; any other launch is refused. Arguments: fields, want_odd,
// parity_req, has_t2, neg1, neg2, valid, gtab, ok_out, needs_out, live (or
// 0), partials (or 0), n, grid, threads, shared bytes, stream.
extern "C" int vt_verify_tiles_checked(const int64_t* a) {
  static bool smem_raised[64];
  const int64_t n = a[12];
  const int64_t grid = a[13], threads = a[14], smem_bytes = a[15];
  if (threads != VT_THREADS || n < 0 || n > VT_CHECKED_MAX_LANES ||
      grid != (n + VT_THREADS - 1) / VT_THREADS || smem_bytes != VT_SMEM_BYTES ||
      a[8] == 0 || a[9] == 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_raised[dev]) {
    err = cudaFuncSetAttribute(vt_verify_checked_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               VT_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_raised[dev] = true;
  }
  if (n > 0) {
    vt_verify_checked_kernel<<<(unsigned)grid, VT_THREADS, VT_SMEM_BYTES,
                               (cudaStream_t)VT_PTR(a, 16)>>>(
        (const uint32_t*)VT_PTR(a, 0), (const int32_t*)VT_PTR(a, 1),
        (const int32_t*)VT_PTR(a, 2), (const int32_t*)VT_PTR(a, 3),
        (const int32_t*)VT_PTR(a, 4), (const int32_t*)VT_PTR(a, 5),
        (const uint8_t*)VT_PTR(a, 6), (const uint32_t*)VT_PTR(a, 7),
        (uint8_t*)VT_PTR(a, 8), (uint8_t*)VT_PTR(a, 9),
        (const uint8_t*)VT_PTR(a, 10), (int32_t*)VT_PTR(a, 11), (int)n);
  }
  return (int)cudaGetLastError();
}

__global__ void vt_field_kernel(int op, const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b, uint32_t k,
                                uint32_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe r = fe_apply(op, fe_from(a + 8 * (size_t)i), fe_from(b + 8 * (size_t)i), k);
  VT_UNROLL for (int w = 0; w < 8; w++) out[8 * (size_t)i + w] = r.v[w];
}

// (n, 8) words a and b -> (n, 8) words out. Arguments: op, a, b, k, out,
// n, stream.
extern "C" int vt_field_op(const int64_t* a) {
  int n = (int)a[5];
  if (n > 0)
    vt_field_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)VT_PTR(a, 6)>>>(
        (int)a[0], (const uint32_t*)VT_PTR(a, 1), (const uint32_t*)VT_PTR(a, 2),
        (uint32_t)a[3], (uint32_t*)VT_PTR(a, 4), n);
  return (int)cudaGetLastError();
}

// The lane program's recoder alone: one thread per value, the same
// `signed_carries` / `signed_digit` calls as `verify_lane_slots`.
__global__ void vt_recode_kernel(const uint32_t* __restrict__ words,
                                 int32_t* __restrict__ mag,
                                 int32_t* __restrict__ sgn, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* w = words + 4 * (size_t)i;
  const u128 b = {w[0], w[1], w[2], w[3]};
  const uint32_t carries = signed_carries(b);
  VT_UNROLL for (int wdw = 0; wdw < VT_SGLV_WINDOWS; wdw++) {
    uint32_t neg;
    mag[VT_SGLV_WINDOWS * (size_t)i + wdw] = (int32_t)signed_digit(b, carries, wdw, neg);
    sgn[VT_SGLV_WINDOWS * (size_t)i + wdw] = (int32_t)neg;
  }
}

// (n, 4) words of values below 2^128 -> (n, 26) digit magnitudes and signs.
// Arguments: words, mag, sgn, n, stream.
extern "C" int vt_recode(const int64_t* a) {
  int n = (int)a[3];
  if (n > 0)
    vt_recode_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)VT_PTR(a, 4)>>>(
        (const uint32_t*)VT_PTR(a, 0), (int32_t*)VT_PTR(a, 1),
        (int32_t*)VT_PTR(a, 2), n);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
