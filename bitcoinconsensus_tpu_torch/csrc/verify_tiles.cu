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
// case, infinity on a cancellation) are group equalities, independent of
// coordinates, so (ok, needs_host) is bit-identical to the plain version
// `ops/verify_tiles.py::verify_tiles_reference` on every lane.
//
// What bounds it on this card: integer multiply-add throughput. A lane moves
// about 150 bytes (128 packed field bytes, 6 flags, 8 bytes out) and runs
// about 2,900 field multiplies of 64 32x32->64-bit products each.
//
// Design of this first version: one thread per lane, 64-thread blocks, the
// ragged edge masked in the kernel. Field operations inline; the point
// operations and the addition chains are out-of-line calls (VT_CALL) to
// keep the code size and the build short. Field elements are 8x32-bit
// words kept canonical in [0, p) after every operation
// (2^256 ≡ 0x1000003D1 mod p).
// The per-lane P table (16 entries x 2 coordinates, plus the Z ratios) lives
// in local memory. The cross-lane batch inverse of the TPU kernel becomes a
// per-lane Fermat inverse; the G window table is read by index from global
// memory as canonical affine words, shape (32, 255, 2, 8).
//
// Built by `ops/_build.py` with nvcc into a shared library whose one C entry
// point, `vt_verify_tiles`, launches on the caller's stream and returns
// cudaGetLastError().

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define VT_FN __device__ __forceinline__
#define VT_CALL __device__ __noinline__
#define VT_CONST __constant__ const
#else
// Host build of the lane program, for checking its arithmetic without a
// card: a C++ compiler sees plain inline functions.
#define VT_FN static inline
#define VT_CALL static
#define VT_CONST static const
#endif

typedef struct {
  uint32_t v[8];  // little-endian words, canonical: value in [0, p)
} fe;

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
#define VT_G_WINDOWS 32
#define VT_G_ENTRIES 255

// ---------------------------------------------------------------------------
// Field arithmetic mod p = 2^256 - 0x1000003D1.

VT_FN void fe_set(fe* r, const uint32_t* w) {
  for (int i = 0; i < 8; i++) r->v[i] = w[i];
}

VT_FN void fe_set_small(fe* r, uint32_t x) {
  r->v[0] = x;
  for (int i = 1; i < 8; i++) r->v[i] = 0;
}

VT_FN bool fe_is_zero(const fe* a) {
  uint32_t z = 0;
  for (int i = 0; i < 8; i++) z |= a->v[i];
  return z == 0;
}

VT_FN bool fe_eq_words(const fe* a, const uint32_t* w) {
  uint32_t d = 0;
  for (int i = 0; i < 8; i++) d |= a->v[i] ^ w[i];
  return d == 0;
}

// r = (value of r + top·2^256) mod p, canonical. Requires top < 2^40.
VT_FN void fe_reduce_top(fe* r, uint64_t top) {
  // top·2^256 ≡ top·0x1000003D1 = top·977 + top·2^32.
  uint64_t c = (uint64_t)r->v[0] + top * 977u;
  r->v[0] = (uint32_t)c;
  c >>= 32;
  c += (uint64_t)r->v[1] + top;
  r->v[1] = (uint32_t)c;
  c >>= 32;
  for (int i = 2; i < 8; i++) {
    c += r->v[i];
    r->v[i] = (uint32_t)c;
    c >>= 32;
  }
  if (c) {
    // Wrapped past 2^256 once more: the low words are now small, so adding
    // 0x1000003D1 cannot carry out again.
    uint64_t d = (uint64_t)r->v[0] + 0x3D1u;
    r->v[0] = (uint32_t)d;
    d >>= 32;
    d += (uint64_t)r->v[1] + 1u;
    r->v[1] = (uint32_t)d;
    d >>= 32;
    for (int i = 2; i < 8 && d; i++) {
      d += r->v[i];
      r->v[i] = (uint32_t)d;
      d >>= 32;
    }
  }
  // One conditional subtraction of p: r >= p iff r + 0x1000003D1 carries.
  fe s;
  uint64_t e = (uint64_t)r->v[0] + 0x3D1u;
  s.v[0] = (uint32_t)e;
  e >>= 32;
  e += (uint64_t)r->v[1] + 1u;
  s.v[1] = (uint32_t)e;
  e >>= 32;
  for (int i = 2; i < 8; i++) {
    e += r->v[i];
    s.v[i] = (uint32_t)e;
    e >>= 32;
  }
  if (e) *r = s;
}

VT_FN void fe_add(fe* r, const fe* a, const fe* b) {
  uint64_t c = 0;
  fe t;
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a->v[i] + b->v[i];
    t.v[i] = (uint32_t)c;
    c >>= 32;
  }
  *r = t;
  fe_reduce_top(r, c);
}

VT_FN void fe_sub(fe* r, const fe* a, const fe* b) {
  int64_t c = 0;
  fe t;
  for (int i = 0; i < 8; i++) {
    c += (int64_t)a->v[i] - (int64_t)b->v[i];
    t.v[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: 0 or -1
  }
  if (c) {
    // a < b: t = a - b + 2^256; a - b + p = t - 0x1000003D1 (no wrap).
    uint64_t d = 0;
    for (int i = 0; i < 8; i++) {
      d += (uint64_t)t.v[i] + VT_P[i];
      t.v[i] = (uint32_t)d;
      d >>= 32;
    }
  }
  *r = t;
}

VT_FN void fe_neg(fe* r, const fe* a) {
  fe z;
  fe_set_small(&z, 0);
  fe_sub(r, &z, a);
}

VT_FN void fe_mul(fe* r, const fe* a, const fe* b) {
  uint32_t t[16];
  for (int i = 0; i < 16; i++) t[i] = 0;
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a->v[i] * b->v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // lo + hi·(2^32 + 977): a 288-bit sum, then fold its top word.
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u;
    if (i > 0) c += t[7 + i];
    r->v[i] = (uint32_t)c;
    c >>= 32;
  }
  c += t[15];
  fe_reduce_top(r, c);
}

VT_FN void fe_sqr(fe* r, const fe* a) { fe_mul(r, a, a); }

VT_FN void fe_mul_int(fe* r, const fe* a, uint32_t k) {
  uint64_t c = 0;
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a->v[i] * k;
    r->v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce_top(r, c);
}

VT_FN void fe_sqr_n(fe* r, const fe* a, int n) {
  *r = *a;
  for (int i = 0; i < n; i++) fe_sqr(r, r);
}

// x2..x223: a^(2^k - 1), the shared head of the inverse and square-root
// addition chains (the block structure of libsecp256k1's field chains).
VT_CALL void fe_chain_head(const fe* a, fe* x2, fe* x3, fe* x22, fe* x223) {
  fe x6, x9, x11, x44, x88, x176, x220, t;
  fe_sqr(&t, a);
  fe_mul(x2, &t, a);
  fe_sqr(&t, x2);
  fe_mul(x3, &t, a);
  fe_sqr_n(&t, x3, 3);
  fe_mul(&x6, &t, x3);
  fe_sqr_n(&t, &x6, 3);
  fe_mul(&x9, &t, x3);
  fe_sqr_n(&t, &x9, 2);
  fe_mul(&x11, &t, x2);
  fe_sqr_n(&t, &x11, 11);
  fe_mul(x22, &t, &x11);
  fe_sqr_n(&t, x22, 22);
  fe_mul(&x44, &t, x22);
  fe_sqr_n(&t, &x44, 44);
  fe_mul(&x88, &t, &x44);
  fe_sqr_n(&t, &x88, 88);
  fe_mul(&x176, &t, &x88);
  fe_sqr_n(&t, &x176, 44);
  fe_mul(&x220, &t, &x44);
  fe_sqr_n(&t, &x220, 3);
  fe_mul(x223, &t, x3);
}

// r = a^(p-2) (Fermat inverse; 0 -> 0).
VT_CALL void fe_inv(fe* r, const fe* a) {
  fe x2, x3, x22, x223, t;
  fe_chain_head(a, &x2, &x3, &x22, &x223);
  fe_sqr_n(&t, &x223, 23);
  fe_mul(&t, &t, &x22);
  fe_sqr_n(&t, &t, 5);
  fe_mul(&t, &t, a);
  fe_sqr_n(&t, &t, 3);
  fe_mul(&t, &t, &x2);
  fe_sqr_n(&t, &t, 2);
  fe_mul(r, &t, a);
}

// r = a^((p+1)/4): a square root of a when one exists.
VT_CALL void fe_sqrt_cand(fe* r, const fe* a) {
  fe x2, x3, x22, x223, t;
  fe_chain_head(a, &x2, &x3, &x22, &x223);
  fe_sqr_n(&t, &x223, 23);
  fe_mul(&t, &t, &x22);
  fe_sqr_n(&t, &t, 6);
  fe_mul(&t, &t, &x2);
  fe_sqr_n(r, &t, 2);
}

// ---------------------------------------------------------------------------
// Group law on Jacobian points (X, Y, Z); infinity is tracked by the caller
// as a flag, exactly as the TPU kernel carries its masks.

typedef struct {
  fe X, Y, Z;
} pt;

VT_FN void pt_set_inf(pt* p) {
  fe_set_small(&p->X, 1);
  fe_set_small(&p->Y, 1);
  fe_set_small(&p->Z, 0);
}

// dbl-2009-l (a = 0).
VT_CALL void pt_double(pt* r, const pt* p) {
  fe A, B, C, D, E, F, t, u;
  fe_sqr(&A, &p->X);
  fe_sqr(&B, &p->Y);
  fe_sqr(&C, &B);
  fe_add(&t, &p->X, &B);
  fe_sqr(&t, &t);
  fe_add(&u, &A, &C);
  fe_sub(&t, &t, &u);
  fe_mul_int(&D, &t, 2);
  fe_mul_int(&E, &A, 3);
  fe_sqr(&F, &E);
  fe Z3;
  fe_mul(&Z3, &p->Y, &p->Z);
  fe_mul_int(&Z3, &Z3, 2);
  fe_mul_int(&t, &D, 2);
  fe_sub(&r->X, &F, &t);
  fe_sub(&t, &D, &r->X);
  fe_mul(&t, &E, &t);
  fe_mul_int(&u, &C, 8);
  fe_sub(&r->Y, &t, &u);
  r->Z = Z3;
}

// Flagged mixed addition R + (x2, y2), madd-2007-bl, R known finite. Sets
// *h_zero / *r_zero (H = U2 - X1 ≡ 0, S2 - Y1 ≡ 0). On h_zero && !r_zero
// (R = -Q) the result is infinity; on h_zero && r_zero (R = Q) it is garbage
// and the caller defers the lane. `ratio`, when given, receives 2H = Z3/Z1.
VT_CALL void pt_madd_core(pt* r, const pt* p, const fe* x2, const fe* y2,
                        bool* h_zero, bool* r_zero, fe* ratio) {
  fe Z1Z1, U2, S2, H, Rs, HH, I, J, rr, V, t, u;
  fe_sqr(&Z1Z1, &p->Z);
  fe_mul(&U2, x2, &Z1Z1);
  fe_mul(&t, &p->Z, &Z1Z1);
  fe_mul(&S2, y2, &t);
  fe_sub(&H, &U2, &p->X);
  fe_sub(&Rs, &S2, &p->Y);
  *h_zero = fe_is_zero(&H);
  *r_zero = fe_is_zero(&Rs);
  if (ratio) fe_mul_int(ratio, &H, 2);
  fe_sqr(&HH, &H);
  fe_mul_int(&I, &HH, 4);
  fe_mul(&J, &H, &I);
  fe_mul_int(&rr, &Rs, 2);
  fe_mul(&V, &p->X, &I);
  fe X3, Y3, Z3;
  fe_sqr(&t, &rr);
  fe_mul_int(&u, &V, 2);
  fe_add(&u, &J, &u);
  fe_sub(&X3, &t, &u);
  fe_sub(&t, &V, &X3);
  fe_mul(&t, &rr, &t);
  fe_mul(&u, &p->Y, &J);
  fe_mul_int(&u, &u, 2);
  fe_sub(&Y3, &t, &u);
  fe_add(&t, &p->Z, &H);
  fe_sqr(&t, &t);
  fe_add(&u, &Z1Z1, &HH);
  fe_sub(&Z3, &t, &u);
  if (*h_zero && !*r_zero) {
    pt_set_inf(r);
  } else {
    r->X = X3;
    r->Y = Y3;
    r->Z = Z3;
  }
}

// R += (x2, y2) with R's infinity flag `*inf`; ORs the equal-points case
// into *needs (only when R was finite).
VT_FN void pt_madd_flagged(pt* R, bool* inf, const fe* x2, const fe* y2,
                           bool* needs) {
  if (*inf) {
    R->X = *x2;
    R->Y = *y2;
    fe_set_small(&R->Z, 1);
    *inf = false;
    return;
  }
  bool h0, r0;
  pt out;
  pt_madd_core(&out, R, x2, y2, &h0, &r0, 0);
  *R = out;
  *inf = h0 && !r0;
  *needs = *needs || (h0 && r0);
}

// The flagged join R1 + R2 (add-2007-bl) with both infinity flags.
VT_CALL void pt_add_flagged(pt* R, bool* inf1, const pt* Q, bool inf2,
                          bool* needs) {
  if (inf2) return;  // result R1, infinity flag unchanged
  if (*inf1) {
    *R = *Q;
    *inf1 = false;
    return;
  }
  fe Z1Z1, Z2Z2, U1, U2, S1, S2, H, Rs, I, J, rr, V, t, u;
  fe_sqr(&Z1Z1, &R->Z);
  fe_sqr(&Z2Z2, &Q->Z);
  fe_mul(&U1, &R->X, &Z2Z2);
  fe_mul(&U2, &Q->X, &Z1Z1);
  fe_mul(&t, &Q->Z, &Z2Z2);
  fe_mul(&S1, &R->Y, &t);
  fe_mul(&t, &R->Z, &Z1Z1);
  fe_mul(&S2, &Q->Y, &t);
  fe_sub(&H, &U2, &U1);
  fe_sub(&Rs, &S2, &S1);
  bool h0 = fe_is_zero(&H), r0 = fe_is_zero(&Rs);
  *needs = *needs || (h0 && r0);
  if (h0 && !r0) {
    pt_set_inf(R);
    *inf1 = true;
    return;
  }
  fe_mul_int(&t, &H, 2);
  fe_sqr(&I, &t);
  fe_mul(&J, &H, &I);
  fe_mul_int(&rr, &Rs, 2);
  fe_mul(&V, &U1, &I);
  fe X3, Y3, Z3;
  fe_sqr(&t, &rr);
  fe_mul_int(&u, &V, 2);
  fe_add(&u, &J, &u);
  fe_sub(&X3, &t, &u);
  fe_sub(&t, &V, &X3);
  fe_mul(&t, &rr, &t);
  fe_mul(&u, &S1, &J);
  fe_mul_int(&u, &u, 2);
  fe_sub(&Y3, &t, &u);
  fe_add(&t, &R->Z, &Q->Z);
  fe_sqr(&t, &t);
  fe_add(&u, &Z1Z1, &Z2Z2);
  fe_sub(&t, &t, &u);
  fe_mul(&Z3, &t, &H);
  R->X = X3;
  R->Y = Y3;
  R->Z = Z3;
}

// ---------------------------------------------------------------------------
// Scalar recoding.

// `width` bits of the 128-bit value b (4 LE words) at bit `pos`; bits past
// 127 read as zero.
VT_FN uint32_t bits128(const uint32_t* b, int pos, int width) {
  int wi = pos >> 5, sh = pos & 31;
  uint64_t lo = wi < 4 ? b[wi] : 0u;
  uint64_t hi = wi + 1 < 4 ? b[wi + 1] : 0u;
  return (uint32_t)(((lo | (hi << 32)) >> sh) & ((1u << width) - 1u));
}

// Signed 5-bit windows of a value < 2^128: digits in [-16, 15] whose
// sum d_w·32^w is the value (`pallas_kernel.py::_signed_digits128`). The
// top window never carries out (bits 125..127 + carry <= 8 < 16).
VT_FN void signed_digits128(const uint32_t* b, uint8_t* mag, uint8_t* sgn) {
  int carry = 0;
  for (int w = 0; w < VT_SGLV_WINDOWS; w++) {
    int t = (int)bits128(b, 5 * w, 5) + carry;
    int neg = t >= 16;
    int d = neg ? t - 32 : t;
    carry = neg;
    mag[w] = (uint8_t)(d < 0 ? -d : d);
    sgn[w] = (uint8_t)(d < 0);
  }
}

// ---------------------------------------------------------------------------
// One lane. `w` points at the lane's 32 packed words: a, |b1|‖|b2|, px, t1
// (each 8 little-endian words). gtab: (32, 255, 2, 8) canonical affine words.

VT_FN void verify_lane(const uint32_t* w, int32_t want_odd, int32_t parity_req,
                       int32_t has_t2, int32_t neg1, int32_t neg2,
                       uint8_t valid_in, const uint32_t* gtab, int32_t* ok_out,
                       int32_t* needs_out) {
  const uint32_t* a = w;
  const uint32_t* t1 = w + 24;

  uint8_t db1[VT_SGLV_WINDOWS], ds1[VT_SGLV_WINDOWS];
  uint8_t db2[VT_SGLV_WINDOWS], ds2[VT_SGLV_WINDOWS];
  signed_digits128(w + 8, db1, ds1);
  signed_digits128(w + 12, db2, ds2);

  // -- lift P's y from (x, parity): y = sqrt(x^3 + 7) ----------------------
  fe x, y, rhs, t;
  fe_set(&x, w + 16);
  fe_reduce_top(&x, 0);  // the TPU kernel's limbs work mod p as well
  fe_sqr(&t, &x);
  fe_mul(&t, &t, &x);
  fe seven;
  fe_set_small(&seven, 7);
  fe_add(&rhs, &t, &seven);
  fe_sqrt_cand(&y, &rhs);
  fe_sqr(&t, &y);
  bool sq_ok = fe_eq_words(&t, rhs.v);
  bool odd = (y.v[0] & 1u) != 0;
  if (odd != (want_odd == 1)) fe_neg(&y, &y);
  bool valid = valid_in != 0 && sq_ok;
  if (!valid) {  // sanitise to G; the verdict stays masked by `valid`
    fe_set(&x, VT_GX);
    fe_set(&y, VT_GY);
  }

  // -- {1..16}·P at one global Z ---------------------------------------------
  fe tx[16], ty[16], ratio[16];
  bool needs = false;
  tx[0] = x;
  ty[0] = y;
  fe_mul_int(&ratio[1], &y, 2);  // Z_1 = 2·y·Z_0, Z_0 = 1
  pt R;
  R.X = x;
  R.Y = y;
  fe_set_small(&R.Z, 1);
  pt_double(&R, &R);
  tx[1] = R.X;
  ty[1] = R.Y;
  for (int k = 2; k < 16; k++) {
    bool h0, r0;
    pt nxt;
    pt_madd_core(&nxt, &R, &x, &y, &h0, &r0, &ratio[k]);
    needs = needs || (h0 && r0);
    R = nxt;
    tx[k] = R.X;
    ty[k] = R.Y;
  }
  // Rescale rows 14..0 to row 15's Z: c_k = prod_{j=k+1..15} ratio_j.
  fe c = ratio[15];
  for (int k = 14; k >= 0; k--) {
    if (k < 14) fe_mul(&c, &c, &ratio[k + 1]);
    fe c2, c3;
    fe_sqr(&c2, &c);
    fe_mul(&c3, &c2, &c);
    fe_mul(&tx[k], &tx[k], &c2);
    fe_mul(&ty[k], &ty[k], &c3);
  }
  fe global_z = c;

  // -- (±b1 ± λ·b2)·P: 26 signed windows on the global-Z (isomorphic) curve
  fe beta;
  fe_set(&beta, VT_BETA);
  bool r_inf = true;
  pt_set_inf(&R);
  for (int i = 0; i < VT_SGLV_WINDOWS; i++) {
    int wdw = VT_SGLV_WINDOWS - 1 - i;
    if (!r_inf) {  // doublings of infinity stay infinity
      for (int k = 0; k < 5; k++) pt_double(&R, &R);
    }
    int d1 = db1[wdw];
    if (d1 > 0) {
      fe sy = ty[d1 - 1];
      if ((ds1[wdw] ^ neg1) == 1) fe_neg(&sy, &sy);
      pt_madd_flagged(&R, &r_inf, &tx[d1 - 1], &sy, &needs);
    }
    int d2 = db2[wdw];
    if (d2 > 0) {
      fe sx, sy = ty[d2 - 1];
      fe_mul(&sx, &tx[d2 - 1], &beta);  // λ·(x, y) = (β·x, y)
      if ((ds2[wdw] ^ neg2) == 1) fe_neg(&sy, &sy);
      pt_madd_flagged(&R, &r_inf, &sx, &sy, &needs);
    }
  }
  fe_mul(&R.Z, &R.Z, &global_z);  // back to the true curve

  // -- a·G: 32 windows of 8 bits against the affine table --------------------
  pt Rg;
  bool rg_inf = true;
  pt_set_inf(&Rg);
  for (int i = 0; i < VT_G_WINDOWS; i++) {
    int da = (int)((a[i >> 2] >> (8 * (i & 3))) & 0xFFu);
    if (da > 0) {
      const uint32_t* e = gtab + ((size_t)(i * VT_G_ENTRIES + da - 1) * 2) * 8;
      fe gx, gy;
      fe_set(&gx, e);
      fe_set(&gy, e + 8);
      pt_madd_flagged(&Rg, &rg_inf, &gx, &gy, &needs);
    }
  }
  pt_add_flagged(&R, &r_inf, &Rg, rg_inf, &needs);
  needs = needs && valid;  // invalid lanes never defer (sanitised to G)

  // -- affine + accept ---------------------------------------------------------
  bool ok = false;
  if (valid && !r_inf && !needs) {
    fe zi, zi2, zi3, ax, ay;
    fe_inv(&zi, &R.Z);
    fe_sqr(&zi2, &zi);
    fe_mul(&zi3, &zi2, &zi);
    fe_mul(&ax, &R.X, &zi2);
    fe_mul(&ay, &R.Y, &zi3);
    // t1 ships raw: a target >= p never equals a canonical x. t1 + n is
    // compared mod p, and only when has_t2.
    bool ok_x = fe_eq_words(&ax, t1);
    if (!ok_x && has_t2 == 1) {
      fe t1n;
      uint64_t cc = 0;
      for (int i = 0; i < 8; i++) {
        cc += (uint64_t)t1[i] + VT_N[i];
        t1n.v[i] = (uint32_t)cc;
        cc >>= 32;
      }
      fe_reduce_top(&t1n, cc);
      ok_x = fe_eq_words(&ax, t1n.v);
    }
    bool y_odd = (ay.v[0] & 1u) != 0;
    bool par_ok = parity_req < 0 || (y_odd == (parity_req == 1));
    ok = ok_x && par_ok;
  }
  *ok_out = ok ? 1 : 0;
  *needs_out = needs ? 1 : 0;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(64)
    vt_verify_kernel(const uint32_t* __restrict__ fields,
                     const int32_t* __restrict__ want_odd,
                     const int32_t* __restrict__ parity_req,
                     const int32_t* __restrict__ has_t2,
                     const int32_t* __restrict__ neg1,
                     const int32_t* __restrict__ neg2,
                     const uint8_t* __restrict__ valid,
                     const uint32_t* __restrict__ gtab,
                     int32_t* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t w[32];
  const uint4* src = reinterpret_cast<const uint4*>(fields + 32 * (size_t)i);
  for (int k = 0; k < 8; k++) {
    uint4 q = src[k];
    w[4 * k] = q.x;
    w[4 * k + 1] = q.y;
    w[4 * k + 2] = q.z;
    w[4 * k + 3] = q.w;
  }
  verify_lane(w, want_odd[i], parity_req[i], has_t2[i], neg1[i], neg2[i],
              valid[i], gtab, out + i, out + n + i);
}

extern "C" int vt_verify_tiles(const void* fields, const void* want_odd,
                               const void* parity_req, const void* has_t2,
                               const void* neg1, const void* neg2,
                               const void* valid, const void* gtab, void* out,
                               int n, int grid, int threads, void* stream) {
  // grid and threads come from the wrapper's launch contract
  // (VERIFY_TILES_CONTRACT); a launch other than one 64-thread block per 64
  // lanes is refused.
  if (threads != 64 || grid != (n + 63) / 64) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    vt_verify_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)fields, (const int32_t*)want_odd,
        (const int32_t*)parity_req, (const int32_t*)has_t2,
        (const int32_t*)neg1, (const int32_t*)neg2, (const uint8_t*)valid,
        (const uint32_t*)gtab, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
