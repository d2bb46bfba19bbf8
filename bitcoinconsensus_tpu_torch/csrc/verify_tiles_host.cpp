// Host build of `verify_tiles.cu`'s lane program, for the scalar-schedule
// prover (`analysis/scalar_check.py`): the kernel's own recoder and ladder,
// compiled by g++ (`ops/_build.py`, name `verify_tiles_host`), with the
// schedule hooks recording into a caller's buffer.
//
//   vt_host_recode  (n, 4) words of values below 2^128 -> (n, 26) digit
//                   magnitudes and signs, through `signed_carries` and
//                   `signed_digit`, as `vt_recode` runs them on the card.
//   vt_host_trace   one lane through `verify_lane`: its (ok, needs_host) and
//                   the hook events, five int32 each (event, a, b, c, d).
//   vt_host_epilogue  the checked launch's per-warp partials from a
//                   launch's verdicts, through `vt_epilogue_terms`.

#include <stddef.h>
#include <stdint.h>

static int32_t* vt_trace_buf = nullptr;
static int vt_trace_cap = 0;
static int vt_trace_n = 0;

static void vt_trace_push(int ev, int a, int b, int c, int d) {
  if (vt_trace_n < vt_trace_cap) {
    int32_t* r = vt_trace_buf + 5 * (size_t)vt_trace_n;
    r[0] = ev;
    r[1] = a;
    r[2] = b;
    r[3] = c;
    r[4] = d;
  }
  vt_trace_n++;
}

#define VT_TRACE(ev, a, b, c, d) \
  vt_trace_push((ev), (int)(a), (int)(b), (int)(c), (int)(d))

#include "verify_tiles.cu"

extern "C" void vt_host_recode(const uint32_t* words, int32_t* mag,
                               int32_t* sgn, int n) {
  for (int i = 0; i < n; i++) {
    const uint32_t* w = words + 4 * (size_t)i;
    const u128 b = {w[0], w[1], w[2], w[3]};
    const uint32_t carries = signed_carries(b);
    for (int wdw = 0; wdw < VT_SGLV_WINDOWS; wdw++) {
      uint32_t neg;
      mag[VT_SGLV_WINDOWS * (size_t)i + wdw] =
          (int32_t)signed_digit(b, carries, wdw, neg);
      sgn[VT_SGLV_WINDOWS * (size_t)i + wdw] = (int32_t)neg;
    }
  }
}

// The checked launch's epilogue on the host: (n,) int32 ok, needs and (or
// null) uint8 live -> the (3, ceil(n / 32)) int32 per-warp partials, each
// warp's lanes summed through `vt_epilogue_terms`, as the card's shuffles
// sum them (integer sums: the order does not matter).
extern "C" void vt_host_epilogue(const int32_t* ok, const int32_t* needs,
                                 const uint8_t* live, int32_t* partials,
                                 int n) {
  const int n_warps = (n + 31) / 32;
  for (int w = 0; w < n_warps; w++) {
    int32_t sum[3] = {0, 0, 0};
    for (int i = 32 * w; i < 32 * w + 32; i++) {
      int32_t t[3];
      vt_epilogue_terms(i, n, i < n ? ok[i] : 0, i < n ? needs[i] : 0, live, t);
      for (int r = 0; r < 3; r++) sum[r] += t[r];
    }
    for (int r = 0; r < 3; r++) partials[r * (size_t)n_warps + w] = sum[r];
  }
}

// Returns the number of events the lane raised; at most `cap` are stored.
extern "C" int vt_host_trace(const uint32_t* w, int32_t want_odd,
                             int32_t parity_req, int32_t has_t2, int32_t neg1,
                             int32_t neg2, int32_t valid, const uint32_t* gtab,
                             int32_t* ok_needs, int32_t* events, int cap) {
  vt_trace_buf = events;
  vt_trace_cap = cap;
  vt_trace_n = 0;
  verify_lane(w, want_odd, parity_req, has_t2, neg1, neg2, (uint8_t)valid,
              gtab, ok_needs, ok_needs + 1);
  vt_trace_buf = nullptr;
  vt_trace_cap = 0;
  return vt_trace_n;
}
