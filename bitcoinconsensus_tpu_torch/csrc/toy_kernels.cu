// The kernel prover's toy kernels, hand-written CUDA for Hopper (sm_90a).
//
// Replaces the Pallas prover's toys in
// `bitcoinconsensus_tpu/analysis/pallas_check.py`: `_build_positive` (:780),
// `_build_oob_index_map` (:798), `_build_read_before_write` (:819),
// `_build_mul_overflow` (:841), `_build_double_write` (:860),
// `_build_f32_default_precision_dot` (:884), `_build_f32_accum_overflow`
// (:910) and `_build_f32_unvetted_roundtrip` (:933). Each kernel here is
// launched as the contract of the same name in `analysis/kernel_check.py`
// declares it: one block per 128 columns of a row-major (rows, cols) int32
// array, the grid and the threads per block passed in by the wrapper from
// the contract.
//
// - tk_positive: o = x + 1 on (8, cols), one thread per element, the window
//   staged through a shared (8, 128) tile; the ragged edge is masked.
// - tk_mul: o = fe_mul(x, x) per column of (20, cols) radix-2^13 limbs, one
//   thread per column: the port's `limbs.fe_mul` (schoolbook columns, then
//   its settle schedule) in uint32_t arithmetic, so that a wrap is defined.
//   On W2-bounded limbs it equals `limbs.fe_mul` bit for bit.
// - tk_f32_dot_tf32: per block, y = X X^T of the float32 (8, 128) window on
//   the tensor cores in TF32 (mma.sync m16n8k8, operands rounded to 10
//   mantissa bits): the counterpart of a float32 dot without
//   Precision.HIGHEST. o[r, :] = int(y[r, 0]).
// - tk_f32_dot: the same product in full float32 (fmaf on the CUDA cores,
//   k in order), the counterpart of Precision.HIGHEST.
// - tk_f32_square: o = int(float(x) * float(x)), one thread per element;
//   tk_f32_write: the same square left as float32 (the reference's
//   inexact-float-output fixture, `tests/test_pallas_check.py:112`).
// - tk_oob_index_map, tk_double_write (one kernel, tk_window_copy) and
//   tk_read_before_write: a copy of (8, 128) windows whose column offsets,
//   first + step * block, the wrapper reads off the contract's index maps,
//   so each launch holds the defect its contract declares. They are
//   instrumented as a sanitizer would be, so that a launch has a defined
//   result: a window that leaves its array is neither read nor written and
//   sets the block's fault 0; every output element written counts once in
//   `writes`; a read of a shared scratch row that no thread wrote reads 0
//   and sets the block's fault 1 (a shadow flag per row).
//
// What bounds them on this card: bytes for all but tk_mul and the dots
// (each element read and written once, 8 bytes per element); int32
// operations for tk_mul (967 per column against 160 bytes per column). At
// the toys' widths all are far below a launch's own latency, so each launch
// costs its launch.
//
// Built by `ops/_build.py` with nvcc into a shared library; every launcher
// runs on the caller's stream and returns cudaGetLastError(). Without
// __CUDACC__ the per-element functions compile as plain C++, which is how
// their arithmetic is tested without a card.

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TK_FN __host__ __device__ __forceinline__
#else
#define TK_FN static inline
#endif

#define TK_TILE 128
#define TK_ROWS 8
#define TK_NLIMB 20
#define TK_MASK 0x1FFFu

TK_FN int32_t tk_positive_elem(int32_t x) {
  return (int32_t)((uint32_t)x + 1u);
}

// float32 -> int32 toward zero, as torch's `.to(torch.int32)`; the toys'
// values lie well inside the int32 range.
TK_FN float tk_f32_write_elem(int32_t x) {
  float f = (float)x;
  return f * f;
}

TK_FN int32_t tk_f32_square_elem(int32_t x) {
  return (int32_t)tk_f32_write_elem(x);
}

// One row of the full-float32 dot: sum over k of a[k] * b[k], k in order.
TK_FN float tk_dot_row(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int k = 0; k < n; k++) acc = fmaf(a[k], b[k], acc);
  return acc;
}

// One parallel carry pass over n limbs (`limbs._pass`): each limb keeps its
// low 13 bits and takes the carry of the limb below. top 0: the top carry is
// zero; 1: it wraps into limbs 0..2 as 2^260 = 16C = [7440, 1, 1024]; 2: it
// becomes a new top limb. Returns the new length.
TK_FN int tk_pass(uint32_t* x, int n, int top) {
  uint32_t c_top = x[n - 1] >> 13;
  for (int i = n - 1; i >= 1; i--) x[i] = (x[i] & TK_MASK) + (x[i - 1] >> 13);
  x[0] &= TK_MASK;
  if (top == 1) {
    x[0] += c_top * 7440u;
    x[1] += c_top;
    x[2] += c_top * 1024u;
  } else if (top == 2) {
    x[n++] = c_top;
  }
  return n;
}

// Fold the limbs at positions >= 20 down by 2^260 = 16C (`limbs._fold_high`).
TK_FN int tk_fold(uint32_t* x, int n) {
  int n_hi = n - TK_NLIMB;
  int out = n_hi + 2 > TK_NLIMB ? n_hi + 2 : TK_NLIMB;
  uint32_t hi[TK_NLIMB + 2];
  for (int i = 0; i < n_hi; i++) hi[i] = x[TK_NLIMB + i];
  for (int i = TK_NLIMB; i < out; i++) x[i] = 0;
  for (int i = 0; i < n_hi; i++) {
    x[i] += hi[i] * 7440u;
    x[i + 1] += hi[i];
    x[i + 2] += hi[i] * 1024u;
  }
  return out;
}

// fe_mul of one column: a[i] = x[i * stride], o[i * stride] likewise. The
// settle steps are `limbs._settle_plan(limbs._MUL_BOUNDS)`: pass:append,
// pass:append, fold, pass:none, fold, pass:wrap x 3 (held equal to the plan
// by the CPU tests).
TK_FN void tk_fe_mul_col(const int32_t* a, const int32_t* b, int stride,
                         int32_t* o) {
  uint32_t av[TK_NLIMB], bv[TK_NLIMB], x[2 * TK_NLIMB + 2];
  for (int i = 0; i < TK_NLIMB; i++) {
    av[i] = (uint32_t)a[i * stride];
    bv[i] = (uint32_t)b[i * stride];
  }
  for (int k = 0; k < 2 * TK_NLIMB + 2; k++) x[k] = 0;
  for (int i = 0; i < TK_NLIMB; i++)
    for (int j = 0; j < TK_NLIMB; j++) x[i + j] += av[i] * bv[j];
  int n = 2 * TK_NLIMB - 1;
  n = tk_pass(x, n, 2);
  n = tk_pass(x, n, 2);
  n = tk_fold(x, n);
  n = tk_pass(x, n, 0);
  n = tk_fold(x, n);
  for (int r = 0; r < 3; r++) n = tk_pass(x, n, 1);
  for (int i = 0; i < TK_NLIMB; i++) o[i * stride] = (int32_t)x[i];
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_positive_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                       int cols) {
  __shared__ int32_t tile[TK_ROWS][TK_TILE];
  int r = threadIdx.x / TK_TILE, c = threadIdx.x % TK_TILE;
  int col = blockIdx.x * TK_TILE + c;
  bool in = col < cols;
  if (in) tile[r][c] = x[(size_t)r * cols + col];
  __syncthreads();
  if (in) o[(size_t)r * cols + col] = tk_positive_elem(tile[r][c]);
}

__global__ void __launch_bounds__(TK_TILE)
    tk_mul_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                  int cols) {
  int col = blockIdx.x * TK_TILE + threadIdx.x;
  if (col < cols) tk_fe_mul_col(x + col, x + col, cols, o + col);
}

// The (8, 128) window of x as float32 in shared memory; with `tf32`, each
// value rounded to TF32 (nearest, ties away from zero) as the tensor cores
// take it.
__device__ __forceinline__ void tk_stage_f32(const int32_t* x, int cols,
                                             float (*t)[TK_TILE], bool tf32) {
  int r = threadIdx.x / TK_TILE, c = threadIdx.x % TK_TILE;
  float f = (float)x[(size_t)r * cols + blockIdx.x * TK_TILE + c];
  if (tf32) {
    uint32_t u;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(f));
    f = __uint_as_float(u);
  }
  t[r][c] = f;
}

__device__ __forceinline__ void tk_write_col0(int32_t* o, int cols,
                                              const float* y) {
  int r = threadIdx.x / TK_TILE, c = threadIdx.x % TK_TILE;
  o[(size_t)r * cols + blockIdx.x * TK_TILE + c] = (int32_t)y[r];
}

// y[:, 0] of X X^T on the tensor cores: warp 0 runs 16 mma.sync m16n8k8
// TF32 steps over k. A is X (rows 8-15 zero), B[k][n] = X[n][k]; lanes with
// threadID_in_group 0 hold column 0 of D in c0 (rows 0-7).
__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_f32_dot_tf32_kernel(const int32_t* __restrict__ x,
                           int32_t* __restrict__ o, int cols) {
  __shared__ float t[TK_ROWS][TK_TILE];
  __shared__ float y[TK_ROWS];
  tk_stage_f32(x, cols, t, true);
  __syncthreads();
  if (threadIdx.x < 32) {
    int g = threadIdx.x >> 2, q = threadIdx.x & 3;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    for (int k0 = 0; k0 < TK_TILE; k0 += 8) {
      uint32_t a0 = __float_as_uint(t[g][k0 + q]);
      uint32_t a2 = __float_as_uint(t[g][k0 + q + 4]);
      uint32_t b0 = __float_as_uint(t[g][k0 + q]);
      uint32_t b1 = __float_as_uint(t[g][k0 + q + 4]);
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
          : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
    }
    if (q == 0) y[g] = d0;
  }
  __syncthreads();
  tk_write_col0(o, cols, y);
}

// y[:, 0] of X X^T in full float32: eight threads, one row each.
__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_f32_dot_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o,
                      int cols) {
  __shared__ float t[TK_ROWS][TK_TILE];
  __shared__ float y[TK_ROWS];
  tk_stage_f32(x, cols, t, false);
  __syncthreads();
  if (threadIdx.x < TK_ROWS) y[threadIdx.x] = tk_dot_row(t[threadIdx.x], t[0], TK_TILE);
  __syncthreads();
  tk_write_col0(o, cols, y);
}

__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_f32_square_kernel(const int32_t* __restrict__ x,
                         int32_t* __restrict__ o, int cols) {
  int r = threadIdx.x / TK_TILE, c = threadIdx.x % TK_TILE;
  size_t i = (size_t)r * cols + blockIdx.x * TK_TILE + c;
  o[i] = tk_f32_square_elem(x[i]);
}

__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_f32_write_kernel(const int32_t* __restrict__ x, float* __restrict__ o,
                        int cols) {
  int r = threadIdx.x / TK_TILE, c = threadIdx.x % TK_TILE;
  size_t i = (size_t)r * cols + blockIdx.x * TK_TILE + c;
  o[i] = tk_f32_write_elem(x[i]);
}

// Launchers take their arguments packed as one array of 64-bit words, in
// this order: (x, o, cols, grid, threads, stream) -> cudaError_t; ctypes then
// converts one pointer instead of each argument (`ops/launch.py`). A launch
// whose threads differ from what the kernel indexes by is refused.
#define TK_PTR(a, i) ((void*)(intptr_t)(a)[i])
#define TK_LAUNCHER(name, want_threads, out_t)                              \
  extern "C" int tk_##name(const int64_t* a) {                              \
    int cols = (int)a[2], grid = (int)a[3], threads = (int)a[4];            \
    if (threads != (want_threads)) return (int)cudaErrorInvalidValue;      \
    if (grid > 0)                                                           \
      tk_##name##_kernel<<<grid, threads, 0, (cudaStream_t)TK_PTR(a, 5)>>>( \
          (const int32_t*)TK_PTR(a, 0), (out_t*)TK_PTR(a, 1), cols);        \
    return (int)cudaGetLastError();                                         \
  }

TK_LAUNCHER(positive, TK_ROWS* TK_TILE, int32_t)
TK_LAUNCHER(mul, TK_TILE, int32_t)
TK_LAUNCHER(f32_dot_tf32, TK_ROWS* TK_TILE, int32_t)
TK_LAUNCHER(f32_dot, TK_ROWS* TK_TILE, int32_t)
TK_LAUNCHER(f32_square, TK_ROWS* TK_TILE, int32_t)
TK_LAUNCHER(f32_write, TK_ROWS* TK_TILE, float)

// The checked window copy. Block b copies the input window at column
// in_first + in_step * b to the output window at out_first + out_step * b.
// With `scratch`, each element also adds row 0 of a shared (4, 128) scratch
// that no thread writes: the read is checked against the rows' shadow flags.
struct TkWindows {
  int in_step, in_first, out_step, out_first;
};

__device__ __forceinline__ void tk_checked_copy(const int32_t* x, int32_t* o,
                                                int cols, TkWindows w,
                                                int32_t* writes,
                                                int32_t* faults, bool scratch) {
  __shared__ int32_t s[4][TK_TILE];
  __shared__ int32_t written[4];  // shadow: rows of s some thread wrote
  int r = threadIdx.x / TK_TILE, c = threadIdx.x % TK_TILE;
  long long in0 = w.in_first + (long long)w.in_step * blockIdx.x;
  long long out0 = w.out_first + (long long)w.out_step * blockIdx.x;
  if (threadIdx.x < 4) written[threadIdx.x] = 0;
  __syncthreads();
  if (in0 < 0 || in0 + TK_TILE > cols || out0 < 0 || out0 + TK_TILE > cols) {
    if (threadIdx.x == 0) faults[2 * blockIdx.x] = 1;
    return;
  }
  int32_t v = x[(size_t)r * cols + in0 + c];
  if (scratch) {
    if (written[0]) {
      v += s[0][c];
    } else if (threadIdx.x == 0) {
      faults[2 * blockIdx.x + 1] = 1;
    }
  }
  size_t oi = (size_t)r * cols + out0 + c;
  o[oi] = v;
  atomicAdd(&writes[oi], 1);
}

__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_window_copy_kernel(const int32_t* __restrict__ x, int32_t* o, int cols,
                          TkWindows w, int32_t* writes, int32_t* faults) {
  tk_checked_copy(x, o, cols, w, writes, faults, false);
}

__global__ void __launch_bounds__(TK_ROWS* TK_TILE)
    tk_read_before_write_kernel(const int32_t* __restrict__ x, int32_t* o,
                                int cols, TkWindows w, int32_t* writes,
                                int32_t* faults) {
  tk_checked_copy(x, o, cols, w, writes, faults, true);
}

// Launchers of the checked kernels, packed as above: (x, o, cols, grid,
// threads, in_step, in_first, out_step, out_first, writes, faults, stream).
#define TK_CHECKED_LAUNCHER(name, kernel)                                     \
  extern "C" int tk_##name(const int64_t* a) {                                \
    int cols = (int)a[2], grid = (int)a[3], threads = (int)a[4];              \
    if (threads != TK_ROWS * TK_TILE) return (int)cudaErrorInvalidValue;     \
    TkWindows w = {(int)a[5], (int)a[6], (int)a[7], (int)a[8]};               \
    if (grid > 0)                                                             \
      kernel<<<grid, threads, 0, (cudaStream_t)TK_PTR(a, 11)>>>(              \
          (const int32_t*)TK_PTR(a, 0), (int32_t*)TK_PTR(a, 1), cols, w,     \
          (int32_t*)TK_PTR(a, 9), (int32_t*)TK_PTR(a, 10));                   \
    return (int)cudaGetLastError();                                           \
  }

TK_CHECKED_LAUNCHER(oob_index_map, tk_window_copy_kernel)
TK_CHECKED_LAUNCHER(double_write, tk_window_copy_kernel)
TK_CHECKED_LAUNCHER(read_before_write, tk_read_before_write_kernel)

#endif  // __CUDACC__
