// The device verdict checksum, hand-written CUDA for Hopper (sm_90a).
//
// Replaces `bitcoinconsensus_tpu/crypto/jax_backend.py::_verdict_checksum`
// (:379-396), a small XLA program (not a Pallas kernel) that the reference
// chains onto every in-flight verdict buffer. Over the padded `ok` buffer
// (B,) bool it computes the int32 pair
//
//     out[0] = sum_i ok[i]        out[1] = sum_i ok[i] * (i % 251 + 1)
//
// which the settle seam recomputes from the buffer the host received
// (`resilience/guards.check_checksum`). The weighted sum stays below
// 251 * B, inside int32 up to VC_MAX_LANES lanes; the launcher refuses more.
//
// Design: one block of 1,024 threads, whatever B (a dispatch is at most
// `chunk` lanes, 8,192 by default). Thread t walks lanes t, t + 1024, ...:
// neighbouring threads read neighbouring bytes, and the weight index steps
// by 1024 % 251 = 20 per iteration, so no division runs in the loop. Each
// warp reduces its 32 partial pairs with shuffles, the 32 warps' pairs meet
// in shared memory, and warp 0 reduces them and writes the two words once.
// What bounds it on this card: B bytes read over 3.35 TB/s is a few
// nanoseconds at B = 8,192, so a launch costs its launch.
//
// Built by `ops/_build.py` with nvcc into a shared library; the launcher
// runs on the caller's stream and returns cudaGetLastError().

#include <stdint.h>

#include <cuda_runtime.h>

#define VC_THREADS 1024
#define VC_WARPS (VC_THREADS / 32)
#define VC_MOD 251
#define VC_STEP (VC_THREADS % VC_MOD)
#define VC_MAX_LANES (1 << 23)

__global__ void __launch_bounds__(VC_THREADS, 1)
    vc_checksum_kernel(const uint8_t* __restrict__ ok, int32_t* __restrict__ out,
                       int n) {
  const int t = threadIdx.x;
  int32_t count = 0, wsum = 0;
  int r = t % VC_MOD;  // i % 251 for the thread's current lane i
  for (int i = t; i < n; i += VC_THREADS) {
    const int32_t v = ok[i] != 0;
    count += v;
    wsum += v * (r + 1);
    r += VC_STEP;
    if (r >= VC_MOD) r -= VC_MOD;
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
    wsum += __shfl_down_sync(0xffffffffu, wsum, off);
  }
  __shared__ int32_t s_count[VC_WARPS], s_wsum[VC_WARPS];
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    s_count[warp] = count;
    s_wsum[warp] = wsum;
  }
  __syncthreads();
  if (warp == 0) {
    count = s_count[lane];  // VC_WARPS == 32: one partial pair per lane
    wsum = s_wsum[lane];
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
      wsum += __shfl_down_sync(0xffffffffu, wsum, off);
    }
    if (lane == 0) {
      out[0] = count;
      out[1] = wsum;
    }
  }
}

// Launchers take their arguments packed as one array of 64-bit words
// (`ops/launch.py`). Launch contract (VERDICT_CHECKSUM_CONTRACT): a grid of
// one block of VC_THREADS threads, 0 <= n <= VC_MAX_LANES; any other launch
// is refused. Arguments: ok, out, n, grid, threads, stream.
#define VC_PTR(a, i) ((void*)(intptr_t)(a)[i])

extern "C" int vc_verdict_checksum(const int64_t* a) {
  const int64_t n = a[2];
  if (a[3] != 1 || a[4] != VC_THREADS || n < 0 || n > VC_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  vc_checksum_kernel<<<1, VC_THREADS, 0, (cudaStream_t)VC_PTR(a, 5)>>>(
      (const uint8_t*)VC_PTR(a, 0), (int32_t*)VC_PTR(a, 1), (int)n);
  return (int)cudaGetLastError();
}
