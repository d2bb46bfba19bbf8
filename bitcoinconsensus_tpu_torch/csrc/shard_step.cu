// The epilogue of the mesh's sharded step, hand-written CUDA for Hopper
// (sm_90a).
//
// Replaces the device half of `bitcoinconsensus_tpu/parallel/mesh.py::
// make_sharded_step`'s `local_step` (:201-223), an XLA program of the
// reference (not a Pallas kernel) run inside `shard_map` on every device
// shard after its verify kernel: the shard's failure count, which the
// `psum` AND-reduces into the block verdict, and the shard's verdict
// checksum pair (`_verdict_checksum` over the shard's own slice). One
// launch covers all the shards of one dispatch that lie on one device,
// one block per shard. Over shard s's rows, contiguous in the flat (B,)
// bool buffers ok, needs and live (B = n_shards * S), it writes the int32
// triple, one column of the (3, n_shards) output
//
//     out[0][s] = sum_i ok[i]                          (the count)
//     out[1][s] = sum_i ok[i] * (i % 251 + 1)          (the weighted sum)
//     out[2][s] = sum_i live[i] & ~ok[i] & ~needs[i]   (the failures)
//
// with i the SHARD-LOCAL row, 0 <= i < S, as the reference checksums the
// shard's slice: the weights restart at every shard. `live` marks real
// lanes: pad and sentinel rows never count as failures, a structurally
// invalid real lane does, and a lane the verify kernel deferred to the host
// (`needs`) stays out, the host fixup ANDs its verdict in. The weighted sum
// stays below 251 * S, inside int32 up to SS_MAX_LANES rows a shard; the
// launcher refuses more.
//
// Design: this first version is simple and right. One block of 1,024
// threads a shard; thread t walks rows t, t + 1024, ... of its shard (the
// weight index steps by 1024 % 251 = 20, so no division runs in the loop),
// each warp reduces its three partials with shuffles, the 32 warps' meet in
// shared memory, and warp 0 writes the shard's three words once. What
// bounds it on this card: 3 bytes read a row and 12 bytes written a shard
// over 3.35 TB/s is a few nanoseconds for a dispatch of 8,192 rows, so a
// launch costs its launch at every mesh width.
//
// Built by `ops/_build.py` with nvcc into a shared library; the launcher
// runs on the caller's stream and returns cudaGetLastError().

#include <stdint.h>

#include <cuda_runtime.h>

#define SS_THREADS 1024
#define SS_WARPS (SS_THREADS / 32)
#define SS_MOD 251
#define SS_STEP (SS_THREADS % SS_MOD)
#define SS_MAX_LANES (1 << 23)

__global__ void __launch_bounds__(SS_THREADS, 1)
    ss_epilogue_kernel(const uint8_t* __restrict__ ok,
                       const uint8_t* __restrict__ needs,
                       const uint8_t* __restrict__ live,
                       int32_t* __restrict__ out, int rows) {
  const int t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * (size_t)rows;
  int32_t count = 0, wsum = 0, fails = 0;
  int r = t % SS_MOD;  // i % 251 for the thread's current shard-local row i
  for (int i = t; i < rows; i += SS_THREADS) {
    const int32_t v = ok[base + i] != 0;
    count += v;
    wsum += v * (r + 1);
    fails += live[base + i] != 0 && !v && needs[base + i] == 0;
    r += SS_STEP;
    if (r >= SS_MOD) r -= SS_MOD;
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
    wsum += __shfl_down_sync(0xffffffffu, wsum, off);
    fails += __shfl_down_sync(0xffffffffu, fails, off);
  }
  __shared__ int32_t s_count[SS_WARPS], s_wsum[SS_WARPS], s_fails[SS_WARPS];
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    s_count[warp] = count;
    s_wsum[warp] = wsum;
    s_fails[warp] = fails;
  }
  __syncthreads();
  if (warp == 0) {
    count = s_count[lane];  // SS_WARPS == 32: one partial triple per lane
    wsum = s_wsum[lane];
    fails = s_fails[lane];
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_down_sync(0xffffffffu, count, off);
      wsum += __shfl_down_sync(0xffffffffu, wsum, off);
      fails += __shfl_down_sync(0xffffffffu, fails, off);
    }
    if (lane == 0) {
      out[blockIdx.x] = count;
      out[gridDim.x + blockIdx.x] = wsum;
      out[2 * gridDim.x + blockIdx.x] = fails;
    }
  }
}

// Launchers take their arguments packed as one array of 64-bit words
// (`ops/launch.py`). Launch contract (SHARD_EPILOGUE_CONTRACT): a grid of
// one block of SS_THREADS threads per shard, 1 <= n_shards <= 65,535 and
// 0 <= rows <= SS_MAX_LANES; any other launch is refused. Arguments: ok,
// needs, live, out, rows (a shard), n_shards, grid, threads, stream.
#define SS_PTR(a, i) ((void*)(intptr_t)(a)[i])

extern "C" int ss_shard_epilogue(const int64_t* a) {
  const int64_t rows = a[4], n_shards = a[5];
  if (a[6] != n_shards || a[7] != SS_THREADS || n_shards < 1 ||
      n_shards > 65535 || rows < 0 || rows > SS_MAX_LANES)
    return (int)cudaErrorInvalidValue;
  ss_epilogue_kernel<<<(unsigned)n_shards, SS_THREADS, 0,
                       (cudaStream_t)SS_PTR(a, 8)>>>(
      (const uint8_t*)SS_PTR(a, 0), (const uint8_t*)SS_PTR(a, 1),
      (const uint8_t*)SS_PTR(a, 2), (int32_t*)SS_PTR(a, 3), (int)rows);
  return (int)cudaGetLastError();
}
