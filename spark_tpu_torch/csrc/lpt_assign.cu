// Greedy LPT assignment of fine hash buckets onto mesh shards, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it ports the reference's XLA loop
// spark_tpu/parallel/collective.py `balanced_assignment` (a
// `lax.fori_loop` over the buckets, heaviest first, each onto the
// least-loaded shard).  The port ran it on the host after a device-to-host
// copy of the counts, which a CUDA graph cannot hold; as torch ops it
// would put about four nodes per bucket into every captured exchange.
//
//   counts  (n_fine,) int64   global live rows per fine bucket (psum'd)
//   order   (n_fine,) int64   the buckets heaviest first, a STABLE order
//                             (equal counts keep bucket order): the
//                             wrapper's torch.sort(-counts, stable=True)
//   assign  (n_fine,) int32   out: the shard of each bucket
//   loads   (n_shards,) int64 out: the rows each shard receives
//
// Step i takes bucket j = order[i] onto the shard of least load, the
// first one on a tie, and adds counts[j] to that shard's load.  The steps
// are sequential by definition (each argmin sees every earlier step), so
// the kernel is ONE warp: the loads live in shared memory, each lane
// scans the shards lane, lane + 32, ... for its least (first on a tie),
// five shuffles reduce the warp's (load, shard) pairs to the first least,
// and lane 0 adds the bucket.
//
// Bound: bytes, and far below the time it takes.  It reads 16 bytes a
// bucket and writes 4 (about 2.5 KB at 128 buckets: under a nanosecond
// at 3.35 TB/s) and does n_fine * n_shards comparisons; what it takes is
// the latency of n_fine dependent steps of a few shuffles each, a few
// microseconds, which is why it is one launch and not 4 * n_fine.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kLanes)
lpt_assign_kernel(const long long* __restrict__ counts,
                  const long long* __restrict__ order, int n_fine,
                  int n_shards, int* __restrict__ assign,
                  long long* __restrict__ loads_out) {
  extern __shared__ long long loads[];
  const int lane = threadIdx.x;
  for (int s = lane; s < n_shards; s += kLanes) loads[s] = 0;
  __syncwarp();
  for (int i = 0; i < n_fine; ++i) {
    long long best = LLONG_MAX;
    int arg = n_shards;
    // ascending s within a lane: a later equal load never replaces
    for (int s = lane; s < n_shards; s += kLanes) {
      const long long v = loads[s];
      if (v < best) {
        best = v;
        arg = s;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const long long ob = __shfl_down_sync(kFull, best, off);
      const int oa = __shfl_down_sync(kFull, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (lane == 0) {
      const long long j = order[i];
      loads[arg] += counts[j];
      assign[j] = arg;
    }
    __syncwarp();
  }
  for (int s = lane; s < n_shards; s += kLanes) loads_out[s] = loads[s];
}

}  // namespace

// All pointers are device pointers.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int spark_lpt_assign(const long long* counts,
                                const long long* order, int n_fine,
                                int n_shards, int* assign, long long* loads,
                                void* stream) {
  if (n_shards <= 0 || n_fine < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(long long) * (size_t)n_shards;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  lpt_assign_kernel<<<1, kLanes, smem,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      counts, order, n_fine, n_shards, assign, loads);
  return (int)cudaGetLastError();
}
