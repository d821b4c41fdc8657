// Greedy LPT assignment of fine hash buckets onto mesh shards, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it ports the reference's XLA loop
// spark_tpu/parallel/collective.py `balanced_assignment` (a
// `lax.fori_loop` over the buckets, heaviest first, each onto the
// least-loaded shard).  As torch ops it would put about four nodes per
// bucket into every captured exchange, so it is one launch.
//
//   counts  (n_fine,) int64   global live rows per fine bucket (psum'd)
//   order   (n_fine,) int64   the buckets heaviest first, a STABLE order
//                             (equal counts keep bucket order), or null:
//                             then the kernel ranks the buckets itself
//   assign  (n_fine,) int32   out: the shard of each bucket
//   loads   (n_shards,) int64 out: the rows each shard receives
//
// Step i takes the i-th heaviest bucket j onto the shard of least load,
// the first one on a tie, and adds counts[j] to that shard's load.  The
// steps are sequential by definition (each argmin sees every earlier
// step).
//
// Bound: latency.  It reads 8 bytes a bucket and writes 4 (about 1.5 KB at
// 128 buckets: under a nanosecond at 3.35 TB/s); what it takes is the
// chain of n_fine dependent steps.  So the design keeps every step of the
// chain out of device memory:
//  * one launch, one block: every thread stages the counts into shared
//    memory in one coalesced pass before any step runs;
//  * the stable descending order is computed here (n_fine <= kRankMax):
//    each thread ranks its buckets by counting the buckets that are
//    heavier, or as heavy with a lower index (n_fine^2 comparisons of
//    broadcast shared-memory reads: 16K at 128 buckets), and scatters the
//    bucket and its count to that rank in shared memory.  Beyond kRankMax
//    buckets the wrapper passes a sorted `order` and the block stages it,
//    kStage buckets at a time, with the counts in that order;
//  * the loads of the shards live in registers: with at most 8 shards one
//    thread holds them all and takes the argmin with a tree of
//    compare-selects (the left index kept on a tie); with at most 32 each
//    lane holds one shard's load and the argmin is two warp min-reductions
//    (the high word signed, then the low word of the candidates) and a
//    ballot; more shards keep their loads in shared memory, each lane
//    scanning every 32nd and five shuffles reducing the warp's pairs.
// A step is then a few dozen cycles of register and shared-memory work.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRankMax = 512;        // buckets ranked in the kernel
constexpr int kStage = 1024;         // buckets staged at a time
constexpr unsigned kFull = 0xffffffffu;

// at most S shards (a power of two), their loads in one thread's
// registers; a shard past n_shards holds LLONG_MAX and is never chosen
template <int S>
struct FewShards {
  static constexpr int kLanes = 1;
  static constexpr bool kWide = false;
  long long ld[S];

  __device__ void init(int n_shards, long long*, int) {
#pragma unroll
    for (int k = 0; k < S; ++k) ld[k] = k < n_shards ? 0 : LLONG_MAX;
  }

  __device__ void step(int j, long long c, int* assign, int, int,
                       long long*) {
    long long v[S];
    int a[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      v[k] = ld[k];
      a[k] = k;
    }
    // neighbours pair up, so the left index is always the lower one
#pragma unroll
    for (int w = S / 2; w >= 1; w >>= 1) {
#pragma unroll
      for (int k = 0; k < w; ++k) {
        const bool right = v[2 * k + 1] < v[2 * k];
        v[k] = right ? v[2 * k + 1] : v[2 * k];
        a[k] = right ? a[2 * k + 1] : a[2 * k];
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k == a[0]) ld[k] += c;
    assign[j] = a[0];
  }

  __device__ void store(long long* out, int n_shards, int, long long*) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (k < n_shards) out[k] = ld[k];
  }
};

// at most 32 shards: lane s holds shard s's load
struct WarpShards {
  static constexpr int kLanes = 32;
  static constexpr bool kWide = false;
  long long ld;

  __device__ void init(int n_shards, long long*, int lane) {
    ld = lane < n_shards ? 0 : LLONG_MAX;
  }

  __device__ void step(int j, long long c, int* assign, int lane, int,
                       long long*) {
    // (signed high word, unsigned low word) orders as the int64 does
    const int hi = (int)(ld >> 32);
    const unsigned lo = (unsigned)ld;
    const int min_hi = __reduce_min_sync(kFull, hi);
    const unsigned min_lo =
        __reduce_min_sync(kFull, hi == min_hi ? lo : 0xffffffffu);
    const unsigned win = __ballot_sync(kFull, hi == min_hi && lo == min_lo);
    const int arg = __ffs(win) - 1;
    if (lane == arg) ld += c;
    if (lane == 0) assign[j] = arg;
  }

  __device__ void store(long long* out, int n_shards, int lane, long long*) {
    if (lane < n_shards) out[lane] = ld;
  }
};

// any number of shards: the loads in shared memory
struct WideShards {
  static constexpr int kLanes = 32;
  static constexpr bool kWide = true;

  __device__ void init(int n_shards, long long* loads, int lane) {
    for (int s = lane; s < n_shards; s += 32) loads[s] = 0;
    __syncwarp();
  }

  __device__ void step(int j, long long c, int* assign, int lane,
                       int n_shards, long long* loads) {
    long long best = LLONG_MAX;
    int arg = n_shards;
    // ascending s within a lane: a later equal load never replaces
    for (int s = lane; s < n_shards; s += 32) {
      const long long v = loads[s];
      if (v < best) {
        best = v;
        arg = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long ob = __shfl_down_sync(kFull, best, off);
      const int oa = __shfl_down_sync(kFull, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    if (lane == 0) {
      loads[arg] += c;
      assign[j] = arg;
    }
    __syncwarp();
  }

  __device__ void store(long long* out, int n_shards, int lane,
                        long long* loads) {
    for (int s = lane; s < n_shards; s += 32) out[s] = loads[s];
  }
};

template <class Shards>
__global__ void __launch_bounds__(kMaxThreads)
lpt_assign_kernel(const long long* __restrict__ counts,
                  const long long* __restrict__ order, int n_fine,
                  int n_shards, int* __restrict__ assign,
                  long long* __restrict__ loads_out) {
  extern __shared__ __align__(16) long long smem[];
  long long* s_sorted = smem;                    // kStage: counts by rank
  long long* s_counts = s_sorted + kStage;       // kRankMax: by bucket
  long long* s_loads = s_counts + kRankMax;      // n_shards (wide only)
  int* s_order = reinterpret_cast<int*>(
      s_loads + (Shards::kWide ? n_shards : 0));  // kStage: bucket by rank
  const int tid = threadIdx.x;
  Shards shards;
  if (tid < Shards::kLanes) shards.init(n_shards, s_loads, tid);
  const bool ranked = order == nullptr;
  if (ranked) {
    for (int i = tid; i < n_fine; i += blockDim.x) s_counts[i] = counts[i];
    __syncthreads();
    for (int i = tid; i < n_fine; i += blockDim.x) {
      const long long c = s_counts[i];
      int rank = 0;
#pragma unroll 8
      for (int j = 0; j < n_fine; ++j) {
        const long long o = s_counts[j];
        rank += (o > c) | ((o == c) & (j < i));
      }
      s_order[rank] = i;
      s_sorted[rank] = c;
    }
    __syncthreads();
  }
  for (int base = 0; base < n_fine; base += kStage) {
    const int len = n_fine - base < kStage ? n_fine - base : kStage;
    if (!ranked) {
      for (int i = tid; i < len; i += blockDim.x) {
        const int j = (int)order[base + i];
        s_order[i] = j;
        s_sorted[i] = counts[j];
      }
      __syncthreads();
    }
    if (tid < Shards::kLanes)
#pragma unroll 4
      for (int i = 0; i < len; ++i)
        shards.step(s_order[i], s_sorted[i], assign, tid, n_shards, s_loads);
    __syncthreads();                  // before the next stage overwrites
  }
  if (tid < Shards::kLanes) shards.store(loads_out, n_shards, tid, s_loads);
}

template <class Shards>
int launch(const long long* counts, const long long* order, int n_fine,
           int n_shards, int* assign, long long* loads, cudaStream_t stream) {
  const size_t smem = sizeof(long long) * (kStage + kRankMax)
                      + (Shards::kWide ? sizeof(long long) * n_shards : 0)
                      + sizeof(int) * kStage;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        lpt_assign_kernel<Shards>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  int threads = order == nullptr ? (n_fine + 31) / 32 * 32 : 256;
  threads = threads < 32 ? 32 : threads > kMaxThreads ? kMaxThreads : threads;
  lpt_assign_kernel<Shards><<<1, threads, smem, stream>>>(
      counts, order, n_fine, n_shards, assign, loads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spark_lpt_rank_max() { return kRankMax; }

// All pointers are device pointers; `order` is null for n_fine <=
// spark_lpt_rank_max() (the kernel ranks) and the stable descending order
// otherwise.  Returns the CUDA error of the launch (0 on success).
extern "C" int spark_lpt_assign(const long long* counts,
                                const long long* order, int n_fine,
                                int n_shards, int* assign, long long* loads,
                                void* stream) {
  if (n_shards <= 0 || n_fine < 0 || (order == nullptr && n_fine > kRankMax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_shards <= 2)
    return launch<FewShards<2>>(counts, order, n_fine, n_shards, assign,
                                loads, st);
  if (n_shards <= 4)
    return launch<FewShards<4>>(counts, order, n_fine, n_shards, assign,
                                loads, st);
  if (n_shards <= 8)
    return launch<FewShards<8>>(counts, order, n_fine, n_shards, assign,
                                loads, st);
  if (n_shards <= 32)
    return launch<WarpShards>(counts, order, n_fine, n_shards, assign, loads,
                              st);
  return launch<WideShards>(counts, order, n_fine, n_shards, assign, loads,
                            st);
}
