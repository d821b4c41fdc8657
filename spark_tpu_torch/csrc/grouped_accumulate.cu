// Grouped accumulate for Hopper (sm_90a): out[b, p] = sum over the rows i
// with bucket[i] == b of plane p's value at row i, counting only buckets
// below (*n_active) * 512.  Two entries share one kernel body:
//
//   * planes in (`spark_grouped_accumulate`): plane p's value is the byte
//     planes[i, p] of an (N, P) uint8 matrix — the one-to-one counterpart
//     of the TPU kernel;
//   * columns in (`spark_grouped_accumulate_columns`): each plane is
//     computed in registers from the columns it comes from, so the (N, P)
//     matrix is never written.  A plane is a mask (1 where the mask byte
//     is nonzero) or a limb of a value column:
//         mask ? ((x ^ offset if 8 bytes wide else x + offset) >> 8*limb) & 0xFF : 0
//     with x the value sign-extended to 64 bits and the sum wrapping.
//
// Replaces the TPU kernel spark_tpu/pallas_agg.py `_kernel` /
// `grouped_accumulate` (the MXU hash map of the grouped aggregate) and, in
// the columns entry, the limb-plane build in front of it
// (spark_tpu/kernels.py `fast_branch`).  The TPU form builds one-hot tiles
// in VMEM and feeds the matrix unit with bf16 planes; the function is the
// same here, its tiling is not.
//
// Bound: bytes.  The work is a few integer operations per plane byte, far
// below the card's operation rate, while every input is read once from
// device memory: N * (4 + row bytes) in, B * P * 8 out.  The design:
//
//   * persistent grid: as many CTAs as fit on the card at once
//     (cudaOccupancyMaxActiveClusters), each taking row tiles with a grid
//     stride; *n_active is read on the device, so the host never waits;
//   * the accumulator holds the table's buckets in int32 lanes in shared
//     memory, as many as fit beside the tile ring (up to 227 KB of
//     dynamic shared memory): one pass over the rows when they cover the
//     live range, else a pass per accumulator-wide chunk of it.  A
//     bucket's lanes are padded to an odd count, so the 32 rows of a warp
//     spread over all 32 banks;
//   * a ring of kStages (2) tiles of up to kMaxTileRows (4,096) rows:
//     each tile holds the rows' bucket codes and every input column, each
//     a contiguous byte range brought in by one bulk (TMA) copy that
//     completes on the stage's mbarrier (single bytes where a source is
//     not 16-byte aligned, and for a ragged end).  The next tile lands
//     while the CTA accumulates this one, each thread its kRows rows
//     together (the columns loader decodes each plane run once for them).
//     Tiles are sized so that every CTA takes the same number.  Fewer,
//     larger tiles measured faster than deeper rings of smaller ones
//     (tools/k1_sweep.py), and a warp-specialised ring (one loading warp,
//     31 warps taking 128-row tiles each) was slower still: its time grew
//     with the number of tiles the one loading warp had to issue;
//   * one 32-bit shared atomicAdd per nonzero plane byte.  (A 64-bit
//     shared atomicAdd carrying two planes was tried: sm_90 has none, it
//     compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64);
//   * a thread block cluster of kCluster (2) CTAs reduces their
//     accumulators through distributed shared memory, each CTA a slice,
//     before one 64-bit
//     global atomicAdd per nonzero sum; integer atomics are exact, so the
//     result does not depend on the order in which CTAs run;
//   * exact at any N: a CTA flushes and re-zeroes after at most
//     rows_per_flush rows (255 * 8,421,504 < 2^31).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

// Tuning, chosen at the main path with tools/k1_sweep.py (which times
// variants of these lines in copies of this file): threads a CTA and CTAs
// an SM aims for, the shared memory a CTA may take, ring stages, the
// largest tile, and the CTAs of a cluster.
constexpr int kThreads = 1024;
constexpr int kMinBlocks = 1;
constexpr int kSmemBudget = 232448;
constexpr int kStages = 2;             // tiles in the ring, kStages - 1 in flight
constexpr int kMaxTileRows = 4096;
constexpr int kCluster = 2;

constexpr int kChunk = 512;            // n_active counts 512-bucket chunks
constexpr int kMinTileRows = 16;       // keeps every byte range 16-byte sized
constexpr int kMaxColumns = 16;
constexpr int kMaxPlanes = 64;

typedef unsigned long long u64;

struct Geometry {
  long long n, n_tiles;
  int P, B, S;            // S: accumulator lanes per bucket, P rounded up to odd
  int W;                  // buckets the accumulator holds
  int R, tile_bytes;      // rows and bytes per tile
  int rounds_per_flush;   // grid-stride rounds between flushes
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(unsigned bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk (TMA) copy of bytes (a multiple of 16, both ends 16-byte
// aligned) into this CTA's shared memory, completing on barrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The part of a byte range the bulk copy takes: its whole 16-byte
// multiples when the source is 16-byte aligned, else nothing.
__device__ __forceinline__ int bulk_part(const uint8_t* src, int nbytes) {
  return ((uintptr_t)src & 15) == 0 ? nbytes & ~15 : 0;
}

// One input region of a tile: `width` bytes a row, at `prefix` bytes a row
// past the bucket codes.
struct Column {
  const uint8_t* ptr;
  int width;
  int prefix;
};

// A thread's rows of a tile: kRows rows, row[i] < 0 where there is none
// (past the tile, or a bucket outside this pass), dst[i] its bucket's
// accumulator lanes.  Each loader adds the rows' plane values there, all
// of a thread's rows together so their reads overlap.
constexpr int kRows = kMaxTileRows / kThreads;
static_assert(kRows >= 1 && kMaxTileRows % kThreads == 0,
              "a tile is a whole number of rows a thread");

// The planes-in loader: one region, the (N, P) plane matrix.  With P even
// a row's planes are read two bytes at a time.
struct PlanesIn {
  const uint8_t* planes;
  int P;

  __device__ int regions() const { return 1; }
  __device__ Column region(int) const { return Column{planes, P, 0}; }

  __device__ __forceinline__ void accumulate(const uint8_t* tile, int R,
                                             const int* row,
                                             unsigned* const* dst) const {
    const uint8_t* src = tile + 4 * R;
    if ((P & 1) == 0) {
      for (int p = 0; p < P; p += 2) {
        unsigned v[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          v[i] = row[i] < 0 ? 0u : *reinterpret_cast<const uint16_t*>(
                                       src + row[i] * P + p);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (v[i] & 0xFFu) atomicAdd(dst[i] + p, v[i] & 0xFFu);
          if (v[i] >> 8) atomicAdd(dst[i] + p + 1, v[i] >> 8);
        }
      }
      return;
    }
    for (int p = 0; p < P; ++p) {
      unsigned v[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        v[i] = row[i] < 0 ? 0u : src[row[i] * P + p];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (v[i]) atomicAdd(dst[i] + p, v[i]);
    }
  }
};

// A run of consecutive planes: limbs limb0 .. limb0 + n - 1 of one value
// under one mask and offset (the planes of one Sum), or (value < 0) a
// single mask plane.
struct PlaneRun {
  long long offset;
  int value;   // column of the value, or -1: the plane is the mask itself
  int mask;    // column of the mask, or -1: every row
  int limb0, n, plane0;
};

// The columns-in loader: the distinct columns the planes read, each
// loaded once per row, and the planes as runs: a value is read and offset
// once for all its limbs.
struct ColumnsIn {
  int n_cols, n_runs;
  Column col[kMaxColumns];
  PlaneRun run[kMaxPlanes];

  __device__ int regions() const { return n_cols; }
  __device__ Column region(int i) const { return col[i]; }

  __device__ __forceinline__ void accumulate(const uint8_t* tile, int R,
                                             const int* row,
                                             unsigned* const* dst) const {
    for (int r = 0; r < n_runs; ++r) {       // the same runs in every thread
      const PlaneRun u = run[r];
      const uint8_t* m =
          u.mask < 0 ? nullptr : tile + R * (4 + col[u.mask].prefix);
      bool on[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        on[i] = row[i] >= 0 && (m == nullptr || m[row[i]] != 0);
      if (u.value < 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (on[i]) atomicAdd(dst[i] + u.plane0, 1u);
        continue;
      }
      const int w = col[u.value].width;
      const uint8_t* p = tile + R * (4 + col[u.value].prefix);
      u64 y[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k = on[i] ? row[i] : 0;
        long long x;
        switch (w) {
          case 1: x = reinterpret_cast<const int8_t*>(p)[k]; break;
          case 2: x = reinterpret_cast<const int16_t*>(p)[k]; break;
          case 4: x = reinterpret_cast<const int32_t*>(p)[k]; break;
          default: x = reinterpret_cast<const long long*>(p)[k]; break;
        }
        y[i] = (w == 8 ? (u64)x ^ (u64)u.offset : (u64)x + (u64)u.offset)
               >> (8 * u.limb0);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (!on[i]) continue;
        unsigned* d = dst[i] + u.plane0;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const unsigned v = (unsigned)(y[i] >> (8 * l)) & 0xFFu;
          if (l < u.n && v) atomicAdd(d + l, v);
        }
      }
    }
  }
};

// Bring tile t into a stage of the ring: thread 0 arms the stage's barrier
// with the bulk bytes and issues one bulk copy per byte range; every
// thread copies, byte by byte, what the bulk copies cannot take.
template <class Loader>
__device__ __forceinline__ void load_tile(uint8_t* buf, unsigned bar,
                                          const Loader& ld,
                                          const int32_t* bucket,
                                          const Geometry& g, long long t) {
  const long long r0 = t * g.R;
  const int rows = (int)min((long long)g.R, g.n - r0);
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(bucket + r0);
  // range -1 is the bucket codes, at the tile's start
  auto range = [&](int i, const uint8_t** src, uint8_t** dst) {
    const Column c = i < 0 ? Column{codes, 4, -4} : ld.region(i);
    *src = i < 0 ? codes : c.ptr + r0 * c.width;
    *dst = buf + g.R * (4 + c.prefix);
    return rows * c.width;
  };
  const uint8_t* src;
  uint8_t* dst;
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int i = -1; i < ld.regions(); ++i) {
      const int nbytes = range(i, &src, &dst);
      total += bulk_part(src, nbytes);
    }
    mbar_arrive_expect(bar, total);
    for (int i = -1; i < ld.regions(); ++i) {
      const int nbytes = range(i, &src, &dst);
      if (const int body = bulk_part(src, nbytes))
        bulk_copy(dst, src, body, bar);
    }
  }
  for (int i = -1; i < ld.regions(); ++i) {
    const int nbytes = range(i, &src, &dst);
    for (int k = bulk_part(src, nbytes) + threadIdx.x; k < nbytes;
         k += kThreads)
      dst[k] = src[k];
  }
}

template <class Loader>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grouped_accumulate_kernel(
    const int32_t* __restrict__ bucket, const int32_t* __restrict__ n_active,
    u64* __restrict__ out, const Geometry g, const __grid_constant__ Loader ld) {
  extern __shared__ __align__(16) unsigned acc[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(acc) +
                   (((size_t)g.W * g.S * 4 + 15) & ~(size_t)15);
  const unsigned bars = smem_addr(tiles + (size_t)kStages * g.tile_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const long long limit_ll = (long long)(*n_active) * kChunk;
  const int L = (int)(limit_ll < (long long)g.B ? limit_ll : (long long)g.B);
  const long long grid = gridDim.x;
  const long long rounds = (g.n_tiles + grid - 1) / grid;
  // every CTA of a cluster runs the same passes and flushes; q counts this
  // CTA's tiles, which take the ring's stages and barrier phases in turn
  long long q = 0;
  for (int c0 = 0; c0 < L; c0 += g.W) {
    const int c1 = min(c0 + g.W, L);           // buckets [c0, c1) here
    const int entries = (c1 - c0) * g.S;
    for (long long s0 = 0; s0 < rounds; s0 += g.rounds_per_flush) {
      for (int e = threadIdx.x; e < entries; e += kThreads) acc[e] = 0;

      // this CTA's tiles of the segment: (s0 + k) * grid + blockIdx.x
      const long long first = s0 * grid + blockIdx.x;
      long long K = 0;
      if (first < g.n_tiles)
        K = min((long long)g.rounds_per_flush, (g.n_tiles - 1 - first) / grid + 1);
      for (long long k = 0; k < K && k < kStages - 1; ++k) {
        const int st = (int)((q + k) % kStages);
        load_tile(tiles + (size_t)st * g.tile_bytes, bars + 8 * st, ld,
                  bucket, g, first + k * grid);
      }
      __syncthreads();                          // zeroed
      for (long long k = 0; k < K; ++k) {
        const long long kk = k + kStages - 1;
        if (kk < K) {                           // into the stage freed last
          const int st = (int)((q + kk) % kStages);
          load_tile(tiles + (size_t)st * g.tile_bytes, bars + 8 * st, ld,
                    bucket, g, first + kk * grid);
        }
        const int st = (int)((q + k) % kStages);
        mbar_wait(bars + 8 * st, (unsigned)(((q + k) / kStages) & 1));
        __syncthreads();                        // and every byte copy
        const uint8_t* buf = tiles + (size_t)st * g.tile_bytes;
        const int32_t* codes = reinterpret_cast<const int32_t*>(buf);
        const long long r0 = (first + k * grid) * g.R;
        const int rows = (int)min((long long)g.R, g.n - r0);
        int row[kRows];
        unsigned* dst[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = threadIdx.x + i * kThreads;
          const int b = r < rows ? codes[r] : -1;
          const bool live = b >= c0 && b < c1;
          row[i] = live ? r : -1;
          dst[i] = acc + (size_t)(live ? b - c0 : 0) * g.S;
        }
        ld.accumulate(buf, g.R, row, dst);
        __syncthreads();                        // the stage may be refilled
      }
      q += K;

      // flush: each CTA of the cluster sums one slice of every CTA's
      // accumulator (distributed shared memory), one atomic per sum
      cluster.sync();
      const int step = n_ranks * kThreads;
      for (int e0 = rank * kThreads + threadIdx.x; e0 < entries;
           e0 += 4 * step) {
        u64 sum[4] = {0, 0, 0, 0};     // four sums' reads before any atomic
        for (int qr = 0; qr < n_ranks; ++qr) {
          const unsigned* remote = cluster.map_shared_rank(acc, qr);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (e0 + i * step < entries) sum[i] += remote[e0 + i * step];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = e0 + i * step;
          if (e < entries && sum[i])   // a padding lane stays 0
            atomicAdd(out + (c0 + e / g.S) * (long long)g.P + e % g.S, sum[i]);
        }
      }
      cluster.sync();                           // slices read: re-zero
    }
  }
}

std::mutex g_launch_mutex;   // guards each instantiation's cached attributes

// Size a launch: the tile, the accumulator, the dynamic shared memory and
// the grid, into cfg (which points at attr) and g.  The kernel's
// attributes are set, and its occupancy asked for, only the first time a
// shared-memory size is seen: a launch whose size was seen before makes
// no such call, so one captured into a CUDA graph after an eager run of
// the same launches makes none while the graph is being captured.
template <class Loader>
int plan(long long n, int P, int B, int row_width, long long rows_per_flush,
         cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg, Geometry* g) {
  auto kernel = grouped_accumulate_kernel<Loader>;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem_max > kSmemBudget) smem_max = kSmemBudget;
  const long long lanes = P | 1;
  const long long row_bytes = 4 + (long long)row_width;
  // the largest tile whose ring leaves room for 1,024 buckets (two of the
  // chunks n_active counts), or for one bucket; then the accumulator: all
  // of B, or as many buckets as the rest holds
  long long R = 0;
  for (long long want = 1024; want >= 1 && !R; want = want > 1 ? 1 : 0)
    for (long long r = kMaxTileRows; r >= kMinTileRows && !R; r /= 2)
      if (kStages * (r * row_bytes + 8) + 16 + want * lanes * 4 <= smem_max)
        R = r;
  if (!R) return (int)cudaErrorInvalidValue;              // rows too wide
  const long long ring = kStages * (R * row_bytes + 8);   // tiles, barriers
  const long long room = (smem_max - ring - 16) / (lanes * 4);
  const long long W = room < B ? room : B;
  const long long smem = ((W * lanes * 4 + 15) & ~15LL) + ring;
  if (rows_per_flush < R) return (int)cudaErrorInvalidValue;   // R only shrinks

  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->blockDim = dim3(kThreads);
  cfg->gridDim = dim3(kCluster);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;

  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(g_launch_mutex);
    static long long opt_in_smem = -1;             // the attribute's value
    static std::map<long long, int> resident_at;   // smem -> clusters
    auto it = resident_at.find(smem);
    if (it == resident_at.end()) {
      // the opt-in only grows: a smaller launch stays within it
      if (smem > opt_in_smem) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        opt_in_smem = smem;
      }
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
      if (err != cudaSuccess) return (int)err;
      it = resident_at.emplace(smem, clusters).first;
    }
    resident = it->second;
  }
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;

  // even out the last round: the fewest tiles a CTA needs at the largest
  // tile, then the smallest tile (a multiple of 16 rows) that still takes
  // every row in that many rounds
  const long long ctas = (long long)resident * kCluster;
  const long long per_cta = ((n + R - 1) / R + ctas - 1) / ctas;
  R = ((n + ctas * per_cta - 1) / (ctas * per_cta) + 15) & ~15LL;

  g->n = n;
  g->n_tiles = (n + R - 1) / R;
  g->P = P;
  g->B = B;
  g->S = (int)lanes;
  g->W = (int)W;
  g->R = (int)R;
  g->tile_bytes = (int)(R * row_bytes);
  const long long rpf = rows_per_flush / R;
  g->rounds_per_flush = (int)(rpf < 0x7fffffffLL ? rpf : 0x7fffffffLL);
  const long long needed = (g->n_tiles + kCluster - 1) / kCluster;
  const long long clusters = needed < resident ? needed : resident;
  cfg->gridDim = dim3((unsigned)(clusters * kCluster));
  return 0;
}

template <class Loader>
int launch(const int32_t* bucket, const int32_t* n_active, int64_t* out,
           long long n, int P, int B, int row_width, const Loader& ld,
           long long rows_per_flush, void* stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Geometry g;
  const int err = plan<Loader>(n, P, B, row_width, rows_per_flush, attr,
                               &cfg, &g);
  if (err != 0) return err;
  cfg.stream = (cudaStream_t)stream;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, grouped_accumulate_kernel<Loader>, bucket, n_active,
      reinterpret_cast<u64*>(out), g, ld);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

}  // namespace

// C interfaces, bound with ctypes.  `out` is a zeroed (B, P) int64 tensor
// the caller allocated; `n_active` is a device int32 scalar.  Each returns
// 0 or a cudaError_t code (never launched, or refused at launch).
extern "C" int spark_grouped_accumulate(const int32_t* bucket,
                                        const uint8_t* planes,
                                        const int32_t* n_active,
                                        int64_t* out, long long n, int P,
                                        int B, long long rows_per_flush,
                                        void* stream) {
  if (n <= 0) return 0;
  if (P <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const PlanesIn ld{planes, P};
  return launch(bucket, n_active, out, n, P, B, P, ld, rows_per_flush,
                stream);
}

// Columns: n_cols distinct columns (device pointers and byte widths 1, 2,
// 4 or 8; a mask is 1 byte wide); planes: for each of P planes its value
// column (or -1: the plane is its mask), mask column (or -1: every row),
// limb and offset.  Consecutive limbs of one value under one mask and
// offset become one run, read and offset once a row.
extern "C" int spark_grouped_accumulate_columns(
    const int32_t* bucket, const unsigned long long* col_ptrs,
    const int* col_widths, int n_cols, const int* plane_value,
    const int* plane_mask, const int* plane_limb,
    const long long* plane_offset, int P, const int32_t* n_active,
    int64_t* out, long long n, int B, long long rows_per_flush,
    void* stream) {
  if (n <= 0) return 0;
  if (P <= 0 || P > kMaxPlanes || n_cols < 0 || n_cols > kMaxColumns ||
      B <= 0)
    return (int)cudaErrorInvalidValue;
  ColumnsIn ld = {};
  ld.n_cols = n_cols;
  int prefix = 0;
  for (int i = 0; i < n_cols; ++i) {
    const int w = col_widths[i];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    ld.col[i] = Column{reinterpret_cast<const uint8_t*>(col_ptrs[i]), w, prefix};
    prefix += w;
  }
  for (int k = 0; k < P; ++k) {
    const int v = plane_value[k], m = plane_mask[k], limb = plane_limb[k];
    if (v < -1 || v >= n_cols || m < -1 || m >= n_cols || limb < 0 ||
        limb > 7 || (m >= 0 && col_widths[m] != 1))
      return (int)cudaErrorInvalidValue;
    PlaneRun* last = ld.n_runs ? &ld.run[ld.n_runs - 1] : nullptr;
    if (v >= 0 && last && last->value == v && last->mask == m &&
        last->offset == plane_offset[k] && last->limb0 + last->n == limb) {
      ++last->n;                       // the next limb of the same value
      continue;
    }
    ld.run[ld.n_runs++] = PlaneRun{plane_offset[k], v, m, limb, 1, k};
  }
  return launch(bucket, n_active, out, n, P, B, prefix, ld, rows_per_flush,
                stream);
}

// The launch either entry makes for n rows of row_width input bytes (the
// planes, or the columns' widths summed), P planes and B buckets, without
// launching: info (7 ints) gets grid, threads, dynamic shared memory,
// cluster size, tile rows, accumulator buckets and ring stages.
extern "C" int spark_grouped_accumulate_shape(int columns, long long n, int P,
                                              int B, int row_width,
                                              long long rows_per_flush,
                                              int* info) {
  if (n <= 0 || P <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Geometry g;
  const int err =
      columns ? plan<ColumnsIn>(n, P, B, row_width, rows_per_flush, attr,
                                &cfg, &g)
              : plan<PlanesIn>(n, P, B, row_width, rows_per_flush, attr,
                               &cfg, &g);
  if (err != 0) return err;
  const int shape[7] = {(int)cfg.gridDim.x, kThreads,
                        (int)cfg.dynamicSmemBytes, kCluster, g.R, g.W,
                        kStages};
  for (int i = 0; i < 7; ++i) info[i] = shape[i];
  return 0;
}
