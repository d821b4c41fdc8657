// Grouped accumulate for Hopper (sm_90a): out[b, p] = sum of planes[i, p]
// over the rows i with bucket[i] == b, counting only buckets below
// (*n_active) * 512.
//
// Replaces the TPU kernel spark_tpu/pallas_agg.py `_kernel` /
// `grouped_accumulate` (the MXU hash map of the grouped aggregate).  The
// TPU form builds one-hot tiles in VMEM and feeds the matrix unit; the
// function is the same here, its tiling is not.
//
// Bound: bytes.  The work is one integer add per plane byte, far below the
// card's operation rate, while the inputs are read once from device
// memory: N * (4 + P) bytes in, B * P * 8 bytes out.  The design keeps the
// accumulator in shared memory so that device memory sees one pass over
// the inputs (per active bucket chunk):
//
//   * the grid is (row blocks x bucket chunks), flattened to one axis;
//   * a block first skips itself when its chunk starts at or beyond the
//     live limit (*n_active) * 512 — read from device memory, so the host
//     never waits for it; rows whose bucket is past the limit never count;
//   * it zeroes an int32 accumulator for its chunk in shared memory, then
//     streams its rows, one row per thread (a warp reads 32 consecutive
//     rows, i.e. 32 * P contiguous plane bytes), skips rows whose bucket
//     lies outside the chunk without reading their planes, and atomically
//     adds each nonzero byte into the accumulator; at most kRowsPerBlock
//     rows feed one accumulator, and 255 * kRowsPerBlock < 2^31 keeps
//     int32 exact;
//   * it flushes the nonzero entries into the int64 output with 64-bit
//     atomicAdd.  Integer atomics are exact, so the result does not
//     depend on the order in which blocks run.
//
// Later work, not done here: vectorized 16-byte loads, warp-private
// histograms, and fusing the limb extraction in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;                  // n_active counts 512-bucket chunks
constexpr long long kRowsPerBlock = 16384;   // 255 * 16384 < 2^31
constexpr int kSmemBytes = 48 * 1024;        // no opt-in attribute needed

__global__ void grouped_accumulate_kernel(
    const int32_t* __restrict__ bucket, const uint8_t* __restrict__ planes,
    const int32_t* __restrict__ n_active,
    unsigned long long* __restrict__ out, long long n, int P, int B,
    int chunk_width, int n_chunks) {
  extern __shared__ int acc[];
  const int chunk = blockIdx.x % n_chunks;
  const long long row_block = blockIdx.x / n_chunks;
  const int c0 = chunk * chunk_width;
  const long long limit_ll = (long long)(*n_active) * kChunk;
  const int limit = (int)(limit_ll < (long long)B ? limit_ll : (long long)B);
  if (c0 >= limit) return;  // the whole chunk lies past the live key range
  const int c1 = min(c0 + chunk_width, limit);  // buckets [c0, c1) count here
  const int width = (c1 - c0) * P;
  for (int i = threadIdx.x; i < width; i += blockDim.x) acc[i] = 0;
  __syncthreads();

  const long long r0 = row_block * kRowsPerBlock;
  const long long r1 = min(n, r0 + kRowsPerBlock);
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    const int b = bucket[row];
    if (b < c0 || b >= c1) continue;
    const uint8_t* src = planes + row * P;
    int* dst = acc + (b - c0) * P;
    for (int p = 0; p < P; ++p) {
      const int v = src[p];
      if (v != 0) atomicAdd(&dst[p], v);
    }
  }
  __syncthreads();

  // chunk rows are contiguous in the (B, P) row-major output
  unsigned long long* dst = out + (long long)c0 * P;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const int v = acc[i];
    if (v != 0) atomicAdd(&dst[i], (unsigned long long)v);
  }
}

}  // namespace

// C interface, bound with ctypes.  `out` is a zeroed (B, P) int64 tensor
// the caller allocated; `n_active` is a device int32 scalar.  Returns 0 or
// a cudaError_t code (never launched, or refused at launch).
extern "C" int spark_grouped_accumulate(const int32_t* bucket,
                                        const uint8_t* planes,
                                        const int32_t* n_active,
                                        int64_t* out, long long n, int P,
                                        int B, void* stream) {
  if (n <= 0) return 0;
  if (P <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  int chunk_width = kSmemBytes / (4 * P);
  if (chunk_width <= 0) return (int)cudaErrorInvalidValue;  // P too wide
  if (chunk_width >= kChunk) chunk_width -= chunk_width % kChunk;
  if (chunk_width > B) chunk_width = B;
  const int n_chunks = (B + chunk_width - 1) / chunk_width;
  const long long row_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = row_blocks * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)chunk_width * P * sizeof(int);
  grouped_accumulate_kernel<<<(unsigned)blocks, kThreads, smem,
                              (cudaStream_t)stream>>>(
      bucket, planes, n_active, reinterpret_cast<unsigned long long*>(out),
      n, P, B, chunk_width, n_chunks);
  return (int)cudaGetLastError();
}
