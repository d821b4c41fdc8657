// All-to-all exchange (kernel K2) for Hopper (sm_90a).
//
// Replaces spark_tpu/parallel/ici.py `_pallas_a2a`, the Pallas direct
// all-to-all: `out_d[s] = in_s[d]` for every sender s and receiver d.
// Here every participant (mesh shard) lives on one card, so an exchange
// is a reordering copy in device memory:
//
//   plane k, sender s:    src[k][s] is (n, cap, ...) contiguous; row d is
//                         the block bound for receiver d
//   plane k, all:         dst[k] is (n, n, cap, ...) contiguous; dst[k][d][s]
//                         is the block receiver d got from sender s
//
// ONE launch moves every plane of one exchange (each column, each
// validity mask, the row-validity plane, a run table): the planes are
// separate allocations, so the launch carries a table of their pointers
// as a kernel parameter (__grid_constant__: read in place, never copied
// per thread).  A parameter needs no device allocation and no host-to-
// device copy, and the launch copies it whole.  The table holds up to
// kMaxEntries entries: 32,704 bytes, inside the 32,764 bytes of kernel
// parameters that CUDA 12.1 and later take.  With `gather` the
// sender's whole buffer (cap, ...) goes to every receiver (the source
// stride over d is 0): the all-gather of broadcast joins rides the same
// kernel.
//
// Bound: bytes.  Each block is read once and written once; there is no
// arithmetic.  Each CUDA block copies one chunk (at most 64 KiB) of one
// (plane, s, d) block with 16-byte loads and stores when both ends are
// 16-byte aligned, and byte by byte otherwise (bool planes and int32 run
// tables whose block sizes are not multiples of 16).
//
// Why there is no barrier: the TPU kernel fenced its buffers against the
// neighbouring invocations with a barrier semaphore, because remote DMAs
// from other chips could land at any time.  On one card the launch is
// ordered on the caller's stream after every op that produced the send
// buffers and before every op that reads the outputs, which is that fence.
//
// Across processes (the device tier of the cross-process exchange,
// spark_tpu/parallel/ici.py `device_exchange`): each sender packs its
// planes into an arena allocated here with cudaMalloc and exported with
// cudaIpcGetMemHandle; each receiver maps its peers' arenas
// (cudaIpcOpenMemHandle) and PULLS its own blocks with one launch of the
// same kernel, with n_dst = 1: the table's source pointers point at the
// receiver's slot inside each sender's arena, and dst[k][0][s] is what
// sender s packed for it.  Two processes on one card are time-sliced
// contexts and stream order does not cross them, so the order is kept
// on the host: a sender synchronizes its stream after packing and
// publishes its sidecar before its commit marker; a receiver launches
// only after the commit barrier and synchronizes before it commits the
// next exchange (the arenas are double-buffered by exchange).  No
// device-side barrier: it would spin through context switches and hang
// on a dead peer.
//
// Table layout (int64), P planes, n participants (n_src senders):
//   [0, P*n)           source pointer of (plane k, sender s) at k*n + s
//   [P*n, P*n+P)       destination pointer of plane k
//   next P             block bytes of plane k
//   next P             source stride over d, bytes (block bytes, or 0)
//   next P+1           first work item of plane k (exclusive prefix of
//                      n*n*ceil(block bytes / kChunk)); entry P is the total

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 64 * 1024;
constexpr int kMaxEntries = 4088;

struct Table {
  long long v[kMaxEntries];
};

// n senders and n_dst receivers: the local exchange has n_dst = n, a
// cross-process pull n_dst = 1
__global__ void __launch_bounds__(kThreads)
all_to_all_kernel(const __grid_constant__ Table table, int P, int n,
                  int n_dst) {
  const long long* src_ptr = table.v;
  const long long* dst_ptr = src_ptr + (long long)P * n;
  const long long* block_bytes = dst_ptr + P;
  const long long* src_stride = block_bytes + P;
  const long long* first = src_stride + P;
  const long long item = blockIdx.x;

  // the plane of this work item; planes without bytes own no items
  int k = 0;
  while (k + 1 < P && first[k + 1] <= item) ++k;
  const long long bb = block_bytes[k];
  const long long per = (bb + kChunk - 1) / kChunk;
  const long long local = item - first[k];
  const long long blk = local / per;
  const long long c = local - blk * per;
  const long long s = blk / n_dst;
  const long long d = blk - s * n_dst;
  const long long off = c * kChunk;
  const long long len = bb - off < kChunk ? bb - off : kChunk;

  const char* src = reinterpret_cast<const char*>(src_ptr[k * n + s])
                    + d * src_stride[k] + off;
  char* dst = reinterpret_cast<char*>(dst_ptr[k]) + (d * n + s) * bb + off;

  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const long long nvec = len >> 4;
    const uint4* __restrict__ s4 = reinterpret_cast<const uint4*>(src);
    uint4* __restrict__ d4 = reinterpret_cast<uint4*>(dst);
    // kUnroll loads in flight per thread before their stores: a copy has
    // no arithmetic to hide memory latency behind
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nvec; i += kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = s4[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d4[i + u * kThreads] = v[u];
    }
    for (; i < nvec; i += kThreads) d4[i] = s4[i];
    done = nvec << 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads)
    dst[i] = src[i];
}

}  // namespace

// host_table: the `entries` int64 entries described above, in host memory;
// total: its entry first[P] (the number of work items, one CUDA block
// each).  Returns the CUDA error of the launch (0 on success).
extern "C" int spark_all_to_all(const long long* host_table, int entries,
                                int P, int n, long long total, void* stream) {
  if (P <= 0 || n <= 0 || total <= 0) return 0;
  if (entries != P * n + 4 * P + 1 || entries > kMaxEntries ||
      total > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Table table;
  memcpy(table.v, host_table, sizeof(long long) * entries);
  all_to_all_kernel<<<(unsigned)total, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(table, P, n,
                                                                n);
  return (int)cudaGetLastError();
}

// The cross-process pull: the same table with n = n_src senders and
// first[] counting n_src * ceil(block bytes / kChunk) items per plane;
// dst[k] is (1, n_src, block) and source pointers may point into arenas
// mapped from other processes.
extern "C" int spark_a2a_pull(const long long* host_table, int entries,
                              int P, int n_src, long long total,
                              void* stream) {
  if (P <= 0 || n_src <= 0 || total <= 0) return 0;
  if (entries != P * n_src + 4 * P + 1 || entries > kMaxEntries ||
      total > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Table table;
  memcpy(table.v, host_table, sizeof(long long) * entries);
  all_to_all_kernel<<<(unsigned)total, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(table, P,
                                                                n_src, 1);
  return (int)cudaGetLastError();
}

// ---- the arena and its IPC handle -----------------------------------------
// The arena is one cudaMalloc allocation: an IPC handle names a whole
// allocation, never a tensor inside a block of PyTorch's caching
// allocator.  Each call first makes `device` current in this library's
// runtime.

extern "C" int spark_ipc_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}

extern "C" int spark_ipc_alloc(int device, long long bytes, void** ptr) {
  int rc = (int)cudaSetDevice(device);
  if (rc != 0) return rc;
  return (int)cudaMalloc(ptr, (size_t)bytes);
}

extern "C" int spark_ipc_free(int device, void* ptr) {
  int rc = (int)cudaSetDevice(device);
  if (rc != 0) return rc;
  return (int)cudaFree(ptr);
}

extern "C" int spark_ipc_get_handle(int device, void* ptr,
                                    unsigned char* out) {
  int rc = (int)cudaSetDevice(device);
  if (rc != 0) return rc;
  cudaIpcMemHandle_t h;
  rc = (int)cudaIpcGetMemHandle(&h, ptr);
  if (rc == 0) memcpy(out, &h, sizeof(h));
  return rc;
}

extern "C" int spark_ipc_open(int device, const unsigned char* in,
                              void** ptr) {
  int rc = (int)cudaSetDevice(device);
  if (rc != 0) return rc;
  cudaIpcMemHandle_t h;
  memcpy(&h, in, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int spark_ipc_close(int device, void* ptr) {
  int rc = (int)cudaSetDevice(device);
  if (rc != 0) return rc;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// host → arena bytes, queued on `stream` (CUDA stages a pageable source
// before the call returns; the caller synchronizes before publishing)
extern "C" int spark_ipc_copy(int device, void* dst, const void* src,
                              long long bytes, void* stream) {
  int rc = (int)cudaSetDevice(device);
  if (rc != 0) return rc;
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyDefault,
                              reinterpret_cast<cudaStream_t>(stream));
}
