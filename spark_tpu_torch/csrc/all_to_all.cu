// All-to-all exchange (kernel K2) for Hopper (sm_90a).
//
// Replaces spark_tpu/parallel/ici.py `_pallas_a2a`, the Pallas direct
// all-to-all: `out_d[s] = in_s[d]` for every sender s and receiver d.
// The mesh's participants (shards) live on one card or on several cards
// of one host; an exchange is a reordering copy that each receiver's card
// makes, reading its senders' buffers where they are:
//
//   plane k, sender s:    src[k][s] is (n, cap, ...) contiguous; row d is
//                         the block bound for receiver d
//   plane k, card c:      dst[k] is (n_dst, n, cap, ...) contiguous, the
//                         card's receivers d0 .. d0 + n_dst - 1;
//                         dst[k][d - d0][s] is the block receiver d got
//                         from sender s
//
// ONE launch per receiving card moves every plane of one exchange (each
// column, each validity mask, the row-validity plane, a run table): the
// planes are separate allocations, so the launch carries a table of their
// pointers as a kernel parameter (__grid_constant__: read in place, never
// copied per thread).  A parameter needs no device allocation and no
// host-to-device copy, and the launch copies it whole.  The table holds up
// to kMaxEntries entries: 32,704 bytes, inside the 32,764 bytes of kernel
// parameters that CUDA 12.1 and later take.  With `gather` the sender's
// whole buffer (cap, ...) goes to every receiver (the source stride over d
// is 0): the all-gather of broadcast joins rides the same kernel.  On one
// card the launch has n_dst = n, d0 = 0: every receiver.
//
// Bound: bytes.  Each block is read once and written once; there is no
// arithmetic.  Each CUDA block copies one chunk (at most 64 KiB) of one
// (plane, s, d) block with 16-byte loads and stores when both ends are
// 16-byte aligned, and byte by byte otherwise (bool planes and int32 run
// tables whose block sizes are not multiples of 16).  A block whose sender
// lives on another card is read over NVLink (450 GB/s each way, against
// the card's 3.35 TB/s): with peer access on (spark_enable_peer_access),
// a peer card's address is loadable in a kernel under unified addressing,
// the counterpart of `make_async_remote_copy`.
//
// The order across cards.  On one card no barrier is needed: the launch
// is ordered on the caller's stream after every op that produced the send
// buffers and before every op that reads the outputs, which is the fence
// the TPU kernel's barrier semaphore made.  Across cards stream order does
// not cross devices, so each card's ONE launch of exchange_kernel carries
// the order itself, as `_pallas_a2a` keeps its barrier and copy
// semaphores inside its one kernel:
//  * arrive: the first block of the launch to run (an atomic ticket, so
//    never a block that may be left unscheduled) fences and stores the
//    launch's epoch into this card's arrival slot on every card, with a
//    system-scope release store;
//  * per-sender waits: each work item polls, with an acquire load, the
//    arrival slot of its own sender's card only, then copies: the bytes of
//    senders that arrived early move while a late card is still busy;
//  * completion: each block bumps a per-card counter after its copy; the
//    block that completes the count stores "done reading" into every
//    card's slot for this card (when this card read anything), waits until
//    every card that reads this card's sources has stored its own (so no
//    sender frees or reuses a send buffer a peer still reads: the caching
//    allocator hands it to the sender's next op), and advances the epoch.
// A card with no receivers in an exchange (the gathers to card 0) still
// launches, with no copy items: it arrives and waits.  Each card of a set
// has one state allocation (cudaMalloc, outside every graph pool): the
// arrival and done slots of every card, the epoch, the arrival ticket,
// the failure mark and the block counter.  The epoch lives in device
// memory, so a CUDA-graph replay advances it too.  Every wait has a time
// limit read from %globaltimer: the first block that reaches it writes the
// peer it waited for into the card's error word (mapped host memory, read
// by the wrapper without a synchronization) and marks the launch failed,
// and every block then skips its copy and wait, so a dead peer never hangs
// the card.  barrier_kernel, the separate barrier that an exchange once
// took before and after its copy, stays for timing that order.
//
// Across processes (the device tier of the cross-process exchange,
// spark_tpu/parallel/ici.py `device_exchange`): each sender packs its
// planes into an arena allocated here with cudaMalloc and exported with
// cudaIpcGetMemHandle; each receiver maps its peers' arenas
// (cudaIpcOpenMemHandle, with peer access when the sender is on another
// card) and PULLS its own blocks with one launch of pull_kernel (below)
// on its own card: row s of plane k's output is what sender s packed for
// it.  Processes share no stream order, on one card (time-sliced
// contexts) or on several, so the order is kept on the host: a sender
// synchronizes its stream after packing and publishes its sidecar before
// its commit marker; a receiver launches only after the commit barrier
// and synchronizes before it commits the next exchange (the arenas are
// double-buffered by exchange).  No device-side barrier there: it would
// spin through context switches, and the host order already holds.
//
// all_to_all_kernel's table layout (int64), P planes, n senders, one
// receiving card with receivers d0 .. d0 + n_dst - 1 (cuda_a2a.a2a_card_plan
// cuts it per card):
//   [0, P*n)           source pointer of (plane k, sender s) at k*n + s
//   [P*n, P*n+P)       destination pointer of plane k on this card
//   next P             block bytes of plane k
//   next P             source stride over d, bytes (block bytes, or 0)
//   next P+1           first work item of plane k (exclusive prefix of
//                      n*n_dst*ceil(block bytes / kChunk)); entry P is the
//                      total
// (exchange_kernel orders the items of a plane chunk by chunk: item_of)
// exchange_kernel's table adds the order across cards (cuda_a2a.a2a_card_plan
// with `cross`), C cards:
//   next 5             C, this card's rank, its error word's address, the
//                      readers (bit c: card c receives in this exchange),
//                      the time limit of a wait in ns
//   next n             the card of sender s
//   next C             the BarrierState address of card p

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

// one work item of a table: a chunk of the block (plane k, sender s,
// receiver d0 + r)
struct Item {
  const char* src;
  char* dst;
  long long len;
  int s;
};

// n senders and the n_dst receivers d0 .. d0 + n_dst - 1 of one card: on
// one card n_dst = n and d0 = 0.  The senders are taken from `rot` on
// (s = (rot + i) mod n for the i-th): on several cards each card starts
// with its own senders (rot = d0), then the next card's, so at any moment
// the cards read from different senders, where the same order everywhere
// would make every card read one sender's NVLink egress at once; and in
// exchange_kernel a card's first items, its own, wait for no arrival
//
// The items of a plane go block by block (all_to_all_kernel): sender slot,
// then receiver row, then the block's chunks.  With `interleave`
// (exchange_kernel) they go chunk by chunk, and within a chunk receiver by
// receiver, sender by sender: every moment of a launch then reads every
// sender, so cards that did not start together, or wait, never pile onto
// one sender's NVLink egress (in the block-by-block order the cards stay
// on distinct senders only while they run in step, which the old order's
// barrier before every copy gave)
__device__ __forceinline__ Item item_of(const long long* v, int P, int n,
                                        int d0, int n_dst, int rot,
                                        long long item,
                                        bool interleave = false) {
  const long long* src_ptr = v;
  const long long* dst_ptr = src_ptr + (long long)P * n;
  const long long* block_bytes = dst_ptr + P;
  const long long* src_stride = block_bytes + P;
  const long long* first = src_stride + P;
  // the plane of this work item; planes without bytes own no items
  int k = 0;
  while (k + 1 < P && first[k + 1] <= item) ++k;
  const long long bb = block_bytes[k];
  const long long per = (bb + kChunk - 1) / kChunk;
  const long long local = item - first[k];
  long long c, i, r;                          // chunk, sender slot, row
  if (interleave) {
    const long long round = (long long)n * n_dst;
    c = local / round;
    const long long rest = local - c * round;
    r = rest / n;
    i = rest - r * n;
  } else {
    const long long blk = local / per;
    c = local - blk * per;
    i = blk / n_dst;
    r = blk - i * n_dst;
  }
  const long long s = (i + rot) % n;
  const long long d = d0 + r;
  const long long off = c * kChunk;
  Item it;
  it.len = bb - off < kChunk ? bb - off : kChunk;
  it.src = reinterpret_cast<const char*>(src_ptr[k * n + s])
           + d * src_stride[k] + off;
  it.dst = reinterpret_cast<char*>(dst_ptr[k]) + (r * n + s) * bb + off;
  it.s = (int)s;
  return it;
}

// one block copies one item: 16-byte loads and stores where both ends are
// 16-byte aligned, bytes otherwise
__device__ __forceinline__ void copy_item(const Item& it) {
  const char* src = it.src;
  char* dst = it.dst;
  const long long len = it.len;
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

__global__ void __launch_bounds__(kThreads)
all_to_all_kernel(const __grid_constant__ Table table, int P, int n,
                  int d0, int n_dst, int rot) {
  copy_item(item_of(table.v, P, n, d0, n_dst, rot, blockIdx.x));
}

}  // namespace

// host_table: the `entries` int64 entries described above, in host memory;
// d0 / n_dst: the card's receivers; rot: the first sender; total: its entry
// first[P] (the number of work items, one CUDA block each).  Launches on
// `stream`, whose card must be current.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int spark_all_to_all_part(const long long* host_table,
                                     int entries, int P, int n, int d0,
                                     int n_dst, int rot, long long total,
                                     void* stream) {
  if (P <= 0 || n <= 0 || n_dst <= 0 || total <= 0) return 0;
  if (entries != P * n + 4 * P + 1 || entries > kMaxEntries ||
      total > 0x7fffffffLL || d0 < 0 || d0 + n_dst > n || rot < 0 ||
      rot >= n)
    return (int)cudaErrorInvalidValue;
  Table table;
  memcpy(table.v, host_table, sizeof(long long) * entries);
  all_to_all_kernel<<<(unsigned)total, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      table, P, n, d0, n_dst, rot);
  return (int)cudaGetLastError();
}

// every receiver on the caller's one card, senders in order
extern "C" int spark_all_to_all(const long long* host_table, int entries,
                                int P, int n, long long total, void* stream) {
  return spark_all_to_all_part(host_table, entries, P, n, 0, n, 0, total,
                               stream);
}

// ---- peer access and the cross-card barrier (barrier_kernel) ------------

// Peer access from `device` to `peer` (cudaDeviceEnablePeerAccess, made
// with `device` current); one already enabled is success.
extern "C" int spark_enable_peer_access(int device, int peer) {
  int current = -1;
  cudaGetDevice(&current);
  int rc = (int)cudaSetDevice(device);
  if (rc == 0) {
    rc = (int)cudaDeviceEnablePeerAccess(peer, 0);
    if (rc == (int)cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();              // clear the error it left
      rc = 0;
    }
  }
  if (current >= 0) cudaSetDevice(current);
  return rc;
}

namespace {

constexpr int kMaxCards = 32;
constexpr int kCrossHead = 5;
// the first polls of a wait spin without sleeping, for this many ns
constexpr int kSpinNs = 4000;
// exchange_kernel's blocks an SM, as all_to_all_kernel's registers allow
constexpr int kExchangeMinBlocks = 5;

// a card's state (device memory).  flags[p]: the epoch card p last arrived
// at; epoch: this card's last finished exchange or barrier; done[p]: the
// epoch at which card p last finished reading this card's sources;
// arrived: the last epoch a block of this card arrived at (the arrival
// ticket); failed: the last epoch at which a wait of this card gave up;
// blocks: the finished blocks of the running launch
struct BarrierState {
  unsigned long long flags[kMaxCards];
  unsigned long long epoch;
  unsigned long long done[kMaxCards];
  unsigned long long arrived;
  unsigned long long failed;
  unsigned int blocks;
};

struct BarrierArgs {
  BarrierState* state[kMaxCards];      // card p's state, on card p
  unsigned int* error;                 // this card's word, mapped host memory
  long long timeout_ns;
  int rank, n;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// one block of kMaxCards threads; thread p signals card p and waits for it
__global__ void __launch_bounds__(kMaxCards)
barrier_kernel(const __grid_constant__ BarrierArgs a) {
  __shared__ unsigned long long epoch;
  BarrierState* self = a.state[a.rank];
  if (threadIdx.x == 0) {
    epoch = self->epoch + 1;
    self->epoch = epoch;
    // the writes of every op before this barrier on the card's stream
    // reach the whole system before any peer is signalled
    __threadfence_system();
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= a.n) return;
  const unsigned long long e = epoch;
  store_release(&a.state[p]->flags[a.rank], e);
  const unsigned long long* mine = &self->flags[p];
  const unsigned long long t0 = global_ns();
  while (true) {
    if (load_acquire(mine) >= e) break;
    if ((long long)(global_ns() - t0) > a.timeout_ns) {
      *reinterpret_cast<volatile unsigned int*>(a.error) = p + 1;
      __threadfence_system();
      break;
    }
    __nanosleep(200);
  }
}

// waits until *slot reaches epoch e: false if the launch failed, or if
// the wait reached its limit (then, for the first to give up, the card's
// error word names `peer`)
__device__ bool wait_slot(const unsigned long long* slot,
                          unsigned long long e, BarrierState* self,
                          unsigned int* error, int peer,
                          long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  while (true) {
    if (load_acquire(slot) >= e) return true;
    if (load_volatile(&self->failed) >= e) return false;
    const long long waited = (long long)(global_ns() - t0);
    if (waited > timeout_ns) {
      if (atomicMax(&self->failed, e) < e) {
        *reinterpret_cast<volatile unsigned int*>(error) = peer + 1;
        __threadfence_system();
      }
      return false;
    }
    if (waited > kSpinNs) __nanosleep(128);
  }
}

// the order across cards in an exchange_kernel table (after the copy part)
__device__ __forceinline__ const long long* cross_of(const Table& t, int P,
                                                    int n) {
  return t.v + (long long)P * n + 4 * P + 1;
}

__device__ __forceinline__ BarrierState* state_of(const long long* x, int n,
                                                  int card) {
  return reinterpret_cast<BarrierState*>(x[kCrossHead + n + card]);
}

// One exchange on one card of a set: arrive, copy each item once its
// sender's card has arrived, then finish (see the header).  Launched with
// max(items, 1) blocks.  The copy is all_to_all_kernel's, and so is its
// register budget (kExchangeMinBlocks blocks an SM): what the order across
// cards needs lives in the table (a kernel parameter, re-read where
// needed) and in shared memory, not in registers across the copy.  The
// stores that signal other cards are made by one thread per card at
// once, after one system fence.
__global__ void __launch_bounds__(kThreads, kExchangeMinBlocks)
exchange_kernel(const __grid_constant__ Table table, int P, int n, int d0,
                int n_dst, int rot) {
  __shared__ unsigned long long s_epoch;
  __shared__ int s_flag;
  const int t = threadIdx.x;
  {
    const long long* x = cross_of(table, P, n);
    if (t == 0) {
      BarrierState* self = state_of(x, n, (int)x[1]);
      // the previous launch on this card's stream advanced the epoch
      const unsigned long long e = load_volatile(&self->epoch) + 1;
      s_epoch = e;
      // the arrival ticket: whichever block runs first signals (a block
      // that sees it taken skips the atomic)
      const bool first = load_volatile(&self->arrived) < e &&
                         atomicMax(&self->arrived, e) < e;
      // the writes of every op before this launch on the card's stream
      // reach the system before any card is signalled
      if (first) __threadfence_system();
      s_flag = first;
    }
    __syncthreads();
    if (s_flag && t < (int)x[0])
      store_release(&state_of(x, n, t)->flags[x[1]], s_epoch);
  }
  const long long total = table.v[(long long)P * n + 4 * P];
  if ((long long)blockIdx.x < total) {
    const Item it = item_of(table.v, P, n, d0, n_dst, rot, blockIdx.x,
                            true);
    __syncthreads();                        // s_flag is read above
    if (t == 0) {
      const long long* x = cross_of(table, P, n);
      const int rank = (int)x[1];
      const int from = (int)x[kCrossHead + it.s];
      BarrierState* self = state_of(x, n, rank);
      // this card's own senders are ordered by its stream already
      s_flag = from == rank
                   ? load_volatile(&self->failed) < s_epoch
                   : wait_slot(&self->flags[from], s_epoch, self,
                               reinterpret_cast<unsigned int*>(x[2]), from,
                               x[4]);
    }
    __syncthreads();
    if (s_flag) copy_item(it);
  }
  __syncthreads();
  const long long* x = cross_of(table, P, n);
  BarrierState* self = state_of(x, n, (int)x[1]);
  if (t == 0) {
    // this block's loads were consumed by its stores before the count;
    // its stores are for this card's later ops, which its stream orders
    const bool last = atomicAdd(&self->blocks, 1u) + 1 == gridDim.x;
    if (last) {
      self->blocks = 0;
      __threadfence_system();
    }
    s_flag = last;
  }
  __syncthreads();
  if (!s_flag) return;
  // the last block of the launch: every item of this card is read
  const unsigned long long e = s_epoch;
  const int C = (int)x[0];
  if (t < C) {
    if (n_dst > 0) store_release(&state_of(x, n, t)->done[x[1]], e);
    // thread c waits for card c if it reads this card's sources
    if ((((unsigned long long)x[3]) >> t) & 1)
      wait_slot(&self->done[t], e, self,
                reinterpret_cast<unsigned int*>(x[2]), t, x[4]);
  }
  __syncthreads();
  if (t == 0)
    *reinterpret_cast<volatile unsigned long long*>(&self->epoch) = e;
}

// makes `device` current for a call and the caller's card current again
// after it (the caller's thread keeps the card it had)
struct DeviceScope {
  int prev = -1;
  int rc;
  explicit DeviceScope(int device) {
    cudaGetDevice(&prev);
    rc = (int)cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// the latency floor of a flag across two cards: rank 0 stores i into the
// peer's word and waits for i in its own, rank 1 answers each; rank 0
// writes the round trips' nanoseconds to *ns (-1 at the time limit)
__global__ void flag_pingpong_kernel(unsigned long long* mine,
                                     unsigned long long* peer, int rank,
                                     int rounds, long long timeout_ns,
                                     long long* ns) {
  const unsigned long long t0 = global_ns();
  for (int i = 1; i <= rounds; ++i) {
    if (rank == 0) store_release(peer, (unsigned long long)i);
    while (load_acquire(mine) < (unsigned long long)i) {
      if ((long long)(global_ns() - t0) > timeout_ns) {
        if (rank == 0) *ns = -1;
        return;
      }
    }
    if (rank == 1) store_release(peer, (unsigned long long)i);
  }
  if (rank == 0) *ns = (long long)(global_ns() - t0);
}

}  // namespace

extern "C" int spark_barrier_max_cards() { return kMaxCards; }

extern "C" int spark_barrier_state_bytes() {
  return (int)sizeof(BarrierState);
}

// a zeroed barrier state on `device` (cudaMalloc: outside every graph
// pool, so a captured launch's pointers stay good); *ptr gets its address
extern "C" int spark_barrier_alloc(int device, void** ptr) {
  DeviceScope scope(device);
  if (scope.rc != 0) return scope.rc;
  int rc = (int)cudaMalloc(ptr, sizeof(BarrierState));
  if (rc != 0) return rc;
  rc = (int)cudaMemset(*ptr, 0, sizeof(BarrierState));
  if (rc == 0) rc = (int)cudaDeviceSynchronize();
  return rc;
}

// zero a state again (after a timed-out wait left the epochs apart); the
// caller has synchronized every card of the set
extern "C" int spark_barrier_reset(int device, void* ptr) {
  DeviceScope scope(device);
  if (scope.rc != 0) return scope.rc;
  int rc = (int)cudaMemset(ptr, 0, sizeof(BarrierState));
  if (rc == 0) rc = (int)cudaDeviceSynchronize();
  return rc;
}

// the state's bytes (spark_barrier_state_bytes of them) into `host`
extern "C" int spark_barrier_read(int device, const void* ptr, void* host) {
  DeviceScope scope(device);
  if (scope.rc != 0) return scope.rc;
  return (int)cudaMemcpy(host, ptr, sizeof(BarrierState),
                         cudaMemcpyDeviceToHost);
}

// `words` zeroed unsigned ints of mapped, portable pinned host memory: the
// error words, which every card writes and the host reads
extern "C" int spark_barrier_error_words(int words, void** ptr) {
  int rc = (int)cudaHostAlloc(ptr, sizeof(unsigned int) * words,
                              cudaHostAllocMapped | cudaHostAllocPortable);
  if (rc == 0) memset(*ptr, 0, sizeof(unsigned int) * words);
  return rc;
}

// One barrier_kernel on card `rank` of a set of `n` cards: `states` holds
// the n states' addresses (card p's at p), `error` this card's error word.
// Launches on `stream`, whose card must be current; returns the CUDA error
// of the launch.
extern "C" int spark_barrier(const long long* states, int n, int rank,
                             void* error, long long timeout_ns,
                             void* stream) {
  if (n < 1 || n > kMaxCards || rank < 0 || rank >= n || timeout_ns <= 0)
    return (int)cudaErrorInvalidValue;
  BarrierArgs a;
  memset(&a, 0, sizeof(a));
  for (int p = 0; p < n; ++p)
    a.state[p] = reinterpret_cast<BarrierState*>(states[p]);
  a.error = reinterpret_cast<unsigned int*>(error);
  a.timeout_ns = timeout_ns;
  a.rank = rank;
  a.n = n;
  barrier_kernel<<<1, kMaxCards, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

// One exchange on one card of a set: host_table is the `entries` int64
// entries of exchange_kernel's layout (the copy part, then the order
// across cards); d0 / n_dst: the card's receivers (n_dst 0: an
// arrive-and-wait launch); rot: the first sender; total: the copy part's
// work items.  Launches on `stream`, whose card must be current; returns
// the CUDA error of the launch.
extern "C" int spark_exchange_part(const long long* host_table, int entries,
                                   int P, int n, int d0, int n_dst, int rot,
                                   long long total, void* stream) {
  if (P <= 0 || n <= 0 || n_dst < 0 || total < 0 || entries > kMaxEntries ||
      entries < P * n + 4 * P + 1 + kCrossHead)
    return (int)cudaErrorInvalidValue;
  const long long* x = host_table + P * n + 4 * P + 1;
  const long long C = x[0];
  if (C < 1 || C > kMaxCards || x[1] < 0 || x[1] >= C || x[4] <= 0 ||
      entries != P * n + 4 * P + 1 + kCrossHead + n + C ||
      host_table[P * n + 4 * P] != total || total > 0x7fffffffLL ||
      (n_dst == 0 && total != 0) || d0 < 0 || d0 + n_dst > n || rot < 0 ||
      rot >= n)
    return (int)cudaErrorInvalidValue;
  Table table;
  memcpy(table.v, host_table, sizeof(long long) * entries);
  const unsigned blocks = total > 0 ? (unsigned)total : 1u;
  exchange_kernel<<<blocks, kThreads, 0,
                    reinterpret_cast<cudaStream_t>(stream)>>>(
      table, P, n, d0, n_dst, rot);
  return (int)cudaGetLastError();
}

// The flag ping-pong between two cards (`rounds` round trips): mine[r] /
// peer[r] are each rank's word and the other rank's word, on rank r's card
// `devices[r]`, launched on `streams[r]`; *ns (device memory on rank 0's
// card) gets the round trips' time.  Returns the CUDA error of the
// launches.
extern "C" int spark_flag_pingpong(const int* devices, void* const* mine,
                                   void* const* peer, void* const* streams,
                                   int rounds, long long timeout_ns,
                                   long long* ns) {
  if (rounds <= 0 || timeout_ns <= 0) return (int)cudaErrorInvalidValue;
  for (int r = 1; r >= 0; --r) {               // the answering rank first
    DeviceScope scope(devices[r]);
    if (scope.rc != 0) return scope.rc;
    flag_pingpong_kernel<<<1, 1, 0,
                           reinterpret_cast<cudaStream_t>(streams[r])>>>(
        reinterpret_cast<unsigned long long*>(mine[r]),
        reinterpret_cast<unsigned long long*>(peer[r]), r, rounds,
        timeout_ns, ns);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

// ---- the cross-process pull (pull_kernel) ---------------------------------
//
// Replaces, in the device tier, the n_dst = 1 use of all_to_all_kernel
// above, and through it the role of spark_tpu/parallel/ici.py:352
// `_pallas_a2a` in the JAX package's `device_exchange`: per plane k and
// sender s, `len[k]` bytes from the sender's arena slot (a CUDA IPC
// mapping of another process's allocation) to row s of the receiver's
// output, whose rows are `stride[k]` bytes apart.
//
// Bound: bytes.  Each byte is read once and written once: 2 * bytes over
// 3.35 TB/s; there is no arithmetic.  What the design does about it:
//  * persistent blocks: blocks_per_sm blocks on each SM (the SM count read
//    once per device) walk the flat list of work items with a stride of
//    gridDim.x, so there is no ragged second wave, and the segment of an
//    item comes from a binary search over its table of first items;
//  * the bytes move through the Tensor Memory Accelerator: one thread of
//    each block keeps a ring of `stages` shared-memory stages of
//    `stage_bytes` in flight (cp.async.bulk global -> shared on an
//    mbarrier, then shared -> global in a bulk group, the stage refilled
//    once its store has read it), so no register carries a byte and the
//    loads of several stages overlap the stores of others;
//  * alignment: a bulk copy takes 16-byte aligned addresses and sizes.  A
//    segment whose source and destination agree mod 16 has its head (up to
//    the destination's next 16-byte boundary) and its tail (<= 15 B each)
//    copied by plain threads and its body through the ring.  A segment
//    whose ends disagree mod 16 (a run table whose slot stride is
//    max_runs * 4 B) is copied by plain threads with 16-byte stores, its
//    source read as aligned words and shifted into place: no byte loop
//    over a whole item;
//  * a table sized to the launch: up to kSmallEntries entries (2 KiB) go
//    in a small __grid_constant__ struct, larger ones in the 32 KB one.
//
// The division of work is `cuda_a2a.pull_plan`, which the CPU tests hold
// to its rules; this kernel follows the same rule.
//
// Table layout (int64), P planes, n senders, segment g = k * n + s:
//   [0, P*n)          source address of segment g
//   [P*n, P*n+P)      destination base of plane k
//   next P            bytes per sender of plane k (len)
//   next P            destination row stride of plane k, bytes
//   next P*n + 1      first work item of segment g (exclusive prefix of
//                     its item counts); entry P*n is the total
// A segment of len 0 has no item.  Otherwise, with src and dst its ends:
// if (src ^ dst) & 15 == 0, head = min(len, -dst & 15), body = (len - head)
// & ~15, tail = the rest, and it has max(1, ceil(body / stage_bytes))
// items: item j moves body bytes [j, j + 1) * stage_bytes through the
// ring, and item 0 also copies the head and the tail; otherwise it has
// ceil(len / stage_bytes) items, item j copying bytes [j, j + 1) *
// stage_bytes by plain threads.

namespace {

constexpr int kPullThreads = 256;          // warp 0: the ring; 1..7: plain
constexpr int kPlainThreads = kPullThreads - 32;
constexpr int kSmallEntries = 256;
constexpr int kMaxStages = 16;

template <int kMax>
struct PullTable {
  long long v[kMax];
};

struct Segment {
  const char* src;
  char* dst;
  long long len, head, body, j;       // j: the item's index in its segment
  bool matched;
};

__device__ __forceinline__ Segment segment_of(const long long* v, int P,
                                              int n, long long item) {
  const int segs = P * n;
  const long long* dst_base = v + segs;
  const long long* len = dst_base + P;
  const long long* stride = len + P;
  const long long* first = stride + P;
  int lo = 0, hi = segs;               // first[lo] <= item < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= item) lo = mid; else hi = mid;
  }
  const int k = lo / n, s = lo - k * n;
  Segment g;
  g.src = reinterpret_cast<const char*>(v[lo]);
  g.dst = reinterpret_cast<char*>(dst_base[k]) + s * stride[k];
  g.len = len[k];
  g.j = item - first[lo];
  g.matched = ((reinterpret_cast<uintptr_t>(g.src) ^
                reinterpret_cast<uintptr_t>(g.dst)) & 15) == 0;
  g.head = (16 - (reinterpret_cast<uintptr_t>(g.dst) & 15)) & 15;
  if (g.head > g.len) g.head = g.len;
  g.body = (g.len - g.head) & ~15LL;
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// waits for the phase of `bar` with this parity to complete; a copy that
// never lands (which would hang the card) traps after ~10 s instead
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(gmem), "r"(smem_addr(smem)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the next body chunk at or after item `it` of this block's items (it
// advances by `step`); false when the block has no more
__device__ __forceinline__ bool next_chunk(const long long* v, int P, int n,
                                           long long total, long long step,
                                           long long stage_bytes,
                                           long long& it, const char*& src,
                                           char*& dst, uint32_t& bytes) {
  for (; it < total; it += step) {
    const Segment g = segment_of(v, P, n, it);
    if (!g.matched || g.body == 0) continue;
    const long long off = g.head + g.j * stage_bytes;
    const long long rest = g.body - g.j * stage_bytes;
    src = g.src + off;
    dst = g.dst + off;
    bytes = static_cast<uint32_t>(rest < stage_bytes ? rest : stage_bytes);
    it += step;
    return true;
  }
  return false;
}

// d4[i] = load(i) for i < nvec by `nt` threads (t = 0..nt-1), four loads
// in flight per thread before their stores: a copy has no arithmetic to
// hide memory latency behind
template <typename Load>
__device__ __forceinline__ void store_vecs(uint4* d4, long long nvec, int t,
                                           int nt, Load load) {
  long long i = t;
  for (; i + 3LL * nt < nvec; i += 4LL * nt) {
    const uint4 v0 = load(i), v1 = load(i + nt), v2 = load(i + 2LL * nt),
                v3 = load(i + 3LL * nt);
    d4[i] = v0;
    d4[i + nt] = v1;
    d4[i + 2LL * nt] = v2;
    d4[i + 3LL * nt] = v3;
  }
  for (; i < nvec; i += nt) d4[i] = load(i);
}

// bytes [0, len) from src to dst by `nt` threads (t = 0..nt-1), whatever
// their alignment: bytes up to dst's next 16-byte boundary, then 16-byte
// stores whose source is read as aligned 8- or 4-byte words (shifted
// into place when src is not 4-byte aligned), then the last < 16 bytes
__device__ void plain_copy(const char* src, char* dst, long long len, int t,
                           int nt) {
  long long head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > len) head = len;
  for (long long i = t; i < head; i += nt) dst[i] = src[i];
  src += head;
  dst += head;
  len -= head;
  const long long nvec = len >> 4;
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  if ((sa & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    store_vecs(d4, nvec, t, nt, [=](long long i) { return s4[i]; });
  } else if ((sa & 7) == 0) {
    const uint2* s2 = reinterpret_cast<const uint2*>(src);
    store_vecs(d4, nvec, t, nt, [=](long long i) {
      const uint2 a = s2[2 * i], b = s2[2 * i + 1];
      return make_uint4(a.x, a.y, b.x, b.y);
    });
  } else if ((sa & 3) == 0) {
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
    store_vecs(d4, nvec, t, nt, [=](long long i) {
      const uint32_t* w = s1 + 4 * i;
      return make_uint4(w[0], w[1], w[2], w[3]);
    });
  } else {
    // every aligned word read holds at least one byte of the source
    const uint32_t shift = 8 * static_cast<uint32_t>(sa & 3);
    const uint32_t* s1 = reinterpret_cast<const uint32_t*>(sa & ~uintptr_t(3));
    store_vecs(d4, nvec, t, nt, [=](long long i) {
      const uint32_t* w = s1 + 4 * i;
      const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
      return make_uint4(__funnelshift_r(w0, w1, shift),
                        __funnelshift_r(w1, w2, shift),
                        __funnelshift_r(w2, w3, shift),
                        __funnelshift_r(w3, w4, shift));
    });
  }
  for (long long i = (nvec << 4) + t; i < len; i += nt) dst[i] = src[i];
}

template <int kMax>
__global__ void __launch_bounds__(kPullThreads)
pull_kernel(const __grid_constant__ PullTable<kMax> table, int P, int n,
            long long total, int stages, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long* v = table.v;
  const long long step = gridDim.x;
  if (threadIdx.x >= 32) {
    // plain threads: the heads and tails of aligned segments, and whole
    // items of segments whose ends disagree mod 16
    const int t = threadIdx.x - 32;
    for (long long it = blockIdx.x; it < total; it += step) {
      const Segment g = segment_of(v, P, n, it);
      if (g.matched) {
        if (g.j != 0) continue;
        const long long tail = g.head + g.body;
        for (long long i = t; i < g.head; i += kPlainThreads)
          g.dst[i] = g.src[i];
        for (long long i = tail + t; i < g.len; i += kPlainThreads)
          g.dst[i] = g.src[i];
      } else {
        const long long off = g.j * stage_bytes;
        const long long rest = g.len - off;
        plain_copy(g.src + off, g.dst + off,
                   rest < stage_bytes ? rest : stage_bytes, t,
                   kPlainThreads);
      }
    }
    return;
  }
  if (threadIdx.x != 0) return;
  // one thread keeps the ring: stage i's bytes, its mbarrier, and the
  // destination and size of the chunk it holds
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(stages) * stage_bytes);
  char** st_dst = reinterpret_cast<char**>(bar + stages);
  uint32_t* st_len = reinterpret_cast<uint32_t*>(st_dst + stages);
  for (int i = 0; i < stages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar + i)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long sb = stage_bytes;
  long long it = blockIdx.x;
  long long loaded = 0;
  const char* src;
  char* dst;
  uint32_t bytes;
  while (loaded < stages && next_chunk(v, P, n, total, step, sb, it, src,
                                       dst, bytes)) {
    const int i = static_cast<int>(loaded);
    bulk_load(smem + i * sb, src, bytes, bar + i);
    st_dst[i] = dst;
    st_len[i] = bytes;
    ++loaded;
  }
  for (long long c = 0; c < loaded; ++c) {
    const int i = static_cast<int>(c % stages);
    wait_parity(bar + i, static_cast<uint32_t>((c / stages) & 1));
    bulk_store(st_dst[i], smem + i * sb, st_len[i]);
    // refill the stage of chunk c - 1 once its store has read it; the
    // store of chunk c stays in flight
    if (c >= 1 && loaded == c - 1 + stages &&
        next_chunk(v, P, n, total, step, sb, it, src, dst, bytes)) {
      const int r = static_cast<int>((c - 1) % stages);
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      bulk_load(smem + r * sb, src, bytes, bar + r);
      st_dst[r] = dst;
      st_len[r] = bytes;
      ++loaded;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

size_t pull_smem_bytes(int stages, int stage_bytes) {
  return static_cast<size_t>(stages) * stage_bytes
         + stages * (sizeof(uint64_t) + sizeof(char*) + sizeof(uint32_t));
}

int g_sm_count[64];                 // per device, read once

template <int kMax>
int launch_pull(const long long* host_table, int entries, int P, int n,
                long long total, int stages, int stage_bytes, int grid,
                cudaStream_t stream) {
  static size_t smem_set = 0;       // the attribute set for this kernel
  const size_t smem = pull_smem_bytes(stages, stage_bytes);
  if (smem > smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        pull_kernel<kMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = smem;
  }
  PullTable<kMax> table;
  memcpy(table.v, host_table, sizeof(long long) * entries);
  pull_kernel<kMax><<<grid, kPullThreads, smem, stream>>>(
      table, P, n, total, stages, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cross-process pull.  host_table: the `entries` int64 entries above
// in host memory; total: its last entry (the number of work items);
// stages / stage_bytes: the ring (stage_bytes a multiple of 16);
// blocks_per_sm: the persistent blocks each SM runs; device: the card the
// outputs are on.  Returns the CUDA error of the launch (0 on success).
extern "C" int spark_a2a_pull(const long long* host_table, int entries,
                              int P, int n_src, long long total, int stages,
                              int stage_bytes, int blocks_per_sm, int device,
                              void* stream) {
  if (P <= 0 || n_src <= 0 || total <= 0) return 0;
  if (entries != 2 * P * n_src + 3 * P + 1 || entries > kMaxEntries ||
      total > 0x7fffffffLL || stages < 2 || stages > kMaxStages ||
      stage_bytes < 16 || stage_bytes % 16 != 0 || blocks_per_sm < 1 ||
      device < 0 || device >= 64 ||
      pull_smem_bytes(stages, stage_bytes) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) {
    const cudaError_t rc = cudaSetDevice(device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  if (g_sm_count[device] == 0) {
    int sms = 0;
    const cudaError_t rc = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    g_sm_count[device] = sms;
  }
  const long long most = static_cast<long long>(blocks_per_sm)
                         * g_sm_count[device];
  const int grid = static_cast<int>(total < most ? total : most);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rc = entries <= kSmallEntries
      ? launch_pull<kSmallEntries>(host_table, entries, P, n_src, total,
                                   stages, stage_bytes, grid, st)
      : launch_pull<kMaxEntries>(host_table, entries, P, n_src, total,
                                 stages, stage_bytes, grid, st);
  if (current >= 0 && current != device) cudaSetDevice(current);
  return rc;
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
