// K8: the collectives of a process grid as kernels over peer pointers, so
// that a CUDA graph's conditional (WHILE) body can hold them: the face
// exchange in two halves (post, finish), the all-reduce of a small vector
// and the all-gather to a replicated level.
//
// Replaces: no Pallas kernel.  The JAX package runs these as XLA
// collectives inside its jitted inner restart (lax.ppermute of the faces,
// ddalphaamg_tpu/parallel/halo.py:60-114; lax.psum of the inner products,
// ddalphaamg_tpu/solvers/device_gmres.py:111-136; the replicated coarsest
// level through a sharding constraint, ddalphaamg_tpu/mg/hierarchy.py:
// 223-232), inside its lax.while_loop (hierarchy.py:806-850).  torch's NCCL
// work can be captured into a graph, but not into a conditional body: the
// instantiation of such a graph fails (cudaErrorInvalidValue; measured by
// scripts/probe_torch_nccl_graph.py on H100s with NCCL 2.28.9), so the
// port's device programs, whose loops are WHILE nodes (csrc/graph.cu),
// cannot hold NCCL's work.
//
// Design: every rank allocates one arena of device memory at the grid's
// setup (ddaamg_peer_alloc) and opens every other rank's through CUDA IPC
// (ddaamg_peer_open; parallel/peer.py shares the handles once, through the
// process group).  A sender writes its data straight into the receiver's
// arena (NVLink stores), then a flag word there; the receiver spins on its
// own flag word and then reads its own memory.  Every call runs ROW thread
// blocks, whatever its size (a block whose chunk is empty still counts and
// signals), and block b of a call moves chunk b; so no block waits for
// another block of its own grid, both ends split a message into the same
// chunks, and each block's call counter (in the rank's own memory, touched
// by that block only) is the call's count on every rank.  A flag carries
// the call's count, which only grows: no reset, no race with a late
// reader.  Buffers are doubled by the parity of the count, and a sender
// never writes call k + 2 before the receiver has read call k out of the
// same buffer: for the all-reduce and the gather that follows from their
// shape (no rank ends call k + 1 before every rank began it, after that
// rank's call k ended, in stream order); the exchange, whose sends may go
// one way only (a shift along a ring), has back-pressure: the finish of
// call k writes k into an acknowledgement word of the sender's arena, one
// a block, and each block of the sender's post of call k + 2 waits until
// all ROW words of its mailbox say k.  Ordering: the data stores, then
// __threadfence_system() and a barrier, then a release store of the flag
// at system scope; the reader acquires the flag at system scope before
// the barrier after which its block reads; the acknowledgement is released
// after the barrier that follows the reads and acquired before the
// barrier that precedes the writes.
//
// All-reduce: block b writes chunk b of its vector into slot `rank` of
// every rank's arena (its own too), raises the flags, waits for every
// rank's flag of chunk b, and sums the slots in rank order 0, 1, ..., so
// every rank gets the same bits (the host loops' bits too: they run the
// same kernel).  All-gather: the same with a copy of the slots in rank
// order.  The exchange's post kernel writes every face of one operator
// apply (all split axes) into the receiving ranks' mailboxes; the finish
// kernel waits, copies them out and acknowledges them, so the interior
// kernel runs between the two.  A waiting block spins with __nanosleep; no
// block depends on another block of its own rank, so a grid larger than
// the card's resident blocks cannot deadlock.  Every function returns the CUDA error
// code (0: success).
//
// Bound: a message crosses NVLink once (each rank's bytes written once to
// each receiver) and is read once more locally; small all-reduces are
// bound by the flag round trip, a few microseconds (PERF.md, K8).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int MAXS = 8;    // sends (receives) of one exchange call: 4 axes x 2 ways
constexpr int MAXP = 16;   // ranks of a grid
constexpr int THREADS = 256;
constexpr int ROW = 64;    // thread blocks of every call: flag words (and counters) a mailbox or rank

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// this block's next call count (counter[b] is this block's alone)
__device__ __forceinline__ unsigned long long next_count(unsigned long long* counter) {
  __shared__ unsigned long long seq;
  if (threadIdx.x == 0) {
    seq = counter[blockIdx.x] + 1;
    counter[blockIdx.x] = seq;
  }
  __syncthreads();
  return seq;
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a rank that never sends (a collective it skipped) would leave the others
// spinning for ever: after WAIT_LIMIT_NS the kernel traps, and the launch's
// error reaches the host at its next synchronization
constexpr unsigned long long WAIT_LIMIT_NS = 120ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void spin_until(const unsigned long long* flag, unsigned long long seq) {
  const unsigned long long t0 = globaltimer_ns();
  while (ld_acquire(flag) < seq) {
    __nanosleep(64);
    if (globaltimer_ns() - t0 > WAIT_LIMIT_NS) __trap();
  }
}

__device__ __forceinline__ void wait_flag(const unsigned long long* flag, unsigned long long seq) {
  if (threadIdx.x == 0) spin_until(flag, seq);
}

// chunk [c0, c1) of n 8-byte words for block b of nb
__device__ __forceinline__ void chunk(long long n, int b, int nb, long long& c0, long long& c1) {
  const long long per = (n + nb - 1) / nb;
  c0 = min(n, per * b);
  c1 = min(n, c0 + per);
}

__device__ __forceinline__ void copy_words(uint2* dst, const uint2* src, long long c0, long long c1) {
  for (long long i = c0 + threadIdx.x; i < c1; i += blockDim.x) dst[i] = src[i];
}

struct Sends {
  const uint2* src[MAXS];        // this rank's face (8-byte words)
  uint2* box[MAXS];              // the receiver's mailbox, parity-0 buffer
  unsigned long long* flag[MAXS];   // the receiver's flag words of the mailbox [ROW]
  const unsigned long long* ack[MAXS];  // this rank's acknowledgement words of that mailbox [ROW]
  unsigned long long* count[MAXS];  // this rank's counters of that mailbox [ROW]
  long long words[MAXS];
};

struct Recvs {
  const uint2* box[MAXS];        // this rank's mailbox, parity-0 buffer
  uint2* out[MAXS];
  unsigned long long* flag[MAXS];   // this rank's flag words of the mailbox [ROW]
  unsigned long long* ack[MAXS];    // the sender's acknowledgement words of the mailbox [ROW]
  unsigned long long* count[MAXS];
  long long words[MAXS];
};

// block (b, i): once the receiver has read call seq - 2 out of the buffer
// (all ROW acknowledgements), chunk b of send i into its mailbox, then the
// flag
__global__ void __launch_bounds__(THREADS) post_kernel(Sends s, long long stride) {  // stride: words
  const int i = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  __shared__ unsigned long long seq;
  if (threadIdx.x == 0) {
    seq = s.count[i][b] + 1;
    s.count[i][b] = seq;
  }
  __syncthreads();
  if (seq > 2 && threadIdx.x < ROW) spin_until(s.ack[i] + threadIdx.x, seq - 2);
  __syncthreads();
  long long c0, c1;
  chunk(s.words[i], b, nb, c0, c1);
  copy_words(s.box[i] + (seq & 1) * stride, s.src[i], c0, c1);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) st_release(s.flag[i] + b, seq);
}

// block (b, i): wait for chunk b of receive i, copy it out, acknowledge it
__global__ void __launch_bounds__(THREADS) finish_kernel(Recvs r, long long stride) {  // stride: words
  const int i = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  __shared__ unsigned long long seq;
  if (threadIdx.x == 0) {
    seq = r.count[i][b] + 1;
    r.count[i][b] = seq;
  }
  __syncthreads();
  wait_flag(r.flag[i] + b, seq);
  __syncthreads();
  long long c0, c1;
  chunk(r.words[i], b, nb, c0, c1);
  copy_words(r.out[i], r.box[i] + (seq & 1) * stride, c0, c1);
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) st_release(r.ack[i] + b, seq);
}

struct Ranks {
  unsigned char* slot[MAXP];      // rank p's arena: this rank's slot, parity-0 buffer
  unsigned long long* flag[MAXP]; // rank p's flag words for this rank [ROW]
  const unsigned char* mine;      // this rank's arena: slot of rank 0, parity 0
  const unsigned long long* myflag;  // this rank's flag words [ranks][ROW]
  unsigned long long* count;      // this rank's counters [ROW]
  int ranks;
};

// elements [c0, c1) of src into slot `rank` of every rank, raise the flags
// of block b, wait for every rank's; returns the parity of the call
template <typename T>
__device__ __forceinline__ int scatter_wait(const Ranks& k, const T* src, long long n, long long stride,
                                            long long& c0, long long& c1) {
  const unsigned long long seq = next_count(k.count);
  chunk(n, blockIdx.x, gridDim.x, c0, c1);
  for (int p = 0; p < k.ranks; ++p) {
    T* dst = (T*)(k.slot[p] + (seq & 1) * stride);
    for (long long i = c0 + threadIdx.x; i < c1; i += blockDim.x) dst[i] = src[i];
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int p = 0; p < k.ranks; ++p) st_release(k.flag[p] + blockIdx.x, seq);
  for (int p = 0; p < k.ranks; ++p) wait_flag(k.myflag + (long long)p * ROW + blockIdx.x, seq);
  __syncthreads();
  return (int)(seq & 1);
}

// rank p's buffer of the given parity in this rank's arena
template <typename T>
__device__ __forceinline__ const T* slot_of(const Ranks& k, int p, int parity, long long stride) {
  return (const T*)(k.mine + ((long long)p * 2 + parity) * stride);
}

// out = sum over ranks, in rank order, of every rank's n reals (T)
template <typename T>
__global__ void __launch_bounds__(THREADS) allreduce_kernel(Ranks k, const T* src, T* out, long long n,
                                                            long long stride) {
  long long c0, c1;
  const int par = scatter_wait(k, src, n, stride, c0, c1);
  for (long long i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
    T acc = slot_of<T>(k, 0, par, stride)[i];
    for (int p = 1; p < k.ranks; ++p) acc += slot_of<T>(k, p, par, stride)[i];
    out[i] = acc;
  }
}

// rank p's n 8-byte words at out + p * out_words, in rank order
__global__ void __launch_bounds__(THREADS) allgather_kernel(Ranks k, const uint2* src, uint2* out, long long n,
                                                            long long out_words, long long stride) {
  long long c0, c1;
  const int par = scatter_wait(k, src, n, stride, c0, c1);
  for (int p = 0; p < k.ranks; ++p)
    copy_words(out + (long long)p * out_words, slot_of<uint2>(k, p, par, stride), c0, c1);
}

// slot[p]: rank p's slot for this rank (parity 0), flag[p]: rank p's flag
// words for this rank; mine: this rank's slot 0 (parity 0), myflag: its
// flag words [ranks][ROW]
int fill_ranks(Ranks& k, void* const* slot, void* const* flag, const void* mine, const void* myflag,
               void* count, int ranks) {
  if (ranks < 1 || ranks > MAXP) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < ranks; ++p) {
    k.slot[p] = (unsigned char*)slot[p];
    k.flag[p] = (unsigned long long*)flag[p];
  }
  k.mine = (const unsigned char*)mine;
  k.myflag = (const unsigned long long*)myflag;
  k.count = (unsigned long long*)count;
  k.ranks = ranks;
  return 0;
}

#define TRY(call)                              \
  do {                                         \
    cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

extern "C" {

// size of an IPC handle in bytes
int ddaamg_peer_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// thread blocks of every call, flag words a mailbox or rank has
int ddaamg_peer_row() { return ROW; }

// a zeroed arena of `bytes` on the current device and its IPC handle
int ddaamg_peer_alloc(long long bytes, void** ptr, void* handle) {
  TRY(cudaMalloc(ptr, (size_t)bytes));
  TRY(cudaMemset(*ptr, 0, (size_t)bytes));
  cudaIpcMemHandle_t h;
  TRY(cudaIpcGetMemHandle(&h, *ptr));
  memcpy(handle, &h, sizeof(h));
  return 0;
}

// another rank's arena in this process (NVLink peer access on first use)
int ddaamg_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ddaamg_peer_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int ddaamg_peer_free(void* ptr) { return (int)cudaFree(ptr); }

// the exchange's first half: n sends, each words 8-byte words of src into
// the receiver's mailbox box (parity-0 buffer; the parity-1 buffer is
// stride_bytes further), then flag[b] of each chunk b (b < ROW) once the
// acknowledgement words ack [ROW] of that mailbox (this rank's) allow it;
// count: this rank's counters of each receiving mailbox [ROW]
int ddaamg_peer_post(const void* const* src, void* const* box, void* const* flag, const void* const* ack,
                     void* const* count, const long long* words, int n, long long stride_bytes, void* stream) {
  if (n < 1 || n > MAXS || stride_bytes % 8) return (int)cudaErrorInvalidValue;
  Sends s = {};
  for (int i = 0; i < n; ++i) {
    s.src[i] = (const uint2*)src[i];
    s.box[i] = (uint2*)box[i];
    s.flag[i] = (unsigned long long*)flag[i];
    s.ack[i] = (const unsigned long long*)ack[i];
    s.count[i] = (unsigned long long*)count[i];
    s.words[i] = words[i];
  }
  post_kernel<<<dim3(ROW, n), THREADS, 0, (cudaStream_t)stream>>>(s, stride_bytes / 8);
  return (int)cudaGetLastError();
}

// its second half: wait for each of n mailboxes (flag, count as above, this
// rank's), copy words 8-byte words out and acknowledge them in the
// sender's words ack [ROW]
int ddaamg_peer_finish(const void* const* box, void* const* out, void* const* flag, void* const* ack,
                       void* const* count, const long long* words, int n, long long stride_bytes, void* stream) {
  if (n < 1 || n > MAXS || stride_bytes % 8) return (int)cudaErrorInvalidValue;
  Recvs r = {};
  for (int i = 0; i < n; ++i) {
    r.box[i] = (const uint2*)box[i];
    r.out[i] = (uint2*)out[i];
    r.flag[i] = (unsigned long long*)flag[i];
    r.ack[i] = (unsigned long long*)ack[i];
    r.count[i] = (unsigned long long*)count[i];
    r.words[i] = words[i];
  }
  finish_kernel<<<dim3(ROW, n), THREADS, 0, (cudaStream_t)stream>>>(r, stride_bytes / 8);
  return (int)cudaGetLastError();
}

// the arguments of the all-reduce and the all-gather: slot[p], rank p's
// slot for this rank (parity 0; the parity-1 buffer stride_bytes further),
// flag[p], rank p's flag words for this rank; mine, this rank's slot of
// rank 0 (parity 0), myflag, its flag words [ranks][ROW]; count, this
// rank's counters [ROW]

// out [n] = the sum over the ranks of src [n] (reals: float if f64 == 0,
// double else), in rank order
int ddaamg_peer_allreduce(void* const* slot, void* const* flag, const void* mine, const void* myflag,
                          void* count, int ranks, const void* src, void* out, long long n, int f64,
                          long long stride_bytes, void* stream) {
  Ranks k;
  int rc = fill_ranks(k, slot, flag, mine, myflag, count, ranks);
  if (rc) return rc;
  auto st = (cudaStream_t)stream;
  if (f64)
    allreduce_kernel<double><<<ROW, THREADS, 0, st>>>(k, (const double*)src, (double*)out, n, stride_bytes);
  else
    allreduce_kernel<float><<<ROW, THREADS, 0, st>>>(k, (const float*)src, (float*)out, n, stride_bytes);
  return (int)cudaGetLastError();
}

// every rank's src [words] (8-byte words) in rank order, rank p's at out +
// p * out_words words (out_words >= words: a round of a longer gather
// writes a column block of [ranks, out_words])
int ddaamg_peer_allgather(void* const* slot, void* const* flag, const void* mine, const void* myflag,
                          void* count, int ranks, const void* src, void* out, long long words,
                          long long out_words, long long stride_bytes, void* stream) {
  Ranks k;
  int rc = fill_ranks(k, slot, flag, mine, myflag, count, ranks);
  if (rc) return rc;
  if (stride_bytes % 8 || out_words < words) return (int)cudaErrorInvalidValue;
  allgather_kernel<<<ROW, THREADS, 0, (cudaStream_t)stream>>>(k, (const uint2*)src, (uint2*)out, words,
                                                               out_words, stride_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
