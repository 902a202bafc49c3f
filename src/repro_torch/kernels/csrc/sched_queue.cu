// Hand-written Hopper (sm_90a) kernels for the scheduler's hot queue ops.
//
// They replace the Pallas kernels of the JAX package's
// src/repro/kernels/sched_queue.py (ctr_add, push, pop_first) and are the
// `cuda` StepOps of repro_torch.core.backends.  Plain C entry points, built
// with nvcc into a shared library and loaded with ctypes
// (repro_torch/kernels/sched_queue.py).  Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
//
// All three are integer bookkeeping on a few KiB to 512 KiB of state
// (W = 64 workers, Q = 16 slots: buf + ts are 2 x 256 KiB).  Each touches
// O(W) or O(W^2) int32 words per launch, so every one of them is bound by
// launch latency and the host path, far below the card's memory or
// integer rate: the design goal is one small launch with no host
// synchronisation, few dependent trips to memory inside it, and a host
// side that converts one packed record (a bytes object read with memcpy)
// instead of a dozen ctypes arguments.
//
// Integer `%` in C++ truncates toward zero; the JAX package's `%` floors.
// The scan positions take (p - me - 1) mod n of negative values, so every
// modulo below goes through floor_mod.

#include <cuda_runtime.h>
#include <cstring>

namespace {

__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return (r != 0 && ((r < 0) != (n < 0))) ? r + n : r;
}

// The (column, value) pairs of one counter bump, by value in the launch:
// value i is (W,) int32, or bool read as one byte a row; code[i] is
// col * 2 + is_bool.
constexpr int CTR_PAIRS_MAX = 16;  // phases.CTR_PAIRS_MAX
struct CtrPairs {
  const void* val[CTR_PAIRS_MAX];
  int code[CTR_PAIRS_MAX];
  int n;
};

// ctr[w, col_i] += val_i[w] for every worker row w and every pair i in
// order, in place, wrapping as int32 (a column may repeat).  Replaces
// _ctr_add_kernel / ctr_add (src/repro/kernels/sched_queue.py:47, :52),
// one launch for a whole run of the step's bumps where the TPU kernel
// takes one column a call.  Moves W * 4 * (2 * n + 1) bytes at most (each
// column read and written, each value read): bound by launch latency, so
// the design goal is one launch for many bumps and a cheap host path.
// One thread per row; rows are disjoint, no atomics.
__global__ void ctr_add_kernel(int* __restrict__ ctr, int W, int nc,
                               const CtrPairs p) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  int* row = ctr + w * nc;
  for (int i = 0; i < p.n; ++i) {
    int col = p.code[i] >> 1;
    int v = (p.code[i] & 1) ? static_cast<const unsigned char*>(p.val[i])[w]
                            : static_cast<const int*>(p.val[i])[w];
    row[col] = static_cast<int>(static_cast<unsigned>(row[col])
                                + static_cast<unsigned>(v));
  }
}

// The record a push call passes by value (sched_queue._PUSH packs it on
// the host: ten pointers, then W and Q).
struct PushArgs {
  int* buf;
  int* ts;
  const int* head;
  int* tail;
  const int* producer;
  const int* consumer;
  const int* task;
  const int* tsv;
  const unsigned char* mask;
  unsigned char* ok;
  int W;
  int Q;
};

// Lane i's ids as the reference reads them (src/repro/core/xqueue.py:66-90):
// its scatter wraps a producer in [-W, 0) to p + W and drops any other, and
// its gathers wrap a negative index once, then clamp to [0, W - 1].
__device__ __forceinline__ int wrapped(int x, int W) {
  return x < 0 ? x + W : x;
}
__device__ __forceinline__ int clamped(int x, int W) {
  return min(max(wrapped(x, W), 0), W - 1);
}

// Producer column j's push: the lane that owns it (the highest active lane
// whose producer wraps to j) appends task tk with timestamp sv to queue
// (c, j) if the queue the reference reads, (clamped(c), j), has room, and
// writes only when c lies in [0, W).  Returns that room: ok_p[j] of the
// reference.  Each column is one thread's, so no two threads touch one
// queue.
__device__ __forceinline__ bool push_column(const PushArgs& a, int j, int c,
                                            int tk, int sv) {
  const long long q = static_cast<long long>(clamped(c, a.W)) * a.W + j;
  const int t = a.tail[q];
  if (t - a.head[q] >= a.Q) return false;
  if (c >= 0 && c < a.W) {
    const long long s = q * a.Q + floor_mod(t, a.Q);
    a.buf[s] = tk;
    a.ts[s] = sv;
    a.tail[q] = t + 1;
  }
  return true;
}

// SPSC push, in place.  Lane i (producer p = producer[i]) appends task[i]
// with timestamp tsv[i] to queue (c = consumer[i], p) when mask[i] and the
// queue has room, and reports ok[i].  Replaces _push_kernel / push
// (src/repro/kernels/sched_queue.py:63, :83).  The result equals the JAX
// package's producer inversion followed by ok = mask & ok_p[producer]
// (src/repro/core/xqueue.py:66-90) for every lane, ids outside [0, W)
// included: active lanes claim their producer column in shared memory
// (atomicMax: the highest lane wins, as the reference's scatter), each
// thread then pushes for its column and publishes ok_p, and each lane
// reads ok_p of its clamped producer.  In the simulator lane == worker, so
// every column has at most one claimant.
//
// Bound: launch latency and the host path, not bytes (a few hundred bytes
// a call against 3.35 TB/s).  One block of W threads (W <= PUSH_W_MAX,
// which the wrapper enforces; the simulator's widths go to 200): every
// lane's loads issued at once, then the one dependent load of the queue's
// head and tail, then the writes: two trips to memory a launch.
constexpr int PUSH_W_MAX = 1024;

__global__ void push_kernel(const PushArgs a) {
  __shared__ int owner[PUSH_W_MAX];
  __shared__ int s_c[PUSH_W_MAX], s_tk[PUSH_W_MAX], s_sv[PUSH_W_MAX];
  __shared__ unsigned char ok_p[PUSH_W_MAX];
  const int W = a.W, i = threadIdx.x;
  int p = 0;
  bool m = false;
  if (i < W) {
    p = a.producer[i];
    m = a.mask[i];
    s_c[i] = a.consumer[i];
    s_tk[i] = a.task[i];
    s_sv[i] = a.tsv[i];
    owner[i] = -1;
  }
  __syncthreads();
  const int wp = wrapped(p, W);
  if (i < W && m && wp >= 0 && wp < W) atomicMax(&owner[wp], i);
  __syncthreads();
  if (i < W) {
    const int l = owner[i];
    ok_p[i] = l >= 0 && push_column(a, i, s_c[l], s_tk[l], s_sv[l]);
  }
  __syncthreads();
  if (i < W) a.ok[i] = m && ok_p[clamped(p, W)];
}

// The record a pop call passes by value (sched_queue._POP packs it on the
// host: twelve pointers, then W, Q and n_active, then 4 bytes of padding).
// n_active_ptr is a 0-dim int32 on the device, or null: then n_active is
// the value.
struct PopArgs {
  const int* buf;
  const int* ts;
  int* head;
  const int* tail;
  const int* rot;
  const unsigned char* mask;
  const int* n_active_ptr;
  int* task_out;
  int* ts_out;
  int* src_out;
  unsigned char* found_out;
  int* checked_out;
  int W;
  int Q;
  int n_active;
};

// The scan key packs (scan position, producer) as pos << 16 | p, so a W
// above POP_W_MAX does not fit (the position runs to W + 1).
constexpr int POP_W_MAX = 0xFFFF - 1;

// Rotated pop scan.  One warp per consumer row `me`, its lanes strided
// over producers p.  Each lane computes the analytic scan position of its
// producers (src/repro/core/xqueue.py:112-121: master queue first, then
// the other live producers rotated by rot[me]), masks empty queues to
// W + 1, and keeps the least key pos << 16 | p with the head it read; one
// __reduce_min_sync gives the first non-empty queue in scan order (the
// lowest p wins ties, as argmin does), and a shuffle brings its head from
// the lane that read it.  Lane 0 then gathers the head slot and advances
// head[me, src] in place.  Replaces _pop_kernel / pop_first
// (src/repro/kernels/sched_queue.py:122, :136), whose body is
// xqueue.pop_compute (src/repro/core/xqueue.py:124).  Consumers that find
// nothing still gather buf/ts[me, me, head % Q] and report src = me,
// checked = n_active: the dequeue phase passes those on.  A position past
// W + 1 (n_active > W, out of contract) keys as W + 1: pop_compute finds
// nothing there either.
//
// Bound: launch latency and the host path, not bytes (about 1 KB of
// heads and tails a call).  The design keeps the dependent trips to
// memory to three (the row's heads and tails with rot, mask and n_active;
// the gathered slot; the writes) and the warp's reduction to one
// instruction.
__global__ void pop_kernel(const PopArgs a) {
  const int W = a.W, Q = a.Q;
  int me = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (me >= W) return;  // uniform across the warp
  int n_active = a.n_active_ptr ? *a.n_active_ptr : a.n_active;
  int r = a.rot[me];
  unsigned char m = a.mask[me];
  int n_act = max(n_active, 1);
  int nm1 = max(n_active - 1, 1);
  const int* hrow = a.head + static_cast<long long>(me) * W;
  const int* trow = a.tail + static_cast<long long>(me) * W;
  unsigned best = 0xFFFFFFFFu;
  int h_best = 0, h_me = 0;
  for (int p = lane; p < W; p += 32) {
    int h = hrow[p];
    int t = trow[p];
    if (p == me) h_me = h;
    int pos = (p == me) ? 0
                        : 1 + floor_mod(floor_mod(p - me - 1, n_act) - r, nm1);
    bool cand = (t - h > 0) && (p < n_act);
    unsigned key = (static_cast<unsigned>(cand ? min(pos, W + 1) : W + 1)
                    << 16) | static_cast<unsigned>(p);
    if (key < best) {
      best = key;
      h_best = h;
    }
  }
  unsigned k = __reduce_min_sync(0xffffffffu, best);
  int bpos = static_cast<int>(k >> 16);
  int bp = static_cast<int>(k & 0xFFFFu);
  // the lane holding producer bp kept its head beside its least key
  int hb = __shfl_sync(0xffffffffu, h_best, bp & 31);
  int hm = __shfl_sync(0xffffffffu, h_me, me & 31);
  if (lane != 0) return;
  bool found_any = bpos <= W;
  bool found = m && found_any;
  int src = found_any ? bp : me;
  int h = found ? hb : hm;
  long long q = static_cast<long long>(me) * W + (found ? src : me);
  long long s = q * Q + floor_mod(h, Q);
  a.task_out[me] = a.buf[s];
  a.ts_out[me] = a.ts[s];
  a.src_out[me] = src;
  a.found_out[me] = found ? 1 : 0;
  a.checked_out[me] = found_any ? bpos + 1 : n_active;
  if (found) a.head[q] = h + 1;
}

// Nothing: the launch floor of the ctypes path (timing tools only).
__global__ void noop_kernel() {}

}  // namespace

extern "C" {

// `packed` is n value pointers (uint64) then n codes (int32, col * 2 +
// is_bool), as sched_queue.ctr_add packs them on the host.
int sq_ctr_add(void* ctr, int W, int nc, int n, const void* packed,
               void* stream) {
  if (n < 1 || n > CTR_PAIRS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CtrPairs p = {};
  const char* bytes = static_cast<const char*>(packed);
  for (int i = 0; i < n; ++i) {
    unsigned long long v;
    memcpy(&v, bytes + 8 * i, sizeof v);
    memcpy(&p.code[i], bytes + 8 * n + 4 * i, sizeof p.code[i]);
    p.val[i] = reinterpret_cast<const void*>(v);
  }
  p.n = n;
  const int threads = 128;
  ctr_add_kernel<<<(W + threads - 1) / threads, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(ctr), W, nc, p);
  return static_cast<int>(cudaGetLastError());
}

// `packed` is a PushArgs record.  One block of W threads, W <= PUSH_W_MAX.
int sq_push(const void* packed, void* stream) {
  PushArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.W <= 0 || a.W > PUSH_W_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  push_kernel<<<1, (a.W + 31) / 32 * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// `packed` is a PopArgs record.  Four warps (consumers) a block; a W that
// does not fit the scan key is refused.
int sq_pop_first(const void* packed, void* stream) {
  PopArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.W <= 0 || a.W > POP_W_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps_per_block = 4;
  pop_kernel<<<(a.W + warps_per_block - 1) / warps_per_block,
               32 * warps_per_block, 0,
               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One empty launch through the same path as sq_push (`packed` unread):
// what a call costs with no kernel work, for the timing tools.
int sq_noop(const void* packed, void* stream) {
  (void)packed;
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
