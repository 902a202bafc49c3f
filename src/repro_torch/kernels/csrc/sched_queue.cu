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
// launch latency, far below the card's memory or integer rate: the design
// goal here is one small launch with no host synchronisation, correct
// before fast.
//
// Integer `%` in C++ truncates toward zero; the JAX package's `%` floors.
// The scan positions take (p - me - 1) mod n of negative values, so every
// modulo below goes through floor_mod.

#include <cuda_runtime.h>
#include <climits>
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

// SPSC push, in place.  Lane i (producer p = producer[i]) appends task[i]
// with timestamp tsv[i] to queue (c = consumer[i], p) when mask[i] and the
// queue has room, and reports ok[i].  Replaces _push_kernel / push
// (src/repro/kernels/sched_queue.py:63, :83).  Active producers are
// distinct (lane == worker in the simulator), so each thread owns the
// whole producer column p: its tail, its buffer slots.  No atomics.  The
// result equals the JAX package's producer inversion followed by
// ok = mask & ok_p[producer] (src/repro/core/xqueue.py:70-90), inactive
// and padded lanes included (they write nothing and report false).
__global__ void push_kernel(int* __restrict__ buf, int* __restrict__ ts,
                            const int* __restrict__ head,
                            int* __restrict__ tail,
                            const int* __restrict__ producer,
                            const int* __restrict__ consumer,
                            const int* __restrict__ task,
                            const int* __restrict__ tsv,
                            const unsigned char* __restrict__ mask,
                            unsigned char* __restrict__ ok, int W, int Q) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  int p = producer[i];
  unsigned char okv = 0;
  if (mask[i] && p >= 0 && p < W) {
    int c = consumer[i];
    int q = c * W + p;
    int t = tail[q];
    if (t - head[q] < Q) {
      int s = floor_mod(t, Q);
      buf[q * Q + s] = task[i];
      ts[q * Q + s] = tsv[i];
      tail[q] = t + 1;
      okv = 1;
    }
  }
  ok[i] = okv;
}

// Rotated pop scan.  One warp per consumer row `me`, strided over
// producers p so any W works.  Each lane computes the analytic scan
// position of its producers (src/repro/core/xqueue.py:112-121: master
// queue first, then the other live producers rotated by rot[me]), masks
// empty queues to W + 1, and a warp min-reduce finds the first non-empty
// queue in scan order (the lowest p wins ties, as argmin does).  Lane 0
// then gathers the head slot and advances head[me, src] in place.
// Replaces _pop_kernel / pop_first (src/repro/kernels/sched_queue.py:122,
// :136), whose body is xqueue.pop_compute (src/repro/core/xqueue.py:124).
// Consumers that find nothing still gather buf/ts[me, me, head % Q] and
// report src = me, checked = n_active: the dequeue phase passes those on.
// n_active is read from device memory, so a launch needs no host sync.
__global__ void pop_kernel(const int* __restrict__ buf,
                           const int* __restrict__ ts, int* __restrict__ head,
                           const int* __restrict__ tail,
                           const int* __restrict__ rot,
                           const unsigned char* __restrict__ mask,
                           const int* __restrict__ n_active_ptr,
                           int* __restrict__ task_out,
                           int* __restrict__ ts_out,
                           int* __restrict__ src_out,
                           unsigned char* __restrict__ found_out,
                           int* __restrict__ checked_out, int W, int Q) {
  int me = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  int lane = threadIdx.x % 32;
  if (me >= W) return;  // uniform across the warp
  int n_active = *n_active_ptr;
  int n_act = max(n_active, 1);
  int nm1 = max(n_active - 1, 1);
  int r = rot[me];
  int best = INT_MAX, best_p = INT_MAX;
  for (int p = lane; p < W; p += 32) {
    int pos = (p == me) ? 0
                        : 1 + floor_mod(floor_mod(p - me - 1, n_act) - r, nm1);
    bool cand = (tail[me * W + p] - head[me * W + p] > 0) && (p < n_act);
    int pm = cand ? pos : W + 1;
    if (pm < best || (pm == best && p < best_p)) {
      best = pm;
      best_p = p;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    int ob = __shfl_down_sync(0xffffffffu, best, off);
    int op = __shfl_down_sync(0xffffffffu, best_p, off);
    if (ob < best || (ob == best && op < best_p)) {
      best = ob;
      best_p = op;
    }
  }
  if (lane != 0) return;
  bool found_any = best <= W;
  bool found = mask[me] && found_any;
  int src = found_any ? best_p : me;
  int safe = found ? src : me;
  int q = me * W + safe;
  int h = head[q];
  int slot = floor_mod(h, Q);
  task_out[me] = buf[q * Q + slot];
  ts_out[me] = ts[q * Q + slot];
  src_out[me] = src;
  found_out[me] = found ? 1 : 0;
  checked_out[me] = found_any ? best + 1 : n_active;
  if (found) head[q] = h + 1;
}

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

int sq_push(void* buf, void* ts, const void* head, void* tail,
            const void* producer, const void* consumer, const void* task,
            const void* tsv, const void* mask, void* ok, int W, int Q,
            void* stream) {
  const int threads = 128;
  push_kernel<<<(W + threads - 1) / threads, threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(buf), static_cast<int*>(ts),
      static_cast<const int*>(head), static_cast<int*>(tail),
      static_cast<const int*>(producer), static_cast<const int*>(consumer),
      static_cast<const int*>(task), static_cast<const int*>(tsv),
      static_cast<const unsigned char*>(mask),
      static_cast<unsigned char*>(ok), W, Q);
  return static_cast<int>(cudaGetLastError());
}

int sq_pop_first(const void* buf, const void* ts, void* head,
                 const void* tail, const void* rot, const void* mask,
                 const void* n_active, void* task_out, void* ts_out,
                 void* src_out, void* found_out, void* checked_out, int W,
                 int Q, void* stream) {
  const int warps_per_block = 4;
  const int threads = 32 * warps_per_block;
  pop_kernel<<<(W + warps_per_block - 1) / warps_per_block, threads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buf), static_cast<const int*>(ts),
      static_cast<int*>(head), static_cast<const int*>(tail),
      static_cast<const int*>(rot), static_cast<const unsigned char*>(mask),
      static_cast<const int*>(n_active), static_cast<int*>(task_out),
      static_cast<int*>(ts_out), static_cast<int*>(src_out),
      static_cast<unsigned char*>(found_out),
      static_cast<int*>(checked_out), W, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
