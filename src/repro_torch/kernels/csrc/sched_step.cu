// Hand-written Hopper (sm_90a) kernel: the scheduler simulator's whole run
// loop, for a batch of simulations, in one launch.
//
// Replaces the JAX package's whole-step megakernel
// (src/repro/kernels/sched_step.py: build_fused_step / _pallas_step, whose
// body is repro.core.phases.step_pipeline over the reference ops) and is
// the `cuda_fused` backend of repro_torch.core.backends.  Plain C entry
// point `ss_run`, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/sched_step.py); it launches on the stream it
// is given, allocates nothing, and returns cudaGetLastError().
//
// Design.  One thread block per simulation (the grid is the batch), one
// thread per worker lane (the block rounded up to whole warps; threads past
// W hold no lane but take part in every barrier and ballot).  The block
// repeats the step while the run gate holds, at most max_iters times, so a
// whole run is one launch with no host round trip.  Everything a block
// touches belongs to its own simulation, so no grid-wide synchronisation is
// needed.
//
// What bounds it.  A step touches a few KiB per simulation, and its work is
// a dependent chain of block barriers and per-lane walks over O(W) words:
// the kernel is bound by that latency chain, not by bytes or integer rate.
// The first version of this kernel kept the (W, W) queue heads and tails,
// the counter rows and the victim-weight tables in device memory, so every
// walk was a chain of L2 round trips, walked the scan order with two
// divisions a position, and kept a victim's transfer in per-thread arrays
// in local memory (1.5 KB a thread): a NA-WS step at W = 64 took ~246k
// cycles, 71 % of them in the victim phase and 14 % in the pop scan
// (clock64 split on the H100, PERF.md).  This design keeps the chain in
// shared memory and registers:
//  * the heads and tails of the queues live in shared memory for the whole
//    run, rows padded to W + 1 words (a warp walking 32 rows at one column
//    hits 32 banks), loaded in the prologue and written back at the end,
//    when they fit beside the rest in 227 KB (W <= 156; ss_resident);
//    otherwise the same code walks them in device memory (rows of W words);
//  * each lane's counter row lives in shared memory (rows of NC + 1 words)
//    and is written back once; the distance, node and bandwidth tables too;
//  * the victim-weight tables of dlb.remote_weight_table depend only on the
//    thief's domain, so the prologue builds one cumulative row per (domain,
//    table) and pick_victim binary-searches it;
//  * the scan order is walked one position at a time (ScanOrder), with no
//    division in the loop; the pop scan stops at the first non-empty queue
//    (the least scan position);
//  * the NA-WS transfer needs no per-thread arrays: each victim reads its
//    thief queue's head and tail before the phase's first barrier, then
//    walks only the k moved tasks, writing each into a free slot of the
//    thief's queue as it reads it (free slots are never read by another
//    victim), sums cost and payload as it goes, and advances its own heads
//    (only it reads them after that barrier); the thief-queue tails are
//    written after a second barrier;
//  * payloads are read only where a cluster link prices them.
// Two instantiations: 128 threads (W <= 128) and 1024 threads (64 registers
// a thread), chosen in ss_run by W alone.  To fit 64 registers the block's
// uniform values and the lane's less used scalars live in shared memory
// (Sim); ptxas reports no stack frame and no spill for either, and
// chip_smoke.py fails on one.

// Bitwise contract with the plain PyTorch step (repro_torch.core.phases):
//  * every phase reads the state as it stood before the phase: cross-lane
//    reads finish (__syncthreads) before any lane writes what another reads
//    (NA-WS transfer, thief request cells, join counts, the global queue);
//  * racy writes resolve to the highest lane (messaging.last_writer):
//    request cells through an atomicMax winner per victim, the global
//    queue's wrapped slots by rank;
//  * ranks are block-wide exclusive counts of the same flags the cumsums
//    count; the join claim goes to the lowest lane, the pop scan's ties to
//    the lowest producer;
//  * `//` and `%` floor as PyTorch's do (floor_div, floor_mod); int32 sums
//    and products wrap (done in uint32);
//  * the float32 steps (exec penalty, dlb.uniform, the cluster split) are
//    written one operation at a time and built with --fmad=false, so each
//    rounds as PyTorch's float32 ops do on the CPU;
//  * the thief retry runs exactly min(NV_CAP, n_victim) rounds when any
//    lane requests, advancing every lane's xorshift state each round;
//  * a NA-WS transfer's per-task cost is comm + payload / bw > 0, so the
//    tasks inside the time window are a prefix of the k candidates.

#include <cuda_runtime.h>
#include <atomic>
#include <climits>
#include <stdint.h>

namespace {

constexpr int K_SPAWN = 2;   // state.K_SPAWN
constexpr int WS_CAP = 32;   // state.WS_CAP
constexpr int NV_CAP = 24;   // state.NV_CAP
constexpr int NC = 18;       // state.NC: counter columns
constexpr int NCS = NC + 1;  // a counter row in shared memory (odd stride)
constexpr int N_TAB = 3;     // victim-weight tables: any, node-local, remote

// counter columns, state.CTR_NAMES order
enum {
  C_EXEC, C_SELF, C_LOCAL, C_REMOTE, C_STATIC_PUSH, C_IMM_EXEC, C_REQ_SENT,
  C_REQ_HANDLED, C_REQ_HAS_STEAL, C_STOLEN, C_STOLEN_LOCAL, C_STOLEN_REMOTE,
  C_SRC_EMPTY, C_TGT_FULL, C_ATOMIC_OPS, C_BUSY_NS, C_STOLEN_XNODE,
  C_XNODE_BYTES
};

}  // namespace

// Mirror of sched_step.StepArgs (ctypes): leaf pointers in SimState,
// GraphArrays, SweepCase order (each with a leading batch axis), then the
// sizes, the integer costs and the float32 costs.
struct StepArgs {
  int *xq_buf, *xq_ts, *xq_head, *xq_tail;
  int *round, *req_round, *req_tid;
  int *rp_tgt, *rp_left;
  int *g_buf, *g_ts, *g_head, *g_tail;
  int *s_task, *s_cnt, *s_top;
  int* join_cnt;
  unsigned char* done;
  int *done_ns, *creator;
  int *clock, *rr, *deq_rr, *idle;
  long long* rng;
  int *ctr, *n_done;
  unsigned char* overflow;
  int *step_i, *nlink;
  const int *dur, *first_child, *n_children, *notify, *join_dep, *n_tasks,
      *payload;
  const int *queue_id, *barrier_id, *balance_id, *n_workers, *zone_size,
      *seed;
  const float* mem_bound;
  const int *n_victim, *n_steal, *t_interval;
  const float *p_local, *p_local_node;
  const int *n_domains, *dist;
  const unsigned char* flat;
  const int *node, *bw;
  const unsigned char* cluster;
  const int* bneck_bw;
  const float* bw_scale;
  const unsigned char* closed;
  const int* release_ns;
  int B, W, S, Q, T, GQ, R, NCTR, DM, max_steps, max_iters;
  int c_cache, c_zone, c_numa, c_atomic, c_contend, c_lock, c_pq_op, c_alloc,
      c_slot, req_bytes;
  float erp, erp_m1, ezp, c_numa_f;
};

// A block's shared memory: the dynamic part (base_words, then the heads
// and tails when resident) and the per-simulation scalars (g_head, g_tail,
// n_done, overflow, step_i).
extern __shared__ int ss_smem[];
__shared__ int ss_scalar[5];
// A block's uniform values, set once in the prologue: the queue heads and
// tails (rows of hs words, in shared or device memory), the case's F_*
// bits, worker count, zone size and domain count.
struct BlockConsts {
  int *head, *tail;
  int hs;
  unsigned flags;
  int n_w, zsz, nd;
};
__shared__ BlockConsts ss_block;

namespace {

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return (r != 0 && ((r < 0) != (n < 0))) ? r + n : r;
}
__device__ __forceinline__ int floor_div(int a, int n) {
  int q = a / n;
  return (a % n != 0 && ((a < 0) != (n < 0))) ? q - 1 : q;
}
__device__ __forceinline__ uint32_t xorshift(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

// Block-wide exclusive count of `f` over lower threads (the cumsum rank),
// and the total.  Every thread of the block must call it.
__device__ int excl_count(bool f, int* total, int* wb) {
  unsigned bal = __ballot_sync(0xffffffffu, f);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wb[warp] = __popc(bal);
  __syncthreads();
  int before = 0, tot = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    tot += wb[w];
    if (w < warp) before += wb[w];
  }
  __syncthreads();
  *total = tot;
  return before + __popc(bal & ((1u << lane) - 1u));
}

// Block-wide int32 sum, wrapping.  Every thread of the block must call it.
__device__ int block_sum(int v, int* wb) {
  unsigned s = static_cast<unsigned>(v);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) wb[threadIdx.x >> 5] = static_cast<int>(s);
  __syncthreads();
  unsigned tot = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    tot += static_cast<unsigned>(wb[w]);
  __syncthreads();
  return static_cast<int>(tot);
}

// Per-lane rows of shared memory (one word per thread of the block): the
// message cells, the winner and claim scratch, and the lane's scalars that
// are not on every path of a step (registers are scarce at 1024 threads).
enum {
  L_ROUND, L_REQ_ROUND, L_REQ_TID, L_WIN, L_TMP, L_RR, L_DEQ_RR, L_IDLE,
  L_RP_TGT, L_RP_LEFT, L_NLINK, N_LANE_ROWS
};

// Shared-memory words a block needs besides its (W, W) heads and tails:
// the per-lane rows, the warp sums, the counter rows, the weight tables,
// and the distance / bandwidth / node tables.
__host__ __device__ inline int base_words(int W, int DM) {
  return N_LANE_ROWS * ((W + 31) / 32 * 32) + 32 + NCS * W
         + N_TAB * DM * W + 2 * DM * DM + DM;
}

// The case's axis masks and machine kind, as bits of Sim::flags.
enum {
  F_LOCKED = 1, F_XQ = 2, F_PAYS = 4, F_NARP = 8, F_NAWS = 16, F_DLB = 32,
  F_FLAT = 64, F_CLUSTER = 128, F_CLOSED = 256
};

// One simulation as one thread sees it.  Only this lane's hottest values
// are fields (registers); everything else is an accessor: the block's
// uniform values (ss_block), the sizes, this block's slices of the arrays
// and the case's rarer scalars over the kernel's parameters (cheap to
// recompute, so they hold no registers across the step), and the shared
// arrays at fixed offsets of ss_smem (base_words order).  At 1024 threads a
// thread has 64 registers; this keeps the kernel free of spills there.
struct Sim {
  const StepArgs* a;
  // this lane (rr, deq_rr, idle, the NA-RP state and the link bytes are in
  // shared memory: the accessors below)
  int me;
  bool act;  // a worker lane (me < W)
  int clock, s_top;
  uint32_t rng;

  // the block's uniform values (ss_block)
  __device__ int b() const { return blockIdx.x; }
  __device__ int* head() const { return ss_block.head; }
  __device__ int* tail() const { return ss_block.tail; }
  __device__ int hs() const { return ss_block.hs; }
  __device__ int n_w() const { return ss_block.n_w; }
  __device__ int zsz() const { return ss_block.zsz; }
  __device__ int nd() const { return ss_block.nd; }

  __device__ bool is_locked() const { return ss_block.flags & F_LOCKED; }
  __device__ bool uses_xq() const { return ss_block.flags & F_XQ; }
  __device__ bool pays_count() const { return ss_block.flags & F_PAYS; }
  __device__ bool is_narp() const { return ss_block.flags & F_NARP; }
  __device__ bool is_naws() const { return ss_block.flags & F_NAWS; }
  __device__ bool is_dlb() const { return ss_block.flags & F_DLB; }
  __device__ bool flat() const { return ss_block.flags & F_FLAT; }
  __device__ bool cluster() const { return ss_block.flags & F_CLUSTER; }
  __device__ bool closed() const { return ss_block.flags & F_CLOSED; }

  // sizes
  __device__ int W() const { return a->W; }
  __device__ int S() const { return a->S; }
  __device__ int Q() const { return a->Q; }
  __device__ int T() const { return a->T; }
  __device__ int GQ() const { return a->GQ; }
  __device__ int R() const { return a->R; }
  __device__ int DM() const { return a->DM; }
  // this simulation's device arrays
  __device__ long long oWWQ() const {
    return static_cast<long long>(b()) * a->W * a->W * a->Q;
  }
  __device__ long long oWS() const {
    return static_cast<long long>(b()) * a->W * a->S;
  }
  __device__ int* buf() const { return a->xq_buf + oWWQ(); }
  __device__ int* tsb() const { return a->xq_ts + oWWQ(); }
  __device__ int* g_buf() const { return a->g_buf + b() * a->GQ; }
  __device__ int* g_ts() const { return a->g_ts + b() * a->GQ; }
  __device__ int* s_task() const { return a->s_task + oWS(); }
  __device__ int* s_cnt() const { return a->s_cnt + oWS(); }
  __device__ int* join_cnt() const { return a->join_cnt + b() * a->T; }
  __device__ unsigned char* done() const { return a->done + b() * a->T; }
  __device__ int* done_ns() const { return a->done_ns + b() * a->T; }
  __device__ int* creator() const { return a->creator + b() * a->T; }
  __device__ const int* dur() const { return a->dur + b() * a->T; }
  __device__ const int* first_child() const {
    return a->first_child + b() * a->T;
  }
  __device__ const int* n_children() const {
    return a->n_children + b() * a->T;
  }
  __device__ const int* notify() const { return a->notify + b() * a->T; }
  __device__ const int* payload() const { return a->payload + b() * a->T; }
  __device__ const int* release() const { return a->release_ns + b() * a->R; }
  // the case's rarer scalars
  __device__ int barrier_id() const { return a->barrier_id[b()]; }
  __device__ int n_victim() const { return a->n_victim[b()]; }
  __device__ int n_steal() const { return a->n_steal[b()]; }
  __device__ int t_interval() const { return a->t_interval[b()]; }
  __device__ int bneck_bw() const { return a->bneck_bw[b()]; }
  __device__ int n_tasks() const { return a->n_tasks[b()]; }
  __device__ float mem_bound() const { return a->mem_bound[b()]; }
  __device__ float p_local() const { return a->p_local[b()]; }
  __device__ float p_local_node() const { return a->p_local_node[b()]; }
  __device__ float bw_scale() const { return a->bw_scale[b()]; }
  // shared memory, in base_words order: the per-lane rows, the warp sums,
  // the counter rows, the weight tables, the topology tables
  __device__ int lanes() const { return (a->W + 31) / 32 * 32; }
  __device__ int* lane_row(int r) const { return ss_smem + r * lanes(); }
  __device__ int* round() const { return lane_row(L_ROUND); }
  __device__ int* req_round() const { return lane_row(L_REQ_ROUND); }
  __device__ int* req_tid() const { return lane_row(L_REQ_TID); }
  __device__ int* win() const { return lane_row(L_WIN); }
  __device__ int* tmp() const { return lane_row(L_TMP); }
  __device__ int& rr() const { return lane_row(L_RR)[me]; }
  __device__ int& deq_rr() const { return lane_row(L_DEQ_RR)[me]; }
  __device__ int& idle() const { return lane_row(L_IDLE)[me]; }
  __device__ int& rp_tgt() const { return lane_row(L_RP_TGT)[me]; }
  __device__ int& rp_left() const { return lane_row(L_RP_LEFT)[me]; }
  __device__ int& nlink() const { return lane_row(L_NLINK)[me]; }
  __device__ int* wb() const { return lane_row(N_LANE_ROWS); }
  __device__ int* ctr_rows() const { return wb() + 32; }
  __device__ int* cum() const { return ctr_rows() + NCS * a->W; }
  __device__ int* dist() const { return cum() + N_TAB * a->DM * a->W; }
  __device__ int* bw() const { return dist() + a->DM * a->DM; }
  __device__ int* node() const { return dist() + 2 * a->DM * a->DM; }
  __device__ int* g_head() const { return ss_scalar; }
  __device__ int* g_tail() const { return ss_scalar + 1; }
  __device__ int* n_done() const { return ss_scalar + 2; }
  __device__ int* overflow() const { return ss_scalar + 3; }
  __device__ int* step_i() const { return ss_scalar + 4; }

  // counter column `col` of this lane's row += v
  __device__ void bump(int col, int v) {
    int* c = ctr_rows() + me * NCS + col;
    if (act) *c = wadd(*c, v);
  }
  __device__ int& hd(int row, int col) const {
    return head()[row * hs() + col];
  }
  __device__ int& tl(int row, int col) const {
    return tail()[row * hs() + col];
  }
  __device__ int dom(int w) const { return min(floor_div(w, zsz()), nd() - 1); }
  // phases._comm: lock-less latency of a touching a line owned by b
  __device__ int comm(int x, int y) const {
    if (x == y) return a->c_cache;
    if (flat())
      return floor_div(x, zsz()) == floor_div(y, zsz()) ? a->c_zone : a->c_numa;
    return dist()[dom(x) * a->DM + dom(y)];
  }
  // phases._xfer: the D/B payload term
  __device__ int xfer(int x, int y, int nbytes) const {
    if (!cluster() || x == y) return 0;
    return floor_div(nbytes, max(bw()[dom(x) * a->DM + dom(y)], 1));
  }
  __device__ int comm_sz(int x, int y, int nbytes) const {
    return wadd(comm(x, y), xfer(x, y, nbytes));
  }
  __device__ bool same_domain(int x, int y) const {
    return flat() ? floor_div(x, zsz()) == floor_div(y, zsz())
                  : dom(x) == dom(y);
  }
  __device__ bool same_node(int x, int y) const {
    return !cluster() || node()[dom(x)] == node()[dom(y)];
  }
};

// xqueue._scan_order of consumer `me` (me < n_workers), one position at a
// time and without a division in the loop: position 0 is the master queue
// (me itself), position i >= 1 the producer
// (me + 1 + (rot + i - 1) mod (n - 1)) mod n.  next() gives positions 1,
// 2, ... in order.
struct ScanOrder {
  int me, n_act, nm1, j;
  __device__ ScanOrder(int me_, int n_w, int rot)
      : me(me_), n_act(max(n_w, 1)), nm1(max(n_w - 1, 1)),
        j(floor_mod(rot, max(n_w - 1, 1))) {}
  __device__ int next() {
    int p = me + 1 + j;  // < 2 * n_act: one subtraction wraps it
    if (p >= n_act) p -= n_act;
    j = j + 1 == nm1 ? 0 : j + 1;
    return p;
  }
};

// ---------------- completion bookkeeping (phases._finish) ----------------
__device__ __forceinline__ void stack_push(Sim& s, bool mask, int task0,
                                           int cnt) {
  bool fits = mask && s.s_top < s.S();
  if (fits) {
    s.s_task()[s.me * s.S() + s.s_top] = task0;
    s.s_cnt()[s.me * s.S() + s.s_top] = cnt;
    s.s_top += 1;
  } else if (mask) {
    *s.overflow() = 1;  // every writer writes the same value
  }
}

__device__ __forceinline__ void finish(Sim& s, int ftask) {
  bool active = s.act && ftask >= 0 && ftask < s.T();
  if (active) {
    s.done()[ftask] = 1;
    s.done_ns()[ftask] = max(s.done_ns()[ftask], s.clock);
  }
  int nact = __syncthreads_count(active);
  if (threadIdx.x == 0) *s.n_done() = wadd(*s.n_done(), nact);
  int nch = active ? s.n_children()[ftask] : 0;
  stack_push(s, nch > 0, active ? s.first_child()[ftask] : 0, nch);
  // notify joins; duplicate targets accumulate
  int j = active ? s.notify()[ftask] : -1;
  if (j >= 0 && j < s.T()) atomicSub(&s.join_cnt()[j], 1);
  __syncthreads();
  bool newly = j >= 0 && j < s.T() && s.join_cnt()[j] == 0;
  if (__syncthreads_or(newly)) {
    // the lowest lane completing a join claims it
    if (s.act) s.tmp()[s.me] = newly ? j : -1;
    __syncthreads();
    bool mine = newly;
    for (int k = 0; mine && k < s.me; ++k) mine = s.tmp()[k] != j;
    if (mine) s.creator()[j] = s.me;
    stack_push(s, mine, j, 1);
    __syncthreads();
  }
}

// phases._atomic_cost: the k-th simultaneous writer pays k hand-offs
__device__ __forceinline__ void atomic_charge(Sim& s, bool mask) {
  int tot;
  int rank = excl_count(mask, &tot, s.wb());
  if (mask)
    s.clock = wadd(s.clock, wadd(s.a->c_atomic, wmul(rank, s.a->c_contend)));
  s.bump(C_ATOMIC_OPS, mask);
}

// ---------------- adopt (NA-RP spawners adopt a thief pre-push) ----------
__device__ __forceinline__ void adopt_phase(Sim& s, bool running) {
  bool spawner = s.act && s.s_top > 0 && s.is_narp() && running;
  bool valid0 = spawner && s.req_round()[s.me] == s.round()[s.me];
  if (valid0 && s.rp_tgt() < 0) {
    s.rp_tgt() = max(s.req_tid()[s.me], 0);
    s.rp_left() = s.n_steal();
  }
  if (valid0) s.round()[s.me] += 1;
  s.bump(C_REQ_HANDLED, valid0);
}

// ---------------- spawn (push up to K_SPAWN spawned tasks) ----------------
__device__ __forceinline__ void spawn_phase(Sim& s, bool running) {
  const StepArgs& c = *s.a;
  for (int it = 0; it < K_SPAWN; ++it) {
    bool avail = s.act && s.s_top > 0 && running;
    int topi = max(s.s_top - 1, 0);
    int etask = s.act ? s.s_task()[s.me * s.S() + topi] : 0;
    int ecnt = s.act ? s.s_cnt()[s.me * s.S() + topi] : 0;
    int rel = s.release()[min(max(etask, 0), s.R() - 1)];
    bool released = s.closed() || s.clock >= rel;
    bool active = avail && released;
    if (avail && !released) s.clock = rel;  // sleep to the release stamp
    int task = active ? etask : 0;

    // GOMP lane: serialized global-lock push
    bool act_g = active && s.is_locked();
    int n_g;
    int g_tail0 = *s.g_tail();
    int rank_g = excl_count(act_g, &n_g, s.wb());
    int cost_g = act_g ? wadd(c.c_atomic + c.c_pq_op + c.c_alloc,
                              wmul(rank_g, c.c_lock))
                       : 0;
    // XQueue lane, with NA-RP redirection
    bool act_x = active && s.uses_xq();
    bool use_rp = act_x && s.is_narp() && s.rp_tgt() >= 0 && s.rp_left() > 0;
    int tgt = use_rp ? max(s.rp_tgt(), 0) : floor_mod(s.rr(), s.n_w());
    // the payload prices a cluster link only (phases._xfer)
    int pay = act_x && s.cluster() ? s.payload()[task] : 0;
    int cost_x = act_x ? wadd(c.c_alloc + c.c_slot, s.comm_sz(s.me, tgt, pay))
                       : 0;
    s.clock = wadd(wadd(s.clock, cost_g), cost_x);
    // a wrapped slot goes to the highest rank writing it
    if (act_g && rank_g + s.GQ() >= n_g) {
      int gi = floor_mod(wadd(g_tail0, rank_g), s.GQ());
      s.g_buf()[gi] = task;
      s.g_ts()[gi] = s.clock;
    }
    __syncthreads();  // every lane has read g_tail
    if (threadIdx.x == 0) *s.g_tail() = wadd(g_tail0, n_g);
    // SPSC push into queue (tgt, me): this lane owns producer column me
    bool ok = false;
    if (act_x) {
      int t = s.tl(tgt, s.me);
      if (t - s.hd(tgt, s.me) < s.Q()) {
        int sl = floor_mod(t, s.Q());
        int q = tgt * s.W() + s.me;
        s.buf()[q * s.Q() + sl] = task;
        s.tsb()[q * s.Q() + sl] = s.clock;
        s.tl(tgt, s.me) = t + 1;
        ok = true;
      }
    }
    bool imm = act_x && !ok;
    if (act_x && !use_rp) s.rr() += 1;
    if (active) s.creator()[task] = s.me;
    s.bump(C_STATIC_PUSH, act_g || (ok && !use_rp));
    s.bump(C_ATOMIC_OPS, act_g);
    bool okrp = ok && use_rp;
    bool same_d = s.same_domain(s.me, tgt);
    s.bump(C_STOLEN, okrp);
    s.bump(C_STOLEN_LOCAL, okrp && same_d);
    s.bump(C_STOLEN_REMOTE, okrp && !same_d);
    s.bump(C_STOLEN_XNODE, okrp && !s.same_node(s.me, tgt));
    // Alg. 3: stop on quota exhausted or thief queue full (every lane)
    int left = s.rp_left() - (okrp ? 1 : 0);
    bool drop = (use_rp && !ok) || left <= 0;
    s.rp_tgt() = drop ? -1 : s.rp_tgt();
    s.rp_left() = drop ? 0 : left;
    s.bump(C_TGT_FULL, use_rp && !ok);
    if (act_x && s.cluster() && !s.same_node(s.me, tgt))
      s.nlink() = wadd(s.nlink(), pay);
    atomic_charge(s, active && s.pays_count());
    // consume one task from the range entry
    if (active) {
      s.s_task()[s.me * s.S() + topi] = etask + 1;
      s.s_cnt()[s.me * s.S() + topi] = ecnt - 1;
      if (ecnt - 1 == 0) s.s_top -= 1;
    }
    // execute-immediately rule for full target queues
    if (__syncthreads_or(imm)) {
      int dur_t = imm ? s.dur()[task] : 0;
      s.bump(C_IMM_EXEC, imm);
      s.bump(C_EXEC, imm);
      s.bump(C_SELF, imm);
      s.bump(C_BUSY_NS, dur_t);
      s.clock = wadd(s.clock, dur_t);
      finish(s, imm ? task : -1);
      atomic_charge(s, imm && s.pays_count());
    }
    __syncthreads();
  }
}

// ---------------- dequeue (global queue, or the rotated XQueue scan) -------
struct Deq {
  int task, ts;
  bool found;
};

__device__ __forceinline__ Deq dequeue_phase(Sim& s, bool running) {
  const StepArgs& c = *s.a;
  bool idle_m = s.act && s.s_top == 0 && s.me < s.n_w() && running;
  // GOMP lane: contended pops off the single global queue
  bool idle_g = idle_m && s.is_locked();
  int g_head0 = *s.g_head();
  int avail = *s.g_tail() - g_head0;
  int n_idle;
  int rank = excl_count(idle_g, &n_idle, s.wb());
  bool found_g = idle_g && rank < avail;
  int task_g = 0, ts_g = 0;
  if (found_g) {
    int gi = floor_mod(wadd(g_head0, rank), s.GQ());
    task_g = s.g_buf()[gi];
    ts_g = s.g_ts()[gi];
  }
  int nf = __syncthreads_count(found_g);  // every lane has read g_head
  if (threadIdx.x == 0) *s.g_head() = wadd(g_head0, nf);
  int cost_g = idle_g ? wadd(c.c_atomic + c.c_pq_op, wmul(rank, c.c_lock)) : 0;
  s.bump(C_ATOMIC_OPS, idle_g);
  // XQueue lane: master queue first, then the others rotated by deq_rr
  // (xqueue.pop_compute); this lane owns consumer row me
  bool idle_x = idle_m && s.uses_xq();
  bool found_x = false;
  int task_x = 0, ts_x = 0, cost_x = 0;
  if (idle_x) {
    // the first non-empty queue in scan order has the least scan position
    // (xqueue.scan_pos inverts the order over the live producers)
    const int* hrow = s.head() + s.me * s.hs();
    const int* trow = s.tail() + s.me * s.hs();
    int best = -1, src = s.me;
    if (trow[s.me] - hrow[s.me] > 0) {
      best = 0;
    } else {
      ScanOrder so(s.me, s.n_w(), s.deq_rr());
      for (int i = 1; i < s.n_w(); ++i) {
        int p = so.next();
        if (trow[p] - hrow[p] > 0) {
          best = i;
          src = p;
          break;
        }
      }
    }
    found_x = best >= 0;
    int checked = found_x ? best + 1 : s.n_w();
    cost_x = wmul(checked, c.c_cache);
    if (found_x) {
      int q = s.me * s.W() + src;
      int h = s.hd(s.me, src);
      int sl = floor_mod(h, s.Q());
      task_x = s.buf()[q * s.Q() + sl];
      ts_x = s.tsb()[q * s.Q() + sl];
      s.hd(s.me, src) = h + 1;
      int pay_x = s.cluster() ? s.payload()[task_x] : 0;
      cost_x = wadd(cost_x, s.comm_sz(s.me, src, pay_x));
      if (src != s.me) s.deq_rr() += 1;
      if (s.cluster() && !s.same_node(s.me, src))
        s.nlink() = wadd(s.nlink(), pay_x);
    }
  }
  s.clock = wadd(wadd(s.clock, cost_g), cost_x);
  __syncthreads();
  Deq d;
  d.task = s.is_locked() ? task_g : task_x;
  d.ts = s.is_locked() ? ts_g : ts_x;
  d.found = found_g || found_x;
  return d;
}

// ---------------- thief protocol (Alg. 1) ----------------
// dlb.remote_weight_table, once per run: for each domain d and table t (0
// any remote, 1 remote in d's node, 2 in other nodes) the cumulative
// weights over candidate lanes j, (d_max - dist + 1) for a candidate and 0
// otherwise.  One thread per row; every thread of the block must call it.
__device__ __forceinline__ void wt_build(Sim& s) {
  int n_tab = s.cluster() ? N_TAB : 1;
  for (int r = threadIdx.x; r < s.nd() * n_tab; r += blockDim.x) {
    int d = r / n_tab, t = r % n_tab;
    int* row = s.cum() + (d * N_TAB + t) * s.W();
    int dmax = 0;
    for (int pass = 0; pass < 2; ++pass) {
      int cum = 0;
      for (int j = 0; j < s.W(); ++j) {
        int dom_j = min(floor_div(j, s.zsz()), s.nd() - 1);
        int dj = s.dist()[d * s.DM() + dom_j];
        bool cand = j < s.n_w() && dom_j != d;
        if (t == 1) cand = cand && s.node()[d] == s.node()[dom_j];
        if (t == 2) cand = cand && s.node()[d] != s.node()[dom_j];
        if (pass == 0) {
          if (cand) dmax = max(dmax, dj);
        } else {
          if (cand) cum = wadd(cum, dmax - dj + 1);
          row[j] = cum;
        }
      }
    }
  }
  __syncthreads();
}

// dlb._remote_weighted: the first lane whose cumulative weight exceeds
// draw % total, clipped to the last lane (a binary search of the row:
// cumulative weights never decrease).  Sets *has to total > 0.
__device__ __forceinline__ int wt_pick(const Sim& s, int t, int draw,
                                       bool* has) {
  const int* row = s.cum() + (s.dom(s.me) * N_TAB + t) * s.W();
  int total = row[s.W() - 1];
  *has = total > 0;
  int r = draw % max(total, 1);
  int lo = 0, hi = s.W();
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row[mid] > r) hi = mid;
    else lo = mid + 1;
  }
  return min(lo, s.W() - 1);
}

// dlb.pick_victim: two xorshifts, one uniform, one draw; every path
__device__ __forceinline__ int pick_victim(Sim& s) {
  s.rng = xorshift(s.rng);
  float u = static_cast<float>(s.rng >> 8) * (1.0f / 16777216.0f);
  bool want_local = u < s.p_local();
  s.rng = xorshift(s.rng);
  int draw = static_cast<int>(s.rng >> 1);
  int Wn = s.n_w(), Z = s.zsz(), me = s.me;
  int zbase = floor_div(me, Z) * Z;
  int off_l = draw % max(Z - 1, 1);
  int local = zbase + off_l + (off_l >= me - zbase ? 1 : 0);
  int off_r = draw % max(Wn - Z, 1);
  int remote = off_r >= zbase ? off_r + Z : off_r;
  bool has_local = Z > 1, has_remote = Wn > Z;
  if (!s.flat()) {
    int dom_me = s.dom(me);
    int start = dom_me * Z;
    int end = dom_me == s.nd() - 1 ? Wn : (dom_me + 1) * Z;
    int size = end - start;
    int off_h = draw % max(size - 1, 1);
    local = start + off_h + (off_h >= me - start ? 1 : 0);
    bool has_remote_h;
    int remote_h = wt_pick(s, 0, draw, &has_remote_h);
    if (s.cluster()) {
      bool has_nl, has_nr;
      int nl_v = wt_pick(s, 1, draw, &has_nl);
      int nr_v = wt_pick(s, 2, draw, &has_nr);
      // one float32 operation at a time (built with --fmad=false)
      float pn_eff = s.p_local_node();
      if (s.bw_scale() < 1.0f) {
        float keep = 1.0f - s.p_local_node();
        float scaled = keep * s.bw_scale();
        pn_eff = 1.0f - scaled;
      }
      float rest = 1.0f - s.p_local();
      float node_part = rest * pn_eff;
      float bound = s.p_local() + node_part;
      bool want_node = u < bound;
      bool use_nl = (has_nl && has_nr) ? want_node : has_nl;
      remote_h = use_nl ? nl_v : nr_v;
      has_remote_h = has_nl || has_nr;
    }
    remote = remote_h;
    has_local = size > 1;
    has_remote = has_remote_h;
  }
  bool use_local = (has_local && has_remote) ? want_local : has_local;
  return use_local ? local : remote;
}

__device__ __forceinline__ void thief_phase(Sim& s, bool found, bool running) {
  const StepArgs& c = *s.a;
  bool thief_m = s.act && s.s_top == 0 && !found && s.me < s.n_w() && s.is_dlb()
                 && running;
  int idle = thief_m ? s.idle() + 1 : 0;
  bool do_req = thief_m && (idle == 1 || idle >= s.t_interval());
  s.idle() = idle >= s.t_interval() ? 0 : idle;
  int rounds = __syncthreads_or(do_req) ? min(NV_CAP, s.n_victim()) : 0;
  int n_sent = 0, nl = 0;
  for (int v = 0; v < rounds; ++v) {
    bool sm = do_req && v < s.n_victim();
    int victim = s.act ? pick_victim(s) : 0;
    int vs = min(max(victim, 0), s.W() - 1);
    bool sent = sm && s.req_round()[vs] < s.round()[vs];
    __syncthreads();  // every thief has read the request cells
    // racy request writes: the highest thief lane wins (last_writer)
    if (sent && victim >= 0 && victim < s.W())
      atomicMax(&s.win()[victim], s.me);
    __syncthreads();
    if (s.act && s.win()[s.me] >= 0) {
      s.req_round()[s.me] = s.round()[s.me];
      s.req_tid()[s.me] = s.win()[s.me];
      s.win()[s.me] = -1;
    }
    __syncthreads();
    if (s.act) {
      int c1 = s.comm_sz(s.me, victim, c.req_bytes);
      int add = wadd(sm ? wmul(2, c1) : 0, sent ? c1 : 0);
      s.clock = wadd(s.clock, add);
      int msgs = (sm ? 2 : 0) + (sent ? 1 : 0);
      if (sm && s.cluster() && !s.same_node(s.me, victim))
        nl = wadd(nl, wmul(msgs, c.req_bytes));
      n_sent += sent;
    }
  }
  s.bump(C_REQ_SENT, n_sent);
  s.nlink() = wadd(s.nlink(), nl);
}

// ---------------- victim (NA-WS bulk transfer, NA-RP adoption) -----------
// dlb._ws_bulk for this lane.  Before the first barrier a victim reads its
// thief queue's head and tail (another victim may advance that head after
// it).  Between the barriers it walks its own row only: the scan-order
// sizes, the k moved tasks (the r-th is the r-th element of the scan-order
// concatenation), each written at once into a free slot of queue (thief,
// me), which no victim reads, then the per-source takes (a waterfall over
// the scan order) added to its own heads.  The thief-queue tail, which its
// owner walked between the barriers, is written after the second.
__device__ __forceinline__ void victim_phase(Sim& s, bool found) {
  bool valid = s.act && found && s.req_round()[s.me] == s.round()[s.me];
  int thief = s.act ? max(s.req_tid()[s.me], 0) : 0;
  bool vm_ws = valid && s.is_naws();
  int k = 0, tail0 = 0, free0 = 0, clock_add = 0, moved = 0;
  bool src_empty = false, tgt_full = false;
  if (vm_ws) {
    tail0 = s.tl(thief, s.me);
    free0 = s.Q() - (tail0 - s.hd(thief, s.me));
  }
  if (__syncthreads_or(vm_ws)) {
    if (vm_ws) {
      int comm_c = s.comm(s.me, thief);
      int xfer_bw = (s.cluster() && s.me != thief)
                        ? s.bw()[s.dom(s.me) * s.DM() + s.dom(thief)]
                        : 0;
      int ns = min(s.n_steal(), WS_CAP);
      int n_act = max(s.n_w(), 1);
      const int* hrow = s.head() + s.me * s.hs();
      const int* trow = s.tail() + s.me * s.hs();
      // the scan order holds every live producer once
      int avail = 0;
      for (int p = 0; p < n_act; ++p) avail = wadd(avail, trow[p] - hrow[p]);
      k = max(min(ns, min(avail, free0)), 0);
      int k_full = k;
      // the moved tasks: the r-th is the r-th element of the scan-order
      // concatenation of this lane's queues; on a priced link the time
      // window keeps a prefix of them.  The walk holds source p (scan
      // position i, elements [cb, cb + sz)); element r + 1 is read before
      // element r's payload, so their loads overlap.
      ScanOrder so(s.me, s.n_w(), s.deq_rr());
      int i = 0, p = s.me, cb = 0, sz = trow[p] - hrow[p];
      auto load = [&](int r, int* task, int* ts) {
        while (cb + sz <= r && i < n_act - 1) {
          cb = wadd(cb, sz);
          ++i;
          p = so.next();
          sz = trow[p] - hrow[p];
        }
        int q = s.me * s.W() + p;
        int slot = floor_mod(wadd(hrow[p], r - cb), s.Q());
        *task = s.buf()[q * s.Q() + slot];
        *ts = s.tsb()[q * s.Q() + slot];
      };
      int window = wmul(ns, comm_c);
      int qt = thief * s.W() + s.me;
      int before = 0, tr_next = 0, ts_next = 0;
      if (k_full > 0) load(0, &tr_next, &ts_next);
      for (int r = 0; r < k_full; ++r) {
        int tr = tr_next, tsr = ts_next;
        if (r + 1 < k_full) load(r + 1, &tr_next, &ts_next);
        // an empty slot holds -1, which indexes the last task (as in
        // JAX); the payload counts on a priced link only
        int pi = tr < 0 ? tr + s.T() : tr;
        int pay = xfer_bw > 0 ? s.payload()[min(max(pi, 0), s.T() - 1)] : 0;
        int cost = wadd(comm_c,
                        xfer_bw > 0 ? floor_div(pay, max(xfer_bw, 1)) : 0);
        if (xfer_bw > 0 && wadd(before, cost) > window) {
          k = r;
          break;
        }
        int sl = floor_mod(tail0 + r, s.Q());
        s.buf()[qt * s.Q() + sl] = tr;
        s.tsb()[qt * s.Q() + sl] = wadd(max(wadd(s.clock, before), tsr), cost);
        clock_add = wadd(clock_add, cost);
        if (xfer_bw > 0) moved = wadd(moved, pay);
        before = wadd(before, cost);
      }
      bool windowed = k < k_full;
      bool can_more = k < ns && !windowed;
      tgt_full = can_more && k == free0;
      src_empty = can_more && free0 > k && k == avail;
      // per-source takes: a waterfall over the scan order (the inverse of
      // xqueue.scan_pos over the live producers), each size read before
      // the head it advances
      ScanOrder so2(s.me, s.n_w(), s.deq_rr());
      int cbp = 0;
      for (int ip = 0; ip < n_act && cbp < k; ++ip) {
        int pp = ip == 0 ? s.me : so2.next();
        int szp = trow[pp] - hrow[pp];
        int take = min(max(k - cbp, 0), max(szp, 0));
        if (take > 0) s.hd(s.me, pp) += take;
        cbp = wadd(cbp, szp);
      }
    }
    __syncthreads();  // every victim has walked its row
    if (k > 0) s.tl(thief, s.me) = tail0 + k;
  }
  s.clock = wadd(s.clock, clock_add);
  bool same_d = s.same_domain(s.me, thief);
  bool same_n = s.same_node(s.me, thief);
  s.bump(C_STOLEN, k);
  s.bump(C_STOLEN_LOCAL, same_d ? k : 0);
  s.bump(C_STOLEN_REMOTE, same_d ? 0 : k);
  s.bump(C_STOLEN_XNODE, same_n ? 0 : k);
  s.bump(C_REQ_HAS_STEAL, vm_ws && k > 0);
  s.bump(C_SRC_EMPTY, src_empty);
  s.bump(C_TGT_FULL, tgt_full);
  // NA-RP: adopt the thief for future redirected pushes (Alg. 3)
  bool vm_rp = valid && s.is_narp();
  bool adopted = vm_rp && s.rp_tgt() < 0;
  if (adopted) {
    s.rp_tgt() = thief;
    s.rp_left() = s.n_steal();
  }
  s.bump(C_REQ_HAS_STEAL, adopted);
  bool handled = vm_ws || vm_rp;
  s.bump(C_REQ_HANDLED, handled);
  if (s.cluster() && !same_n) s.nlink() = wadd(s.nlink(), moved);
  if (handled) s.round()[s.me] += 1;
}

// ---------------- execute ----------------
__device__ __forceinline__ void exec_phase(Sim& s, const Deq& d) {
  const StepArgs& c = *s.a;
  bool found = s.act && d.found;
  int safe = found ? d.task : 0;
  int dur_t = found ? s.dur()[safe] : 0;
  int cr0 = s.act ? s.creator()[safe] : 0;
  bool same_d = s.same_domain(cr0, s.me);
  if (s.mem_bound() > 0.0f) {
    // the NUMA locality penalty, one float32 operation at a time
    int d_cr = s.dist()[s.dom(cr0) * s.DM() + s.dom(s.me)];
    float pen_rem = c.erp;
    if (!s.flat()) {
      float scaled = c.erp_m1 * static_cast<float>(d_cr);
      float frac = scaled / c.c_numa_f;
      pen_rem = 1.0f + frac;
    }
    float pen = cr0 == s.me ? 1.0f : (same_d ? c.ezp : pen_rem);
    float excess = pen - 1.0f;
    float weighted = s.mem_bound() * excess;
    float mult = 1.0f + weighted;
    float prod = static_cast<float>(dur_t) * mult;
    dur_t = static_cast<int>(prod);
  }
  int start = max(s.clock, found ? d.ts : 0);
  if (found) s.clock = wadd(start, dur_t);
  s.bump(C_EXEC, found);
  s.bump(C_SELF, found && cr0 == s.me);
  s.bump(C_LOCAL, found && cr0 != s.me && same_d);
  s.bump(C_REMOTE, found && !same_d);
  s.bump(C_BUSY_NS, dur_t);
  __syncthreads();  // every lane has read creator
  finish(s, found ? d.task : -1);
  atomic_charge(s, found && s.pays_count());
  s.bump(C_ATOMIC_OPS, found && s.is_locked() && s.barrier_id() == 0);
}

// phases.run_gate: incomplete, under the horizon, no overflow, work left
__device__ __forceinline__ bool run_gate(Sim& s) {
  __syncthreads();
  bool work = false;
  if (s.act) {
    work = s.s_top > 0;
    const int* hrow = s.head() + s.me * s.hs();
    const int* trow = s.tail() + s.me * s.hs();
    for (int p0 = 0; p0 < s.W() && !work; p0 += 8) {
#pragma unroll
      for (int d = 0; d < 8; ++d)
        if (p0 + d < s.W()) work |= trow[p0 + d] > hrow[p0 + d];
    }
  }
  bool has_work = __syncthreads_or(work) || *s.g_tail() > *s.g_head();
  bool gate = *s.n_done() < s.n_tasks() && *s.step_i() < s.a->max_steps
              && !*s.overflow() && has_work;
  __syncthreads();
  return gate;
}

// Copy a (rows, cols) block of device memory (rows of `src_stride` words)
// into shared memory (rows of `dst_stride` words) with asynchronous 4-byte
// copies (cp.async): every thread issues all of its words before any
// arrives, so the prologue waits about one load latency, not one per word;
// the caller waits (cp_async_wait) and then synchronises the block.
__device__ void load_rows(int* dst, int dst_stride, const int* src,
                          int src_stride, int rows, int cols) {
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      unsigned d = static_cast<unsigned>(
          __cvta_generic_to_shared(dst + r * dst_stride + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(__cvta_generic_to_global(src + r * src_stride + c)));
    }
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Write a (rows, cols) block of shared memory back to device memory, row
// by row, the threads striding over the columns.
__device__ void store_rows(int* dst, int dst_stride, const int* src,
                           int src_stride, int rows, int cols) {
  for (int r = 0; r < rows; ++r)
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      dst[r * dst_stride + c] = src[r * src_stride + c];
}

// The kernel.  `resident`: the queue heads and tails live in shared memory
// (see ss_run).
template <int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    sched_step_kernel(const __grid_constant__ StepArgs a, bool resident) {
  const int b = blockIdx.x, W = a.W, DM = a.DM;
  Sim s;
  s.a = &a;
  const long long WW = static_cast<long long>(W) * W;
  int* dev_head = a.xq_head + b * WW;
  int* dev_tail = a.xq_tail + b * WW;
  if (threadIdx.x == 0) {
    // the case's scalars and axis masks (phases.axis_masks)
    bool locked = a.queue_id[b] == 0;
    bool narp = a.balance_id[b] == 1, naws = a.balance_id[b] == 2;
    ss_block.flags = (locked ? F_LOCKED : F_XQ)
                     | (!locked && a.barrier_id[b] == 0 ? F_PAYS : 0)
                     | (narp ? F_NARP : 0) | (naws ? F_NAWS : 0)
                     | (narp || naws ? F_DLB : 0) | (a.flat[b] ? F_FLAT : 0)
                     | (a.cluster[b] ? F_CLUSTER : 0)
                     | (a.closed[b] ? F_CLOSED : 0);
    ss_block.n_w = a.n_workers[b];
    ss_block.zsz = a.zone_size[b];
    ss_block.nd = a.n_domains[b];
    // the heads and tails: after the base_words, or in device memory
    ss_block.head = resident ? ss_smem + base_words(W, DM) : dev_head;
    ss_block.tail = resident ? ss_block.head + W * (W + 1) : dev_tail;
    ss_block.hs = resident ? W + 1 : W;
  }
  __syncthreads();
  // this lane
  s.me = threadIdx.x;
  s.act = s.me < W;
  const long long lw = static_cast<long long>(b) * W + (s.act ? s.me : 0);
  s.clock = s.act ? a.clock[lw] : 0;
  s.s_top = s.act ? a.s_top[lw] : 0;
  s.rng = s.act ? static_cast<uint32_t>(a.rng[lw]) : 0u;
  s.rr() = s.act ? a.rr[lw] : 0;
  s.deq_rr() = s.act ? a.deq_rr[lw] : 0;
  s.idle() = s.act ? a.idle[lw] : 0;
  s.rp_tgt() = s.act ? a.rp_tgt[lw] : -1;
  s.rp_left() = s.act ? a.rp_left[lw] : 0;
  s.nlink() = s.act ? a.nlink[lw] : 0;
  if (resident) {
    load_rows(s.head(), W + 1, dev_head, W, W, W);
    load_rows(s.tail(), W + 1, dev_tail, W, W, W);
  }
  load_rows(s.ctr_rows(), NCS, a.ctr + static_cast<long long>(b) * W * NC,
            NC, W, NC);
  load_rows(s.dist(), DM, a.dist + b * DM * DM, DM, DM, DM);
  load_rows(s.bw(), DM, a.bw + b * DM * DM, DM, DM, DM);
  load_rows(s.node(), DM, a.node + b * DM, DM, 1, DM);
  cp_async_wait();
  if (s.act) {
    s.round()[s.me] = a.round[lw];
    s.req_round()[s.me] = a.req_round[lw];
    s.req_tid()[s.me] = a.req_tid[lw];
    s.win()[s.me] = -1;
  }
  if (threadIdx.x == 0) {
    *s.g_head() = a.g_head[b];
    *s.g_tail() = a.g_tail[b];
    *s.n_done() = a.n_done[b];
    *s.overflow() = a.overflow[b];
    *s.step_i() = a.step_i[b];
  }
  __syncthreads();
  if (!s.flat() && s.is_dlb()) wt_build(s);  // uniform across the block

  for (int it = 0; it < a.max_iters; ++it) {
    if (!run_gate(s)) break;
    adopt_phase(s, true);
    __syncthreads();
    spawn_phase(s, true);
    Deq d = dequeue_phase(s, true);
    thief_phase(s, d.found, true);
    __syncthreads();
    victim_phase(s, d.found);
    __syncthreads();
    exec_phase(s, d);
    // the shared inter-node bottleneck: each sender waits out the other
    // senders' occupancy; the ledger resets every step
    int nlink = s.nlink();
    int tot = block_sum(s.act ? nlink : 0, s.wb());
    if (nlink > 0 && s.cluster())
      s.clock = wadd(s.clock, floor_div(tot - nlink, s.bneck_bw()));
    s.bump(C_XNODE_BYTES, nlink);
    s.nlink() = 0;
    if (threadIdx.x == 0) *s.step_i() += 1;
  }

  // the epilogue recomputes the lane index and the device addresses, so
  // that no prologue value stays live (in registers) across the run loop
  __syncthreads();
  if (s.act) {
    const long long l = static_cast<long long>(blockIdx.x) * a.W + s.me;
    a.clock[l] = s.clock;
    a.rr[l] = s.rr();
    a.deq_rr[l] = s.deq_rr();
    a.idle[l] = s.idle();
    a.s_top[l] = s.s_top;
    a.rp_tgt[l] = s.rp_tgt();
    a.rp_left[l] = s.rp_left();
    a.nlink[l] = s.nlink();
    a.rng[l] = static_cast<long long>(s.rng);
    a.round[l] = s.round()[s.me];
    a.req_round[l] = s.req_round()[s.me];
    a.req_tid[l] = s.req_tid()[s.me];
  }
  const int bb = blockIdx.x;
  if (threadIdx.x == 0) {
    a.g_head[bb] = *s.g_head();
    a.g_tail[bb] = *s.g_tail();
    a.n_done[bb] = *s.n_done();
    a.overflow[bb] = static_cast<unsigned char>(*s.overflow() != 0);
    a.step_i[bb] = *s.step_i();
  }
  store_rows(a.ctr + static_cast<long long>(bb) * a.W * NC, NC, s.ctr_rows(),
             NCS, a.W, NC);
  if (resident) {
    const long long ww = static_cast<long long>(bb) * a.W * a.W;
    store_rows(a.xq_head + ww, a.W, s.head(), a.W + 1, a.W, a.W);
    store_rows(a.xq_tail + ww, a.W, s.tail(), a.W + 1, a.W, a.W);
  }
}

// The most dynamic shared memory a block may use on sm_90: 227 KB, less
// room for the static ss_scalar and ss_block.
constexpr size_t SMEM_MAX = 232448 - 64;

// The (W, W) heads and tails, in words.
inline size_t head_tail_words(int W) {
  return 2 * static_cast<size_t>(W) * (W + 1);
}

// Whether a block of W lanes keeps its heads and tails in shared memory:
// whenever they fit beside the rest.
inline bool fits_resident(int W, int DM) {
  return (base_words(W, DM) + head_tail_words(W)) * sizeof(int) <= SMEM_MAX;
}

template <int MAX_THREADS>
int launch(const StepArgs& a, int threads, cudaStream_t stream) {
  bool resident = fits_resident(a.W, a.DM);
  size_t bytes = (base_words(a.W, a.DM)
                  + (resident ? head_tail_words(a.W) : 0)) * sizeof(int);
  // the cap on dynamic shared memory, raised once a device to the most any
  // launch takes (an attribute call a launch is host time on the per-step
  // path).  The attribute belongs to the current device's context, so each
  // device keeps its own bit; a device past the 64th raises it every launch.
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(sched_step_kernel<MAX_THREADS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_MAX));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  sched_step_kernel<MAX_THREADS><<<a.B, threads, bytes, stream>>>(a,
                                                                  resident);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Advance a batch of a.B simulations by up to a.max_iters steps each (one
// block each, stopping when its run gate fails).  W <= 128 takes the
// 128-thread instantiation, larger W the 1024-thread one; the heads and
// tails are resident in shared memory while they fit beside the rest
// (W <= 156 at DM = 8).  Returns cudaGetLastError(); a.W > 1024 or a
// counter width other than NC is refused.
int ss_run(const StepArgs* args, void* stream) {
  const StepArgs& a = *args;
  if (a.B <= 0) return 0;
  if (a.NCTR != NC) return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((a.W + 31) / 32) * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return threads <= 128 ? launch<128>(a, threads, st)
                        : launch<1024>(a, threads, st);
}

// Whether a block of W lanes keeps its heads and tails in shared memory
// (the rule `launch` applies), for the tests and chip_smoke.py.
int ss_resident(int W, int DM) { return fits_resident(W, DM); }

}  // extern "C"
