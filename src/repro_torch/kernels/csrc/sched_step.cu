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
// whole run is one launch with no host round trip.  Per-lane scalars
// (clock, rr, deq_rr, idle, rng, s_top, NA-RP state, link bytes) live in
// registers; the message cells, which thieves read across lanes, and the
// per-simulation scalars live in shared memory; the (W, W, Q) queues, the
// (W, S) spawn stacks and the (T,) task arrays stay in device memory (512
// KiB of queues at W = 64, Q = 16 is over the 227 KB a block may hold).
// Everything a block touches belongs to its own simulation, so no grid-wide
// synchronisation is needed.
//
// What bounds it.  A step touches a few KiB per simulation (per-lane
// vectors, the (W, W) heads and tails the scans read, the slots actually
// moved), and its work is a dependent chain of ~40 block barriers and
// O(W) scans per lane: the kernel is bound by that latency chain, not by
// bytes or integer rate.  This first version is simple and exact; making
// it fast (fewer barriers, warp-level phases for W <= 32) is later work.
//
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
//    lane requests, advancing every lane's xorshift state each round.

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int K_SPAWN = 2;   // state.K_SPAWN
constexpr int WS_CAP = 32;   // state.WS_CAP
constexpr int NV_CAP = 24;   // state.NV_CAP
constexpr int Q_MAX = 64;    // sched_step.Q_MAX

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

// One simulation as one thread sees it: this block's slices of every
// array, the case's scalars, this lane's registers, the shared arrays.
struct Sim {
  const StepArgs* a;
  int W, S, Q, T, GQ, R, DM;
  // device arrays of this simulation
  int *buf, *tsb, *head, *tail, *g_buf, *g_ts, *s_task, *s_cnt, *join_cnt;
  unsigned char* done;
  int *done_ns, *creator, *ctr;  // ctr: this lane's row
  const int *dur, *first_child, *n_children, *notify, *payload, *release;
  const int *dist, *node, *bw;
  // case scalars
  bool is_locked, uses_xq, pays_count, is_narp, is_naws, is_dlb, flat,
      cluster, closed;
  int barrier_id, n_w, zsz, nd, n_victim, n_steal, t_interval, bneck_bw,
      n_tasks;
  float mem_bound, p_local, p_local_node, bw_scale;
  // this lane
  int me;
  bool act;  // a worker lane (me < W)
  int clock, rr, deq_rr, idle, s_top, rp_tgt, rp_left, nlink;
  uint32_t rng;
  // shared memory
  int *round, *req_round, *req_tid, *win, *tmp, *wb;
  int *g_head, *g_tail, *n_done, *overflow, *step_i;

  __device__ void bump(int col, int v) {
    if (act) ctr[col] = wadd(ctr[col], v);
  }
  __device__ int dom(int w) const { return min(floor_div(w, zsz), nd - 1); }
  // phases._comm: lock-less latency of a touching a line owned by b
  __device__ int comm(int x, int y) const {
    if (x == y) return a->c_cache;
    if (flat)
      return floor_div(x, zsz) == floor_div(y, zsz) ? a->c_zone : a->c_numa;
    return dist[dom(x) * DM + dom(y)];
  }
  // phases._xfer: the D/B payload term
  __device__ int xfer(int x, int y, int nbytes) const {
    if (!cluster || x == y) return 0;
    return floor_div(nbytes, max(bw[dom(x) * DM + dom(y)], 1));
  }
  __device__ int comm_sz(int x, int y, int nbytes) const {
    return wadd(comm(x, y), xfer(x, y, nbytes));
  }
  __device__ bool same_domain(int x, int y) const {
    return flat ? floor_div(x, zsz) == floor_div(y, zsz) : dom(x) == dom(y);
  }
  __device__ bool same_node(int x, int y) const {
    return !cluster || node[dom(x)] == node[dom(y)];
  }
};

// ---------------- completion bookkeeping (phases._finish) ----------------
__device__ void stack_push(Sim& s, bool mask, int task0, int cnt) {
  bool fits = mask && s.s_top < s.S;
  if (fits) {
    s.s_task[s.me * s.S + s.s_top] = task0;
    s.s_cnt[s.me * s.S + s.s_top] = cnt;
    s.s_top += 1;
  } else if (mask) {
    *s.overflow = 1;  // every writer writes the same value
  }
}

__device__ void finish(Sim& s, int ftask) {
  bool active = s.act && ftask >= 0 && ftask < s.T;
  if (active) {
    s.done[ftask] = 1;
    s.done_ns[ftask] = max(s.done_ns[ftask], s.clock);
  }
  int nact = __syncthreads_count(active);
  if (threadIdx.x == 0) *s.n_done = wadd(*s.n_done, nact);
  int nch = active ? s.n_children[ftask] : 0;
  stack_push(s, nch > 0, active ? s.first_child[ftask] : 0, nch);
  // notify joins; duplicate targets accumulate
  int j = active ? s.notify[ftask] : -1;
  if (j >= 0 && j < s.T) atomicSub(&s.join_cnt[j], 1);
  __syncthreads();
  bool newly = j >= 0 && j < s.T && s.join_cnt[j] == 0;
  if (__syncthreads_or(newly)) {
    // the lowest lane completing a join claims it
    if (s.act) s.tmp[s.me] = newly ? j : -1;
    __syncthreads();
    bool mine = newly;
    for (int k = 0; mine && k < s.me; ++k) mine = s.tmp[k] != j;
    if (mine) s.creator[j] = s.me;
    stack_push(s, mine, j, 1);
    __syncthreads();
  }
}

// phases._atomic_charge: the k-th simultaneous writer pays k hand-offs
__device__ void atomic_charge(Sim& s, bool mask) {
  int tot;
  int rank = excl_count(mask, &tot, s.wb);
  if (mask)
    s.clock = wadd(s.clock, wadd(s.a->c_atomic, wmul(rank, s.a->c_contend)));
  s.bump(C_ATOMIC_OPS, mask);
}

// ---------------- adopt (NA-RP spawners adopt a thief pre-push) ----------
__device__ void adopt_phase(Sim& s, bool running) {
  bool spawner = s.act && s.s_top > 0 && s.is_narp && running;
  bool valid0 = spawner && s.req_round[s.me] == s.round[s.me];
  if (valid0 && s.rp_tgt < 0) {
    s.rp_tgt = max(s.req_tid[s.me], 0);
    s.rp_left = s.n_steal;
  }
  if (valid0) s.round[s.me] += 1;
  s.bump(C_REQ_HANDLED, valid0);
}

// ---------------- spawn (push up to K_SPAWN spawned tasks) ----------------
__device__ void spawn_phase(Sim& s, bool running) {
  const StepArgs& c = *s.a;
  for (int it = 0; it < K_SPAWN; ++it) {
    bool avail = s.act && s.s_top > 0 && running;
    int topi = max(s.s_top - 1, 0);
    int etask = s.act ? s.s_task[s.me * s.S + topi] : 0;
    int ecnt = s.act ? s.s_cnt[s.me * s.S + topi] : 0;
    int rel = s.release[min(max(etask, 0), s.R - 1)];
    bool released = s.closed || s.clock >= rel;
    bool active = avail && released;
    if (avail && !released) s.clock = rel;  // sleep to the release stamp
    int task = active ? etask : 0;

    // GOMP lane: serialized global-lock push
    bool act_g = active && s.is_locked;
    int n_g;
    int g_tail0 = *s.g_tail;
    int rank_g = excl_count(act_g, &n_g, s.wb);
    int cost_g = act_g ? wadd(c.c_atomic + c.c_pq_op + c.c_alloc,
                              wmul(rank_g, c.c_lock))
                       : 0;
    // XQueue lane, with NA-RP redirection
    bool act_x = active && s.uses_xq;
    bool use_rp = act_x && s.is_narp && s.rp_tgt >= 0 && s.rp_left > 0;
    int tgt = use_rp ? max(s.rp_tgt, 0) : floor_mod(s.rr, s.n_w);
    int pay = act_x ? s.payload[task] : 0;
    int cost_x = act_x ? wadd(c.c_alloc + c.c_slot, s.comm_sz(s.me, tgt, pay))
                       : 0;
    s.clock = wadd(wadd(s.clock, cost_g), cost_x);
    // a wrapped slot goes to the highest rank writing it
    if (act_g && rank_g + s.GQ >= n_g) {
      int gi = floor_mod(wadd(g_tail0, rank_g), s.GQ);
      s.g_buf[gi] = task;
      s.g_ts[gi] = s.clock;
    }
    __syncthreads();  // every lane has read g_tail
    if (threadIdx.x == 0) *s.g_tail = wadd(g_tail0, n_g);
    // SPSC push into queue (tgt, me): this lane owns producer column me
    bool ok = false;
    if (act_x) {
      int q = tgt * s.W + s.me;
      int t = s.tail[q];
      if (t - s.head[q] < s.Q) {
        int sl = floor_mod(t, s.Q);
        s.buf[q * s.Q + sl] = task;
        s.tsb[q * s.Q + sl] = s.clock;
        s.tail[q] = t + 1;
        ok = true;
      }
    }
    bool imm = act_x && !ok;
    if (act_x && !use_rp) s.rr += 1;
    if (active) s.creator[task] = s.me;
    s.bump(C_STATIC_PUSH, act_g || (ok && !use_rp));
    s.bump(C_ATOMIC_OPS, act_g);
    bool okrp = ok && use_rp;
    bool same_d = s.same_domain(s.me, tgt);
    s.bump(C_STOLEN, okrp);
    s.bump(C_STOLEN_LOCAL, okrp && same_d);
    s.bump(C_STOLEN_REMOTE, okrp && !same_d);
    s.bump(C_STOLEN_XNODE, okrp && !s.same_node(s.me, tgt));
    // Alg. 3: stop on quota exhausted or thief queue full (every lane)
    int left = s.rp_left - (okrp ? 1 : 0);
    bool drop = (use_rp && !ok) || left <= 0;
    s.rp_tgt = drop ? -1 : s.rp_tgt;
    s.rp_left = drop ? 0 : left;
    s.bump(C_TGT_FULL, use_rp && !ok);
    if (act_x && s.cluster && !s.same_node(s.me, tgt))
      s.nlink = wadd(s.nlink, pay);
    atomic_charge(s, active && s.pays_count);
    // consume one task from the range entry
    if (active) {
      s.s_task[s.me * s.S + topi] = etask + 1;
      s.s_cnt[s.me * s.S + topi] = ecnt - 1;
      if (ecnt - 1 == 0) s.s_top -= 1;
    }
    // execute-immediately rule for full target queues
    if (__syncthreads_or(imm)) {
      int dur_t = imm ? s.dur[task] : 0;
      s.bump(C_IMM_EXEC, imm);
      s.bump(C_EXEC, imm);
      s.bump(C_SELF, imm);
      s.bump(C_BUSY_NS, dur_t);
      s.clock = wadd(s.clock, dur_t);
      finish(s, imm ? task : -1);
      atomic_charge(s, imm && s.pays_count);
    }
    __syncthreads();
  }
}

// ---------------- dequeue (global queue, or the rotated XQueue scan) -------
struct Deq {
  int task, ts;
  bool found;
};

__device__ Deq dequeue_phase(Sim& s, bool running) {
  const StepArgs& c = *s.a;
  bool idle_m = s.act && s.s_top == 0 && s.me < s.n_w && running;
  // GOMP lane: contended pops off the single global queue
  bool idle_g = idle_m && s.is_locked;
  int g_head0 = *s.g_head;
  int avail = *s.g_tail - g_head0;
  int n_idle;
  int rank = excl_count(idle_g, &n_idle, s.wb);
  bool found_g = idle_g && rank < avail;
  int task_g = 0, ts_g = 0;
  if (found_g) {
    int gi = floor_mod(wadd(g_head0, rank), s.GQ);
    task_g = s.g_buf[gi];
    ts_g = s.g_ts[gi];
  }
  int nf = __syncthreads_count(found_g);  // every lane has read g_head
  if (threadIdx.x == 0) *s.g_head = wadd(g_head0, nf);
  int cost_g = idle_g ? wadd(c.c_atomic + c.c_pq_op, wmul(rank, c.c_lock)) : 0;
  s.bump(C_ATOMIC_OPS, idle_g);
  // XQueue lane: master queue first, then the others rotated by deq_rr
  // (xqueue.pop_compute); this lane owns consumer row me
  bool idle_x = idle_m && s.uses_xq;
  bool found_x = false;
  int task_x = 0, ts_x = 0, cost_x = 0;
  if (idle_x) {
    int n_act = max(s.n_w, 1), nm1 = max(s.n_w - 1, 1);
    int best = INT_MAX, best_p = 0;
    const int* hrow = s.head + s.me * s.W;
    const int* trow = s.tail + s.me * s.W;
    for (int p = 0; p < s.W; ++p) {
      int pos = p == s.me
                    ? 0
                    : 1 + floor_mod(floor_mod(p - s.me - 1, n_act) - s.deq_rr,
                                    nm1);
      bool cand = trow[p] - hrow[p] > 0 && p < n_act;
      int pm = cand ? pos : s.W + 1;
      if (pm < best) {  // strict: the lowest producer wins ties (argmin)
        best = pm;
        best_p = p;
      }
    }
    found_x = best <= s.W;
    int src = found_x ? best_p : s.me;
    int checked = found_x ? best + 1 : s.n_w;
    cost_x = wmul(checked, c.c_cache);
    if (found_x) {
      int q = s.me * s.W + src;
      int h = s.head[q];
      int sl = floor_mod(h, s.Q);
      task_x = s.buf[q * s.Q + sl];
      ts_x = s.tsb[q * s.Q + sl];
      s.head[q] = h + 1;
      int pay_x = s.payload[task_x];
      cost_x = wadd(cost_x, s.comm_sz(s.me, src, pay_x));
      if (src != s.me) s.deq_rr += 1;
      if (s.cluster && !s.same_node(s.me, src)) s.nlink = wadd(s.nlink, pay_x);
    }
  }
  s.clock = wadd(wadd(s.clock, cost_g), cost_x);
  __syncthreads();
  Deq d;
  d.task = s.is_locked ? task_g : task_x;
  d.ts = s.is_locked ? ts_g : ts_x;
  d.found = found_g || found_x;
  return d;
}

// ---------------- thief protocol (Alg. 1) ----------------
// dlb.remote_weight_table for one thief row, folded: the candidate test,
// then the row's max distance and total weight (draw-independent)
struct WTab {
  int restrict_to;  // 0 any remote, 1 same node, 2 other nodes
  int dmax, total;
};

__device__ bool wt_cand(const Sim& s, int dom_me, int j, int restrict_to,
                        int* d) {
  int dom_j = min(floor_div(j, s.zsz), s.nd - 1);
  *d = s.dist[dom_me * s.DM + dom_j];
  bool remote = j < s.n_w && dom_j != dom_me;
  if (restrict_to == 1) remote = remote && s.node[dom_me] == s.node[dom_j];
  if (restrict_to == 2) remote = remote && s.node[dom_me] != s.node[dom_j];
  return remote;
}

__device__ WTab wt_build(const Sim& s, int restrict_to) {
  int dom_me = min(floor_div(s.me, s.zsz), s.nd - 1);
  WTab t{restrict_to, 0, 0};
  int d;
  for (int j = 0; j < s.W; ++j)
    if (wt_cand(s, dom_me, j, restrict_to, &d)) t.dmax = max(t.dmax, d);
  for (int j = 0; j < s.W; ++j)
    if (wt_cand(s, dom_me, j, restrict_to, &d))
      t.total = wadd(t.total, t.dmax - d + 1);
  return t;
}

// dlb._remote_weighted: the first lane whose cumulative weight exceeds
// draw % total (clipped to the last lane)
__device__ int wt_pick(const Sim& s, const WTab& t, int draw) {
  int r = draw % max(t.total, 1);
  int dom_me = min(floor_div(s.me, s.zsz), s.nd - 1);
  int cum = 0, cnt = 0, d;
  for (int j = 0; j < s.W; ++j) {
    if (wt_cand(s, dom_me, j, t.restrict_to, &d)) cum = wadd(cum, t.dmax - d + 1);
    if (cum > r) break;
    ++cnt;
  }
  return min(cnt, s.W - 1);
}

// dlb.pick_victim: two xorshifts, one uniform, one draw; every path
__device__ int pick_victim(Sim& s, const WTab* tabs) {
  s.rng = xorshift(s.rng);
  float u = static_cast<float>(s.rng >> 8) * (1.0f / 16777216.0f);
  bool want_local = u < s.p_local;
  s.rng = xorshift(s.rng);
  int draw = static_cast<int>(s.rng >> 1);
  int Wn = s.n_w, Z = s.zsz, me = s.me;
  int zbase = floor_div(me, Z) * Z;
  int off_l = draw % max(Z - 1, 1);
  int local = zbase + off_l + (off_l >= me - zbase ? 1 : 0);
  int off_r = draw % max(Wn - Z, 1);
  int remote = off_r >= zbase ? off_r + Z : off_r;
  bool has_local = Z > 1, has_remote = Wn > Z;
  if (!s.flat) {
    int dom_me = min(floor_div(me, Z), s.nd - 1);
    int start = dom_me * Z;
    int end = dom_me == s.nd - 1 ? Wn : (dom_me + 1) * Z;
    int size = end - start;
    int off_h = draw % max(size - 1, 1);
    local = start + off_h + (off_h >= me - start ? 1 : 0);
    int remote_h = wt_pick(s, tabs[0], draw);
    bool has_remote_h = tabs[0].total > 0;
    if (s.cluster) {
      int nl_v = wt_pick(s, tabs[1], draw), nr_v = wt_pick(s, tabs[2], draw);
      bool has_nl = tabs[1].total > 0, has_nr = tabs[2].total > 0;
      // one float32 operation at a time (built with --fmad=false)
      float pn_eff = s.p_local_node;
      if (s.bw_scale < 1.0f) {
        float keep = 1.0f - s.p_local_node;
        float scaled = keep * s.bw_scale;
        pn_eff = 1.0f - scaled;
      }
      float rest = 1.0f - s.p_local;
      float node_part = rest * pn_eff;
      float bound = s.p_local + node_part;
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

__device__ void thief_phase(Sim& s, bool found, bool running) {
  const StepArgs& c = *s.a;
  bool thief_m = s.act && s.s_top == 0 && !found && s.me < s.n_w && s.is_dlb
                 && running;
  int idle = thief_m ? s.idle + 1 : 0;
  bool do_req = thief_m && (idle == 1 || idle >= s.t_interval);
  s.idle = idle >= s.t_interval ? 0 : idle;
  int rounds = __syncthreads_or(do_req) ? min(NV_CAP, s.n_victim) : 0;
  if (rounds <= 0) return;
  WTab tabs[3] = {{0, 0, 0}, {1, 0, 0}, {2, 0, 0}};
  if (s.act && !s.flat) {
    tabs[0] = wt_build(s, 0);
    if (s.cluster) {
      tabs[1] = wt_build(s, 1);
      tabs[2] = wt_build(s, 2);
    }
  }
  int n_sent = 0, nl = 0;
  for (int v = 0; v < rounds; ++v) {
    bool sm = do_req && v < s.n_victim;
    int victim = s.act ? pick_victim(s, tabs) : 0;
    int vs = min(max(victim, 0), s.W - 1);
    bool sent = sm && s.req_round[vs] < s.round[vs];
    __syncthreads();  // every thief has read the request cells
    // racy request writes: the highest thief lane wins (last_writer)
    if (sent && victim >= 0 && victim < s.W) atomicMax(&s.win[victim], s.me);
    __syncthreads();
    if (s.act && s.win[s.me] >= 0) {
      s.req_round[s.me] = s.round[s.me];
      s.req_tid[s.me] = s.win[s.me];
      s.win[s.me] = -1;
    }
    __syncthreads();
    if (s.act) {
      int c1 = s.comm_sz(s.me, victim, c.req_bytes);
      int add = wadd(sm ? wmul(2, c1) : 0, sent ? c1 : 0);
      s.clock = wadd(s.clock, add);
      int msgs = (sm ? 2 : 0) + (sent ? 1 : 0);
      if (sm && s.cluster && !s.same_node(s.me, victim))
        nl = wadd(nl, wmul(msgs, c.req_bytes));
      n_sent += sent;
    }
  }
  s.bump(C_REQ_SENT, n_sent);
  s.nlink = wadd(s.nlink, nl);
}

// ---------------- victim (NA-WS bulk transfer, NA-RP adoption) -----------
__device__ void victim_phase(Sim& s, bool found) {
  bool valid = s.act && found && s.req_round[s.me] == s.round[s.me];
  int thief = s.act ? max(s.req_tid[s.me], 0) : 0;
  bool vm_ws = valid && s.is_naws;
  int k = 0, tail0 = 0, clock_add = 0, moved = 0, n_take = 0;
  bool src_empty = false, tgt_full = false;
  int task_r[Q_MAX], pts_r[Q_MAX];
  int take_p[Q_MAX], take_n[Q_MAX];
  if (__syncthreads_or(vm_ws)) {
    // read part: this victim's queues as they stood before the phase
    if (vm_ws) {
      int comm_c = s.comm(s.me, thief);
      int xfer_bw = (s.cluster && s.me != thief)
                        ? s.bw[s.dom(s.me) * s.DM + s.dom(thief)]
                        : 0;
      int ns = min(s.n_steal, WS_CAP);
      int n_act = max(s.n_w, 1), nm1 = max(s.n_w - 1, 1);
      int rot = s.deq_rr;
      const int* hrow = s.head + s.me * s.W;
      const int* trow = s.tail + s.me * s.W;
      // xqueue._scan_order: position i -> producer, and its valid size
      auto order = [&](int i) {
        return i == 0 ? s.me
                      : floor_mod(s.me + 1 + floor_mod(rot + (i - 1), nm1),
                                  n_act);
      };
      auto szord = [&](int i) {
        if (i != 0 && !(i - 1 < s.n_w - 1)) return 0;
        int p = order(i);
        return trow[p] - hrow[p];
      };
      int avail = 0;
      for (int i = 0; i < s.W; ++i) avail = wadd(avail, szord(i));
      int qt = thief * s.W + s.me;
      tail0 = s.tail[qt];
      int free0 = s.Q - (tail0 - s.head[qt]);
      k = max(min(ns, min(avail, free0)), 0);
      // the r-th moved task is the r-th element of the scan-order
      // concatenation; cost and window over all Q candidates
      int window = wmul(ns, comm_c);
      int i = 0, cb = 0, cum = szord(0), before = 0, k_win = 0;
      int cost_r[Q_MAX], pay_r[Q_MAX];
      for (int r = 0; r < s.Q; ++r) {
        while (i < s.W - 1 && cum <= r) {
          ++i;
          cb = cum;
          cum = wadd(cb, szord(i));
        }
        int q = s.me * s.W + order(i);
        int slot = floor_mod(wadd(s.head[q], r - cb), s.Q);
        int tr = s.buf[q * s.Q + slot];
        int tsr = s.tsb[q * s.Q + slot];
        // an empty slot holds -1, which indexes the last task (as in JAX)
        int pi = tr < 0 ? tr + s.T : tr;
        int pay = s.payload[min(max(pi, 0), s.T - 1)];
        int cost = wadd(comm_c,
                        xfer_bw > 0 ? floor_div(pay, max(xfer_bw, 1)) : 0);
        if (r < k && wadd(before, cost) <= window) ++k_win;
        task_r[r] = tr;
        pts_r[r] = wadd(max(wadd(s.clock, before), tsr), cost);
        cost_r[r] = cost;
        pay_r[r] = pay;
        before = wadd(before, cost);
      }
      int k_full = k;
      if (xfer_bw > 0) k = k_win;
      bool windowed = k < k_full;
      bool can_more = k < ns && !windowed;
      tgt_full = can_more && k == free0;
      src_empty = can_more && free0 > k && k == avail;
      for (int r = 0; r < k; ++r) {
        clock_add = wadd(clock_add, cost_r[r]);
        if (xfer_bw > 0) moved = wadd(moved, pay_r[r]);
      }
      // per-source takes: a waterfall over the scan order (the inverse of
      // xqueue.scan_pos over the live producers)
      int cbp = 0;
      for (int ip = 0; ip < min(n_act, s.W) && cbp < k; ++ip) {
        int sz = szord(ip);
        int take = min(max(k - cbp, 0), max(sz, 0));
        if (take > 0) {
          take_p[n_take] = order(ip);
          take_n[n_take] = take;
          ++n_take;
        }
        cbp = wadd(cbp, sz);
      }
    }
    __syncthreads();  // every victim has read before any writes
    if (k > 0) {
      int qt = thief * s.W + s.me;
      for (int r = 0; r < k; ++r) {
        int sl = floor_mod(tail0 + r, s.Q);
        s.buf[qt * s.Q + sl] = task_r[r];
        s.tsb[qt * s.Q + sl] = pts_r[r];
      }
      s.tail[qt] = tail0 + k;
      for (int t = 0; t < n_take; ++t)
        s.head[s.me * s.W + take_p[t]] += take_n[t];
    }
    __syncthreads();
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
  bool vm_rp = valid && s.is_narp;
  bool adopted = vm_rp && s.rp_tgt < 0;
  if (adopted) {
    s.rp_tgt = thief;
    s.rp_left = s.n_steal;
  }
  s.bump(C_REQ_HAS_STEAL, adopted);
  bool handled = vm_ws || vm_rp;
  s.bump(C_REQ_HANDLED, handled);
  if (s.cluster && !same_n) s.nlink = wadd(s.nlink, moved);
  if (handled) s.round[s.me] += 1;
}

// ---------------- execute ----------------
__device__ void exec_phase(Sim& s, const Deq& d) {
  const StepArgs& c = *s.a;
  bool found = s.act && d.found;
  int safe = found ? d.task : 0;
  int dur_t = found ? s.dur[safe] : 0;
  int cr0 = s.act ? s.creator[safe] : 0;
  bool same_d = s.same_domain(cr0, s.me);
  if (s.mem_bound > 0.0f) {
    // the NUMA locality penalty, one float32 operation at a time
    int d_cr = s.dist[s.dom(cr0) * s.DM + s.dom(s.me)];
    float pen_rem = c.erp;
    if (!s.flat) {
      float scaled = c.erp_m1 * static_cast<float>(d_cr);
      float frac = scaled / c.c_numa_f;
      pen_rem = 1.0f + frac;
    }
    float pen = cr0 == s.me ? 1.0f : (same_d ? c.ezp : pen_rem);
    float excess = pen - 1.0f;
    float weighted = s.mem_bound * excess;
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
  atomic_charge(s, found && s.pays_count);
  s.bump(C_ATOMIC_OPS, found && s.is_locked && s.barrier_id == 0);
}

// phases.run_gate: incomplete, under the horizon, no overflow, work left
__device__ bool run_gate(Sim& s) {
  __syncthreads();
  bool work = false;
  if (s.act) {
    work = s.s_top > 0;
    const int* hrow = s.head + s.me * s.W;
    const int* trow = s.tail + s.me * s.W;
    for (int p = 0; p < s.W && !work; ++p) work = trow[p] > hrow[p];
  }
  bool has_work = __syncthreads_or(work) || *s.g_tail > *s.g_head;
  bool gate = *s.n_done < s.n_tasks && *s.step_i < s.a->max_steps
              && !*s.overflow && has_work;
  __syncthreads();
  return gate;
}

__global__ void __launch_bounds__(1024)
    sched_step_kernel(const StepArgs args) {
  extern __shared__ int smem[];
  __shared__ int sh_scalar[5];  // g_head, g_tail, n_done, overflow, step_i
  const StepArgs& a = args;
  const int b = blockIdx.x, W = a.W;
  Sim s;
  s.a = &a;
  s.W = W;
  s.S = a.S;
  s.Q = a.Q;
  s.T = a.T;
  s.GQ = a.GQ;
  s.R = a.R;
  s.DM = a.DM;
  const long long WW = static_cast<long long>(W) * W;
  s.buf = a.xq_buf + b * WW * a.Q;
  s.tsb = a.xq_ts + b * WW * a.Q;
  s.head = a.xq_head + b * WW;
  s.tail = a.xq_tail + b * WW;
  s.g_buf = a.g_buf + b * a.GQ;
  s.g_ts = a.g_ts + b * a.GQ;
  s.s_task = a.s_task + static_cast<long long>(b) * W * a.S;
  s.s_cnt = a.s_cnt + static_cast<long long>(b) * W * a.S;
  s.join_cnt = a.join_cnt + b * a.T;
  s.done = a.done + b * a.T;
  s.done_ns = a.done_ns + b * a.T;
  s.creator = a.creator + b * a.T;
  s.dur = a.dur + b * a.T;
  s.first_child = a.first_child + b * a.T;
  s.n_children = a.n_children + b * a.T;
  s.notify = a.notify + b * a.T;
  s.payload = a.payload + b * a.T;
  s.release = a.release_ns + b * a.R;
  s.dist = a.dist + b * a.DM * a.DM;
  s.node = a.node + b * a.DM;
  s.bw = a.bw + b * a.DM * a.DM;
  // the case's scalars and axis masks (phases.axis_masks)
  s.is_locked = a.queue_id[b] == 0;
  s.uses_xq = !s.is_locked;
  s.barrier_id = a.barrier_id[b];
  s.pays_count = s.uses_xq && s.barrier_id == 0;
  s.is_narp = a.balance_id[b] == 1;
  s.is_naws = a.balance_id[b] == 2;
  s.is_dlb = s.is_narp || s.is_naws;
  s.n_w = a.n_workers[b];
  s.zsz = a.zone_size[b];
  s.mem_bound = a.mem_bound[b];
  s.n_victim = a.n_victim[b];
  s.n_steal = a.n_steal[b];
  s.t_interval = a.t_interval[b];
  s.p_local = a.p_local[b];
  s.p_local_node = a.p_local_node[b];
  s.nd = a.n_domains[b];
  s.flat = a.flat[b] != 0;
  s.cluster = a.cluster[b] != 0;
  s.bneck_bw = a.bneck_bw[b];
  s.bw_scale = a.bw_scale[b];
  s.closed = a.closed[b] != 0;
  s.n_tasks = a.n_tasks[b];
  // this lane
  s.me = threadIdx.x;
  s.act = s.me < W;
  const long long lw = static_cast<long long>(b) * W + (s.act ? s.me : 0);
  s.ctr = a.ctr + lw * a.NCTR;
  s.clock = s.act ? a.clock[lw] : 0;
  s.rr = s.act ? a.rr[lw] : 0;
  s.deq_rr = s.act ? a.deq_rr[lw] : 0;
  s.idle = s.act ? a.idle[lw] : 0;
  s.s_top = s.act ? a.s_top[lw] : 0;
  s.rp_tgt = s.act ? a.rp_tgt[lw] : -1;
  s.rp_left = s.act ? a.rp_left[lw] : 0;
  s.nlink = s.act ? a.nlink[lw] : 0;
  s.rng = s.act ? static_cast<uint32_t>(a.rng[lw]) : 0u;
  // shared memory: the message cells, the winner and claim scratch
  s.round = smem;
  s.req_round = smem + W;
  s.req_tid = smem + 2 * W;
  s.win = smem + 3 * W;
  s.tmp = smem + 4 * W;
  s.wb = smem + 5 * W;
  s.g_head = sh_scalar;
  s.g_tail = sh_scalar + 1;
  s.n_done = sh_scalar + 2;
  s.overflow = sh_scalar + 3;
  s.step_i = sh_scalar + 4;
  if (s.act) {
    s.round[s.me] = a.round[lw];
    s.req_round[s.me] = a.req_round[lw];
    s.req_tid[s.me] = a.req_tid[lw];
    s.win[s.me] = -1;
  }
  if (threadIdx.x == 0) {
    *s.g_head = a.g_head[b];
    *s.g_tail = a.g_tail[b];
    *s.n_done = a.n_done[b];
    *s.overflow = a.overflow[b];
    *s.step_i = a.step_i[b];
  }

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
    int tot = block_sum(s.act ? s.nlink : 0, s.wb);
    if (s.nlink > 0 && s.cluster)
      s.clock = wadd(s.clock, floor_div(tot - s.nlink, s.bneck_bw));
    s.bump(C_XNODE_BYTES, s.nlink);
    s.nlink = 0;
    if (threadIdx.x == 0) *s.step_i += 1;
  }

  __syncthreads();
  if (s.act) {
    a.clock[lw] = s.clock;
    a.rr[lw] = s.rr;
    a.deq_rr[lw] = s.deq_rr;
    a.idle[lw] = s.idle;
    a.s_top[lw] = s.s_top;
    a.rp_tgt[lw] = s.rp_tgt;
    a.rp_left[lw] = s.rp_left;
    a.nlink[lw] = s.nlink;
    a.rng[lw] = static_cast<long long>(s.rng);
    a.round[lw] = s.round[s.me];
    a.req_round[lw] = s.req_round[s.me];
    a.req_tid[lw] = s.req_tid[s.me];
  }
  if (threadIdx.x == 0) {
    a.g_head[b] = *s.g_head;
    a.g_tail[b] = *s.g_tail;
    a.n_done[b] = *s.n_done;
    a.overflow[b] = static_cast<unsigned char>(*s.overflow != 0);
    a.step_i[b] = *s.step_i;
  }
}

}  // namespace

extern "C" {

// Advance a batch of a.B simulations by up to a.max_iters steps each (one
// block each, stopping when its run gate fails).  Returns
// cudaGetLastError(); a.W > 1024 is refused by the launch itself.
int ss_run(StepArgs a, void* stream) {
  if (a.B <= 0) return 0;
  int threads = ((a.W + 31) / 32) * 32;
  size_t shared = static_cast<size_t>(5 * a.W + 32) * sizeof(int);
  sched_step_kernel<<<a.B, threads, shared,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
