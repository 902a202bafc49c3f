"""Phase layer: the scheduler step as six plain functions on tensors.

The paper's runtime does five orthogonal things per scheduling point —
push spawned tasks, dequeue, run the thief protocol, answer steal requests
as a victim, and execute — over the XQueue / messaging-cell / DLB state,
plus NA-RP's pre-push adoption.  Each is a ``(state, case, …) -> state``
function here, the same phases in the same order as the JAX package's
``repro.core.phases``, so every phase can be held against its counterpart
bitwise.  All spec branching is mask arithmetic over the case's axis-id
tensors; padded lanes (``>= case.n_workers``) never change.

Queue-touching inner kernels are pluggable: every phase takes a
:class:`StepOps` bundle — the XQueue push / pop-scan and the counter bump —
so a backend (:mod:`repro_torch.core.backends`) swaps the plain PyTorch
versions for the CUDA kernels of :mod:`repro_torch.kernels.sched_queue`
without touching phase logic.  The CUDA ops update ``xq`` and ``ctr`` in
place; no phase reads a queue or counter tensor from before an op that
replaced it, so in-place and functional ops give the same result.

Where the JAX package writes with ``mode="drop"`` (out-of-range index =
no write), the port writes through a sink slot past the end or a mask.
Its data-dependent ``while_loop``s (the execute-immediately rule, the join
claim, the thief retry, the NA-WS transfer) are Python loops on
``bool(tensor.any())`` with the same one-shot and retry semantics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import dlb, messaging, xqueue
from repro_torch.core import topology as topology_mod
from repro_torch.core.costs import CostModel
from repro_torch.core.state import (CTR, K_SPAWN, NV_CAP, WS_CAP,
                                    GraphArrays, SimState, SweepCase)

I32 = torch.int32


#: the most ``(column, value)`` pairs one ``StepOps.ctr_add`` call takes
CTR_PAIRS_MAX = 16


class StepOps(NamedTuple):
    """The pluggable inner kernels of the step body (a backend's identity).

    ``push``/``pop_first`` carry :func:`xqueue.push` /
    :func:`xqueue.pop_first` signatures; ``ctr_add(ctr, col, val)`` adds the
    (W,) int32 or bool ``val`` into counter column ``col``, and
    ``ctr_add(ctr, pairs)`` adds each ``(col, val)`` of a sequence of up to
    :data:`CTR_PAIRS_MAX` pairs in order (:func:`ctr_add_ref`).
    Implementations must be bitwise identical to the plain versions.
    """
    name: str
    push: Callable
    pop_first: Callable
    ctr_add: Callable


def ctr_pairs(col_or_pairs, val=None) -> tuple:
    """The ``(column, value)`` pairs of a ``ctr_add`` call: the one pair
    ``(col, val)``, or a sequence of pairs when ``val`` is left out."""
    pairs = (((col_or_pairs, val),) if val is not None
             else tuple(col_or_pairs))
    if not 1 <= len(pairs) <= CTR_PAIRS_MAX:
        raise TypeError(f"ctr_add takes 1 to {CTR_PAIRS_MAX} (col, val) "
                        f"pairs, got {len(pairs)}")
    return pairs


def ctr_add_ref(ctr: torch.Tensor, col_or_pairs, val=None) -> torch.Tensor:
    """Plain ``ctr[:, col] += val`` for one pair, or for each ``(col,
    val)`` pair of a sequence in order: bools add 0 or 1, int32 sums wrap
    (functional: clones ``ctr`` once and returns the clone)."""
    out = ctr.clone()
    for col, v in ctr_pairs(col_or_pairs, val):
        out[:, col] += v
    return out


#: the plain PyTorch kernels
REFERENCE_OPS = StepOps(name="reference", push=xqueue.push,
                        pop_first=xqueue.pop_first, ctr_add=ctr_add_ref)


class AxisMasks(NamedTuple):
    """Per-axis feature gates derived from a case's axis-id tensors."""
    is_locked: torch.Tensor   # locked_global queue lane
    uses_xq: torch.Tensor     # xqueue lane
    pays_count: torch.Tensor  # pays the centralized barrier's atomic count
    is_narp: torch.Tensor
    is_naws: torch.Tensor
    is_dlb: torch.Tensor


def axis_masks(case: SweepCase) -> AxisMasks:
    """Bool scalars selecting each lattice axis's machinery.  The
    centralized barrier's global task count is a separate contended atomic
    only for xqueue runtimes — under the locked_global queue the count
    update rides the already-held task lock."""
    is_locked = case.queue_id == 0
    uses_xq = ~is_locked
    pays_count = uses_xq & (case.barrier_id == 0)
    is_narp = case.balance_id == 1
    is_naws = case.balance_id == 2
    return AxisMasks(is_locked=is_locked, uses_xq=uses_xq,
                     pays_count=pays_count, is_narp=is_narp,
                     is_naws=is_naws, is_dlb=is_narp | is_naws)


def _me(st: SimState) -> torch.Tensor:
    return torch.arange(st.s_top.shape[0], dtype=I32, device=st.clock.device)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=I32)


def _dom(w, case: SweepCase) -> torch.Tensor:
    return topology_mod.domain_of(w, case.zone_size,
                                  case.topo.n_domains).long()


def _comm(costs: CostModel, a, b, case: SweepCase) -> torch.Tensor:
    """Lock-less latency of worker ``a`` touching a line owned by ``b``:
    the two-level ``c_zone``/``c_numa`` model on the flat machine, a
    distance-matrix lookup between NUMA domains otherwise."""
    t = case.topo
    zsz = case.zone_size
    same = a == b
    same_zone = (a // zsz) == (b // zsz)
    legacy = torch.where(same_zone, costs.c_zone, costs.c_numa)
    hier = t.dist[_dom(a, case), _dom(b, case)]
    return torch.where(same, costs.c_cache,
                       torch.where(t.flat, legacy, hier)).to(I32)


def _same_domain(a, b, case: SweepCase) -> torch.Tensor:
    """Do workers ``a`` and ``b`` share a NUMA domain?  Flat machines use
    the raw zone grid; hierarchical ones the *clipped* domain ids."""
    zsz = case.zone_size
    flat_eq = (a // zsz) == (b // zsz)
    hier_eq = _dom(a, case) == _dom(b, case)
    return torch.where(case.topo.flat, flat_eq, hier_eq)


def _same_node(a, b, case: SweepCase) -> torch.Tensor:
    """Do workers ``a`` and ``b`` share a *node*?  True off-cluster."""
    t = case.topo
    na = t.node[_dom(a, case)]
    nb = t.node[_dom(b, case)]
    return torch.where(t.cluster, na == nb, True)


def _xfer(a, b, case: SweepCase, nbytes) -> torch.Tensor:
    """The ``D/B`` payload term of a cross-worker link charge; zero
    off-cluster and on self-links."""
    t = case.topo
    bw = t.bw[_dom(a, case), _dom(b, case)]
    chg = (nbytes // torch.clamp(bw, min=1)).to(I32)
    return torch.where(t.cluster & (a != b), chg, 0)


def _comm_sz(costs: CostModel, a, b, case: SweepCase, nbytes):
    """Full link price ``L + D/B``."""
    return _comm(costs, a, b, case) + _xfer(a, b, case, nbytes)


def _track_xnode(st: SimState, a, b, case: SweepCase, nbytes, mask
                 ) -> SimState:
    """Accrue cross-node bytes into the per-step bottleneck ledger."""
    xn = mask & case.topo.cluster & ~_same_node(a, b, case)
    add = torch.where(xn, nbytes, 0).to(I32)
    return st._replace(nlink_bytes=st.nlink_bytes + add)


def _bump(ops: StepOps, ctr, *pairs):
    """Add each ``(counter name, (W,) int32 or bool value)`` pair into its
    column with one ``ops.ctr_add`` call (int32 sums commute, so a run of
    bumps in one call equals the bumps one by one)."""
    return ops.ctr_add(ctr, [(CTR[name], v) for name, v in pairs])


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")``: indices ``>= len(arr)`` write
    nothing; duplicates resolve to the highest lane."""
    n = arr.shape[0]
    win = messaging.last_writer(idx, torch.ones_like(idx, dtype=torch.bool),
                                n)
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    val = val.expand(idx.shape[0])
    return torch.where(win >= 0, val[win.clamp(min=0).long()], arr)


def _sink(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((idx >= 0) & (idx < n), idx, n).long()


def _stack_push(st: SimState, mask, task0, cnt) -> SimState:
    W, S = st.s_task.shape
    fits = mask & (st.s_top < S)
    idx = torch.where(fits, st.s_top, S)
    # one entry per worker row: one-hot select (idx == S matches nothing)
    one = torch.arange(S, dtype=I32, device=idx.device)[None, :] \
        == idx[:, None]
    s_task = torch.where(one, task0[:, None], st.s_task)
    s_cnt = torch.where(one, cnt[:, None], st.s_cnt)
    s_top = st.s_top + fits.to(I32)
    overflow = st.overflow | (mask & (st.s_top >= S)).any()
    return st._replace(s_task=s_task, s_cnt=s_cnt, s_top=s_top,
                       overflow=overflow)


def _finish(st: SimState, ftask, g: GraphArrays) -> SimState:
    """Completion bookkeeping for per-worker finished tasks (-1 = none):
    spawn-range entries go on the finisher's own stack; the notify target's
    dependency count drops; a join reaching zero is claimed by exactly one
    finisher (the lowest lane) who 'creates' it."""
    W = st.s_top.shape[0]
    T = g.dur.shape[0]
    me = _me(st)
    active = ftask >= 0
    safe = torch.where(active, ftask, 0).long()
    fidx = torch.where(active, ftask, T)
    done = _set_drop(st.done, fidx, True)
    # completion stamp: the finisher's clock already includes the task's
    # execution time, so this is the task's finish time
    done_ns = torch.cat([st.done_ns, st.done_ns.new_full((1,), -1)])
    done_ns = done_ns.scatter_reduce(0, _sink(fidx, T), st.clock, "amax")[:T]
    n_done = st.n_done + _sum(active)
    st = st._replace(done=done, done_ns=done_ns, n_done=n_done)
    # spawned children: one O(1) range entry
    nch = torch.where(active, g.n_children[safe], 0)
    st = _stack_push(st, nch > 0, g.first_child[safe], nch)
    # notify join (duplicate targets accumulate)
    j = torch.where(active, g.notify[safe], -1)
    join_cnt = torch.cat([st.join_cnt, st.join_cnt.new_zeros(1)])
    join_cnt = join_cnt.index_add(0, _sink(j, T),
                                  torch.full_like(j, -1))[:T]
    newly = (j >= 0) & (join_cnt[torch.where(j >= 0, j, 0).long()] == 0)
    st = st._replace(join_cnt=join_cnt)

    # a join becomes ready only occasionally: the (W, W) claim runs once,
    # and only when some join reached zero
    if bool(newly.any()):
        # the lowest-id finisher among those completing the same join
        # claims it (first index of the argmax wins)
        same = newly[:, None] & newly[None, :] & (j[:, None] == j[None, :])
        mine = newly & (same.to(I32).argmax(dim=1).to(I32) == me)
        creator = _set_drop(st.creator, torch.where(mine, j, T), me)
        st = _stack_push(st._replace(creator=creator), mine, j,
                         torch.ones(W, dtype=I32, device=j.device))
    return st


def _atomic_cost(mask, costs: CostModel) -> torch.Tensor:
    """Contended RMWs on one shared cache line (XGOMP's global task count):
    simultaneous writers serialize; the k-th pays k hand-offs.  The caller
    adds the clock charge and bumps ``atomic_ops`` by ``mask``."""
    rank = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    return torch.where(mask, costs.c_atomic + rank * costs.c_contend, 0)


# ---------------- pre-push victim adoption (NA-RP spawners) ----------------
def adopt_phase(st: SimState, running, *, case: SweepCase,
                costs: CostModel, ops: StepOps = REFERENCE_OPS) -> SimState:
    """NA-RP: spawning workers are victims too — adopt a thief pre-push.

    Reads s_top / cells / rp; writes rp, cells.round, ctr[req_handled].
    """
    del costs  # uniform phase signature; adoption itself is free
    m = axis_masks(case)
    spawner = (st.s_top > 0) & m.is_narp & running
    valid0 = messaging.victim_valid(st.cells) & spawner
    rp, _ = dlb.rp_adopt(st.rp, torch.clamp(st.cells.req_tid, min=0),
                         case.params.n_steal, valid0)
    return st._replace(
        rp=rp, cells=messaging.victim_advance(st.cells, valid0),
        ctr=_bump(ops, st.ctr, ("req_handled", valid0)))


# ---------------- phase A: push spawned tasks ----------------
def spawn_phase(st: SimState, running, *, g: GraphArrays, case: SweepCase,
                costs: CostModel, ops: StepOps = REFERENCE_OPS) -> SimState:
    """Each worker with a non-empty spawn stack pushes up to ``K_SPAWN``
    tasks: the locked_global lane pays the serialized lock + pq + malloc,
    the xqueue lane pushes to the round-robin (or NA-RP-redirected) target
    queue, full targets trigger the paper's execute-immediately rule.
    Open-system cases gate each task on its release stamp.
    """
    W, S = st.s_task.shape
    T = g.dur.shape[0]
    me = _me(st)
    me_l = me.long()
    m = axis_masks(case)
    n_w = case.n_workers

    for _ in range(K_SPAWN):
        avail = (st.s_top > 0) & running
        topi = torch.clamp(st.s_top - 1, min=0)
        etask = st.s_task[me_l, topi.long()]
        ecnt = st.s_cnt[me_l, topi.long()]
        # open-system injection gate; a blocked spawner sleeps forward to
        # the head task's release
        R = case.release_ns.shape[0]
        rel = case.release_ns[torch.clamp(etask, 0, R - 1).long()]
        released = case.closed | (st.clock >= rel)
        active = avail & released
        st = st._replace(clock=torch.where(avail & ~released, rel, st.clock))
        task = torch.where(active, etask, 0)

        # --- GOMP lane: serialized global-lock push (lock + pq + malloc)
        act_g = active & m.is_locked
        rank_g = torch.cumsum(act_g.to(I32), 0, dtype=I32) - 1
        cost_g = torch.where(
            act_g,
            costs.c_atomic + costs.c_pq_op + costs.c_alloc
            + rank_g * costs.c_lock, 0)

        # --- XQueue lane (all other modes), with NA-RP redirection
        act_x = active & m.uses_xq
        use_rp = act_x & m.is_narp & (st.rp.tgt >= 0) & (st.rp.left > 0)
        tgt = torch.where(use_rp, torch.clamp(st.rp.tgt, min=0),
                          st.rr % n_w)
        pay = torch.where(act_x, g.payload[task.long()], 0)
        cost_x = torch.where(
            act_x,
            costs.c_alloc + costs.c_slot
            + _comm_sz(costs, me, tgt, case, pay), 0)

        clock = st.clock + cost_g + cost_x
        gq = st.g_buf.shape[0]
        gidx = torch.where(act_g, (st.g_tail + rank_g) % gq, gq)
        g_buf = _set_drop(st.g_buf, gidx, task)
        g_ts = _set_drop(st.g_ts, gidx, clock)
        g_tail = st.g_tail + _sum(act_g)

        xq, ok = ops.push(st.xq, me, tgt, task, clock, act_x)
        pushed_x = ok
        imm = act_x & ~ok
        rr = st.rr + (act_x & ~use_rp).to(I32)
        creator = _set_drop(st.creator, torch.where(active, task, T), me)

        same_d = _same_domain(me, tgt, case)
        redirected = pushed_x & use_rp
        # atomic global count: task created (XGOMP only)
        counted = active & m.pays_count
        ctr = _bump(ops, st.ctr,
                    ("static_push", act_g | (pushed_x & ~use_rp)),
                    ("atomic_ops", act_g),
                    ("stolen", redirected),                # redirections
                    ("stolen_local", redirected & same_d),
                    ("stolen_remote", redirected & ~same_d),
                    ("stolen_xnode",
                     redirected & ~_same_node(me, tgt, case)),
                    ("tgt_full", use_rp & ~ok),
                    ("atomic_ops", counted))
        # Alg. 3: stop on quota exhausted or thief queue full
        left = st.rp.left - redirected.to(I32)
        drop = (use_rp & ~ok) | (left <= 0)
        rp = dlb.RPState(tgt=torch.where(drop, -1, st.rp.tgt),
                         left=torch.where(drop, 0, left))
        st = st._replace(xq=xq, g_buf=g_buf, g_ts=g_ts, g_tail=g_tail,
                         clock=clock + _atomic_cost(counted, costs), rr=rr,
                         rp=rp, ctr=ctr, creator=creator)
        st = _track_xnode(st, me, tgt, case, pay, act_x)

        # consume one task from the range entry (one-hot row update)
        sidx = torch.where(active, topi, S)
        one = torch.arange(S, dtype=I32, device=sidx.device)[None, :] \
            == sidx[:, None]
        s_task = torch.where(one, (etask + 1)[:, None], st.s_task)
        s_cnt = torch.where(one, (ecnt - 1)[:, None], st.s_cnt)
        s_top = torch.where(active & (ecnt - 1 == 0), st.s_top - 1,
                            st.s_top)
        st = st._replace(s_task=s_task, s_cnt=s_cnt, s_top=s_top)

        # execute-immediately rule for full target queues (paper §II-B):
        # queues rarely fill, so the block runs once, and only when needed
        if bool(imm.any()):
            dur_t = torch.where(imm, g.dur[task.long()], 0)
            # task finished -> atomic decrement (XGOMP only)
            counted = imm & m.pays_count
            ctr = _bump(ops, st.ctr, ("imm_exec", imm), ("exec", imm),
                        ("self", imm), ("busy_ns", dur_t),
                        ("atomic_ops", counted))
            st = st._replace(clock=st.clock + dur_t, ctr=ctr)
            st = _finish(st, torch.where(imm, task, -1), g)
            st = st._replace(clock=st.clock + _atomic_cost(counted, costs))
    return st


# ---------------- phase B: dequeue ----------------
def dequeue_phase(st: SimState, running, *, g: GraphArrays, case: SweepCase,
                  costs: CostModel, ops: StepOps = REFERENCE_OPS):
    """Workers with empty spawn stacks pop one task — the locked_global lane
    from the single contended global queue, the xqueue lane by scanning its
    master queue then the rotated auxiliaries (``ops.pop_first``).

    Returns ``(st, task, ts, found)`` for the downstream phases.
    """
    me = _me(st)
    m = axis_masks(case)
    n_w = case.n_workers
    active_w = me < n_w
    idle_m = (st.s_top == 0) & active_w & running

    # --- GOMP lane: contended pops off the single global queue
    idle_g = idle_m & m.is_locked
    avail = st.g_tail - st.g_head
    rank = torch.cumsum(idle_g.to(I32), 0, dtype=I32) - 1
    found_g = idle_g & (rank < avail)
    gq = st.g_buf.shape[0]
    gidx = ((st.g_head + rank) % gq).long()
    task_g = torch.where(found_g, st.g_buf[gidx], 0)
    ts_g = torch.where(found_g, st.g_ts[gidx], 0)
    g_head = st.g_head + _sum(found_g)
    cost_g = torch.where(idle_g,
                         costs.c_atomic + costs.c_pq_op
                         + rank * costs.c_lock, 0)
    ctr = _bump(ops, st.ctr, ("atomic_ops", idle_g))

    # --- XQueue lane: master queue then rotated aux scan
    idle_x = idle_m & m.uses_xq
    xq, task_x, ts_x, src, found_x, checked = ops.pop_first(
        st.xq, st.deq_rr, idle_x, n_w)
    pay_x = torch.where(
        found_x, g.payload[torch.where(found_x, task_x, 0).long()], 0)
    cost_x = torch.where(idle_x, checked * costs.c_cache, 0)
    cost_x = cost_x + torch.where(found_x,
                                  _comm_sz(costs, me, src, case, pay_x), 0)
    deq_rr = st.deq_rr + (found_x & (src != me)).to(I32)

    task = torch.where(m.is_locked, task_g, task_x)
    ts = torch.where(m.is_locked, ts_g, ts_x)
    found = found_g | found_x
    st = st._replace(xq=xq, g_head=g_head, deq_rr=deq_rr, ctr=ctr,
                     clock=st.clock + cost_g + cost_x)
    st = _track_xnode(st, me, src, case, pay_x, found_x)
    return st, task, ts, found


# ---------------- phase B2: thief protocol ----------------
def thief_phase(st: SimState, found, running, *, case: SweepCase,
                costs: CostModel, ops: StepOps = REFERENCE_OPS) -> SimState:
    """Idle workers that found nothing send steal requests to up to
    ``n_victim`` random victims (Alg. 1), on their first idle step and every
    ``t_interval`` thereafter.  The retry loop exits early once no thief
    wants another victim (at most ``NV_CAP`` rounds).
    """
    W = st.s_top.shape[0]
    me = _me(st)
    m = axis_masks(case)
    params = case.params
    n_w = case.n_workers
    zsz = case.zone_size
    active_w = me < n_w
    thief_m = (st.s_top == 0) & ~found & active_w & m.is_dlb & running
    idle = torch.where(thief_m, st.idle + 1, 0)
    do_req = thief_m & ((idle == 1) | (idle >= params.t_interval))
    idle = torch.where(idle >= params.t_interval, 0, idle)
    st = st._replace(idle=idle)

    rounds = st.cells.round   # victim-owned; thieves only read it
    # the (W, W) distance-weight tables are draw-independent: built once
    remote_tbl = dlb.remote_weight_table(me, n_w, zsz, case.topo)
    node_tbls = (dlb.remote_weight_table(me, n_w, zsz, case.topo,
                                         restrict="node_local"),
                 dlb.remote_weight_table(me, n_w, zsz, case.topo,
                                         restrict="node_remote"))

    rng, clock = st.rng, st.clock
    req_round, req_tid = st.cells.req_round, st.cells.req_tid
    n_sent = torch.zeros(W, dtype=I32, device=me.device)
    nl = torch.zeros(W, dtype=I32, device=me.device)
    v = 0
    while v < NV_CAP and bool((do_req & (v < params.n_victim)).any()):
        sm = do_req & (v < params.n_victim)
        rng, victim = dlb.pick_victim(rng, me, n_w, zsz, params.p_local,
                                      case.topo, remote_tbl=remote_tbl,
                                      p_local_node=params.p_local_node,
                                      node_tbls=node_tbls)
        cells, sent = messaging.thief_send(
            messaging.Cells(rounds, req_round, req_tid), me, victim, sm)
        req_round, req_tid = cells.req_round, cells.req_tid
        # request/reply control messages price as L + req_bytes/B on
        # cluster links (the bare latency everywhere else)
        c1 = _comm_sz(costs, me, victim, case, costs.req_bytes)
        clock = clock + torch.where(sm, 2 * c1, 0) + torch.where(sent, c1, 0)
        msgs = torch.where(sm, 2, 0) + torch.where(sent, 1, 0)
        xn = sm & case.topo.cluster & ~_same_node(me, victim, case)
        nl = nl + torch.where(xn, msgs * costs.req_bytes, 0).to(I32)
        n_sent = n_sent + sent.to(I32)
        v += 1
    return st._replace(
        rng=rng, cells=messaging.Cells(rounds, req_round, req_tid),
        clock=clock.to(I32), ctr=_bump(ops, st.ctr, ("req_sent", n_sent)),
        nlink_bytes=st.nlink_bytes + nl)


# ---------------- phase C: victim handling ----------------
def victim_phase(st: SimState, found, *, g: GraphArrays, case: SweepCase,
                 costs: CostModel, ops: StepOps = REFERENCE_OPS) -> SimState:
    """Busy workers with a valid steal request answer it — NA-WS bulk-moves
    up to ``n_steal`` tasks into the thief's queue (Alg. 4), NA-RP adopts
    the thief for future redirected pushes (Alg. 3).  On cluster machines
    the bulk move is payload-priced and cross-node moves feed the
    bottleneck ledger.
    """
    me = _me(st)
    m = axis_masks(case)
    params = case.params
    t = case.topo

    valid = messaging.victim_valid(st.cells) & found
    thief = torch.clamp(st.cells.req_tid, min=0)

    # NA-WS: bulk transfer to the thief's queue (Alg. 4)
    vm_ws = valid & m.is_naws
    comm_c = _comm(costs, me, thief, case)
    bw_vt = t.bw[_dom(me, case), _dom(thief, case)]
    xfer_bw = torch.where(t.cluster & (me != thief), bw_vt, 0).to(I32)
    xq, clock, stolen, src_empty, tgt_full, moved_bytes = dlb.ws_transfer(
        st.xq, vm_ws, thief, params.n_steal, st.clock, comm_c,
        st.deq_rr, WS_CAP, case.n_workers, payload=g.payload,
        xfer_bw=xfer_bw)
    same_d = _same_domain(me, thief, case)
    same_n = _same_node(me, thief, case)

    # NA-RP: adopt the thief for future redirected pushes (Alg. 3)
    vm_rp = valid & m.is_narp
    rp, adopted = dlb.rp_adopt(st.rp, thief, params.n_steal, vm_rp)

    handled = vm_ws | vm_rp
    ctr = _bump(ops, st.ctr, ("stolen", stolen),
                ("stolen_local", torch.where(same_d, stolen, 0)),
                ("stolen_remote", torch.where(~same_d, stolen, 0)),
                ("stolen_xnode", torch.where(~same_n, stolen, 0)),
                ("req_has_steal", vm_ws & (stolen > 0)),
                ("src_empty", src_empty), ("tgt_full", tgt_full),
                ("req_has_steal", adopted), ("req_handled", handled))
    nl = torch.where(t.cluster & ~same_n, moved_bytes, 0).to(I32)
    return st._replace(xq=xq, clock=clock, rp=rp, ctr=ctr,
                       nlink_bytes=st.nlink_bytes + nl,
                       cells=messaging.victim_advance(st.cells, handled))


# ---------------- phase D: execution ----------------
def exec_phase(st: SimState, task, ts, found, *, g: GraphArrays,
               case: SweepCase, costs: CostModel,
               ops: StepOps = REFERENCE_OPS) -> SimState:
    """Workers that dequeued a task run it: the clock first joins the
    producer-side timestamp (causality), memory-bound tasks pay the NUMA
    locality penalty (float32, each operation its own rounding step as in
    the JAX package), and completion bookkeeping happens in ``_finish``.
    """
    me = _me(st)
    m = axis_masks(case)

    safe = torch.where(found, task, 0).long()
    dur_t = torch.where(found, g.dur[safe], 0)
    cr0 = st.creator[safe]
    t = case.topo
    same_d = _same_domain(cr0, me, case)
    d_cr = t.dist[_dom(cr0, case), _dom(me, case)]
    f32 = torch.float32
    pen_rem = torch.where(
        t.flat, costs.exec_remote_penalty,
        1.0 + (costs.exec_remote_penalty - 1.0) * d_cr.to(f32)
        / torch.tensor(float(costs.c_numa), dtype=f32, device=me.device))
    pen = torch.where(cr0 == me, 1.0,
                      torch.where(same_d, costs.exec_zone_penalty, pen_rem))
    mult = 1.0 + case.mem_bound * (pen - 1.0)
    dur_t = torch.where(case.mem_bound > 0,
                        (dur_t.to(f32) * mult).to(I32), dur_t)
    start = torch.maximum(st.clock, torch.where(found, ts, 0))
    clock = torch.where(found, start + dur_t, st.clock)
    # global task count decrement — only the centralized_count barrier
    # keeps one (contended on the xqueue lane, plain on the locked lane)
    counted = found & m.pays_count
    ctr = _bump(ops, st.ctr, ("exec", found), ("self", found & (cr0 == me)),
                ("local", found & (cr0 != me) & same_d),
                ("remote", found & ~same_d), ("busy_ns", dur_t),
                ("atomic_ops", counted),
                ("atomic_ops", found & m.is_locked & (case.barrier_id == 0)))
    st = _finish(st._replace(clock=clock, ctr=ctr),
                 torch.where(found, task, -1), g)
    return st._replace(clock=st.clock + _atomic_cost(counted, costs))


#: the pipeline in step order (adopt_phase is the NA-RP pre-push hook)
PHASES = ("adopt_phase", "spawn_phase", "dequeue_phase", "thief_phase",
          "victim_phase", "exec_phase")


# ---------------- the composed step ----------------
def run_gate(st: SimState, g: GraphArrays, max_steps: int) -> torch.Tensor:
    """The run loop's liveness predicate (0-dim bool): incomplete, under
    the step horizon, no overflow, and some pending work (a spawn-stack
    entry or a queued task) — a workless incomplete run is stalled for
    good."""
    has_work = ((st.s_top > 0).any() | (st.xq.tail > st.xq.head).any()
                | (st.g_tail > st.g_head))
    return ((st.n_done < g.n_tasks) & (st.step_i < max_steps)
            & ~st.overflow & has_work)


def step_pipeline(st: SimState, *, g: GraphArrays, case: SweepCase,
                  costs: CostModel, ops: StepOps = REFERENCE_OPS,
                  max_steps: int) -> SimState:
    """One scheduling point: the six phases composed in step order, each
    gated on ``running`` (:func:`run_gate`), then the cluster tier's
    per-step bottleneck occupancy charge."""
    running = run_gate(st, g, max_steps)
    st = adopt_phase(st, running, case=case, costs=costs, ops=ops)
    st = spawn_phase(st, running, g=g, case=case, costs=costs, ops=ops)
    st, task, ts, found = dequeue_phase(st, running, g=g, case=case,
                                        costs=costs, ops=ops)
    st = thief_phase(st, found, running, case=case, costs=costs, ops=ops)
    st = victim_phase(st, found, g=g, case=case, costs=costs, ops=ops)
    st = exec_phase(st, task, ts, found, g=g, case=case, costs=costs,
                    ops=ops)
    # shared inter-node bottleneck: each sender waits out the *other*
    # senders' occupancy; the ledger is zero off-cluster and resets here
    nl = st.nlink_bytes
    occ = torch.where((nl > 0) & case.topo.cluster,
                      (_sum(nl) - nl) // case.topo.bneck_bw, 0).to(I32)
    st = st._replace(clock=st.clock + occ,
                     ctr=_bump(ops, st.ctr, ("xnode_bytes", nl)),
                     nlink_bytes=torch.zeros_like(nl))
    return st._replace(step_i=st.step_i + running.to(I32))
