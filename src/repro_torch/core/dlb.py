"""NUMA-aware dynamic load balancing policies (paper §IV).

* ``pick_victim`` — conditionally-random victim selection: NUMA-local with
  probability ``p_local``, NUMA-remote otherwise (never self).  Under a
  non-flat :mod:`repro_torch.core.topology` the remote choice is weighted
  inversely with the NUMA distance matrix (near sockets preferred).
* ``NA-RP`` (redirect push, Alg. 3) — a victim that accepted a thief redirects
  its *newly created* tasks to the thief's queue until ``n_steal`` tasks are
  pushed or the thief's queue fills.  Implemented as per-worker
  ``(rp_tgt, rp_left)`` state consulted by the scheduler's push phase.
* ``NA-WS`` (work stealing, Alg. 4) — a victim that accepted a thief dequeues
  up to ``n_steal`` tasks from its own queues and enqueues them to the thief's
  target queue ``(thief, victim)``; stops on own-empty or target-full.

The per-lane PRNG is xorshift32.  PyTorch on the CPU cannot shift uint32
tensors, so the state is carried as int64 holding the uint32 value and
masked back to 32 bits after every left shift; ``state.to_numpy`` returns
it as uint32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import xqueue

I32 = torch.int32
U32_MASK = 0xFFFFFFFF


def xorshift(s: torch.Tensor) -> torch.Tensor:
    """Per-lane xorshift32 PRNG on uint32 values held in int64."""
    s = s ^ ((s << 13) & U32_MASK)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & U32_MASK)
    return s


def uniform(s: torch.Tensor) -> torch.Tensor:
    """U[0,1) from a uint32 state (exact in float32: 24 bits × 2^-24)."""
    return (s >> 8).to(torch.float32) * (1.0 / (1 << 24))


def zone_of(w: torch.Tensor, zone_size: int) -> torch.Tensor:
    return w // zone_size


def remote_weight_table(me: torch.Tensor, n_workers, zone_size, topo,
                        restrict: str | None = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-invariant table for the hierarchy-aware remote choice: per
    (thief, candidate) integer weights *inversely related to domain
    distance* — the nearest remote domain's workers carry weight
    ``1 + (d_max - d_near)``, the farthest carry ``1``.  Depends only on
    ``me``/``zone_size``/``topo``, never on the PRNG draw, so callers
    (``phases.thief_phase``) hoist it out of the victim-retry loop.

    ``restrict`` narrows the candidate set for the cluster tier's
    two-level choice: ``"node_local"`` keeps only remote-socket candidates
    *inside* the thief's node, ``"node_remote"`` only candidates in
    *other* nodes.  Returns ``(cum_weights, total_weight)``, int32.
    """
    W = me.shape[0]
    j = torch.arange(W, dtype=I32, device=me.device)
    dom_j = torch.minimum(j // zone_size, topo.n_domains - 1)
    dom_me = torch.minimum(me // zone_size, topo.n_domains - 1)
    d = topo.dist[dom_me.long()[:, None], dom_j.long()[None, :]]   # (W, W)
    remote = (j[None, :] < n_workers) & (dom_j[None, :] != dom_me[:, None])
    if restrict is not None:
        if restrict not in ("node_local", "node_remote"):
            raise ValueError(f"unknown restrict {restrict!r}")
        same_n = (topo.node[dom_me.long()][:, None]
                  == topo.node[dom_j.long()][None, :])
        remote = remote & (same_n if restrict == "node_local" else ~same_n)
    dmax = torch.where(remote, d, 0).amax(dim=1, keepdim=True)
    wgt = torch.where(remote, dmax - d + 1, 0)                      # (W, W)
    cum = torch.cumsum(wgt, dim=1, dtype=I32)
    return cum, cum[:, -1]


def _remote_weighted(draw: torch.Tensor, cum: torch.Tensor,
                     total: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample from a :func:`remote_weight_table`.  Returns
    ``(victim, has_remote)``."""
    W = cum.shape[-1]
    r = draw[:, None] % torch.clamp(total[:, None], min=1)
    # victim = first lane whose cumulative weight exceeds r (zero-weight
    # lanes share their predecessor's cumsum, so they are never selected)
    victim = (cum <= r).to(I32).sum(dim=1, dtype=I32)
    return torch.clamp(victim, max=W - 1), total > 0


def pick_victim(rng: torch.Tensor, me: torch.Tensor, n_workers, zone_size,
                p_local: torch.Tensor, topo=None, remote_tbl=None,
                p_local_node=None, node_tbls=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random victim != me; same zone/domain with probability ``p_local``.

    The same stratified choice as the JAX package: the local candidate set
    is ``me``'s clipped NUMA domain on hierarchical machines, remote victims
    are weighted inversely with NUMA distance, and on cluster machines the
    single uniform draw stratifies three ways (socket-local,
    node-local-remote-socket, cross-node) with the cross-node stratum
    narrowed by ``topo.bw_scale``.  Exactly two xorshifts per call on every
    path.  Returns (rng', victim).
    """
    W = torch.as_tensor(n_workers, dtype=I32, device=me.device)
    Z = torch.as_tensor(zone_size, dtype=I32, device=me.device)
    rng = xorshift(rng)
    u = uniform(rng)
    want_local = u < p_local
    rng = xorshift(rng)
    draw = (rng >> 1).to(I32)  # non-negative
    zbase = (me // Z) * Z
    # local candidate: one of the Z-1 zone members != me
    off_l = draw % torch.clamp(Z - 1, min=1)
    local = zbase + off_l + (off_l >= (me - zbase)).to(I32)
    # remote candidate: one of the W-Z workers outside the zone
    off_r = draw % torch.clamp(W - Z, min=1)
    remote = torch.where(off_r >= zbase, off_r + Z, off_r)
    has_local = Z > 1
    has_remote = W > Z
    if topo is not None:
        dom_me = torch.minimum(me // Z, topo.n_domains - 1)
        start = dom_me * Z
        end = torch.where(dom_me == topo.n_domains - 1, W, (dom_me + 1) * Z)
        size = end - start
        off_h = draw % torch.clamp(size - 1, min=1)
        local_h = start + off_h + (off_h >= (me - start)).to(I32)
        if remote_tbl is None:
            remote_tbl = remote_weight_table(me, W, Z, topo)
        remote_h, has_remote_h = _remote_weighted(draw, *remote_tbl)
        if p_local_node is not None:
            if node_tbls is None:
                node_tbls = (remote_weight_table(me, W, Z, topo,
                                                 restrict="node_local"),
                             remote_weight_table(me, W, Z, topo,
                                                 restrict="node_remote"))
            nl_v, has_nl = _remote_weighted(draw, *node_tbls[0])
            nr_v, has_nr = _remote_weighted(draw, *node_tbls[1])
            # native fabric keeps the plain two-level split bitwise (the
            # where, not the algebra: 1-(1-pn) re-rounds in float32)
            pn_eff = torch.where(
                topo.bw_scale < 1.0,
                1.0 - (1.0 - p_local_node) * topo.bw_scale, p_local_node)
            want_node = u < p_local + (1.0 - p_local) * pn_eff
            use_nl = torch.where(has_nl & has_nr, want_node, has_nl)
            remote_c = torch.where(use_nl, nl_v, nr_v)
            remote_h = torch.where(topo.cluster, remote_c, remote_h)
            has_remote_h = torch.where(topo.cluster, has_nl | has_nr,
                                       has_remote_h)
        local = torch.where(topo.flat, local, local_h)
        remote = torch.where(topo.flat, remote, remote_h)
        has_local = torch.where(topo.flat, has_local, size > 1)
        has_remote = torch.where(topo.flat, has_remote, has_remote_h)
    use_local = torch.where(has_local & has_remote, want_local, has_local)
    victim = torch.where(use_local, local, remote).to(I32)
    return rng, victim


class RPState(NamedTuple):
    tgt: torch.Tensor   # (W,) adopted thief id, -1 = none (Alg. 3 "No thief")
    left: torch.Tensor  # (W,) remaining tasks to redirect


def rp_make(n_workers: int, device="cpu") -> RPState:
    return RPState(tgt=torch.full((n_workers,), -1, dtype=I32, device=device),
                   left=torch.zeros(n_workers, dtype=I32, device=device))


def rp_adopt(rp: RPState, thief: torch.Tensor, n_steal: torch.Tensor,
             valid: torch.Tensor) -> Tuple[RPState, torch.Tensor]:
    """Alg. 3 doLoadBalancing: adopt the requesting thief iff none is active."""
    adopt = valid & (rp.tgt < 0)
    return RPState(
        tgt=torch.where(adopt, thief, rp.tgt).to(I32),
        left=torch.where(adopt, n_steal, rp.left).to(I32),
    ), adopt


def ws_transfer(xq: xqueue.XQ, victim_mask: torch.Tensor,
                thief: torch.Tensor, n_steal: torch.Tensor,
                clock: torch.Tensor, comm_cost: torch.Tensor,
                deq_rr: torch.Tensor, ws_cap: int, n_active=None,
                payload=None, xfer_bw=None):
    """Alg. 4: each victim moves up to ``n_steal`` tasks from its own queues
    to queue ``(thief, victim)``, stopping on own-empty or target-full.

    The closed form of the paper's pop-one-push-one loop (see
    :func:`_ws_bulk`), gated behind a one-shot check: on the many scheduling
    points with no valid steal request nothing runs.  Returns (xq', clock',
    stolen_count, src_empty, tgt_full, moved_bytes).
    """
    if not bool(victim_mask.any()):
        W = xq.head.shape[0]
        zeros = torch.zeros(W, dtype=I32, device=clock.device)
        false = torch.zeros(W, dtype=torch.bool, device=clock.device)
        return xq, clock, zeros, false, false, zeros
    return _ws_bulk(xq, victim_mask, thief, n_steal, clock, comm_cost,
                    deq_rr, ws_cap, n_active, payload, xfer_bw)


def _ws_bulk(xq: xqueue.XQ, victim_mask, thief, n_steal, clock, comm_cost,
             deq_rr, ws_cap: int, n_active, payload=None, xfer_bw=None):
    """The transfer count is ``k = min(n_steal, ws_cap, available,
    target_free)``, the r-th moved task is the r-th element of the
    scan-order concatenation of the victim's queues, and per-source take
    counts are a waterfall over the scan-order prefix sums.  On a priced
    (cluster) link each task costs ``comm_cost + payload // xfer_bw`` and
    the transfer stops at a time window of ``n_steal * comm_cost``.  Writes
    ``xq`` directly, not through ``StepOps``."""
    W = xq.head.shape[0]
    Q = xqueue.capacity(xq)
    dev = clock.device
    if n_active is None:
        n_active = torch.tensor(W, dtype=I32, device=dev)
    me = torch.arange(W, dtype=I32, device=dev)
    me_l = me.long()
    n_steal = torch.clamp(n_steal, max=ws_cap)
    thief_l = thief.long()

    order, valid = xqueue._scan_order(W, me, deq_rr, n_active)   # (W, W)
    sz = xq.tail - xq.head                                       # (W, W)
    sz_ord = torch.where(valid, torch.gather(sz, 1, order.long()), 0)
    cum = torch.cumsum(sz_ord, dim=1, dtype=I32)
    avail = cum[:, -1]
    cum_before = cum - sz_ord
    free0 = Q - (xq.tail[thief_l, me_l] - xq.head[thief_l, me_l])
    k = torch.minimum(n_steal, torch.minimum(avail, free0))
    k = torch.where(victim_mask, torch.clamp(k, min=0), 0).to(I32)

    r_iota = torch.arange(Q, dtype=I32, device=dev)[None, :]     # (1, Q)
    j_r = (cum[:, None, :] <= r_iota[:, :, None]).sum(dim=2, dtype=I32)
    j_r = torch.clamp(j_r, max=W - 1).long()                     # (W, Q)
    src_r = torch.gather(order, 1, j_r)                          # (W, Q)
    off_r = r_iota - torch.gather(cum_before, 1, j_r)
    slot_r = ((xq.head[me_l[:, None], src_r.long()] + off_r) % Q).long()
    task_r = xq.buf[me_l[:, None], src_r.long(), slot_r]         # (W, Q)
    ts_r = xq.ts[me_l[:, None], src_r.long(), slot_r]
    priced = payload is not None and xfer_bw is not None
    if not priced:
        cost_r = comm_cost[:, None].expand(W, Q)
    else:
        # empty slots hold -1, which indexes the last task (as in JAX)
        pay_r = payload[task_r.long()]                           # (W, Q)
        cost_r = comm_cost[:, None] + torch.where(
            xfer_bw[:, None] > 0,
            pay_r // torch.clamp(xfer_bw[:, None], min=1), 0)
    cost_r = cost_r.to(I32)
    before_r = torch.cumsum(cost_r, dim=1, dtype=I32) - cost_r
    windowed = torch.zeros_like(victim_mask)
    if priced:
        window = (n_steal * comm_cost)[:, None]                  # (W, 1)
        k_win = ((r_iota < k[:, None])
                 & (before_r + cost_r <= window)).sum(dim=1, dtype=I32)
        k_full = k
        k = torch.where(xfer_bw > 0, k_win, k)
        windowed = k < k_full
    take_r = r_iota < k[:, None]
    can_more = victim_mask & (k < n_steal) & ~windowed
    tgt_full = can_more & (k == free0)
    src_empty = can_more & (free0 > k) & (k == avail)
    push_ts_r = torch.maximum(clock[:, None] + before_r, ts_r) + cost_r

    # destination slot of task r is (tail0 + r) % Q in queue (thief, me):
    # per physical slot q, r = (q - tail0) % Q; one one-hot select over the
    # consumer dimension writes the whole batch
    tail0 = xq.tail[thief_l, me_l]
    q_iota = torch.arange(Q, dtype=I32, device=dev)[None, :]
    r_of_q = ((q_iota - tail0[:, None]) % Q).long()              # (W, Q)
    val_q = torch.gather(task_r, 1, r_of_q)
    tsv_q = torch.gather(push_ts_r, 1, r_of_q)
    wr_q = torch.gather(take_r, 1, r_of_q)
    one_c = me[:, None] == thief[None, :]                        # (Wc, Wv)
    upd = one_c[:, :, None] & wr_q[None, :, :]                   # (Wc, Wv, Q)
    buf = torch.where(upd, val_q[None, :, :], xq.buf)
    tsb = torch.where(upd, tsv_q[None, :, :], xq.ts)
    tail = xq.tail + torch.where(one_c, k[None, :], 0)

    # per-source head advance: invert the scan order analytically
    n_act = torch.clamp(n_active, min=1)
    pos_p = xqueue.scan_pos(W, me, deq_rr, n_active)             # (W, W)
    cb_p = torch.gather(cum_before, 1, torch.clamp(pos_p, max=W - 1).long())
    take_p = torch.minimum(torch.clamp(k[:, None] - cb_p, min=0),
                           torch.clamp(sz, min=0))
    take_p = torch.where(me[None, :] < n_act, take_p, 0)
    head = xq.head + take_p

    clock = clock + torch.where(take_r, cost_r, 0).sum(dim=1, dtype=I32)
    moved_bytes = (torch.zeros_like(k) if not priced
                   else torch.where(take_r & (xfer_bw[:, None] > 0),
                                    pay_r, 0).sum(dim=1, dtype=I32))
    return (xqueue.XQ(buf, tsb, head.to(I32), tail.to(I32)), clock.to(I32),
            k, src_empty, tgt_full, moved_bytes)
