"""XQueue: lock-less MPMC queueing built from per-pair SPSC ring buffers.

Faithful to the paper (§II-B / Fig. 2): worker *i* owns one *master* SPSC
queue (pair ``(i, i)``) plus one *auxiliary* SPSC queue per other worker
(pair ``(consumer=i, producer=p)``).  Any task worker ``p`` sends to worker
``c`` goes into queue ``(c, p)`` — so every buffer has exactly one producer
and one consumer, which is the entire correctness argument of B-queue.

Tensor adaptation: the SPSC "only the producer writes the tail, only the
consumer writes the head" discipline becomes *disjoint-slice writes inside a
bulk-synchronous step*: the push phase writes only ``(tail, buf[tgt, self])``
slices keyed by producer id, the pop phase writes only ``(head)`` slices keyed
by consumer id.  The CUDA kernels in :mod:`repro_torch.kernels.sched_queue`
give each producer column / consumer row to one thread / warp on exactly
this argument.

The functions here are the plain PyTorch versions (functional: they return
new tensors and never write their inputs).  Timestamps ride along with every
task so the simulator's virtual clocks stay causal.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

I32 = torch.int32


class XQ(NamedTuple):
    buf: torch.Tensor   # (W, W, Q) int32 — buf[consumer, producer, slot]
    ts: torch.Tensor    # (W, W, Q) int32 — producer-side virtual timestamps
    head: torch.Tensor  # (W, W) int32 monotonic consumer cursor
    tail: torch.Tensor  # (W, W) int32 monotonic producer cursor


def make(n_workers: int, capacity: int, device="cpu") -> XQ:
    W, Q = n_workers, capacity
    return XQ(
        buf=torch.full((W, W, Q), -1, dtype=I32, device=device),
        ts=torch.zeros((W, W, Q), dtype=I32, device=device),
        head=torch.zeros((W, W), dtype=I32, device=device),
        tail=torch.zeros((W, W), dtype=I32, device=device),
    )


def sizes(xq: XQ) -> torch.Tensor:
    """(W, W) occupancy, consumer-major."""
    return xq.tail - xq.head


def capacity(xq: XQ) -> int:
    return xq.buf.shape[-1]


def push(xq: XQ, producer: torch.Tensor, consumer: torch.Tensor,
         task: torch.Tensor, ts: torch.Tensor, mask: torch.Tensor
         ) -> Tuple[XQ, torch.Tensor]:
    """Vectorized push: lane ``i`` (producer ``producer[i]``) appends
    ``task[i]`` to queue ``(consumer[i], producer[i])``.

    Producer ids must be distinct across active lanes (they are: lane ==
    worker), so all writes touch disjoint (consumer, producer) pairs.
    Returns ``(new_xq, ok)`` where ok is False for full queues (caller then
    applies the paper's execute-immediately rule).
    """
    Q = capacity(xq)
    W = xq.head.shape[0]
    lane = torch.arange(W, dtype=I32, device=mask.device)
    # ids outside [0, W) as the reference reads them: its scatter wraps a
    # producer in [-W, 0) to p + W and drops any other; its gathers wrap a
    # negative index once, then clamp to [0, W - 1]
    wrapped = torch.where(producer < 0, producer + W, producer)
    # permute lane data into producer-indexed order: the highest lane
    # naming a producer wins (the JAX package's scatter order); a sink slot
    # at W takes the masked-off and dropped lanes
    live = mask & (wrapped >= 0) & (wrapped < W)
    inv = torch.full((W + 1,), -1, dtype=I32, device=mask.device)
    inv = inv.scatter_reduce(0, torch.where(live, wrapped, W).long(), lane,
                             "amax")[:W]
    has = inv >= 0
    safe = torch.where(has, inv, W - 1).long()
    cons_p = torch.where(has, consumer[safe], 0)
    # the row whose tail and head decide ok; only an in-range consumer is
    # written
    row = _clamped(cons_p, W)
    task_p = task[safe]
    ts_p = ts[safe]
    lane_l = lane.long()
    tail_p = xq.tail[row, lane_l]
    cur_p = tail_p - xq.head[row, lane_l]
    ok_p = has & (cur_p < Q)
    write = ok_p & (cons_p >= 0) & (cons_p < W)
    slot_p = (tail_p % Q).long()
    buf = xq.buf.clone()
    tsb = xq.ts.clone()
    tail = xq.tail.clone()
    pi = lane_l[write]
    ci = row[write]
    si = slot_p[write]
    buf[ci, pi, si] = task_p[write]
    tsb[ci, pi, si] = ts_p[write]
    tail[ci, pi] = tail_p[write] + 1
    ok = mask & ok_p[_clamped(producer, W)]
    return XQ(buf, tsb, xq.head, tail), ok


def _clamped(idx: torch.Tensor, W: int) -> torch.Tensor:
    """``idx`` as a JAX gather reads it from an axis of W: a negative
    index plus W, then clamped to [0, W - 1] (as int64)."""
    return torch.where(idx < 0, idx + W, idx).clamp(0, W - 1).long()


def _scan_order(W: int, me: torch.Tensor, rot: torch.Tensor, n_active):
    """Candidate source order for each consumer: master queue first, then the
    other ``n_active - 1`` live producers starting at rotation ``rot``
    (dequeue round-robin).  ``n_active`` may be a 0-dim tensor ≤ the padded
    width ``W`` (padded lanes are skipped via the returned validity mask)."""
    j = torch.arange(W - 1, dtype=I32, device=me.device)[None, :]
    nm1 = torch.clamp(n_active - 1, min=1)
    raw = (me[:, None] + 1 + ((rot[:, None] + j) % nm1)) % torch.clamp(
        n_active, min=1)
    order = torch.cat([me[:, None], raw.to(I32)], dim=1)     # (W, W)
    W0 = me.shape[0]
    valid = torch.cat(
        [torch.ones((W0, 1), dtype=torch.bool, device=me.device),
         (j < (n_active - 1)).expand(W0, W - 1)], dim=1)
    return order, valid


def scan_pos(W: int, me: torch.Tensor, rot: torch.Tensor, n_active
             ) -> torch.Tensor:
    """(W, W) scan *position* of producer ``p`` in consumer ``me``'s dequeue
    order: the master queue (p == me) is position 0, auxiliary producer ``p``
    sits at ``1 + ((p - me - 1) mod n - rot) mod (n - 1)`` — the closed-form
    inverse of ``_scan_order``.  Integer ``%`` on tensors floors, as in the
    JAX package (the CUDA kernel needs an explicit floor-mod for this)."""
    n_act = torch.clamp(n_active, min=1)
    nm1 = torch.clamp(n_active - 1, min=1)
    p = torch.arange(W, dtype=I32, device=me.device)[None, :]
    d = (p - me[:, None] - 1) % n_act
    return torch.where(p == me[:, None], 0,
                       1 + (d - rot[:, None]) % nm1).to(I32)


def pop_compute(buf, ts, head, tail, rot, mask, n_active):
    """The pop scan as plain tensor math: each consumer takes the first
    non-empty queue in scan order and pops one task from it.

    Returns ``(head', task, ts, src, found, checked)``.  Consumers that find
    nothing still gather ``buf/ts[me, me, head % Q]`` and report
    ``src = me``, ``checked = n_active`` — those values are part of the
    result (the dequeue phase passes them on unmasked).
    """
    W = head.shape[0]
    Q = buf.shape[-1]
    me = torch.arange(W, dtype=I32, device=head.device)
    p = me[None, :]
    pos = scan_pos(W, me, rot, n_active)                  # (W, W)
    sz = tail - head                                      # (W, W) [c, p]
    cand = (sz > 0) & (p < torch.clamp(n_active, min=1))
    pos_m = torch.where(cand, pos, W + 1)
    best = pos_m.amin(dim=1)
    found_any = best <= W
    found = mask & found_any
    src = torch.where(found_any, pos_m.argmin(dim=1).to(I32), me)
    checked = torch.where(found_any, best + 1, n_active).to(I32)
    safe_src = torch.where(found, src, me).long()
    me_l = me.long()
    slot = (head[me_l, safe_src] % Q).long()
    task = buf[me_l, safe_src, slot]
    tsv = ts[me_l, safe_src, slot]
    head = head.clone()
    head[me_l, safe_src] += found.to(I32)
    return head, task, tsv, src, found, checked


def pop_first(xq: XQ, rot: torch.Tensor, mask: torch.Tensor, n_active=None):
    """Every consumer pops one task: master queue first, then auxiliary queues
    in rotated round-robin order (paper §II-B).

    ``n_active`` (0-dim int32 tensor, default: the width) restricts the scan
    to the first ``n_active`` workers so padded lanes stay inert.

    Returns (xq', task, ts, src, found, checked) — ``checked`` is the number
    of queues inspected (each inspection is charged by the cost model).
    """
    if n_active is None:
        n_active = xq.head.shape[0]
    n_active = torch.as_tensor(n_active, dtype=I32, device=xq.head.device)
    head, task, ts, src, found, checked = pop_compute(
        xq.buf, xq.ts, xq.head, xq.tail, rot, mask, n_active)
    return XQ(xq.buf, xq.ts, head, xq.tail), task, ts, src, found, checked
