"""Team-barrier models: GNU's centralized barrier vs. the paper's hybrid
lock-free(gather)/lock-less(release) distributed tree barrier (§III-B).

What matters for performance (and what we model) is:

  centralized (GOMP/XGOMP):
      - every task create/finish atomically updates a *globally shared* task
        count (charged per-op with contention in the scheduler step);
      - at the barrier itself, every worker contends on the same lock/flag:
        2(W-1) atomic ops on one cache line, serialized.

  tree (XGOMPTB and both DLB modes):
      - no global task count at all during the run;
      - gathering: each worker atomically sets its parent's `complete` flag —
        W-1 atomics total, but each flag is shared by exactly two workers, so
        they proceed in parallel level by level (depth = ceil(log2 W));
      - releasing: lock-less tree broadcast of per-worker `release` flags
        (plain stores, no atomics).

  => exactly half the atomic operations of the centralized barrier
     (W-1 vs 2(W-1)), the paper's "theoretical lower bound" claim, which
     the JAX package's `tests/test_barrier.py` asserts.

The tree-gather *conditions* (paper: all workers entered, worker idle, no
unfinished dependencies, children gathered) are what the scheduler's
termination predicate checks; this module charges the episode costs and
counts the atomics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.costs import CostModel


class BarrierStats(NamedTuple):
    time_ns: int          # added to the makespan
    atomic_ops: int


def centralized_episode(n_workers: int, costs: CostModel) -> BarrierStats:
    """All W workers serialize on the barrier lock: the last one waits for
    W-1 hand-offs for the gather and W-1 for the release."""
    W = n_workers
    t = 2 * (W - 1) * (costs.c_atomic + costs.c_contend)
    return BarrierStats(int(t), 2 * (W - 1))


def tree_episode(n_workers: int, costs: CostModel) -> BarrierStats:
    """Gather: levels proceed in parallel, one atomic per level on a 2-sharer
    line; release: lock-less stores down the tree."""
    depth = max(1, math.ceil(math.log2(n_workers)))
    t = depth * (costs.c_atomic + costs.c_zone)      # gather (lock-free)
    t += depth * costs.c_zone                        # release (lock-less)
    return BarrierStats(int(t), n_workers - 1)


def tree_episode_topo(n_workers: int, topo, costs: CostModel) -> BarrierStats:
    """Tree barrier laid out to match a machine topology's socket hierarchy.

    Instead of one flat binary tree over all workers, the gather/release
    tree follows the hierarchy (the paper lays its barrier out per socket
    for exactly this reason): each socket's workers gather through an
    intra-socket binary subtree whose per-level flag hand-off costs
    ``c_zone``, then the socket roots merge pairwise up a socket-level
    binary tree whose level cost is the *actual* inter-socket distance of
    the merging socket blocks (``max`` over the pairs a level joins —
    adjacent sockets merge cheaper than two-hop ones).  Release mirrors the
    gather lock-lessly, and the atomic count stays ``W - 1`` — the paper's
    half-of-centralized bound is layout-independent.

    A single-socket topology degenerates to :func:`tree_episode` exactly
    (the whole tree is one intra-socket subtree), which is what pins the
    topology path to ``tests/golden_modes.json``-era numbers.

    On a *cluster* machine (``n_nodes > 1``) the span-doubling loop yields
    the node-level merge tier for free: sockets are numbered contiguously
    by node (``node_of_socket(s) = s // sockets_per_node``), so the early
    levels merge socket blocks within one node at the intra-node distance
    and the final ``log2(n_nodes)`` levels join whole nodes at the
    cross-node distance — no extra code, just a more expensive ``d_lvl``
    at the top of the tree (tests/test_cluster.py pins this ordering).
    Barrier flags are single cache lines, so no bandwidth term applies —
    only the latency matrix enters.

    ``topo`` is a :class:`~repro_torch.core.topology.MachineTopology`
    (host-side: the barrier episode is charged once per run, after the
    step loop).
    """
    W = n_workers
    zs = topo.zone_size_for(W)                   # workers per socket block
    s_eff = min(-(-W // zs), topo.n_sockets)     # socket blocks actually used
    # the gather waits for the *deepest* subtree: when W is not a socket
    # multiple the last domain absorbs the remainder (domain ids clip to
    # n_sockets - 1), so it is the widest block
    width = max(zs, W - (topo.n_sockets - 1) * zs)
    d_local = math.ceil(math.log2(width)) if width > 1 else 0
    t = d_local * (costs.c_atomic + costs.c_zone)    # intra-socket gather
    t += d_local * costs.c_zone                      # intra-socket release
    n_top = 0
    span = 1
    while span < s_eff:                 # socket-level merges, pairwise
        d_lvl = 0
        for i in range(0, s_eff, 2 * span):
            for a in range(i, min(i + span, s_eff)):
                for b in range(i + span, min(i + 2 * span, s_eff)):
                    d_lvl = max(d_lvl, int(topo.dist[a][b]))
        if d_lvl:
            t += (costs.c_atomic + d_lvl) + d_lvl    # gather + release
            n_top += 1
        span *= 2
    if d_local + n_top == 0:            # W == 1: keep the legacy depth floor
        t = costs.c_atomic + 2 * costs.c_zone
    return BarrierStats(int(t), W - 1)


def episode_for(barrier_name: str, n_workers: int, costs: CostModel,
                topology=None) -> BarrierStats:
    """The barrier episode one case pays, topology included.

    ``centralized_count`` is topology-independent (one contended line is one
    contended line wherever it is homed).  The tree barrier lays out flat
    without a topology — or with a *flat* one, keeping pre-topology results
    bitwise — and hierarchically otherwise (:func:`tree_episode_topo`).
    """
    if barrier_name == "centralized_count":
        return centralized_episode(n_workers, costs)
    if topology is None or topology.is_flat:
        return tree_episode(n_workers, costs)
    return tree_episode_topo(n_workers, topology, costs)


def episode_arrays(barrier_id, n_workers, costs: CostModel) -> BarrierStats:
    """Tensor-valued episode selector: ``barrier_id`` indexes
    ``spec.BARRIERS`` (0 = centralized_count pays the centralized barrier,
    1 = tree pays the tree barrier), ``barrier_id`` and ``n_workers`` are
    tensors or ints, and the result holds int32 tensors equal to
    ``centralized_episode`` / ``tree_episode``.  The sweeps charge the
    episode on the host (:func:`episode_for`); this is the form for code
    that keeps both on the device."""
    nw = torch.as_tensor(n_workers, dtype=torch.int32)
    cent_t = 2 * (nw - 1) * (costs.c_atomic + costs.c_contend)
    cent_a = 2 * (nw - 1)
    depth = torch.clamp(
        torch.ceil(torch.log2(nw.to(torch.float32))).to(torch.int32), min=1)
    tree_t = depth * (costs.c_atomic + costs.c_zone) + depth * costs.c_zone
    tree_a = nw - 1
    is_cent = torch.as_tensor(barrier_id, device=nw.device) == 0
    return BarrierStats(
        time_ns=torch.where(is_cent, cent_t, tree_t).to(torch.int32),
        atomic_ops=torch.where(is_cent, cent_a, tree_a).to(torch.int32))


def tree_gathered(idle: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Pure predicate used by tests: bottom-up AND over a binary tree —
    worker w is gathered iff it is idle and both children (2w+1, 2w+2) are
    gathered.  Returns per-worker gathered flags; the root flag is the
    barrier's release trigger."""
    W = n_workers
    gathered = idle
    # iterate depth times: flags propagate up one level per pass
    depth = max(1, math.ceil(math.log2(W))) + 1
    idx = torch.arange(W, device=idle.device)
    left, right = 2 * idx + 1, 2 * idx + 2
    for _ in range(depth):
        lg = torch.where(left < W, gathered[torch.clamp(left, max=W - 1)],
                         True)
        rg = torch.where(right < W, gathered[torch.clamp(right, max=W - 1)],
                         True)
        gathered = idle & lg & rg
    return gathered
