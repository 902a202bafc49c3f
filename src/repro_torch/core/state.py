"""State layer of the simulator: tuples of tensors, configuration, and init.

Everything the scheduler step reads or writes lives here as fixed-shape
``NamedTuple``s of tensors on one device — :class:`SimState` (the whole
simulator state), :class:`SweepCase` (one configuration, every knob a 0-dim
tensor), :class:`GraphArrays` (the device-side task graph) — plus the static
:class:`SimConfig` and the initializers that build them.  The phase
functions in :mod:`repro_torch.core.phases` are ``(state, case, …) -> state``
maps over these types.

Dtypes follow the JAX package leaf for leaf (int32 clocks, counters and
queues; bool flags; float32 knobs) except the per-lane PRNG state, which is
uint32 there and int64 holding the uint32 value here (see
:mod:`repro_torch.core.dlb`).  :func:`to_numpy` / :func:`from_numpy` carry
states between the two packages as dicts of numpy arrays keyed by field path
(``"xq.buf"``, ``"params.n_victim"``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import dlb, messaging, xqueue
from repro_torch.core import topology as topology_mod
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.core.spec import MODE_SPECS, RuntimeSpec
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.core.topology import MachineTopology, TopoArrays

I32 = torch.int32

# counters (paper §V, plus the cluster tier's locality/traffic pair —
# identically zero on flat and single-node machines)
CTR_NAMES = (
    "exec", "self", "local", "remote",            # task locality at execution
    "static_push", "imm_exec",                     # push outcomes
    "req_sent", "req_handled", "req_has_steal",    # messaging protocol
    "stolen", "stolen_local", "stolen_remote",     # migrated tasks (WS + RP)
    "src_empty", "tgt_full",                       # failed steals
    "atomic_ops", "busy_ns",
    "stolen_xnode",                                # steals crossing a node
    "xnode_bytes",                                 # bytes over the bottleneck
)
NC = len(CTR_NAMES)
CTR = {n: i for i, n in enumerate(CTR_NAMES)}

K_SPAWN = 2     # pushes per worker per scheduling point
WS_CAP = 32     # static bound on Alg. 4's per-round transfer loop
NV_CAP = 24     # static bound on requests per thief retry (paper max N_victim)


def _i32(x, device) -> torch.Tensor:
    return torch.tensor(int(x), dtype=I32, device=device)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


class Params(NamedTuple):
    """Dynamic DLB configuration (§IV-E).  ``p_local_node`` is the cluster
    tier's second stratum (only read on cluster topologies)."""
    n_victim: torch.Tensor
    n_steal: torch.Tensor
    t_interval: torch.Tensor  # in scheduling points
    p_local: torch.Tensor
    p_local_node: torch.Tensor


def make_params(n_victim=4, n_steal=8, t_interval=100, p_local=1.0,
                p_local_node=0.75, device="cpu") -> Params:
    return Params(_i32(n_victim, device), _i32(n_steal, device),
                  _i32(t_interval, device), _f32(p_local, device),
                  _f32(p_local_node, device))


class SweepCase(NamedTuple):
    """One simulator configuration, every knob a tensor on the run's
    device.  The three axis ids carry a
    :class:`~repro_torch.core.spec.RuntimeSpec` (queue_id indexes
    ``spec.QUEUES``, etc.)."""
    queue_id: torch.Tensor    # int32 index into spec.QUEUES
    barrier_id: torch.Tensor  # int32 index into spec.BARRIERS
    balance_id: torch.Tensor  # int32 index into spec.BALANCERS
    n_workers: torch.Tensor   # int32 active workers (≤ the padded width)
    zone_size: torch.Tensor   # int32 workers per NUMA zone / socket
    seed: torch.Tensor        # int32 PRNG seed
    mem_bound: torch.Tensor   # float32 memory-bound fraction of task runtime
    params: Params
    topo: TopoArrays          # machine topology (flat degenerate by default)
    closed: torch.Tensor      # bool scalar — closed system (no arrival gate)
    release_ns: torch.Tensor  # (R,) int32 per-task release stamps


def make_case(spec: RuntimeSpec | str | int, n_workers: int, zone_size: int,
              seed: int = 0, mem_bound: float = 0.0,
              params: Params | None = None,
              topology: MachineTopology | str | None = None,
              release_ns=None, closed: bool | None = None,
              device="cpu") -> SweepCase:
    """Lift a runtime configuration to tensors on ``device``.

    ``spec`` accepts a :class:`RuntimeSpec`, a legacy mode name or spec
    slug, or a legacy integer mode id.  ``topology`` accepts a
    :class:`~repro_torch.core.topology.MachineTopology` or preset name;
    ``None`` is the flat degenerate machine.  ``release_ns`` is the
    open-system per-task release vector; ``None`` is the closed system.
    """
    if isinstance(spec, int):
        spec = MODE_SPECS[tuple(MODE_SPECS)[spec]]
    else:
        spec = RuntimeSpec.coerce(spec)
    topo = topology_mod.resolve(topology)
    if closed is None:
        closed = release_ns is None
    release = (np.zeros((1,), np.int32) if release_ns is None
               else np.asarray(release_ns, np.int32))
    return SweepCase(
        queue_id=_i32(spec.queue_id, device),
        barrier_id=_i32(spec.barrier_id, device),
        balance_id=_i32(spec.balance_id, device),
        n_workers=_i32(n_workers, device),
        zone_size=_i32(zone_size, device), seed=_i32(seed, device),
        mem_bound=_f32(mem_bound, device),
        params=params if params is not None else make_params(device=device),
        topo=(topology_mod.degenerate_arrays(device) if topo is None
              else topo.arrays(device)),
        closed=torch.tensor(bool(closed), device=device),
        release_ns=torch.as_tensor(release, device=device))


class GraphArrays(NamedTuple):
    """Device-side task graph (see taskgraph.py for the encoding).
    ``n_tasks`` is the true (unpadded) task count."""
    dur: torch.Tensor
    first_child: torch.Tensor
    n_children: torch.Tensor
    notify: torch.Tensor
    join_dep: torch.Tensor
    n_tasks: torch.Tensor    # int32 scalar — true (unpadded) task count
    payload: torch.Tensor    # (T,) int32 task payload in bytes (cluster D/B)


def graph_arrays(graph: TaskGraph, pad_to: int | None = None,
                 device="cpu") -> GraphArrays:
    """Lift a host TaskGraph to device tensors, optionally padded to a
    common length with inert tasks (dur 0, no children, no notify target)."""
    T = graph.n_tasks
    P = max(pad_to or T, T)

    def pad(a, fill):
        out = np.full(P, fill, np.int32)
        out[:T] = np.asarray(a, np.int32)
        return torch.as_tensor(out, device=device)

    payload = (np.zeros(T, np.int32) if graph.payload is None
               else graph.payload)
    return GraphArrays(
        dur=pad(graph.dur, 0), first_child=pad(graph.first_child, 0),
        n_children=pad(graph.n_children, 0), notify=pad(graph.notify, -1),
        join_dep=pad(graph.join_dep, 0), n_tasks=_i32(T, device),
        payload=pad(payload, 0))


class SimState(NamedTuple):
    xq: xqueue.XQ
    cells: messaging.Cells
    rp: dlb.RPState
    # GOMP-mode single global queue
    g_buf: torch.Tensor
    g_ts: torch.Tensor
    g_head: torch.Tensor
    g_tail: torch.Tensor
    # per-worker spawn stacks of contiguous task-id ranges
    s_task: torch.Tensor   # (W, S) next task id of the range
    s_cnt: torch.Tensor    # (W, S) remaining count
    s_top: torch.Tensor    # (W,)
    # task-graph dynamic state
    join_cnt: torch.Tensor
    done: torch.Tensor
    done_ns: torch.Tensor  # (T,) int32 completion clock per task (-1 = never)
    creator: torch.Tensor
    # worker state
    clock: torch.Tensor
    rr: torch.Tensor
    deq_rr: torch.Tensor
    idle: torch.Tensor
    rng: torch.Tensor      # (W,) int64 holding uint32 xorshift states
    ctr: torch.Tensor      # (W, NC) int32
    n_done: torch.Tensor
    overflow: torch.Tensor
    step_i: torch.Tensor
    #: (W,) int32 — bytes each worker pushed over the inter-node bottleneck
    #: *this step*; charged as link occupancy at step end, then reset
    nlink_bytes: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulator configuration — fixes every tensor shape.
    ``backend`` names the step backend (see :mod:`repro_torch.core.backends`);
    ``None`` follows the device: ``cuda_fused`` on a GPU, ``reference`` on
    the CPU."""
    n_workers: int = 64
    n_zones: int = 8
    queue_cap: int = 16
    stack_cap: int = 512
    max_steps: int = 200_000
    costs: CostModel = DEFAULT_COSTS
    backend: Optional[str] = None


def init_state(g: GraphArrays, W: int, S: int, q_cap: int, gq_cap: int,
               seed) -> SimState:
    """Fresh simulator state on ``g``'s device: empty queues/cells/stacks,
    per-lane RNG streams derived from ``seed``, and the root task seeded
    onto worker 0's spawn stack as a 1-length range (:func:`init_batch`
    for a batch of one)."""
    seeds = torch.tensor([int(seed)], dtype=torch.int64, device=g.dur.device)
    return lane(init_batch(batch_of_one(g), seeds, W, S, q_cap, gq_cap), 0)


# ---------------- batches of simulations ----------------
def tree_map(fn, tree, *rest):
    """``fn`` leaf by leaf over tuples of tensors of one structure (a
    ``SimState``, ``SweepCase`` or ``GraphArrays``), rebuilding the tuple."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The tensors of a tuple of tensors, depth first."""
    if not isinstance(tree, tuple):
        return [tree]
    out = []
    for x in tree:
        if isinstance(x, tuple):
            out.extend(leaves(x))
        else:
            out.append(x)
    return out


def stack(trees):
    """Stack same-shaped tuples of tensors along a new leading batch axis
    (the port's counterpart of vmapping over a batch of simulations)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def to_device(tree, device):
    """Copy a tuple of tensors to ``device`` without a host sync (tensors
    already there are kept as they are)."""
    return tree_map(lambda x: x.to(device, non_blocking=True), tree)


def batch_of_one(tree):
    """A single simulation's tuple as a batch of one: views, so an
    in-place update of the batch reaches the original tensors."""
    return tree_map(lambda x: x.unsqueeze(0), tree)


def lane(tree, b: int):
    """Lane ``b`` of a batched tuple (views)."""
    return tree_map(lambda x: x[b], tree)


def init_batch(gb: GraphArrays, seeds: torch.Tensor, W: int, S: int,
               q_cap: int, gq_cap: int) -> SimState:
    """Fresh states for a batch of graphs ``gb`` with per-lane ``seeds``,
    every leaf with a leading batch axis, built on ``gb``'s device with
    batched fills (no host copy): the JAX package's ``init_state`` lane by
    lane."""
    B, T = gb.dur.shape
    dev = gb.dur.device

    def full(shape, value, dtype=I32):
        return torch.full((B, *shape), value, dtype=dtype, device=dev)

    lanes = torch.arange(W, dtype=torch.int64, device=dev)
    seed32 = seeds.to(torch.int64) & dlb.U32_MASK
    rng = (lanes[None, :] * 2654435761
           + ((seed32[:, None] * 40503 + 1) & dlb.U32_MASK)) & dlb.U32_MASK
    s_cnt = full((W, S), 0)
    s_cnt[:, 0, 0] = 1
    s_top = full((W,), 0)
    s_top[:, 0] = 1
    return SimState(
        xq=xqueue.XQ(full((W, W, q_cap), -1), full((W, W, q_cap), 0),
                     full((W, W), 0), full((W, W), 0)),
        cells=messaging.Cells(full((W,), 1), full((W,), 0), full((W,), -1)),
        rp=dlb.RPState(full((W,), -1), full((W,), 0)),
        g_buf=full((gq_cap,), -1), g_ts=full((gq_cap,), 0),
        g_head=full((), 0), g_tail=full((), 0),
        s_task=full((W, S), 0), s_cnt=s_cnt, s_top=s_top,
        join_cnt=gb.join_dep.clone(),
        done=full((T,), False, torch.bool), done_ns=full((T,), -1),
        creator=full((T,), 0), clock=full((W,), 0),
        rr=torch.arange(W, dtype=I32, device=dev).repeat(B, 1),
        deq_rr=full((W,), 0), idle=full((W,), 0), rng=rng.contiguous(),
        ctr=full((W, NC), 0), n_done=full((), 0),
        overflow=full((), False, torch.bool), step_i=full((), 0),
        nlink_bytes=full((W,), 0))


# ---------------- carrying states between the two packages ----------------
#: leaves held as int64 here but uint32 in the JAX package
_UINT32_LEAVES = ("rng",)


def to_numpy(tree, prefix: str = "") -> dict:
    """Flatten a tuple of arrays (this package's tensors, or the JAX
    package's ``SimState``/``SweepCase``/``GraphArrays``) into a dict of
    numpy arrays keyed by dotted field path.  The PRNG leaf comes out as
    uint32 on either side."""
    out = {}
    for name, leaf in zip(tree._fields, tree):
        path = prefix + name
        if hasattr(leaf, "_fields"):
            out.update(to_numpy(leaf, path + "."))
            continue
        if isinstance(leaf, torch.Tensor):
            arr = leaf.detach().cpu().numpy()
        else:
            arr = np.asarray(leaf)
        if name in _UINT32_LEAVES:
            arr = arr.astype(np.uint32)
        out[path] = arr
    return out


def from_numpy(arrays: dict, cls, device="cpu", prefix: str = ""):
    """Build ``cls`` (``SimState``, ``SweepCase`` or ``GraphArrays``, or
    any of their nested tuples) on ``device`` from a :func:`to_numpy`-style
    dict.  Every array is copied."""
    fields = {}
    for name in cls._fields:
        path = prefix + name
        sub = _NESTED.get((cls, name))
        if sub is not None:
            fields[name] = from_numpy(arrays, sub, device, path + ".")
            continue
        arr = np.array(arrays[path])
        if name in _UINT32_LEAVES:
            arr = arr.astype(np.int64)
        fields[name] = torch.as_tensor(arr, device=device)
    return cls(**fields)


_NESTED = {
    (SimState, "xq"): xqueue.XQ,
    (SimState, "cells"): messaging.Cells,
    (SimState, "rp"): dlb.RPState,
    (SweepCase, "params"): Params,
    (SweepCase, "topo"): TopoArrays,
}
