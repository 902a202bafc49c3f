"""Planning layer of the experiment service: what to run, in which shapes.

``build_plan`` turns a flat list of :class:`CaseSpec` configurations into an
explicit :class:`SweepPlan` — the paddings every executor must share (worker
lane width, task count, locked-global-queue capacity) plus the (spec,
graph)-grouped chunks the batch is cut into.  Planning is pure host-side
bookkeeping (no tensors), the same grouping and padding as the JAX
package's ``repro.core.plan``, so both packages cut a sweep identically.

The plan is executor-independent by contract: results are bitwise identical
whatever the chunking, padding, or execution strategy.  Chunks are
**spec-pure** (they never cross a :class:`~repro_torch.core.spec.RuntimeSpec`
lattice point, so one batched launch never drags cheap runtimes through the
NA-WS transfer machinery) and sort by graph and DLB knobs so heterogeneity
clusters.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core import arrivals as arrivals_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.spec import DLB_BALANCERS, RuntimeSpec, resolve_spec
from repro_torch.core.taskgraph import TaskGraph
from repro_torch.core.topology import MachineTopology

#: legacy alias — balancers whose DLB knobs (n_victim/n_steal/t_interval/
#: p_local) are live
DLB_MODES = DLB_BALANCERS


@dataclasses.dataclass(frozen=True, init=False)
class CaseSpec:
    """Host-side description of one simulator configuration.

    ``spec`` names the runtime as a :class:`RuntimeSpec` lattice point (the
    legacy string ``mode=`` keyword still works with a
    ``DeprecationWarning``); ``.mode`` reads back the ladder name when the
    spec is on-ladder, else the slug.  ``topology`` is a
    :class:`~repro_torch.core.topology.MachineTopology`, a preset name, or
    ``None`` for the flat ``n_zones`` machine (with a topology its sockets
    are the zones and ``n_zones`` is ignored).  ``arrivals`` is an
    :class:`~repro_torch.core.arrivals.ArrivalProcess`, a string spec
    (``"poisson:2"``), or ``None`` for the closed system.
    """
    spec: RuntimeSpec = RuntimeSpec()
    n_workers: int = 32
    n_zones: int = 4
    seed: int = 0
    n_victim: int = 4
    n_steal: int = 8
    t_interval: int = 100
    p_local: float = 1.0
    graph: int = 0          # index into the graphs list passed to run_cases
    topology: MachineTopology | None = None
    arrivals: ArrivalProcess | None = None
    #: cluster tier second stratum (see dlb.pick_victim); only live when
    #: ``topology`` is a cluster machine
    p_local_node: float = 0.75

    # hand-written so the deprecated ``mode=`` keyword stays an init-only
    # argument without becoming a field
    def __init__(self, spec: RuntimeSpec | str | None = None,
                 n_workers: int = 32, n_zones: int = 4, seed: int = 0,
                 n_victim: int = 4, n_steal: int = 8, t_interval: int = 100,
                 p_local: float = 1.0, graph: int = 0,
                 topology: MachineTopology | str | None = None,
                 arrivals: ArrivalProcess | str | None = None,
                 mode: str | RuntimeSpec | None = None,
                 p_local_node: float = 0.75):
        set_ = object.__setattr__      # frozen dataclass
        set_(self, "spec", resolve_spec(spec, mode, where="CaseSpec"))
        set_(self, "n_workers", n_workers)
        set_(self, "n_zones", n_zones)
        set_(self, "seed", seed)
        set_(self, "n_victim", n_victim)
        set_(self, "n_steal", n_steal)
        set_(self, "t_interval", t_interval)
        set_(self, "p_local", p_local)
        set_(self, "graph", graph)
        set_(self, "topology", topology_mod.resolve(topology))
        set_(self, "arrivals", arrivals_mod.resolve(arrivals))
        set_(self, "p_local_node", p_local_node)

    @property
    def mode(self) -> str:
        """Legacy ladder name of this case's spec (slug when off-ladder)."""
        return self.spec.label

    @property
    def zone_size(self) -> int:
        if self.topology is not None:
            return self.topology.zone_size_for(self.n_workers)
        return max(self.n_workers // self.n_zones, 1)

    @property
    def knobs(self) -> tuple:
        return (self.n_victim, self.n_steal, self.t_interval, self.p_local,
                self.p_local_node)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One executor dispatch: a spec-pure slice of the planned cases.

    ``indices`` point into the spec list the plan was built from; batched
    executors pad the chunk from ``n_real`` up to ``padded_size`` with
    *inert* lanes (the first member's configuration against a zero-task
    graph, whose run gate is false from step 0) and drop them on the way
    out.
    """
    indices: Tuple[int, ...]
    spec: RuntimeSpec
    hetero_dlb: bool    # >1 distinct DLB knob tuple under a DLB balancer

    @property
    def mode(self) -> str:
        return self.spec.label

    @property
    def n_real(self) -> int:
        return len(self.indices)

    @property
    def padded_size(self) -> int:
        """Next power of two (the JAX package's compiled-shape rule, kept
        so both packages pad a chunk identically)."""
        p = 1
        while p < self.n_real:
            p *= 2
        return p


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Everything executors need to agree on before running a sweep."""
    n_cases: int
    w_pad: int                      # shared worker lane width (max n_workers)
    t_pad: int                      # shared task count (max graph size)
    gq_cap: int                     # locked-global-queue capacity
    chunks: Tuple[ChunkPlan, ...]

    def validate(self) -> None:
        seen = sorted(i for c in self.chunks for i in c.indices)
        assert seen == list(range(self.n_cases)), "chunks must partition"


def build_plan(graphs: Sequence[TaskGraph], specs: Sequence[CaseSpec],
               chunk_size: int = 64) -> SweepPlan:
    """Group ``specs`` into spec-pure chunks and fix the shared paddings.

    Cases sort by (spec axes, topology, arrivals, graph, DLB knobs, seed)
    and fill chunks greedily up to ``chunk_size``, never crossing a
    :class:`RuntimeSpec` lattice point.  Results scatter back by index, so
    execution order never affects the returned arrays.
    """
    specs = list(specs)
    assert specs, "empty sweep"
    assert chunk_size >= 1
    assert all(0 <= s.graph < len(graphs) for s in specs)
    w_pad = max(s.n_workers for s in specs)
    t_pad = max(g.n_tasks for g in graphs)
    # the locked global queue must hold every live task; other queue
    # flavors leave it untouched, so a tiny placeholder keeps state small
    gq_cap = (t_pad + 2
              if any(s.spec.queue == "locked_global" for s in specs) else 4)

    order = sorted(range(len(specs)), key=lambda i: (
        specs[i].spec.axis_ids,
        "" if specs[i].topology is None else specs[i].topology.sort_key,
        "" if specs[i].arrivals is None else specs[i].arrivals.sort_key,
        specs[i].graph, specs[i].n_steal,
        specs[i].n_victim, specs[i].t_interval, specs[i].p_local,
        specs[i].p_local_node, specs[i].seed))
    groups: List[List[int]] = []
    for i in order:
        if (groups and specs[groups[-1][0]].spec == specs[i].spec
                and len(groups[-1]) < chunk_size):
            groups[-1].append(i)
        else:
            groups.append([i])
    chunks = []
    for idxs in groups:
        spec = specs[idxs[0]].spec
        hetero = (spec.balance in DLB_BALANCERS
                  and len({specs[i].knobs for i in idxs}) > 1)
        chunks.append(ChunkPlan(indices=tuple(idxs), spec=spec,
                                hetero_dlb=hetero))
    plan = SweepPlan(n_cases=len(specs), w_pad=w_pad, t_pad=t_pad,
                     gq_cap=gq_cap, chunks=tuple(chunks))
    plan.validate()
    return plan
