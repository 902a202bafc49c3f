"""Run loop of the lock-less task scheduler simulator, in PyTorch.

The counterpart of the JAX package's ``repro.core.scheduler``: it builds a
case on the host, initialises the state on the device, repeats
:func:`~repro_torch.core.phases.step_pipeline` while
:func:`~repro_torch.core.phases.run_gate` holds, and adds the barrier
episode.  Results are bitwise those of the JAX package (the simulator
counts virtual nanoseconds in integers).

Runs go to the CUDA device unless the caller passes ``device="cpu"``;
without a GPU and without ``device=`` the run raises.  The step backend
follows the device (the fused ``cuda_fused`` kernel on the card, one
launch per run; the plain ``reference`` ops on the CPU) unless
``cfg.backend`` names one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import arrivals as arrivals_mod
from repro_torch.core import backends as backends_mod
from repro_torch.core import barrier as barrier_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.spec import MODE_SPECS, RuntimeSpec, resolve_spec
from repro_torch.core.state import (CTR, CTR_NAMES, GraphArrays, Params,
                                    SimConfig, SimState, SweepCase,
                                    batch_of_one, graph_arrays, init_batch,
                                    lane, make_case, make_params, to_device)
from repro_torch.core.taskgraph import TaskGraph

#: legacy five-rung ladder names (see repro_torch.core.spec for the lattice)
MODES = tuple(MODE_SPECS)
MODE_ID = {m: i for i, m in enumerate(MODES)}


def resolve_device(device=None) -> torch.device:
    """The run's device: ``device`` as given, else the CUDA device.  No
    GPU and no explicit device is an error, never a silent CPU run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class SimResult:
    name: str
    mode: str                 # legacy ladder name when on-ladder, else slug
    n_workers: int
    completed: bool
    time_ns: int
    steps: int
    counters: dict            # summed over workers
    per_worker_busy: np.ndarray
    per_worker_clock: np.ndarray
    per_worker_exec: np.ndarray
    spec: RuntimeSpec | None = None   # the lattice point that produced this
    arrivals: str = "closed"          # arrival-process label (see arrivals)
    slo: dict | None = None           # arrivals.slo_metrics record

    @property
    def throughput_tasks_per_s(self) -> float:
        return self.counters["exec"] / max(self.time_ns, 1) * 1e9

    @property
    def latency_p99_ns(self) -> int:
        """Nearest-rank p99 of per-task (completion − release) latency."""
        return int(self.slo["p99_ns"]) if self.slo else -1

    @property
    def sustained_tasks_per_s(self) -> float:
        """Completions over the busy span (open-system throughput)."""
        return float(self.slo["throughput_tasks_per_s"]) if self.slo else 0.0


class Run(NamedTuple):
    """One finished simulation: the final state and what built it."""
    name: str
    state: SimState
    graph: GraphArrays
    case: SweepCase
    spec: RuntimeSpec
    cfg: SimConfig
    topology: topology_mod.MachineTopology | None
    arrivals: arrivals_mod.ArrivalProcess | None
    release: np.ndarray | None


def run(graph: TaskGraph, mode: str | RuntimeSpec | None = None,
        params: Params | None = None, cfg: SimConfig | None = None,
        seed: int = 0, *, spec: RuntimeSpec | str | None = None,
        topology=None, arrivals=None, device=None) -> Run:
    """Simulate ``graph`` to completion and return the final state (the
    arguments are :func:`run_schedule`'s).  ``params`` built by
    :func:`~repro_torch.core.state.make_params` may lie on the CPU or on
    the run's device; ``None`` takes the defaults."""
    dev = resolve_device(device)
    rspec = resolve_spec(spec, mode, where="run_schedule")
    topo = topology_mod.resolve(topology)
    arr = arrivals_mod.resolve(arrivals)
    cfg = cfg or SimConfig()
    cfg = dataclasses.replace(
        cfg, backend=backends_mod.resolve_name(cfg.backend, dev))
    params = params if params is not None else make_params()
    gq_cap = graph.n_tasks + 2 if rspec.queue == "locked_global" else 4
    W = cfg.n_workers
    zone_size = (topo.zone_size_for(W) if topo is not None
                 else max(W // cfg.n_zones, 1))
    release = (None if arr is None
               else arrivals_mod.release_times(arr, graph.n_tasks, seed))
    # inputs are built on the host and copied without a host sync; the
    # state is built on the device (on ``cuda_fused`` the whole run is
    # then one launch and no host sync)
    case = to_device(batch_of_one(make_case(
        rspec, W, zone_size, seed, round(float(graph.mem_bound), 3), params,
        topology=topo, release_ns=release)), dev)
    g = to_device(batch_of_one(graph_arrays(graph)), dev)
    st = init_batch(g, case.seed, W, cfg.stack_cap, cfg.queue_cap, gq_cap)
    st = backends_mod.run_loop(cfg.backend)(
        st, g, case, costs=cfg.costs, max_steps=cfg.max_steps,
        max_iters=cfg.max_steps)
    g, case = lane(g, 0), lane(case, 0)
    return Run(graph.name, lane(st, 0), g, case, rspec, cfg, topo, arr,
               release)


def result(r: Run) -> SimResult:
    """Reduce a finished :class:`Run` to the makespan, the §V counters and
    the per-task SLO record, adding the barrier episode."""
    st, W = r.state, r.cfg.n_workers
    n_tasks = int(r.graph.n_tasks)
    episode = barrier_mod.episode_for(r.spec.barrier, W, r.cfg.costs,
                                      r.topology)
    ctr = st.ctr.cpu().numpy()
    clock = st.clock.cpu().numpy()
    counters = {n: int(ctr[:, i].sum()) for i, n in enumerate(CTR_NAMES)}
    counters["atomic_ops"] += int(episode.atomic_ops)
    time_ns = int(clock.max()) + int(episode.time_ns)
    rel_host = (np.zeros(n_tasks, np.int64) if r.release is None
                else r.release)
    slo = arrivals_mod.slo_metrics(st.done_ns.cpu().numpy(), rel_host,
                                   n_tasks)
    return SimResult(
        name=r.name, mode=r.spec.label, n_workers=W,
        completed=int(st.n_done) == n_tasks and not bool(st.overflow),
        time_ns=time_ns, steps=int(st.step_i), counters=counters,
        per_worker_busy=ctr[:, CTR["busy_ns"]].copy(),
        per_worker_clock=clock.copy(),
        per_worker_exec=ctr[:, CTR["exec"]].copy(),
        spec=r.spec, arrivals=arrivals_mod.label(r.arrivals), slo=slo,
    )


def run_schedule(graph: TaskGraph, mode: str | RuntimeSpec | None = None,
                 params: Params | None = None, cfg: SimConfig | None = None,
                 seed: int = 0, *, spec: RuntimeSpec | str | None = None,
                 topology=None, arrivals=None, device=None) -> SimResult:
    """Simulate scheduling ``graph`` under one runtime configuration.

    ``spec`` names the configuration (a :class:`RuntimeSpec` lattice point;
    the legacy string ``mode=`` still works with a ``DeprecationWarning``);
    the default is the SLB baseline (XQueue + tree barrier + static
    round-robin).  ``topology`` names the simulated machine (``None`` = the
    flat ``cfg.n_zones`` machine); ``arrivals`` runs the open-system mode
    (``None`` = closed system).  ``device`` defaults to the CUDA device and
    raises without one.  Returns makespan + the paper's §V counters, plus
    the per-task SLO record.
    """
    return result(run(graph, mode, params, cfg, seed, spec=spec,
                      topology=topology, arrivals=arrivals, device=device))
