"""The experiment service: batched scheduler-ablation sweeps, layered.

The counterpart of the JAX package's ``repro.core.sweep``, with the same
entry points, arguments (plus ``device=``) and results:

* **plan** (:mod:`repro_torch.core.plan`) — case list → ``SweepPlan``:
  shared paddings and spec-pure chunks;
* **cache** (:mod:`repro_torch.core.cache`) — the content-addressed result
  store, consulted per case before anything runs (keys and entries shared
  with the JAX package);
* **executors** (:mod:`repro_torch.core.executors`) — ``serial`` /
  ``vmap`` / ``sharded``, bitwise identical by contract.

``run_cases(graphs, specs)`` runs an arbitrary list of :class:`CaseSpec`;
``run_grid(graphs, queues=..., ...)`` is the cartesian sugar that labels
the result with ``grid_axes``.  Sweeps run on the CUDA device unless the
caller passes ``device="cpu"``; without a GPU and without ``device=`` they
raise.  The backend follows the device (``cuda_fused`` on the card, one
launch per batched chunk; ``reference`` on the CPU).

Correctness contract: a batched run is bitwise identical to running each
configuration alone under any executor and backend, a single-configuration
run matches ``run_schedule``, and a cache hit reproduces the executed
result exactly.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import arrivals as arrivals_mod
from repro_torch.core import backends as backends_mod
from repro_torch.core import barrier as barrier_mod
from repro_torch.core import cache as cache_mod
from repro_torch.core import executors as executors_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.executors import STRATEGIES, ExecContext, select_executor
from repro_torch.core.plan import CaseSpec, build_plan
from repro_torch.core.scheduler import resolve_device
from repro_torch.core.spec import AXES, RuntimeSpec, spec_product
from repro_torch.core.state import (CTR_NAMES, SimConfig, graph_arrays,
                                    to_device)
from repro_torch.core.taskgraph import TaskGraph

__all__ = ["CaseSpec", "SweepResult", "run_cases", "run_grid"]


@dataclasses.dataclass
class SweepResult:
    """Structured result of a batched sweep.

    ``time_ns``/``counters``/``completed``/``steps`` are flat per-case
    arrays in ``specs`` order.  From ``run_grid``, ``grid_axes`` names the
    cartesian axes and ``makespans`` / ``counter(name)`` reshape to the
    grid.  The SLO arrays carry per-task latency percentiles and sustained
    throughput (``NaN`` only for a case served from a cache entry written
    before the streaming fields existed).
    """
    specs: List[CaseSpec]
    graph_names: List[str]
    time_ns: np.ndarray               # (B,) int64
    counters: Dict[str, np.ndarray]   # name -> (B,) int64
    completed: np.ndarray             # (B,) bool
    steps: np.ndarray                 # (B,) int64
    wall_s: float = 0.0               # engine wall-clock for this sweep
    cache_hits: int = 0               # cases served from the result cache
    grid_axes: Optional[Dict[str, tuple]] = None
    p50_ns: Optional[np.ndarray] = None        # (B,) float64 (NaN = unknown)
    p90_ns: Optional[np.ndarray] = None
    p99_ns: Optional[np.ndarray] = None
    throughput: Optional[np.ndarray] = None    # (B,) tasks/s over busy span

    def _grid(self, a: np.ndarray) -> np.ndarray:
        if self.grid_axes is None:
            return a
        return a.reshape(tuple(len(v) for v in self.grid_axes.values()))

    @property
    def makespans(self) -> np.ndarray:
        return self._grid(self.time_ns)

    def counter(self, name: str) -> np.ndarray:
        return self._grid(self.counters[name])

    def slo(self, name: str) -> np.ndarray:
        """Grid-shaped view of one SLO array (``p50_ns``/``p90_ns``/
        ``p99_ns``/``throughput``)."""
        return self._grid(getattr(self, name))

    def row(self, i: int) -> dict:
        """One case as a flat dict (benchmark emission helper)."""
        s = self.specs[i]
        return dict(
            app=self.graph_names[s.graph], mode=s.mode,
            queue=s.spec.queue, barrier=s.spec.barrier,
            balance=s.spec.balance,
            topology=topology_mod.label(s.topology),
            arrivals=arrivals_mod.label(s.arrivals),
            n_workers=s.n_workers, seed=s.seed, n_victim=s.n_victim,
            n_steal=s.n_steal, t_interval=s.t_interval, p_local=s.p_local,
            p_local_node=s.p_local_node,
            time_ns=int(self.time_ns[i]), completed=bool(self.completed[i]),
            p50_ns=float(self.p50_ns[i]), p90_ns=float(self.p90_ns[i]),
            p99_ns=float(self.p99_ns[i]),
            throughput_tasks_per_s=float(self.throughput[i]),
            counters={k: int(v[i]) for k, v in self.counters.items()})


def run_cases(graphs: Sequence[TaskGraph] | TaskGraph,
              specs: Sequence[CaseSpec], cfg: SimConfig | None = None,
              chunk_size: int = 64, strategy: str = "auto",
              cache=None, backend: str | None = None,
              pipeline: bool = True, device=None) -> SweepResult:
    """Run every ``CaseSpec`` through the experiment service.

    The result cache (``cache=True`` for the default store, or a
    ``ResultCache``) is consulted per case first; only misses are planned,
    padded and executed.  Per-case results return in ``specs`` order and
    are bitwise independent of grouping, padding, caching, execution
    strategy and backend (which is why the cache keys leave the backend
    out).

    ``strategy``: ``"serial"`` / ``"vmap"`` (alias ``"batched"``) /
    ``"sharded"`` force one executor; ``"auto"`` batches on ``cuda_fused``
    and runs case by case otherwise (see
    :func:`~repro_torch.core.executors.select_executor`).  ``backend``
    overrides ``cfg.backend``; ``None`` follows the device.  ``pipeline``
    (default on) submits chunk *k+1* before collecting chunk *k*.
    """
    if isinstance(graphs, TaskGraph):
        graphs = [graphs]
    graphs = list(graphs)
    specs = list(specs)
    assert specs, "empty sweep"
    assert all(0 <= s.graph < len(graphs) for s in specs)
    assert strategy in STRATEGIES, (strategy, STRATEGIES)
    dev = resolve_device(device)
    cfg = cfg or SimConfig()
    cfg = dataclasses.replace(cfg, backend=backends_mod.resolve_name(
        backend if backend is not None else cfg.backend, dev))

    t0 = time.perf_counter()
    B = len(specs)
    clock_max = np.zeros(B, np.int64)
    ctr_sum = np.zeros((B, len(CTR_NAMES)), np.int64)
    n_done = np.zeros(B, np.int64)
    overflow = np.zeros(B, bool)
    step_i = np.zeros(B, np.int64)
    slo_arr = {n: np.full(B, np.nan) for n in arrivals_mod.SLO_FIELDS}

    def fill_slo(i: int, rec: Optional[dict]) -> None:
        if rec:
            for n in arrivals_mod.SLO_FIELDS:
                slo_arr[n][i] = float(rec[n])

    def release_for(s: CaseSpec) -> np.ndarray:
        g = graphs[s.graph]
        if s.arrivals is None:
            return np.zeros(g.n_tasks, np.int64)
        return arrivals_mod.release_times(s.arrivals, g.n_tasks, s.seed)

    store = cache_mod.resolve(cache)
    keys: List[Optional[str]] = [None] * B
    miss = list(range(B))
    hits = 0
    if store is not None:
        digests = [cache_mod.graph_digest(g) for g in graphs]
        miss = []
        for i, s in enumerate(specs):
            keys[i] = cache_mod.case_key(digests[s.graph], s, cfg)
            rec = store.get(keys[i], required_counters=CTR_NAMES)
            if rec is None:
                miss.append(i)
                continue
            hits += 1
            clock_max[i] = int(rec["clock_max"])
            ctr_sum[i] = [int(rec["counters"][n]) for n in CTR_NAMES]
            n_done[i] = int(rec["n_done"])
            overflow[i] = bool(rec["overflow"])
            step_i[i] = int(rec["step_i"])
            fill_slo(i, rec.get("slo"))

    if miss:
        miss_specs = [specs[i] for i in miss]
        plan = build_plan(graphs, miss_specs, chunk_size=chunk_size)
        run_cfg = dataclasses.replace(cfg, n_workers=plan.w_pad)
        ctx = ExecContext(
            cfg=run_cfg, gq_cap=plan.gq_cap, graphs=graphs,
            garr=[to_device(graph_arrays(g, plan.t_pad), dev)
                  for g in graphs],
            device=dev,
            release_len=(plan.t_pad
                         if any(s.arrivals is not None for s in miss_specs)
                         else 1))

        def postprocess(chunk, raw) -> None:
            executors_mod.ENGINE_STATS["sim_steps"] += int(raw.step_i.sum())
            for j, mi in enumerate(chunk.indices):
                i = miss[mi]
                s = specs[i]
                clock_max[i] = int(raw.clock[j].max())
                ctr_sum[i] = raw.ctr[j].sum(axis=0)
                n_done[i] = int(raw.n_done[j])
                overflow[i] = bool(raw.overflow[j])
                step_i[i] = int(raw.step_i[j])
                slo = arrivals_mod.slo_metrics(
                    raw.done_ns[j], release_for(s), graphs[s.graph].n_tasks)
                fill_slo(i, slo)
                if store is not None:
                    # metadata stamps only; keys stay app-blind
                    store.put(keys[i], dict(
                        clock_max=int(clock_max[i]),
                        counters={n: int(ctr_sum[i][k])
                                  for k, n in enumerate(CTR_NAMES)},
                        n_done=int(n_done[i]), overflow=bool(overflow[i]),
                        step_i=int(step_i[i]), slo=slo,
                        topology=topology_mod.label(s.topology),
                        arrivals=arrivals_mod.label(s.arrivals),
                        app=graphs[s.graph].name.split("(")[0]))

        # depth-2 pipeline: chunk k+1 is submitted (stacked, initialised
        # and launched) before chunk k is collected
        pending = None  # (executor, handle, chunk) in flight
        for chunk in plan.chunks:
            ex = select_executor(strategy, chunk, cfg.backend, dev)
            handle = ex.submit(ctx, miss_specs, chunk)
            if not pipeline:
                postprocess(chunk, ex.collect(handle))
                continue
            if pending is not None:
                postprocess(pending[2], pending[0].collect(pending[1]))
            pending = (ex, handle, chunk)
        if pending is not None:
            postprocess(pending[2], pending[0].collect(pending[1]))

    # barrier episode per case, host-side, as run_schedule accounts it
    ep_t = np.zeros(B, np.int64)
    ep_a = np.zeros(B, np.int64)
    for i, s in enumerate(specs):
        ep = barrier_mod.episode_for(s.spec.barrier, s.n_workers, cfg.costs,
                                     s.topology)
        ep_t[i] = int(ep.time_ns)
        ep_a[i] = int(ep.atomic_ops)

    time_ns = clock_max + ep_t
    counters = {n: ctr_sum[:, i].copy() for i, n in enumerate(CTR_NAMES)}
    counters["atomic_ops"] = counters["atomic_ops"] + ep_a
    completed = np.array(
        [n_done[i] == graphs[s.graph].n_tasks and not overflow[i]
         for i, s in enumerate(specs)])
    return SweepResult(
        specs=specs, graph_names=[g.name for g in graphs],
        time_ns=time_ns, counters=counters, completed=completed,
        steps=step_i, wall_s=time.perf_counter() - t0, cache_hits=hits,
        p50_ns=slo_arr["p50_ns"], p90_ns=slo_arr["p90_ns"],
        p99_ns=slo_arr["p99_ns"],
        throughput=slo_arr["throughput_tasks_per_s"])


def run_grid(graphs: Sequence[TaskGraph] | TaskGraph,
             modes: Sequence[str | RuntimeSpec] | None = None,
             n_workers: Sequence[int] = (32,),
             seeds: Sequence[int] = (0,),
             n_victim: Sequence[int] = (4,),
             n_steal: Sequence[int] = (8,),
             t_interval: Sequence[int] = (100,),
             p_local: Sequence[float] = (1.0,),
             n_zones: int | None = None,
             cfg: SimConfig | None = None,
             chunk_size: int = 64, strategy: str = "auto",
             cache=None, backend: str | None = None,
             pipeline: bool = True, *,
             queues: Sequence[str] | None = None,
             barriers: Sequence[str] | None = None,
             balancers: Sequence[str] | None = None,
             topologies: Sequence = (None,),
             bandwidths: Sequence = (None,),
             arrivals: Sequence = (None,),
             p_local_node: Sequence[float] = (0.75,),
             device=None) -> SweepResult:
    """Cartesian sweep over the spec lattice × machine × workers × seeds ×
    DLB knobs (the JAX package's ``run_grid``; see its docstring for every
    axis).  Unset lattice axes default to the SLB baseline's value; the
    deprecated ``modes=`` list keeps its ``mode`` axis.  Returns a
    ``SweepResult`` whose ``grid_axes`` names every axis in declaration
    order."""
    if isinstance(graphs, TaskGraph):
        graphs = [graphs]
    graphs = list(graphs)
    cfg = cfg or SimConfig()
    zones = cfg.n_zones if n_zones is None else n_zones

    lattice_args = (queues, barriers, balancers)
    if modes is not None and any(a is not None for a in lattice_args):
        raise TypeError("pass either the deprecated modes= or the "
                        "queues=/barriers=/balancers= lattice to run_grid, "
                        "not both")
    if modes is not None:
        if any(isinstance(m, str) for m in modes):
            warnings.warn(
                "modes= in run_grid is deprecated; pass queues=/barriers=/"
                "balancers= (see repro_torch.core.spec.MODE_SPECS for the "
                "mode→spec mapping)", DeprecationWarning, stacklevel=2)
        spec_list = tuple(RuntimeSpec.coerce(m) for m in modes)
        spec_axes = dict(mode=tuple(
            m if isinstance(m, str) else m.label for m in modes))
    else:
        baseline = RuntimeSpec()
        lattice = {}
        for name, vals in zip(("queue", "barrier", "balance"),
                              lattice_args):
            if vals is None:
                lattice[name] = (getattr(baseline, name),)
                continue
            vals = tuple(vals)
            assert vals, f"empty {name} axis in run_grid"
            assert all(v in AXES[name] for v in vals), (name, vals)
            lattice[name] = vals
        spec_list = spec_product(lattice["queue"], lattice["barrier"],
                                 lattice["balance"])
        spec_axes = lattice
    topo_list = tuple(topology_mod.resolve(t) for t in topologies)
    assert topo_list, "empty topology axis in run_grid"
    bw_list = tuple(bandwidths)
    assert bw_list, "empty bandwidth axis in run_grid"
    assert all(b is None for b in bw_list) \
        or all(t is not None for t in topo_list), \
        "bandwidths= rescales machine topologies; the flat machine has none"
    arr_list = tuple(arrivals_mod.resolve(a) for a in arrivals)
    assert arr_list, "empty arrivals axis in run_grid"

    def with_bw(t, b):
        return t if b is None else t.with_bandwidth(b)

    axes = dict(app=tuple(g.name for g in graphs), **spec_axes,
                topology=tuple(topology_mod.label(t) for t in topo_list),
                bandwidth=tuple("native" if b is None else int(b)
                                for b in bw_list),
                arrivals=tuple(arrivals_mod.label(a) for a in arr_list),
                n_workers=tuple(n_workers), seed=tuple(seeds),
                n_victim=tuple(n_victim), n_steal=tuple(n_steal),
                t_interval=tuple(t_interval), p_local=tuple(p_local),
                p_local_node=tuple(p_local_node))
    specs = [
        CaseSpec(spec=sp, n_workers=w, n_zones=zones, seed=sd, n_victim=nv,
                 n_steal=ns, t_interval=ti, p_local=pl, graph=gi,
                 topology=with_bw(tp, bw), arrivals=ar, p_local_node=pn)
        for gi in range(len(graphs)) for sp in spec_list
        for tp in topo_list for bw in bw_list for ar in arr_list
        for w in n_workers for sd in seeds for nv in n_victim
        for ns in n_steal for ti in t_interval for pl in p_local
        for pn in p_local_node
    ]
    res = run_cases(graphs, specs, cfg=cfg, chunk_size=chunk_size,
                    strategy=strategy, cache=cache, backend=backend,
                    pipeline=pipeline, device=device)
    res.grid_axes = axes
    return res
