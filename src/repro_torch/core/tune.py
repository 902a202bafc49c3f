"""Autotuner for the paper's DLB knobs (§IV-E, Table I).

The counterpart of the JAX package's ``repro.core.tune``, with the same
names, search and artifacts (plus ``device=``).  The paper hand-tunes
``n_victim`` / ``n_steal`` / ``T_interval`` / ``p_local`` per application;
this module searches them instead, driven entirely through the experiment
service (``run_cases``), so every evaluated configuration batches, shards,
and caches like any other sweep — re-running a tuner over overlapping rungs
is nearly free once the result cache is warm.  On the card each rung is one
``run_cases`` call on ``cuda_fused``: one fused-kernel launch per chunk.

The search is successive halving with grid refinement: rung 0 evaluates a
coarse grid (plus any caller-seeded configurations, e.g. a hand-tuned
reference — guaranteeing the final pick matches or beats it), then each
round keeps the top ``survivors`` and evaluates their ladder neighbors
(one notch up/down per knob on the ``LADDERS`` below).  Scoring is the mean
makespan over ``seeds``; incomplete runs score infinity.  Everything is
deterministic: ties break lexicographically on the knob tuple.

Per-(app, spec) results persist as JSON artifacts under
``experiments/tuned/`` (:func:`save_artifact` / :func:`load_tuned`), one
file per runtime spec — e.g.
``experiments/tuned/smoke/fib__xqueue-tree-na_ws.json``.  The files are the
JAX package's, byte for byte: both packages read the same artifacts, and
this one writes only where its caller asks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, Optional, Sequence

from repro_torch.core import arrivals as arrivals_mod
from repro_torch.core import topology as topology_mod
from repro_torch.core.cache import CODE_VERSION
from repro_torch.core.plan import CaseSpec
from repro_torch.core.spec import DLB_BALANCERS, RuntimeSpec, resolve_spec
from repro_torch.core.state import SimConfig
from repro_torch.core.sweep import run_cases
from repro_torch.core.taskgraph import TaskGraph

DEFAULT_TUNED_DIR = os.path.join("experiments", "tuned")


def _resolve_topology(topology):
    """Normalize a ``topology=`` argument for artifact slotting: flat
    topologies are bitwise-identical to the no-topology machine, so they
    collapse onto the historical (topology-free) slot."""
    t = topology_mod.resolve(topology)
    return None if t is not None and t.is_flat else t


#: refinement ladders — the per-knob positions the search can land on.
#: Bounds follow the simulator's static caps (NV_CAP=24, WS_CAP=32) and the
#: paper's swept ranges.
LADDERS = dict(
    n_victim=(1, 2, 4, 8, 12, 16, 24),
    n_steal=(1, 2, 4, 8, 16, 32),
    t_interval=(10, 30, 100, 300, 1000),
    p_local=(0.25, 0.5, 0.75, 1.0),
)

#: rung-0 grid: 3·3·2·2 = 36 configurations per (app, mode); refinement
#: reaches every other ladder position from here.
COARSE = dict(
    n_victim=(1, 4, 12),
    n_steal=(1, 8, 32),
    t_interval=(10, 100),
    p_local=(1.0, 0.25),
)


@dataclasses.dataclass(frozen=True, order=True)
class TunedParams:
    """One point in DLB-knob space (ordered for deterministic tie-breaks)."""
    n_victim: int = 4
    n_steal: int = 8
    t_interval: int = 100
    p_local: float = 1.0

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def _neighbors(p: TunedParams) -> Iterable[TunedParams]:
    """One ladder notch up/down per knob (8 candidates max)."""
    for knob, ladder in LADDERS.items():
        v = getattr(p, knob)
        idx = min(range(len(ladder)), key=lambda k: (abs(ladder[k] - v), k))
        for d in (-1, 1):
            j = idx + d
            if 0 <= j < len(ladder) and ladder[j] != v:
                yield dataclasses.replace(p, **{knob: ladder[j]})


def tune_spec(graph: TaskGraph, spec: RuntimeSpec | str, cfg: SimConfig, *,
              seeds: Sequence[int] = (0,), rounds: int = 2,
              survivors: int = 4, coarse: Optional[dict] = None,
              extra: Sequence[TunedParams] = (), cache=None,
              strategy: str = "auto", chunk_size: int = 64,
              topology=None, arrivals=None, device=None) -> dict:
    """Search the DLB knobs for one (graph, spec); returns the best point.

    ``spec`` must sit on a DLB balancer (na_rp / na_ws).  ``topology``
    tunes against a specific machine (artifacts slot per topology);
    ``arrivals`` against an open-system arrival process, where the
    objective is the mean *p99 task latency* instead of the mean makespan.
    ``extra`` configurations join rung 0 — seeding the hand-tuned
    reference guarantees the result matches or beats it under the same
    seeds.  ``device`` goes to ``run_cases``: the CUDA device unless the
    caller passes ``device="cpu"``.  Returns ``dict(params, makespan_ns,
    n_configs, n_sims, seeds, objective[, p99_ns])``, the JAX package's
    answer for the same inputs.
    """
    spec = RuntimeSpec.coerce(spec)
    assert spec.balance in DLB_BALANCERS, spec
    topology = _resolve_topology(topology)
    arrivals = arrivals_mod.resolve(arrivals)
    coarse = coarse or COARSE
    seeds = tuple(seeds)
    scores: Dict[TunedParams, float] = {}
    makespans: Dict[TunedParams, float] = {}
    n_sims = 0

    def evaluate(cands: Sequence[TunedParams]) -> None:
        nonlocal n_sims
        todo = [p for p in dict.fromkeys(cands) if p not in scores]
        if not todo:
            return
        specs = [CaseSpec(spec=spec, n_workers=cfg.n_workers,
                          n_zones=cfg.n_zones, seed=sd, n_victim=p.n_victim,
                          n_steal=p.n_steal, t_interval=p.t_interval,
                          p_local=p.p_local, topology=topology,
                          arrivals=arrivals)
                 for p in todo for sd in seeds]
        res = run_cases(graph, specs, cfg=cfg, cache=cache,
                        strategy=strategy, chunk_size=chunk_size,
                        device=device)
        n_sims += len(specs)
        k = len(seeds)
        for j, p in enumerate(todo):
            sl = slice(j * k, (j + 1) * k)
            if not res.completed[sl].all():
                scores[p] = makespans[p] = float("inf")
                continue
            # numpy float64 means of the int64 makespans and float64 p99s,
            # as the JAX package scores them
            makespans[p] = float(res.time_ns[sl].mean())
            if arrivals is None:
                scores[p] = makespans[p]
            else:
                scores[p] = float(res.p99_ns[sl].mean())

    rung0 = [TunedParams(nv, ns, ti, pl)
             for nv in coarse["n_victim"] for ns in coarse["n_steal"]
             for ti in coarse["t_interval"] for pl in coarse["p_local"]]
    evaluate(list(rung0) + list(extra))
    for _ in range(rounds):
        top = sorted(scores, key=lambda p: (scores[p], p))[:survivors]
        cand = [n for p in top for n in _neighbors(p) if n not in scores]
        if not cand:
            break
        evaluate(cand)

    best = min(scores, key=lambda p: (scores[p], p))
    assert scores[best] != float("inf"), \
        f"no completing configuration found for {graph.name}/{spec.slug}"
    out = dict(params=best, makespan_ns=int(makespans[best]),
               n_configs=len(scores), n_sims=n_sims, seeds=seeds,
               objective="makespan" if arrivals is None else "p99_latency")
    if arrivals is not None:
        out["p99_ns"] = int(scores[best])
    return out


def tune_mode(graph: TaskGraph, mode: str, cfg: SimConfig, **kw) -> dict:
    """Deprecated shim: legacy mode-name entry point for :func:`tune_spec`."""
    spec = resolve_spec(None, mode, where="tune_mode")
    return tune_spec(graph, spec, cfg, **kw)


def sim_signature(cfg: SimConfig) -> str:
    """Digest of the result-relevant simulation physics beyond machine
    size: queue/stack capacities, step budget, and the full cost model —
    the same fields the result cache keys on.  Artifacts tuned under
    different physics must not be applied."""
    blob = json.dumps(dict(
        queue_cap=cfg.queue_cap, stack_cap=cfg.stack_cap,
        max_steps=cfg.max_steps,
        costs={k: repr(v) for k, v in
               sorted(dataclasses.asdict(cfg.costs).items())},
    ), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def artifact_path(app: str, spec: RuntimeSpec | str, smoke: bool,
                  tuned_dir: str = DEFAULT_TUNED_DIR,
                  topology=None, arrivals=None) -> str:
    """``<tuned_dir>/<smoke|full>/<app>__<spec-slug>.json`` — one slot per
    (scale, app, lattice point).  A non-flat topology appends
    ``@<topology-name>`` to the slug, an arrival process appends
    ``+<process-label>``; flat/None and closed/None keep the historical
    filename."""
    spec = RuntimeSpec.coerce(spec)
    topology = _resolve_topology(topology)
    arrivals = arrivals_mod.resolve(arrivals)
    suffix = "" if topology is None else f"@{topology.name}"
    if arrivals is not None:
        suffix += f"+{arrivals.label()}"
    return os.path.join(tuned_dir, "smoke" if smoke else "full",
                        f"{app}__{spec.slug}{suffix}.json")


def save_artifact(app: str, spec: RuntimeSpec | str, result: dict,
                  cfg: SimConfig, *, smoke: bool,
                  slb_ns: Optional[int] = None,
                  ref: Optional[dict] = None,
                  tuned_dir: str = DEFAULT_TUNED_DIR,
                  topology=None, arrivals=None) -> str:
    """Write one (app, spec[, topology][, arrivals]) artifact (see
    :func:`artifact_path`) and return its path.

    ``result`` is :func:`tune_spec`'s return value.  The artifact records
    the spec axes, the simulated machine, the arrival process and the
    smoke flag, plus the SLB makespan and the hand-tuned reference's
    comparison when given; for the same inputs the file is byte-identical
    to the JAX package's.
    """
    spec = RuntimeSpec.coerce(spec)
    topology = _resolve_topology(topology)
    arrivals = arrivals_mod.resolve(arrivals)
    rec = dict(
        app=app, spec=spec.asdict(), spec_slug=spec.slug,
        smoke=bool(smoke), code_version=CODE_VERSION,
        n_workers=cfg.n_workers, n_zones=cfg.n_zones,
        max_steps=cfg.max_steps, sim_signature=sim_signature(cfg),
        params=result["params"].asdict(),
        makespan_ns=int(result["makespan_ns"]),
        n_configs=int(result["n_configs"]),
        n_sims=int(result["n_sims"]),
        seeds=list(result["seeds"]),
        objective=result.get("objective", "makespan"),
    )
    if topology is not None:
        rec["topology"] = topology.asdict()
    if arrivals is not None:
        rec["arrivals"] = arrivals.asdict()
        rec["p99_ns"] = int(result["p99_ns"])
    if slb_ns is not None:
        rec["slb_ns"] = int(slb_ns)
    if ref is not None:
        rec["ref"] = ref
    path = artifact_path(app, spec, smoke, tuned_dir, topology=topology,
                         arrivals=arrivals)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_tuned(app: str, spec: RuntimeSpec | str, *, smoke: bool,
               cfg: Optional[SimConfig] = None,
               n_workers: Optional[int] = None,
               n_zones: Optional[int] = None,
               max_steps: Optional[int] = None,
               tuned_dir: str = DEFAULT_TUNED_DIR,
               topology=None, arrivals=None) -> Optional[dict]:
    """Load the (app, spec[, topology][, arrivals]) artifact if it matches
    the requested machine and offered load.

    Passing ``cfg`` checks the full simulation scale: worker count, zone
    count, and the physics signature.  Returns the artifact dict, or None
    when absent, unreadable, tuned at a different scale, lattice point,
    machine or arrival process, or under another code version.
    """
    spec = RuntimeSpec.coerce(spec)
    topology = _resolve_topology(topology)
    arrivals = arrivals_mod.resolve(arrivals)
    path = artifact_path(app, spec, smoke, tuned_dir, topology=topology,
                         arrivals=arrivals)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if rec.get("code_version") != CODE_VERSION:
        return None
    if bool(rec.get("smoke")) != bool(smoke):
        return None
    if rec.get("spec") != spec.asdict():
        return None
    want_topo = None if topology is None else topology.asdict()
    if rec.get("topology") != want_topo:
        return None
    want_arr = None if arrivals is None else arrivals.asdict()
    if rec.get("arrivals") != want_arr:
        return None
    if cfg is not None:
        if rec.get("n_workers") != cfg.n_workers:
            return None
        if rec.get("n_zones") != cfg.n_zones:
            return None
        if rec.get("sim_signature") != sim_signature(cfg):
            return None
    if n_workers is not None and rec.get("n_workers") != n_workers:
        return None
    if n_zones is not None and rec.get("n_zones") != n_zones:
        return None
    if max_steps is not None and rec.get("max_steps") != max_steps:
        return None
    if "params" not in rec:
        return None
    return rec
