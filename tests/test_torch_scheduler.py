"""End-to-end parity of the port's ``run_schedule`` on the CPU.

* The 10 cases of ``tests/golden_modes.json`` (5 legacy modes × 2 graphs)
  reproduce bitwise — ``time_ns``, ``steps`` and every counter — under
  both step backends.
* Open-system (``arrivals=``) and NUMA / cluster cases match the JAX
  package's ``run_schedule`` field for field, SLO record included, and the
  final simulator state matches leaf for leaf.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import arrivals as j_arr  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.core import state as j_state  # noqa: E402
from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core import topology as j_topo  # noqa: E402
from repro.core.spec import RuntimeSpec as JSpec  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core import taskgraph as t_tg  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402
from repro_torch.core.spec import RuntimeSpec  # noqa: E402
from repro_torch.core.state import (CTR_NAMES, SimConfig,  # noqa: E402
                                    make_params, to_numpy)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_modes.json")
with open(GOLDEN_PATH) as f:
    GOLDEN = json.load(f)
CFG = SimConfig(**GOLDEN["cfg"])
KNOBS = GOLDEN["knobs"]


def t_graph(name):
    family, kw = GOLDEN["graphs"][name]
    return t_tg.build(family, **kw)


@pytest.mark.parametrize("backend", ("reference", "cuda"))
@pytest.mark.parametrize("case", GOLDEN["cases"],
                         ids=[f"{c['graph']}-{c['mode']}"
                              for c in GOLDEN["cases"]])
def test_golden_modes_bitwise(case, backend):
    res = t_sched.run_schedule(
        t_graph(case["graph"]), spec=RuntimeSpec.from_mode(case["mode"]),
        cfg=dataclasses.replace(CFG, backend=backend),
        params=make_params(**KNOBS), device="cpu")
    label = (case["graph"], case["mode"], backend)
    assert res.completed, label
    assert res.time_ns == case["time_ns"], label
    assert res.steps == case["steps"], label
    for name in case["counters"]:
        assert res.counters[name] == case["counters"][name], (*label, name)
    for name in set(CTR_NAMES) - set(case["counters"]):
        assert res.counters[name] == 0, (*label, name)


def _topologies(name):
    if name is None:
        return None, None
    if "@bw" in name:
        base, bw = name.split("@bw")
        return (t_topo.PRESETS[base].with_bandwidth(int(bw)),
                j_topo.PRESETS[base].with_bandwidth(int(bw)))
    return t_topo.PRESETS[name], j_topo.PRESETS[name]


def _jax_run(graph, spec, cfg, seed, topo, arrivals, params):
    """The JAX package's run_schedule, keeping its final state."""
    res = j_sched.run_schedule(graph, spec=spec, cfg=cfg, seed=seed,
                               topology=topo, arrivals=arrivals,
                               params=params)
    cfg = dataclasses.replace(cfg, backend="reference")
    arr = j_arr.resolve(arrivals)
    gq = graph.n_tasks + 2 if spec.queue == "locked_global" else 4
    W = cfg.n_workers
    zone = topo.zone_size_for(W) if topo else max(W // cfg.n_zones, 1)
    rel = None if arr is None else j_arr.release_times(arr, graph.n_tasks,
                                                       seed)
    case = j_state.make_case(spec, W, zone, seed,
                             round(float(graph.mem_bound), 3), params,
                             topology=topo, release_ns=rel)
    g = j_state.graph_arrays(graph)
    st = j_sched._run_cached(cfg, gq, g, case,
                             j_sched._init_cached(cfg, gq, g, case))
    return res, st


#: (graph, payload, mode, n_workers, topology, arrivals, seed)
VS_JAX = [
    ("fib9", False, "na_ws", 16, None, "poisson:2", 1),
    ("uts250", False, "na_rp", 16, None, "lognormal:2:1.5", 2),
    ("fib9", False, "gomp", 16, None, "bursty:2:4:0.5", 0),
    ("fib9", False, "xgomp", 12, "quad_socket_48", None, 3),
    ("fib9", True, "na_ws", 16, "two_node_2x24", None, 0),
    ("uts250", True, "na_rp", 16, "rack_4x2x24", "poisson:4", 5),
    ("fib9", True, "na_ws", 16, "two_node_2x24@bw4", None, 7),
]


@pytest.mark.parametrize("gname,payload,mode,n_w,topo,arrivals,seed", VS_JAX,
                         ids=[f"{c[0]}-{c[2]}-{c[4]}-{c[5]}" for c in VS_JAX])
def test_run_schedule_matches_jax(gname, payload, mode, n_w, topo, arrivals,
                                  seed):
    family, kw = GOLDEN["graphs"][gname]
    tg, jg = t_tg.build(family, **kw), j_tg.build(family, **kw)
    if payload:
        tg, jg = tg.with_payload(8.0), jg.with_payload(8.0)
    t_topo_, j_topo_ = _topologies(topo)
    cfg_kw = dict(n_workers=n_w, n_zones=4, max_steps=60_000)
    j_res, j_st = _jax_run(jg, JSpec.from_mode(mode),
                           j_sched.SimConfig(**cfg_kw), seed, j_topo_,
                           arrivals, j_state.make_params(**KNOBS))
    t_run = t_sched.run(tg, spec=RuntimeSpec.from_mode(mode),
                        cfg=SimConfig(**cfg_kw), seed=seed,
                        topology=t_topo_, arrivals=arrivals,
                        params=make_params(**KNOBS), device="cpu")
    t_res = t_sched.result(t_run)
    label = (gname, mode, topo, arrivals)
    assert j_res.completed and t_res.completed, label
    for field in ("name", "mode", "n_workers", "completed", "time_ns",
                  "steps", "counters", "arrivals", "slo"):
        assert getattr(t_res, field) == getattr(j_res, field), (*label,
                                                                field)
    for field in ("per_worker_busy", "per_worker_clock", "per_worker_exec"):
        assert np.array_equal(getattr(t_res, field), getattr(j_res, field))
    assert t_res.latency_p99_ns == j_res.latency_p99_ns
    a, b = to_numpy(t_run.state), to_numpy(j_st)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype, (*label, k)
        assert np.array_equal(a[k], b[k]), (*label, k)
