"""The port's batched sweep service against the JAX package's, bitwise.

* ``run_cases`` (``reference`` and ``cuda_fused`` backends, on the CPU)
  equals the JAX ``run_cases`` on the 10 goldens plus open-system cases in
  the same batch (the mixed batch of ``tests/test_golden_modes.py``), on
  every executor: makespans, steps, every counter and the SLO arrays.
* ``run_grid`` against the JAX package: ``tests/test_torch_grid.py``.
* ``SweepResult.row`` round-trips every knob and result, and ``auto``
  picks the executor the port documents.

The tolerance is zero differences.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import sweep as j_sweep  # noqa: E402
from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core.scheduler import SimConfig as JConfig  # noqa: E402
from repro.core.spec import RuntimeSpec as JSpec  # noqa: E402
from repro_torch.core import executors, sweep  # noqa: E402
from repro_torch.core import taskgraph as t_tg  # noqa: E402
from repro_torch.core.plan import CaseSpec, build_plan  # noqa: E402
from repro_torch.core.spec import RuntimeSpec  # noqa: E402
from repro_torch.core.state import CTR_NAMES, SimConfig  # noqa: E402

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_modes.json")
with open(GOLDEN_PATH) as f:
    GOLDEN = json.load(f)
SLO = ("p50_ns", "p90_ns", "p99_ns", "throughput")


def assert_results_equal(a, b, label):
    assert np.array_equal(a.time_ns, b.time_ns), label
    assert np.array_equal(a.steps, b.steps), label
    assert np.array_equal(a.completed, b.completed), label
    assert a.counters.keys() == b.counters.keys(), label
    for n in b.counters:
        assert np.array_equal(a.counters[n], b.counters[n]), (label, n)
    for n in SLO:
        assert np.array_equal(getattr(a, n), getattr(b, n)), (label, n)


def golden_specs(cls, spec_cls):
    cfg = GOLDEN["cfg"]
    names = list(GOLDEN["graphs"])
    closed = [cls(spec=spec_cls.from_mode(c["mode"]),
                  n_workers=cfg["n_workers"], n_zones=cfg["n_zones"],
                  graph=names.index(c["graph"]), **GOLDEN["knobs"])
              for c in GOLDEN["cases"]]
    open_ = [cls(spec=spec_cls.from_mode("na_ws"),
                 n_workers=cfg["n_workers"], n_zones=cfg["n_zones"],
                 graph=gi, arrivals="poisson:2", **GOLDEN["knobs"])
             for gi in range(len(names))]
    return closed + open_


@pytest.fixture(scope="module")
def jax_goldens():
    graphs = [j_tg.build(f, **kw) for f, kw in GOLDEN["graphs"].values()]
    return j_sweep.run_cases(graphs, golden_specs(j_sweep.CaseSpec, JSpec),
                             cfg=JConfig(**GOLDEN["cfg"]), strategy="batched")


#: every executor; on the CPU ``cuda_fused`` runs the kernel's plain twin,
#: the same lane loop the batched ``reference`` executor runs
@pytest.mark.parametrize("strategy,backend", [("serial", "reference"),
                                              ("batched", "cuda_fused"),
                                              ("sharded", "reference")])
def test_run_cases_matches_jax_on_goldens(jax_goldens, strategy, backend):
    graphs = [t_tg.build(f, **kw) for f, kw in GOLDEN["graphs"].values()]
    res = sweep.run_cases(graphs, golden_specs(CaseSpec, RuntimeSpec),
                          cfg=SimConfig(**GOLDEN["cfg"]), strategy=strategy,
                          backend=backend, device="cpu")
    assert res.completed.all()
    assert_results_equal(res, jax_goldens, (strategy, backend))
    for i, c in enumerate(GOLDEN["cases"]):
        assert int(res.time_ns[i]) == c["time_ns"], c
        assert int(res.steps[i]) == c["steps"], c
        for name in CTR_NAMES:
            assert int(res.counters[name][i]) == c["counters"].get(name, 0)


def test_row_round_trips_specs():
    graphs = [t_tg.fib(6), t_tg.uts(80)]
    specs = [CaseSpec(spec=s, n_workers=w, n_zones=2, graph=gi, seed=sd,
                      n_victim=nv, topology=tp, arrivals=ar)
             for gi, s, w, sd, nv, tp, ar in [
                 (0, "na_ws", 4, 0, 2, None, None),
                 (1, "gomp", 6, 1, 4, "quad_socket_48", None),
                 (0, "na_rp", 8, 2, 3, "two_node_2x24", "poisson:2"),
                 (1, "xgomp", 4, 3, 1, None, "bursty:2:4:0.5")]]
    res = sweep.run_cases(graphs, specs, cfg=SimConfig(max_steps=60_000),
                          device="cpu")
    for i, s in enumerate(specs):
        row = res.row(i)
        assert row["app"] == graphs[s.graph].name
        assert row["mode"] == s.mode
        assert (row["queue"], row["barrier"], row["balance"]) == s.spec.axes
        assert row["n_workers"] == s.n_workers and row["seed"] == s.seed
        assert (row["n_victim"], row["n_steal"], row["t_interval"],
                row["p_local"], row["p_local_node"]) == s.knobs
        assert row["time_ns"] == int(res.time_ns[i])
        assert row["completed"] == bool(res.completed[i])
        assert row["counters"] == {k: int(v[i])
                                   for k, v in res.counters.items()}
        for n in SLO[:3]:
            assert row[n] == float(getattr(res, n)[i])
        assert row["throughput_tasks_per_s"] == float(res.throughput[i])


def test_auto_strategy_and_engine_stats():
    graphs = [t_tg.fib(5)]
    specs = [CaseSpec(spec="na_ws", n_workers=4, n_zones=2, seed=s)
             for s in range(3)]
    chunk = build_plan(graphs, specs).chunks[0]
    pick = executors.select_executor
    assert pick("auto", chunk, "cuda_fused", "cpu").name == "vmap"
    assert pick("auto", chunk, "reference", "cpu").name == "serial"
    assert pick("batched", chunk).name == "vmap"
    stats = executors.reset_engine_stats()
    res = {b: sweep.run_cases(graphs, specs, cfg=SimConfig(max_steps=9999),
                              backend=b, device="cpu")
           for b in ("reference", "cuda_fused")}
    assert_results_equal(res["cuda_fused"], res["reference"], "auto")
    # serial: one dispatch per case; batched: one per chunk
    assert stats["dispatches"] == len(specs) + 1
    assert stats["chunks"] == 2
    assert stats["sim_steps"] == 2 * int(res["reference"].steps.sum())


def test_entry_points_need_a_device_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes there")
    specs = [CaseSpec(spec="na_ws", n_workers=4, n_zones=2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_cases(t_tg.fib(4), specs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run_grid(t_tg.fib(4), n_workers=(4,))


def test_pipeline_toggle_is_invisible():
    graphs = [t_tg.fib(6)]
    specs = [CaseSpec(spec=s, n_workers=4, n_zones=2, seed=1)
             for s in ("gomp", "xgomptb", "na_ws")]
    kw = dict(cfg=SimConfig(max_steps=60_000), strategy="batched",
              device="cpu")
    a = sweep.run_cases(graphs, specs, pipeline=True, **kw)
    b = sweep.run_cases(graphs, specs, pipeline=False, **kw)
    assert_results_equal(a, b, "pipeline")
    assert dataclasses.is_dataclass(a)
