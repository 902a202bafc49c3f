"""Times of the fused simulator kernel (``cuda_fused``) on the card.

What ``chip_smoke.py`` phase 5 times beside the kernel's twin, and what a
comparison of two versions of the port needs, as one JSON line:

* ``naws_step_ms`` / ``gomp_step_ms``: one step of a mid-run state
  (``fib(16)`` NA-WS, ``uts(3000)`` gomp, W=64, step 40) through
  ``sched_step`` with ``max_iters = 1``, ms a call by CUDA events over
  back-to-back calls (the wrapper's host time included: calls overlap);
* ``naws_launch``: what that NA-WS one-step call is made of: the kernel's
  device time (profiler) for a zero-step launch (``max_iters = 0``: the
  prologue's loads and the epilogue's write-back, no step) beside a
  one-step launch, and the wrapper's host time a call
  (``time.perf_counter_ns``) beside that of its leaf checks alone;
* ``whole_run_ms``: one launch that runs ``fib(16)`` NA-WS at W=64 from its
  first step to its last, as phase 3 runs it (CUDA events, a fresh state
  each launch);
* ``main_path_s``: phase 3's twelve ``cuda_fused`` runs (the five ladder
  modes on ``fib(16)`` and ``uts(3000)`` at W=64, NA-WS on
  ``quad_socket_48``), host clock, each ending in a synchronise;
* ``sweep``: phase 4's 72-case batched ``run_cases`` (configurations per
  second, mean wall time per chunk launch), then the same sweep traced for
  the kernel's device time per chunk launch.

    PYTHONPATH=src python3 -m repro_torch.step_bench

Needs a CUDA device.  Uses only entry points the port has had since the
fused kernel came in, so the same script times an older checkout:
``PYTHONPATH=<checkout>/src python3 src/repro_torch/step_bench.py``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import torch

from repro_torch import apps
from repro_torch.core import plan, scheduler, sweep
from repro_torch.core.spec import LATTICE, MODE_SPECS
from repro_torch.core.state import SimConfig, batch_of_one, tree_map
from repro_torch.kernels import sched_step as ss

#: the mid-run step timed (past the ramp-up of the bench graphs)
MID_STEP = 40


def events_ms(fn, n: int) -> float:
    """Mean ms a call of ``fn(i)`` over ``n`` back-to-back calls, by CUDA
    events, after ``min(n, 10)`` warm-up calls (``fn`` takes a fresh state
    each call)."""
    for i in range(min(n, 10)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def _state(graph, mode, max_steps, dev, **kw):
    cfg = SimConfig(backend="cuda_fused", max_steps=max_steps, **kw)
    r = scheduler.run(graph, spec=MODE_SPECS[mode], cfg=cfg, device=dev)
    return tuple(batch_of_one(x) for x in (r.state, r.graph, r.case))


def step_ms(graph, mode, dev, n: int = 200) -> float:
    """One step of a mid-run state, ``max_iters = 1``."""
    st, g, case = _state(graph, mode, MID_STEP, dev)
    costs, big = SimConfig().costs, SimConfig().max_steps
    pool = iter([tree_map(torch.clone, st) for _ in range(n + 10)])
    return events_ms(lambda i: ss.sched_step(
        next(pool), g, case, costs=costs, max_steps=big, max_iters=1), n)


def _device_us(fn, n: int) -> float:
    """The fused kernel's mean device µs a launch over ``n`` calls of
    ``fn(i)``, traced by the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "sched_step_kernel" in e.key]
    count = sum(e.count for e in rows)
    return sum(e.device_time_total for e in rows) / count if count else None


def launch_split(graph, mode, dev, n: int = 200) -> dict:
    """A mid-run one-step launch taken apart: device µs of a zero-step and
    a one-step launch, the wrapper's host µs a call, and the host µs of its
    three leaf checks alone."""
    st, g, case = _state(graph, mode, MID_STEP, dev)
    costs, big = SimConfig().costs, SimConfig().max_steps

    def calls(iters):
        pool = [tree_map(torch.clone, st) for _ in range(n)]
        return lambda i: ss.sched_step(pool[i], g, case, costs=costs,
                                       max_steps=big, max_iters=iters)

    warm = calls(1)
    for i in range(10):
        warm(i)
    out = dict(zero_step_device_us=_device_us(calls(0), n),
               one_step_device_us=_device_us(calls(1), n))
    one = calls(1)
    torch.cuda.synchronize()
    host = 0
    for i in range(n):
        t0 = time.perf_counter_ns()
        one(i)
        host += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    sizes, where = ss._sizes(st, g, case), st.clock.device
    t0 = time.perf_counter_ns()
    for _ in range(n):
        for tree, spec in ((st, ss._STATE), (g, ss._GRAPH), (case, ss._CASE)):
            ss._check_leaves(tree, spec, sizes, where)
    checks = time.perf_counter_ns() - t0
    out.update(wrapper_host_us=host / n / 1e3,
               leaf_checks_host_us=checks / n / 1e3)
    return out


def whole_run_ms(graph, mode, dev, n: int = 5) -> float:
    """One launch running a whole simulation from its initial state."""
    st, g, case = _state(graph, mode, 0, dev)
    costs, big = SimConfig().costs, SimConfig().max_steps
    pool = iter([tree_map(torch.clone, st) for _ in range(2 * n)])
    return events_ms(lambda i: ss.sched_step(
        next(pool), g, case, costs=costs, max_steps=big, max_iters=big), n)


def main_path_s(bench, dev) -> float:
    """Phase 3's twelve ``cuda_fused`` runs, host clock."""
    runs = [(name, m, SimConfig(), None) for name in ("fib", "uts")
            for m in MODE_SPECS]
    runs += [(name, "na_ws", SimConfig(n_workers=48), "quad_socket_48")
             for name in ("fib", "uts")]
    total = 0.0
    for name, mode, cfg, topo in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scheduler.run(bench[name], spec=MODE_SPECS[mode],
                      cfg=dataclasses.replace(cfg, backend="cuda_fused"),
                      topology=topo, device=dev)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total


def sweep_specs() -> list:
    """Phase 4's 72 cases: the 12-point lattice on three machines and the
    two bench graphs."""
    machines = ((None, 64), ("quad_socket_48", 48), ("two_node_2x24", 96))
    return [plan.CaseSpec(spec=sp, n_workers=w, n_zones=8, graph=gi,
                          topology=topo)
            for gi in range(2) for sp in LATTICE for topo, w in machines]


def sweep_times(bench, dev) -> dict:
    """The batched sweep untraced (configurations per second, wall per
    chunk launch), then traced (the kernel's device time per launch)."""
    graphs = [bench["fib"], bench["uts"]]
    specs = sweep_specs()
    chunks = len({s.spec for s in specs})

    def go():
        return sweep.run_cases(graphs, specs,
                               cfg=SimConfig(backend="cuda_fused"),
                               strategy="batched", device=dev)

    go()  # builds nothing new, but warms the host paths
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    go()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        go()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "sched_step_kernel" in e.key]
    n = sum(e.count for e in rows)
    device_ms = (sum(e.device_time_total for e in rows) / n / 1e3
                 if n else None)
    return dict(cases=len(specs), chunks=chunks, wall_s=wall,
                configs_per_s=len(specs) / wall,
                chunk_wall_ms=wall / chunks * 1e3,
                chunk_device_ms=device_ms, traced_launches=n)


def measure(dev=None) -> dict:
    dev = torch.device(dev or "cuda")
    bench = {n: apps.build(n, scale="bench") for n in ("fib", "uts")}
    ss.build()
    out = dict(naws_step_ms=step_ms(bench["fib"], "na_ws", dev),
               gomp_step_ms=step_ms(bench["uts"], "gomp", dev),
               naws_launch=launch_split(bench["fib"], "na_ws", dev),
               whole_run_ms=whole_run_ms(bench["fib"], "na_ws", dev))
    out["main_path_s"] = main_path_s(bench, dev)
    out["sweep"] = sweep_times(bench, dev)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("step_bench needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "source": str(ss.SOURCE),
                      **measure()}), flush=True)


if __name__ == "__main__":
    main()
