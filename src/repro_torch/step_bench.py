"""Times of the simulator's kernels on the card: the fused kernel
(``cuda_fused``) and the ``cuda`` backend's queue kernels.

What ``chip_smoke.py`` phase 5 times beside the kernels' twins, and what a
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
  ``cuda_main_path``: the same twelve runs on the ``cuda`` backend (seconds,
  steps, steps per second, the push and pop launches);
* ``sweep``: phase 4's 72-case batched ``run_cases`` (configurations per
  second, mean wall time per chunk launch), then the same sweep traced for
  the kernel's device time per chunk launch;
* ``queue_ops``: ``push`` and ``pop_first`` at phase 3's shapes (W=64,
  Q=16, the lanes ``chip_smoke.py`` builds), each call on a fresh copy of
  the queues: ms a call by CUDA events over back-to-back calls, the
  wrapper's host µs a call beside those of its argument checks alone and
  its output allocations alone (medians of four rounds of 5000 calls in
  turns; for ``pop_first`` also one buffer and five views of it,
  ``one_buffer_alloc_host_us``), and the kernel's device µs a launch
  (profiler) on the fresh copies (their 512 KiB cold in L2) and on one
  queue every call (``device_us_warm``: warm, as the ``cuda`` backend's
  one queue is from step to step); beside them the launch floor, an empty
  kernel launched through the same ctypes path (``sq_noop``; omitted for
  a checkout without it), and the counter bump's device µs a launch for
  one pair and for the spawn phase's run of seven;
* ``rwkv6``: the RWKV6 kernel at the serving shape (B=4, H=32, T=1024,
  Dh=64, bf16, a zero state; ``chip_smoke.py`` phase 7's inputs), in the
  model's (B, T, H, Dh) layout and packed: ms a call by CUDA events over
  back-to-back calls and device µs a launch (profiler).  It calls only
  ``rwkv6_scan.rwkv6``, so it times an older checkout's kernel too.

    PYTHONPATH=src python3 -m repro_torch.step_bench [--rwkv6-only]
    PYTHONPATH=src python3 -m repro_torch.step_bench --rwkv6-shapes

``--rwkv6-only`` measures only ``rwkv6``.  ``--rwkv6-shapes`` times the
RWKV6 kernel at each launch shape of ``RWKV6_SHAPES`` (Dh = 64): an edited
copy of ``csrc/rwkv6_scan.cu`` a shape, built and bound in place of the
wrapper's library while it is timed, and held against the twin.

Needs a CUDA device.  Uses only entry points the port has had since the
fused kernel came in, so the same script times an older checkout:
``PYTHONPATH=<checkout>/src python3 src/repro_torch/step_bench.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch import apps
from repro_torch.core import plan, scheduler, sweep
from repro_torch.core.spec import LATTICE, MODE_SPECS
from repro_torch.core.state import NC, SimConfig, batch_of_one, tree_map
from repro_torch.core import xqueue
from repro_torch.kernels import registry as reg
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.kernels import sched_queue as sq
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


def _device_us(fn, n: int, kernel: str = "sched_step_kernel") -> float:
    """The mean device µs a launch of ``kernel`` (a substring of its
    symbol) over ``n`` calls of ``fn(i)``, traced by the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key]
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


def main_path_s(bench, dev, backend: str = "cuda_fused") -> tuple:
    """Phase 3's twelve runs on ``backend``, host clock: ``(seconds,
    steps)``."""
    runs = [(name, m, SimConfig(), None) for name in ("fib", "uts")
            for m in MODE_SPECS]
    runs += [(name, "na_ws", SimConfig(n_workers=48), "quad_socket_48")
             for name in ("fib", "uts")]
    total, steps = 0.0, 0
    for name, mode, cfg, topo in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = scheduler.run(bench[name], spec=MODE_SPECS[mode],
                          cfg=dataclasses.replace(cfg, backend=backend),
                          topology=topo, device=dev)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
        steps += int(r.state.step_i)
    return total, steps


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


def _host_us(fn, n: int) -> float:
    """Mean host µs a call of ``fn(i)`` (``time.perf_counter_ns`` around
    each call; the device may still be working when it returns)."""
    torch.cuda.synchronize()
    total = 0
    for i in range(n):
        t0 = time.perf_counter_ns()
        fn(i)
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / n / 1e3


def queue_inputs(dev, W: int = 64, Q: int = 16, seed: int = 0):
    """Phase 5's queue state and lanes (``chip_smoke.py``): half the queues
    empty, the rest holding 1..Q tasks; push from every lane to random
    consumers with 3 in 4 lanes live; pop with random rotations, 9 in 10
    consumers live, ``n_active = W - 2``."""
    rs = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    head = rs.integers(0, 1000, (W, W)).astype(np.int32)
    size = np.where(rs.random((W, W)) < 0.5, 0,
                    rs.integers(1, Q + 1, (W, W))).astype(np.int32)
    xq = xqueue.XQ(t(rs.integers(-1, 5000, (W, W, Q)).astype(np.int32)),
                   t(rs.integers(0, 10**6, (W, W, Q)).astype(np.int32)),
                   t(head), t(head + size))
    push = (torch.arange(W, dtype=torch.int32, device=dev),
            t(rs.integers(0, W, W).astype(np.int32)),
            t(rs.integers(0, 5000, W).astype(np.int32)),
            t(rs.integers(0, 10**6, W).astype(np.int32)),
            t(rs.random(W) < 0.75))
    pop = (t(rs.integers(0, 1000, W).astype(np.int32)), t(rs.random(W) < 0.9),
           torch.tensor(W - 2, dtype=torch.int32, device=dev))
    return xq, push, pop


def _split_parts(xq, push, pop) -> dict:
    """``{kernel: {part: fn}}``: each wrapper's argument checks and output
    allocations as it runs them (for a checkout whose wrappers predate the
    factored checks, the per-tensor ``_check`` calls and the per-output
    ``torch.empty`` calls those wrappers made), and for ``pop_first`` the
    one-buffer design beside them."""
    W, Q = xq.buf.shape[0], xq.buf.shape[-1]
    where, dev = xq.buf.get_device(), xq.buf.device
    one_buffer = {"one_buffer_alloc": lambda: _one_buffer_outputs(W, where)}
    if hasattr(sq, "_push_checks"):
        return {"push": {"checks": lambda: sq._push_checks(xq, *push),
                         "alloc": lambda: torch.empty_like(push[4])},
                "pop_first": {"checks": lambda: sq._pop_checks(xq, *pop),
                              "alloc": lambda: sq._pop_outputs(pop[0],
                                                               pop[1]),
                              **one_buffer}}
    i32, b8 = torch.int32, torch.bool

    def queue_checks():
        for name, t, shape in (("buf", xq.buf, (W, W, Q)),
                               ("ts", xq.ts, (W, W, Q)),
                               ("head", xq.head, (W, W)),
                               ("tail", xq.tail, (W, W))):
            sq._check(t, name, shape, i32, where)

    def push_checks():
        queue_checks()
        for name, t in zip(("producer", "consumer", "task", "ts"), push):
            sq._check(t, name, (W,), i32, where)
        sq._check(push[4], "mask", (W,), b8, where)

    def pop_checks():
        queue_checks()
        sq._check(pop[0], "rot", (W,), i32, where)
        sq._check(pop[1], "mask", (W,), b8, where)
        sq._check(pop[2], "n_active", (), i32, where)

    def pop_allocs():
        return [torch.empty(W, dtype=d, device=dev)
                for d in (i32, i32, i32, b8, i32)]

    return {"push": {"checks": push_checks,
                     "alloc": lambda: torch.empty(W, dtype=b8, device=dev)},
            "pop_first": {"checks": pop_checks, "alloc": pop_allocs,
                          **one_buffer}}


def _one_buffer_outputs(W: int, where: int) -> tuple:
    """A pop's five outputs as views of one 17 W-byte buffer (task, ts,
    src and checked as int32, then found as bool): the design
    ``_pop_outputs`` was held against, timed beside it."""
    out = torch.empty(17 * W, dtype=torch.uint8, device=where)
    task, ts, src, checked = out[:16 * W].view(torch.int32).view(4, W).unbind()
    return task, ts, src, out[16 * W:].view(torch.bool), checked


def _host_us_turns(fns: dict, n: int = 5000, rounds: int = 4) -> dict:
    """Median host µs a call of each ``fn()`` in ``fns`` over ``rounds``
    rounds of ``n`` calls each, in turns, the order reversed every other
    round (host times of a few µs swing between runs of one process)."""
    times = {k: [] for k in fns}
    items = list(fns.items())
    for r in range(rounds):
        for k, fn in (items if r % 2 == 0 else items[::-1]):
            times[k].append(_host_us(lambda i: fn(), n))
    return {k: statistics.median(v) for k, v in times.items()}


def queue_ops(dev, n: int = 500) -> dict:
    """``push`` and ``pop_first`` at phase 3's shapes taken apart, and the
    launch floor of their ctypes path."""
    xq, push, pop = queue_inputs(dev)
    sq.build()
    calls = {"push": (sq.push, push, "push_kernel"),
             "pop_first": (sq.pop_first, pop, "pop_kernel")}
    parts = _host_us_turns({f"{name}.{part}": fn
                            for name, fns in _split_parts(xq, push,
                                                          pop).items()
                            for part, fn in fns.items()})
    out = {}
    for name, (fn, args, key) in calls.items():
        def fresh():
            pool = iter([xqueue.XQ(*(x.clone() for x in xq))
                         for _ in range(n + 10)])
            return lambda i: fn(next(pool), *args)

        same = xqueue.XQ(*(x.clone() for x in xq))
        out[name] = dict(
            ms=events_ms(fresh(), n),
            host_us=_host_us(fresh(), n),
            **{part[len(name) + 1:] + "_host_us": us
               for part, us in parts.items() if part.startswith(name + ".")},
            device_us=_device_us(fresh(), n, key),
            device_us_warm=_device_us(lambda i: fn(same, *args), n, key))
    W = xq.buf.shape[0]
    # the counter bump's device time beside them: one pair, and the spawn
    # phase's run of seven in one launch
    ctr = torch.zeros((W, NC), dtype=torch.int32, device=dev)
    one = [(15, push[2])]
    seven = [(c, push[4] if c % 2 else push[3])
             for c in (4, 14, 9, 10, 11, 16, 14)]
    out["ctr_add"] = dict(
        device_us=_device_us(lambda i: sq.ctr_add(ctr, one), n,
                             "ctr_add_kernel"),
        device_us_seven=_device_us(lambda i: sq.ctr_add(ctr, seven), n,
                                   "ctr_add_kernel"))
    lib = sq._library()
    noop = getattr(lib, "sq_noop", None)
    if noop is not None:
        record, where = bytes(sq._PUSH.size), xq.buf.get_device()

        def floor(i):
            return noop(record, reg.stream(where))

        out["launch_floor"] = dict(
            ms=events_ms(floor, n), host_us=_host_us(floor, n),
            device_us=_device_us(floor, n, "noop_kernel"))
    return out


def rwkv6_inputs(dev, layout: str = "model", B: int = 4, H: int = 32,
                 T: int = 1024, Dh: int = 64):
    """Phase 7's timed inputs (``chip_smoke.rwkv_inputs``): bf16 r, k, v,
    w (k and v by 0.3, sigmoid decays), u by 0.1, a zero state; in the
    "model" layout r, k, v, w are (B, T, H, Dh) buffers viewed as (B, H, T,
    Dh)."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r = randn(B, H, T, Dh).bfloat16()
    k = (randn(B, H, T, Dh) * 0.3).bfloat16()
    v = (randn(B, H, T, Dh) * 0.3).bfloat16()
    w = torch.sigmoid(randn(B, H, T, Dh)).bfloat16()
    if layout == "model":
        r, k, v, w = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (r, k, v, w))
    return (r, k, v, w, randn(H, Dh) * 0.1,
            torch.zeros((B, H, Dh, Dh), device=dev))


def rwkv6_times(dev, n: int = 50) -> dict:
    """The RWKV6 kernel at the serving shape in both layouts: ms a call
    (CUDA events, ``n`` back-to-back calls) and device µs a launch."""
    out = {}
    for layout in ("model", "packed"):
        args = rwkv6_inputs(dev, layout)
        out[layout] = dict(
            ms=events_ms(lambda i: rk.rwkv6(*args), n),
            device_us=_device_us(lambda i: rk.rwkv6(*args), 20,
                                 "rwkv6_kernel"))
    return out


#: launch shapes tried at Dh = 64: (value columns a lane, warps a block,
#: steps a tile)
RWKV6_SHAPES = ((4, 4, 32), (4, 4, 16), (8, 2, 32), (4, 2, 32))
_SHAPE64 = re.compile(r"struct Shape<64> \{ static constexpr int CP = \d+, "
                      r"NW = \d+, TT = \d+; \};")


def rwkv6_shapes(dev, shapes=RWKV6_SHAPES) -> dict:
    """:func:`rwkv6_times` at each Dh = 64 launch shape of ``shapes``, the
    launch and ptxas's registers and spills of the bf16 instantiation, and
    the largest difference from the twin at the serving shape (model
    layout)."""
    src = rk.SOURCE.read_text()
    if not _SHAPE64.search(src):
        raise ValueError(f"{rk.SOURCE} has no Shape<64> line to edit")
    args = rwkv6_inputs(dev)
    want = rk.plain(*args)[0].float()
    saved, out = rk._library, {}
    try:
        for cp, nw, tt in shapes:
            path = reg.BUILD_ROOT / "rwkv6_shapes" / f"cp{cp}_nw{nw}_tt{tt}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(_SHAPE64.sub(
                f"struct Shape<64> {{ static constexpr int CP = {cp}, "
                f"NW = {nw}, TT = {tt}; }};", src))
            lib_path, log = reg.build(path)
            lib = rk.bind(lib_path)
            rk._library = lambda: lib
            ptxas = re.search(
                r"rwkv6_kernelI13__nv_bfloat16Li64E\w*'? for 'sm_90a'\n.*?"
                r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?"
                r"Used (\d+) registers", log, re.S)
            got = rk.rwkv6(*args)[0].float()
            out[f"{cp},{nw},{tt}"] = dict(
                launch=rk.launch_shape(4, 32, 64),
                registers=int(ptxas.group(3)) if ptxas else None,
                spill_bytes=(int(ptxas.group(1)) + int(ptxas.group(2))
                             if ptxas else None),
                max_abs_err=float((got - want).abs().max()),
                **rwkv6_times(dev))
    finally:
        rk._library = saved
    return out


def measure(dev=None) -> dict:
    dev = torch.device(dev or "cuda")
    bench = {n: apps.build(n, scale="bench") for n in ("fib", "uts")}
    ss.build()
    out = dict(naws_step_ms=step_ms(bench["fib"], "na_ws", dev),
               gomp_step_ms=step_ms(bench["uts"], "gomp", dev),
               naws_launch=launch_split(bench["fib"], "na_ws", dev),
               whole_run_ms=whole_run_ms(bench["fib"], "na_ws", dev))
    out["main_path_s"] = main_path_s(bench, dev)[0]
    out["sweep"] = sweep_times(bench, dev)
    out["queue_ops"] = queue_ops(dev)
    out["rwkv6"] = rwkv6_times(dev)
    reg.reset_launches()
    cuda_s, cuda_steps = main_path_s(bench, dev, "cuda")
    out["cuda_main_path"] = dict(
        s=cuda_s, steps=cuda_steps, steps_per_s=cuda_steps / cuda_s,
        launches={k: reg.KERNELS[k].launches for k in ("push", "pop_first")})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--rwkv6-only", action="store_true")
    which.add_argument("--rwkv6-shapes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_bench needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if args.rwkv6_shapes:
        res = {"rwkv6_shapes": rwkv6_shapes(dev)}
    elif args.rwkv6_only:
        res = {"rwkv6": rwkv6_times(dev)}
    else:
        res = measure(dev)
    print(json.dumps({"card": card, "source": str(ss.SOURCE), **res}),
          flush=True)


if __name__ == "__main__":
    main()
