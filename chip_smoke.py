#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

In order, it
1. prints the card's name and power limit (nvidia-smi), then builds the
   port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   timing the build;
2. reproduces the 10 cases of ``tests/golden_modes.json`` bitwise on the
   card with the ``cuda`` step backend (``time_ns``, ``steps``, counters);
3. runs the main path at full width (``SimConfig()``: W=64, 8 zones, Q=16,
   S=512): bench-scale ``fib`` (n=16) and ``uts`` (n_target=3000) under the
   five ladder specs, plus NA-WS on ``quad_socket_48`` at W=48, each with
   the ``cuda`` and the ``reference`` backend on the card, and requires the
   final states to be equal leaf for leaf.  The kernels' launch counts are
   zeroed just before and read just after the ``cuda`` runs;
4. holds each kernel against its plain PyTorch twin on random inputs at the
   main path's shapes and times kernel, twin and (for ``ctr_add``) the one
   PyTorch call computing the same function, with CUDA events;
5. prints the ``kernels`` JSON line, the end-to-end times and steps per
   second of step 3, and last the device line.

Any mismatch or exception exits non-zero.  Without a CUDA device, or run
outside the repository, it exits non-zero and prints no result.  It also
prints the compiler's register report and one ``{"report": ...}`` line with
every case's steps and times.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden_modes.json"

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM3
#: bytes/s, and the non-tensor float32 rate, used as the rate of the
#: kernels' scalar int32 operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def states_equal(a, b, to_numpy) -> bool:
    x, y = to_numpy(a), to_numpy(b)
    return x.keys() == y.keys() and all(
        x[k].dtype == y[k].dtype and (x[k] == y[k]).all() for k in x)


def cuda_time_ms(fn, n: int, torch) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``n`` calls, by CUDA
    events after a warm-up."""
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


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.exists():
        return fail("run from the repository root (src/repro_torch and "
                    "tests/golden_modes.json not found)")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device available")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import apps
    from repro_torch.core import scheduler, xqueue
    from repro_torch.core.spec import MODE_SPECS, RuntimeSpec
    from repro_torch.core.state import (CTR_NAMES, NC, SimConfig,
                                        make_params, to_numpy)
    from repro_torch.core.taskgraph import build as build_graph
    from repro_torch.kernels import sched_queue as sq

    dev = torch.device("cuda")
    card = smi_line()
    print(card, flush=True)
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # 1. build the kernels
    t0 = time.perf_counter()
    lib_path, log = sq.build()
    report["build_s"] = time.perf_counter() - t0
    print(log.strip())
    print(f"built {lib_path.name} in {report['build_s']:.2f} s", flush=True)

    # 2. the goldens, bitwise, on the cuda backend
    golden = json.loads(GOLDEN.read_text())
    gcfg = SimConfig(**golden["cfg"], backend="cuda")
    graphs = {n: build_graph(b, **kw)
              for n, (b, kw) in golden["graphs"].items()}
    for c in golden["cases"]:
        r = scheduler.run_schedule(
            graphs[c["graph"]], spec=RuntimeSpec.from_mode(c["mode"]),
            cfg=gcfg, params=make_params(**golden["knobs"], device=dev),
            device=dev)
        want = dict(c["counters"], **{n: 0 for n in CTR_NAMES
                                      if n not in c["counters"]})
        got = {n: r.counters[n] for n in want}
        if not (r.completed and r.time_ns == c["time_ns"]
                and r.steps == c["steps"] and got == want):
            return fail(f"golden {c['graph']}/{c['mode']} differs: "
                        f"time_ns {r.time_ns} vs {c['time_ns']}, steps "
                        f"{r.steps} vs {c['steps']}, counters {got}")
    print(f"goldens: {len(golden['cases'])} cases bitwise on "
          f"{gcfg.backend}", flush=True)

    # 3. the main path at full width: cuda against reference, leaf by leaf
    runs = [(name, m, MODE_SPECS[m], SimConfig(), None)
            for name in ("fib", "uts") for m in MODE_SPECS]
    runs += [(name, "na_ws", MODE_SPECS["na_ws"], SimConfig(n_workers=48),
              "quad_socket_48") for name in ("fib", "uts")]
    bench = {name: apps.build(name, scale="bench") for name in ("fib", "uts")}
    wall = {"cuda": 0.0, "reference": 0.0}
    steps = 0
    cases = []
    sq.reset_launches()
    for name, mode, spec, cfg, topo in runs:
        out = {}
        for backend in ("cuda", "reference"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[backend] = scheduler.run(
                bench[name], spec=spec,
                cfg=dataclasses.replace(cfg, backend=backend),
                topology=topo, device=dev)
            torch.cuda.synchronize()
            out[backend + "_s"] = time.perf_counter() - t0
            wall[backend] += out[backend + "_s"]
        res = scheduler.result(out["cuda"])
        if not res.completed:
            return fail(f"{name}/{mode}/{topo} did not complete")
        if not states_equal(out["cuda"].state, out["reference"].state,
                            to_numpy):
            return fail(f"{name}/{mode}/{topo}: cuda and reference final "
                        "states differ")
        steps += res.steps
        cases.append(dict(graph=bench[name].name, mode=mode,
                          topology=topo or "flat", n_workers=cfg.n_workers,
                          n_tasks=bench[name].n_tasks, steps=res.steps,
                          time_ns=res.time_ns, cuda_s=out["cuda_s"],
                          reference_s=out["reference_s"]))
        print(f"  {name:4s} {mode:8s} {topo or 'flat':15s} W={cfg.n_workers}"
              f" steps={res.steps} cuda={out['cuda_s']:.3f}s "
              f"reference={out['reference_s']:.3f}s  bitwise", flush=True)
    launches = {k: v.launches for k, v in sq.KERNELS.items()}
    if not all(launches.values()):
        return fail(f"a kernel never launched on the main path: {launches}")
    report["main_path"] = dict(cases=cases, steps=steps, wall_s=wall,
                               launches=launches)

    # 4. each kernel against its plain twin, and its time, at W=64, Q=16
    W, Q, n_time = 64, 16, 200
    rs = np.random.default_rng(0)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    head = rs.integers(0, 1000, (W, W)).astype(np.int32)
    size = np.where(rs.random((W, W)) < 0.5, 0,
                    rs.integers(1, Q + 1, (W, W))).astype(np.int32)
    xq0 = xqueue.XQ(t(rs.integers(-1, 5000, (W, W, Q)).astype(np.int32)),
                    t(rs.integers(0, 10**6, (W, W, Q)).astype(np.int32)),
                    t(head), t(head + size))
    copies = [xqueue.XQ(*(x.clone() for x in xq0)) for _ in range(n_time)]

    def xq_copy():
        return xqueue.XQ(*(x.clone() for x in xq0))

    def max_err(a, b):
        return max(int((x.long() - y.long()).abs().max())
                   for x, y in zip(a, b))

    kernels = []
    # ctr_add: ctr[:, col] += val
    ctr = t(rs.integers(0, 10**6, (W, NC)).astype(np.int32))
    val = t(rs.integers(0, 100, W).astype(np.int32))
    col = 15
    err = max_err([sq.ctr_add(ctr.clone(), col, val)],
                  [sq.PLAIN["ctr_add"](ctr, col, val)])
    work = ctr.clone()
    ms = cuda_time_ms(lambda i: sq.ctr_add(work, col, val), n_time, torch)
    plain_ms = cuda_time_ms(lambda i: sq.PLAIN["ctr_add"](ctr, col, val),
                            n_time, torch)

    def library(i):
        work[:, col] += val

    lib_ms = cuda_time_ms(library, n_time, torch)
    b, by = bound_ms(3 * W * 4, W)
    kernels.append(dict(name="ctr_add", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=lib_ms))

    # push: every lane its own producer column, random targets
    producer = torch.arange(W, dtype=torch.int32, device=dev)
    consumer = t(rs.integers(0, W, W).astype(np.int32))
    task = t(rs.integers(0, 5000, W).astype(np.int32))
    tsv = t(rs.integers(0, 10**6, W).astype(np.int32))
    mask = t(rs.random(W) < 0.75)
    lanes = (producer, consumer, task, tsv, mask)
    got = sq.push(xq_copy(), *lanes)
    want = sq.PLAIN["push"](xq0, *lanes)
    err = max(max_err(got[0], want[0]), max_err([got[1]], [want[1]]))
    ms = cuda_time_ms(lambda i: sq.push(copies[i], *lanes), n_time, torch)
    plain_ms = cuda_time_ms(lambda i: sq.PLAIN["push"](xq0, *lanes),
                            n_time, torch)
    n_live, n_ok = int(mask.sum()), int(want[1].sum())
    # lane vectors + mask in, head/tail of live pairs read, slot + stamp +
    # tail written per accepted push, ok out
    b, by = bound_ms(4 * W * 4 + W + 8 * n_live + 12 * n_ok + W, 6 * W)
    kernels.append(dict(name="push", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=None))

    # pop_first: rotated scan over half-empty queues, a few padded lanes
    rot = t(rs.integers(0, 1000, W).astype(np.int32))
    pmask = t(rs.random(W) < 0.9)
    n_act = torch.tensor(W - 2, dtype=torch.int32, device=dev)
    copies = [xq_copy() for _ in range(n_time)]
    got = sq.pop_first(xq_copy(), rot, pmask, n_act)
    want = sq.PLAIN["pop_first"](xq0, rot, pmask, n_act)
    err = max(max_err(got[0], want[0]), max_err(got[1:], want[1:]))
    ms = cuda_time_ms(lambda i: sq.pop_first(copies[i], rot, pmask, n_act),
                      n_time, torch)
    plain_ms = cuda_time_ms(
        lambda i: sq.PLAIN["pop_first"](xq0, rot, pmask, n_act), n_time,
        torch)
    inspected = int(want[5].sum())
    n_found = int(want[4].sum())
    # head+tail of each inspected queue, rot/mask/n_active, the gathered
    # slot and stamp in; task/ts/src/checked/found out, found heads written
    b, by = bound_ms(8 * inspected + 5 * W + 4 + 8 * W + 17 * W
                     + 4 * n_found, 12 * inspected)
    kernels.append(dict(name="pop_first", max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=None))

    for k in kernels:
        if k["max_abs_err"] != 0:
            return fail(f"kernel {k['name']} disagrees with its plain twin "
                        f"(max abs err {k['max_abs_err']})")
        k.update(route="cuda",
                 source="src/repro_torch/kernels/csrc/sched_queue.cu",
                 replaces=sq.KERNELS[k["name"]].replaces,
                 launches=launches[k["name"]])
    report["kernels"] = kernels
    print(json.dumps({"report": report}))

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(json.dumps({"main_path_wall_s": wall, "main_path_steps": steps,
                      "steps_per_s": {b: steps / s for b, s in wall.items()},
                      "launches": launches}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
