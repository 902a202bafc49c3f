"""Where one simulation's time goes on the card.

Runs one bench-scale configuration per step backend (``cuda_fused``,
``cuda``, ``reference``): first untraced (wall time, steps per second),
then a window of mid-run steps under ``torch.profiler`` through the
backend's run loop, and on ``cuda_fused`` also one whole traced run.  It
prints per backend and trace: the device's busy time (the sum of the CUDA
kernels' own time; one stream, so kernels never overlap) against the traced
wall time, kernel launches and host synchronisations (per step in the
window, per run for the whole run), and the kernels that took the most
device time.  Needs a CUDA device.

    PYTHONPATH=src python3 -m repro_torch.profile_run [--graph fib]
        [--mode na_ws]

at ``SimConfig()`` width (W=64), tracing steps 40-59.  The whole-run trace
is taken only on ``cuda_fused``: the other backends' runs launch thousands
of launches a step, and post-processing such a trace takes minutes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType

from repro_torch import apps
from repro_torch.core import backends, scheduler
from repro_torch.core.spec import RuntimeSpec
from repro_torch.core.state import SimConfig, batch_of_one

PORT_KERNELS = ("ctr_add_kernel", "push_kernel", "pop_kernel",
                "sched_step_kernel")
BACKENDS = ("cuda_fused", "cuda", "reference")
#: the traced window: past the ramp-up of the bench-scale graphs, and short
#: enough that the profiler's post-processing stays in seconds
START, WINDOW, TOP = 40, 20, 12
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC")


def trace(fn, top=TOP) -> dict:
    """Run ``fn`` under ``torch.profiler``, then sum the device's busy time
    and count launches and host syncs."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU-side op
    # rows of the trace also carry the device time of their kernels
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    dev_rows = sorted(((us, n, name) for name, (us, n) in per_name.items()),
                      reverse=True)
    device_us = sum(us for us, _, _ in dev_rows)
    cpu = {a.key: a.count for a in prof.key_averages()}
    return dict(
        traced_wall_s=traced_wall, device_busy_s=device_us / 1e6,
        device_busy_share=device_us / 1e6 / traced_wall,
        device_events=sum(n for _, n, _ in dev_rows),
        launch_calls=sum(cpu.get(k, 0) for k in LAUNCH_CALLS),
        host_syncs=cpu.get("cudaStreamSynchronize", 0),
        top=[dict(kernel=key[:100], count=n, device_ms=us / 1e3)
             for us, n, key in dev_rows[:top]],
        # this package's own kernels (csrc/*.cu), by device time
        port_kernels={k: dict(count=n, device_us_mean=us / n)
                      for us, n, name in dev_rows for k in PORT_KERNELS
                      if k in name})


def profile(graph, spec, cfg, start=START, window=WINDOW) -> dict:
    """Untraced whole-run wall time, then a traced window of ``window``
    steps from step ``start`` through the backend's run loop (and, on
    ``cuda_fused``, a traced whole run)."""
    dev = torch.device("cuda")
    scheduler.run(graph, spec=spec, cfg=cfg, device=dev)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = scheduler.run(graph, spec=spec, cfg=cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = int(r.state.step_i)
    r = scheduler.run(graph, spec=spec, device=dev,
                      cfg=dataclasses.replace(cfg, max_steps=start))
    st, g, case = (batch_of_one(x) for x in (r.state, r.graph, r.case))
    loop = backends.run_loop(cfg.backend)
    win = trace(lambda: loop(st, g, case, costs=cfg.costs,
                             max_steps=cfg.max_steps, max_iters=window))
    rec = dict(
        backend=cfg.backend, steps=steps, wall_s=wall,
        steps_per_s=steps / wall, ms_per_step=wall / steps * 1e3,
        window=[start, start + window],
        traced_ms_per_step=win["traced_wall_s"] / window * 1e3,
        device_busy_share=win["device_busy_share"],
        device_events_per_step=win["device_events"] / window,
        launch_calls_per_step=win["launch_calls"] / window,
        host_syncs_per_step=win["host_syncs"] / window,
        top=win["top"], port_kernels=win["port_kernels"])
    if cfg.backend == "cuda_fused":
        # the run alone: building the inputs, one launch, no host sync
        # (reading the result back is result()'s, outside the trace)
        run = trace(lambda: scheduler.run(graph, spec=spec, cfg=cfg,
                                          device=dev))
        rec["whole_run"] = dict(
            steps=steps, traced_wall_s=run["traced_wall_s"],
            device_busy_share=run["device_busy_share"],
            launch_calls=run["launch_calls"], host_syncs=run["host_syncs"],
            device_events=run["device_events"],
            port_kernels=run["port_kernels"], top=run["top"])
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", default="fib")
    ap.add_argument("--mode", default="na_ws")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_run: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    graph = apps.build(args.graph, scale="bench")
    spec = RuntimeSpec.from_mode(args.mode)
    for backend in BACKENDS:
        cfg = SimConfig(backend=backend)
        rec = profile(graph, spec, cfg)
        rec.update(card=card, graph=graph.name, mode=args.mode,
                   n_workers=cfg.n_workers)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
