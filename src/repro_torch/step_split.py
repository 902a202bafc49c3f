"""Where a step of the fused simulator kernel spends its cycles, by phase.

Builds an instrumented copy of the package's ``csrc/sched_step.cu``
(``--source`` takes an edited copy of it): thread 0 of block 0 reads
``clock64()`` after the run gate and after each phase of the step (adopt,
spawn, dequeue, thief, victim, exec, the bottleneck tail) and adds the
differences into a device array that a ``ss_prof`` entry point copies
out.  Phases end at block barriers, so thread 0's time in a phase is the
block's.  The victim phase is split too: up to its first barrier, and its
walk and transfer up to its second.  The stamps go in after exact lines
of the step loop; a source whose loop reads otherwise is refused.

    PYTHONPATH=src python3 -m repro_torch.step_split [--source PATH]

prints, per configuration (whole runs of ``fib(16)`` / ``uts(3000)`` at
W=64 under NA-WS, gomp and NA-RP, NA-WS on ``quad_socket_48``, and one
mid-run step of NA-WS and of gomp), cycles per step and each phase's
share, then one JSON line.  The stamps cost a few instructions a phase;
compare shares, and time the uninstrumented kernel with
``repro_torch.step_bench``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import time
from pathlib import Path

import torch

from repro_torch import apps
from repro_torch.core import scheduler
from repro_torch.core.spec import MODE_SPECS
from repro_torch.core.state import SimConfig, batch_of_one, tree_map
from repro_torch.kernels import registry as reg
from repro_torch.kernels import sched_step as ss

PHASES = ("gate", "adopt", "spawn", "dequeue", "thief", "victim", "exec",
          "tail")
_GLOBALS = r'''
__device__ unsigned long long g_prof[16];
#define PSTAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) { \
    long long _n = clock64(); g_prof[k] += _n - _pt; _pt = _n; } } while (0)
'''
_ENTRY = r'''int ss_prof(unsigned long long* out, int reset) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (reset) {
    unsigned long long z[16] = {0};
    cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return static_cast<int>(cudaGetLastError());
}

'''
#: (anchor, stamp inserted after it) in the step loop, in order
_LOOP = (("    adopt_phase(s, true);\n    __syncthreads();\n", 1),
         ("    spawn_phase(s, true);\n", 2),
         ("    Deq d = dequeue_phase(s, true);\n", 3),
         ("    thief_phase(s, d.found, true);\n    __syncthreads();\n", 4),
         ("    victim_phase(s, d.found);\n    __syncthreads();\n", 5),
         ("    exec_phase(s, d);\n", 6))


def instrument(src: str) -> str:
    """The source with the stamps, the counters and ``ss_prof``."""
    src = src.replace("namespace {\n\n__device__ __forceinline__ int wadd",
                      _GLOBALS + "namespace {\n\n__device__ __forceinline__ "
                      "int wadd", 1)
    loop = re.search(r"  for \(int it = 0; it < a\.max_iters; \+\+it\) \{"
                     r".*?\n  \}\n", src, re.S).group(0)
    body = loop.replace(
        "    if (!run_gate(s)) break;\n",
        "    long long _pt = clock64();\n    bool _g = run_gate(s);\n"
        "    PSTAMP(0);\n    if (!_g) break;\n")
    for anchor, k in _LOOP:
        body = body.replace(anchor, anchor + f"    PSTAMP({k});\n")
    tail = "    if (threadIdx.x == 0) *s.step_i() += 1;\n"
    body = body.replace(tail, tail + "    PSTAMP(7);\n    if (threadIdx.x == 0"
                        " && blockIdx.x == 0) g_prof[8] += 1;\n")
    if body.count("PSTAMP(") != 8:
        raise ValueError("the step loop of this source has other phases")
    src = src.replace(loop, body)
    # the victim phase's two barriers
    first = "  if (__syncthreads_or(vm_ws)) {\n    if (vm_ws) {\n"
    second = "    __syncthreads();  // every victim has walked its row\n"
    if src.count(first) != 1 or src.count(second) != 1:
        raise ValueError("the victim phase of this source has other barriers")
    src = src.replace(first, (
        "  long long _v0 = clock64();\n  if (__syncthreads_or(vm_ws)) {\n"
        "    long long _v1 = clock64();\n    if (threadIdx.x == 0 && "
        "blockIdx.x == 0) g_prof[9] += _v1 - _v0;\n    if (vm_ws) {\n"))
    src = src.replace(second, second + (
        "    if (threadIdx.x == 0 && blockIdx.x == 0) g_prof[10] += "
        "clock64() - _v1;\n"))
    return src.replace('extern "C" {\n', 'extern "C" {\n' + _ENTRY, 1)


class Split:
    """The instrumented kernel, standing in for ``sched_step``'s library
    while it is entered (``with Split(path) as sp: ... sp.read()``)."""

    def __init__(self, source: Path):
        out = reg.BUILD_ROOT / "split" / "sched_step_split.cu"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(instrument(source.read_text()))
        path, _ = reg.build(out)
        self.lib = ctypes.CDLL(str(path))
        self.lib.ss_run.argtypes = [ctypes.POINTER(ss.StepArgs),
                                    ctypes.c_void_p]
        self.lib.ss_run.restype = ctypes.c_int
        self.ss_run = self.lib.ss_run
        self.lib.ss_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self.lib.ss_prof.restype = ctypes.c_int
        self._buf = (ctypes.c_ulonglong * 16)()

    def __enter__(self):
        self._saved = ss._library
        ss._library = lambda: self
        self.read()
        return self

    def __exit__(self, *exc):
        ss._library = self._saved

    def read(self) -> dict:
        """Cycles per step of each phase since the last read (and reset)."""
        torch.cuda.synchronize()
        if self.lib.ss_prof(self._buf, 1) != 0:
            raise RuntimeError("ss_prof failed")
        p = list(self._buf)
        n = max(p[8], 1)
        out = {k: p[i] / n for i, k in enumerate(PHASES)}
        out.update(steps=p[8], cycles_per_step=sum(p[:8]) / n,
                   victim_to_first_barrier=p[9] / n,
                   victim_walk_transfer=p[10] / n)
        return out


def split(source: Path, dev=None) -> dict:
    dev = torch.device(dev or "cuda")
    bench = {n: apps.build(n, scale="bench") for n in ("fib", "uts")}
    runs = (("fib", "na_ws", None, 64), ("uts", "na_ws", None, 64),
            ("fib", "gomp", None, 64), ("uts", "gomp", None, 64),
            ("fib", "na_rp", None, 64), ("fib", "na_ws", "quad_socket_48", 48))
    out = {}
    with Split(source) as sp:
        for gname, mode, topo, w in runs:
            cfg = SimConfig(n_workers=w, backend="cuda_fused")
            for _ in range(2):  # the first run warms up; the second counts
                sp.read()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scheduler.run(bench[gname], spec=MODE_SPECS[mode], cfg=cfg,
                              topology=topo, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out[f"run {gname} {mode} {topo or 'flat'} W={w}"] = dict(
                sp.read(), wall_ms=wall * 1e3)
        big = SimConfig().max_steps
        for gname, mode in (("fib", "na_ws"), ("uts", "gomp")):
            cfg = SimConfig(backend="cuda_fused", max_steps=40)
            mid = scheduler.run(bench[gname], spec=MODE_SPECS[mode], cfg=cfg,
                                device=dev)
            st, g, case = (batch_of_one(x)
                           for x in (mid.state, mid.graph, mid.case))
            for _ in range(10):
                ss.sched_step(tree_map(torch.clone, st), g, case,
                              costs=cfg.costs, max_steps=big, max_iters=1)
            sp.read()
            for _ in range(100):
                ss.sched_step(tree_map(torch.clone, st), g, case,
                              costs=cfg.costs, max_steps=big, max_iters=1)
            out[f"step 40 {gname} {mode}"] = sp.read()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=ss.SOURCE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_split needs a CUDA device")
    res = split(args.source)
    for name, r in res.items():
        tot = max(r["cycles_per_step"], 1)
        print(f"{name}: {r['steps']} steps, {r['cycles_per_step']:.0f} cycles"
              " a step: " + ", ".join(f"{k} {r[k]:.0f} ({100 * r[k] / tot:.1f}"
                                       "%)" for k in PHASES)
              + f"; victim to its first barrier {r['victim_to_first_barrier']:.0f}"
              f", walk and transfer {r['victim_walk_transfer']:.0f}",
              flush=True)
    print(json.dumps({"source": str(args.source), "split": res}))


if __name__ == "__main__":
    main()
