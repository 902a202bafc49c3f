#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

In order, it
1. prints the card's name and power limit (nvidia-smi), then builds the
   port's five CUDA sources from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together, timing the build and
   printing the compiler's register report; then each flash kernel
   instantiation's registers and spills and its HGMMA and UTMALDG count in
   the SASS (cuobjdump), failing if a bf16 (wgmma) instantiation (one per
   head dim of ``HEAD_DIMS``, 80 included) spills or lacks either, and
   each ``sched_step_kernel`` instantiation's registers, stack frame and
   spills, failing on a stack frame or a spill;
2. reproduces the 10 cases of ``tests/golden_modes.json`` bitwise on the
   card: through ``run_schedule`` on the ``cuda`` and the ``cuda_fused``
   backends, and through ``run_cases`` on ``cuda_fused`` with the serial,
   batched and sharded executors (the goldens mixed with open-system cases
   in one batch);
3. runs the first slice's main path at full width (``SimConfig()``: W=64,
   8 zones, Q=16, S=512): bench-scale ``fib`` (n=16) and ``uts``
   (n_target=3000) under the five ladder specs, plus NA-WS on
   ``quad_socket_48`` at W=48, each with the ``cuda``, ``cuda_fused`` and
   ``reference`` backends, and requires the final states to be equal leaf
   for leaf.  Launch counts are zeroed just before and read just after;
   ``cuda`` may launch ``ctr_add`` at most 12 times a step (one launch per
   run of counter bumps);
4. runs this slice's path, the batched sweep: one ``run_cases`` call on
   ``cuda_fused`` (batched executor) over the 12-point lattice × {flat W=64,
   ``quad_socket_48`` W=48, ``two_node_2x24`` W=96} × the two bench graphs,
   with launch counts zeroed just before and read just after.  Every
   case's raw result must equal the serial executor's, the cases phase 3
   ran must equal phase 3's, and the cluster preset must equal the
   ``reference`` backend at smoke scale;
5. holds each kernel against its plain PyTorch twin at the main path's
   shapes (``ctr_add`` with one pair and with the spawn phase's seven; the
   fused step with ``max_iters = 1`` on mid-run NA-WS, NA-RP and gomp
   states, flat, NUMA and cluster) and times kernel, twin and, where one
   exists, the one PyTorch call computing the same function, with CUDA
   events; ``push`` and ``pop_first`` also at W=144 and W=200 and over
   50 calls in turn on one queue, and their host path taken apart beside
   the launch floor of an empty kernel (``step_bench.queue_ops``: ms a
   call, host µs a call, of its checks and of its allocations, device µs a
   launch); beside them the 7-pair ``ctr_add`` against seven ``+=`` calls,
   a gomp step beside the NA-WS step, one whole-run launch (``fib(16)``
   NA-WS at W=64) and the sweep's mean wall and device time per chunk
   launch (``repro_torch.step_bench``); then whole NA-WS runs at W=144 and
   W=200, the fused kernel's two wider launch shapes (heads and tails in
   shared, then in device memory), against ``reference``;
6. runs the third slice's path, serving gemma2_2b at full width (26
   layers, d_model 2304, vocab 256000, head dim 256, window 4096; random
   bf16 weights made on the card from seed 0): ``repro_torch.launch.serve``
   ``main`` with batch 4, prompt 1024, 32 new tokens, launch counts zeroed
   just before and read just after (26 flash-attention launches in the
   prefill, none while decoding), finite logits; then the same weights
   timed warm, the bf16 greedy ids of the kernel against the plain path
   (printed, not gated), a traced prefill (flash's device time), the full
   model in float32 at batch 2 through the kernel and through its plain
   twin (last-position logits within 1e-3), the kernels against their twin
   per call on the 24 ``FLASH_CASES`` (bf16 on the wgmma kernel at every
   head dim, S = 1, 129, 1000 and 8192, windows that bite, bidirectional
   layers at Dh = 80; float32 on the FMA kernel), a poisoned neighbour
   (KV head 1's V all inf: head 0 finite and bitwise what it gives alone)
   at every head dim, two calls bitwise
   equal, and the time at gemma2_2b's and moonshot_v1_16b_a3b's prefill
   shapes beside the twin's, ``scaled_dot_product_attention``'s and the
   bound;
7. runs the fourth slice's path, serving rwkv6_1_6b at full width (24
   layers, d_model 2048, 32 heads of 64, d_ff 7168, vocab 65536; random
   bf16 weights made on the card from seed 0): ``serve.main`` with batch 4,
   prompt 1024, 32 new tokens, launch counts zeroed just before and read
   just after (24 ``rwkv6_scan`` launches in the prefill, none while
   decoding, no other kernel), finite logits; then the same weights timed
   warm and through the plain path, a traced prefill and a traced prefill
   with 3 decode steps, the full model in float32 at batch 2 through the
   kernel and through its plain twin (last-position prefill logits, then 3
   decode steps from each prefill's own state, within 1e-3), the kernel
   against its twin per call (output and final state) at the serving shape
   and six more, and its time beside the twin's and its bound;
8. runs the fifth slice's path, serving moonshot_v1_16b_a3b at full width
   (48 MoE layers of 64 experts, top-6, NA-RP routing, d_model 2048, 16
   heads of 128, vocab 163840, int8 KV cache; random bf16 weights made on
   the card from seed 0, every earlier model freed first): ``serve.main``
   with batch 4, prompt 1024, 32 new tokens, launch counts zeroed just
   before and read just after (48 ``flash_attention`` and 48
   ``moe_dispatch`` launches in the prefill, 48 ``moe_dispatch`` a decode
   step, no other kernel), finite logits, the peak memory; then the same
   weights timed warm, a traced prefill and a traced prefill with 3 decode
   steps (the dispatch's and flash's device time), the routing counters of
   the prefill's layers, the prefill logits
   and 3 decode steps with only the dispatch swapped for its plain twin
   (bitwise equal: the kernel only moves data), the kernel against its
   twin per call, bitwise, at the model's own layer-0 routing and seven
   more shapes, and its time beside the twin's, one ``index_put_`` call's
   and its bound;
9. after phase 10, prints the ``kernels`` JSON line (``sched_step``'s
   launches are the sweep's and the tuner's, ``flash_attention``'s those
   of phases 6, 8 and 11), the end-to-end rates, the ``serve_hybrid`` line
   of phase 11, the tuner's summary, the card line and last the device
   line;
10. runs the eleventh slice's path, Table I by search, between phase 8
   and the lines of 9: the DLB-knob tuner (``repro_torch.core.tune``) on
   ``cuda_fused``, launch counts zeroed before each part.  (a) Each of the
   18 committed ``experiments/tuned/smoke`` artifacts is searched again as
   ``benchmarks/tune_apps.py`` made it (smoke graph, W=16 in 4 zones, its
   hand-tuned reference seeded, rounds 2, survivors 4, no cache): the
   pick, its makespan, the configurations, the simulations and the seeds
   must equal the artifact's, and so must the SLB and reference
   makespans; the file ``save_artifact`` writes into a temporary directory
   must be the committed one byte for byte but for ``sim_signature`` and
   ``objective``, which the committed files predate, and ``load_tuned``
   must read both.  (b) The same search at bench scale (W=32, the nine
   BOTS apps, both balancers, each app's reference seeded): every pick at
   most its reference, each re-run alone through the serial executor (fib
   and uts also through ``reference``) with an equal makespan; then one
   tune twice through a fresh result cache, the second from the cache
   alone with no launch.  It prints each pick beside the reference and
   SLB makespans, and the walls, simulations per second and launches;
11. runs the twelfth slice's path between phases 8 and 10, every earlier
   model freed first, each model at its published widths and depth with
   random bf16 weights made on the card from seed 0: hymba_1_5b (32
   layers of parallel attention and SSM heads, head dim 64, window 1024)
   and pixtral_12b (40 layers, head dim 128; its prompt is 256 image
   patches and 768 text tokens) through ``serve.main`` with batch 4,
   prompt 1024, 32 new tokens, launch counts zeroed just before and read
   just after (one flash launch per layer in the prefill, none while
   decoding, no other kernel), then warm and with a traced prefill;
   hubert_xlarge's encoder ``forward`` on 4 x 1024 frames (48 flash
   launches, every one bidirectional at head dim 80); each model in
   float32 at batch 2 through the kernel and through its twin (hymba's
   and pixtral's last-position prefill logits and 3 decode steps, each
   from its own prefill's state; hubert's logits at every position;
   within 1e-3; pixtral's 49 GB of float32 weights at full depth); then
   flash at the three prefill shapes
   beside its twin, its bound and one ``scaled_dot_product_attention``
   call (the same function at all three).

Any mismatch or exception exits non-zero.  Without a CUDA device, or run
outside the repository, it exits non-zero and prints no result.  It also
prints one ``{"report": ...}`` line with every case's steps and times.
"""

from __future__ import annotations

import concurrent.futures
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
#: bytes/s, the non-tensor float32 rate, used as the rate of the
#: simulator kernels' scalar int32 operations, and the dense bf16
#: tensor-core rate, the bound of attention's bf16 products
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
#: the simulator's kernels (the main path of phases 3-5)
SIM_KERNELS = ("ctr_add", "push", "pop_first", "sched_step")


class SmokeFailure(Exception):
    pass


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def states_equal(a, b, to_numpy) -> bool:
    x, y = to_numpy(a), to_numpy(b)
    return x.keys() == y.keys() and all(
        x[k].dtype == y[k].dtype and (x[k] == y[k]).all() for k in x)


def max_abs_err(a, b, to_numpy) -> int:
    """Largest absolute difference over every leaf of two tuples of
    tensors (as int64; bools count 0/1)."""
    x, y = to_numpy(a), to_numpy(b)
    assert x.keys() == y.keys()
    return max(int(abs(x[k].astype("int64") - y[k].astype("int64")).max())
               if x[k].size else 0 for k in x)


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


def within(got, want, tol: float) -> bool:
    """Every element within ``tol + tol * |want|`` (atol = rtol = tol)."""
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


def bound_ms(nbytes: float, nops: float,
             ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


#: the serving run of phase 6: gemma2_2b at full width, batch 4, prompt
#: 1024, 32 new tokens, as a user runs it
SERVE_B, SERVE_S, SERVE_GEN = 4, 1024, 32
SERVE_ARGV = ("--arch", "gemma2_2b", "--batch", str(SERVE_B), "--prompt-len",
              str(SERVE_S), "--gen", str(SERVE_GEN), "--seed", "0")
#: the flash kernel against its twin: (label, B, H, KV, S, Dh, dtype,
#: window, softcap, causal) — the serving shape (a local and a full layer),
#: a window that bites, ragged sequences and a small head; the bf16 path at
#: every head dim, S = 1, 129 and 1000, and a window of 200 over S = 1000;
#: then phase 11's layers (hymba's local layer, pixtral's, hubert's
#: bidirectional one at Dh = 80) and Dh = 80 in float32, at a ragged S,
#: with a window on both sides and causal with a window that bites
FLASH_CASES = (
    ("serve_local", 4, 8, 4, 1024, 256, "bfloat16", 4096, 50.0, True),
    ("serve_full", 4, 8, 4, 1024, 256, "bfloat16", 0, 50.0, True),
    ("window_bf16", 1, 8, 4, 8192, 256, "bfloat16", 4096, 50.0, True),
    ("window_f32", 1, 8, 4, 8192, 256, "float32", 4096, 50.0, True),
    ("ragged_64", 2, 4, 2, 1000, 64, "bfloat16", 0, None, True),
    ("ragged_128", 2, 4, 2, 1000, 128, "float32", 300, None, True),
    ("small_f32", 2, 4, 4, 96, 16, "float32", 0, 20.0, True),
    ("moonshot", 4, 16, 16, 1024, 128, "bfloat16", 0, None, True),
    ("s1_256", 1, 2, 1, 1, 256, "bfloat16", 0, 50.0, True),
    ("s129_256", 1, 4, 2, 129, 256, "bfloat16", 0, 50.0, True),
    ("s1000_256", 2, 4, 2, 1000, 256, "bfloat16", 0, 50.0, True),
    ("window_mid", 1, 4, 2, 1000, 256, "bfloat16", 200, 50.0, True),
    ("window_128", 1, 4, 2, 1000, 128, "bfloat16", 100, None, True),
    ("head_192", 1, 4, 1, 300, 192, "bfloat16", 100, None, True),
    ("dh32_bf16", 2, 4, 4, 300, 32, "bfloat16", 0, None, True),
    ("dh16_bf16", 2, 4, 2, 200, 16, "bfloat16", 0, 20.0, True),
    ("hymba_local", 4, 25, 5, 1024, 64, "bfloat16", 1024, None, True),
    ("pixtral", 4, 32, 8, 1024, 128, "bfloat16", 0, None, True),
    ("hubert_bf16", 4, 16, 16, 1024, 80, "bfloat16", 0, None, False),
    ("hubert_f32", 2, 16, 16, 1024, 80, "float32", 0, None, False),
    ("dh80_ragged", 2, 4, 4, 1000, 80, "bfloat16", 0, None, False),
    ("dh80_bidir_win", 1, 4, 2, 300, 80, "float32", 100, None, False),
    ("dh80_window", 1, 4, 2, 1000, 80, "bfloat16", 100, None, True),
    ("dh80_s1", 1, 2, 1, 1, 80, "bfloat16", 0, None, False),
)
#: the two flash kernels as the profiler names them (the wrapper's
#: ``KERNEL_NAMES``): bf16 on the tensor cores, float32 on FMAs
FLASH_KERNEL_KEYS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")
#: the poisoned-neighbour check: (B, H, KV, S) at each head dim of the bf16
#: path; KV head 1's V is all inf, so head 0's rows must never read it
POISON_SHAPE = (1, 4, 2, 1000)
POISON_HEAD_DIMS = (256, 192, 128, 80, 64, 32, 16)
#: atol = rtol per output type: bf16 rounds at 2^-8, float32 only sums in
#: another order
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: last-position logits of the float32 model, kernel against plain path
F32_LOGITS_TOL = 1e-3


def kernel_device_us(prof, key):
    """Mean device microseconds per recorded launch of the kernels whose
    names hold ``key`` (one string or a tuple; per recorded launch: the
    profiler may not record every launch of a short window), or None when
    none was recorded."""
    keys = (key,) if isinstance(key, str) else key
    rows = [e for e in prof.key_averages() if any(k in e.key for k in keys)]
    n = sum(e.count for e in rows)
    return sum(e.device_time_total for e in rows) / n if n else None


def traced_generate(torch, serve, params, cfg, tokens, gen, kernel_key):
    """One ``serve.generate`` under the profiler: device busy time and
    share of the wall time, kernel launches, the device time of the
    kernels whose names hold ``kernel_key`` (one string or a tuple) and of
    the flash kernels, and the largest device ops.  ``tokens`` is the
    batch's tokens, or the whole batch (a dict)."""
    from torch.profiler import ProfilerActivity, profile

    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = serve.generate(params, cfg, batch, gen)
    return trace_summary(torch, prof, (run.prefill_s + run.decode_s) * 1e6,
                         kernel_key)


def trace_summary(torch, prof, wall_us, kernel_key):
    """What :func:`traced_generate` reads from a profile of ``wall_us``
    microseconds of host time."""
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    keys = (kernel_key,) if isinstance(kernel_key, str) else kernel_key
    mine_us = sum(e.self_device_time_total for e in kern
                  if any(k in e.key for k in keys))
    flash_us = sum(e.self_device_time_total for e in kern
                   if any(k in e.key for k in FLASH_KERNEL_KEYS))
    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        launches=sum(e.count for e in kern), kernel_ms=mine_us / 1e3,
        kernel_share_of_device=mine_us / busy_us if busy_us else 0.0,
        flash_ms=flash_us / 1e3,
        top=[(e.key[:70], e.self_device_time_total, e.count)
             for e in sorted(kern, key=lambda e: -e.self_device_time_total)
             [:8]])


def flash_checks(torch, dev):
    """The flash kernels against their plain twin, call by call
    (``FLASH_CASES``: bf16 within 2e-2, float32 within 1e-4); the poisoned
    neighbour (finite, and bitwise what the head gives alone); two calls
    bitwise equal; then the time at gemma2_2b's and moonshot_v1_16b_a3b's
    prefill shapes beside the twin's, ``scaled_dot_product_attention``'s
    and the bound.  Returns ``{"flash_errors", "flash_timed"}``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as fref

    check(set(fa.KERNEL_NAMES.values()) == set(FLASH_KERNEL_KEYS),
          f"flash kernels {fa.KERNEL_NAMES} are not {FLASH_KERNEL_KEYS}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, kv, s, dh, dtype):
        return tuple(torch.randn((b, n, s, dh), generator=gen, device=dev
                                 ).to(dtype) for n in (h, kv, kv))

    errs = {}
    for label, b, h, kv, s, dh, dtype, window, softcap, causal in \
            FLASH_CASES:
        q, k, v = qkv(b, h, kv, s, dh, getattr(torch, dtype))
        got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
        want = fref.flash_attention(q, k, v, causal, window, softcap)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        errs[label] = float((got.float() - want.float()).abs().max())
        check(got.dtype == q.dtype and within(got, want, tol),
              f"flash_attention {label}: max abs err {errs[label]} beyond "
              f"{tol}")
        print(f"  flash {label:12s} B={b} H={h} KV={kv} S={s} Dh={dh} "
              f"{dtype} causal={causal} window={window} softcap={softcap} "
              f"({fa.KERNEL_NAMES[q.dtype]}): max abs err "
              f"{errs[label]:.3g} (tol {tol})", flush=True)

    # KV head 1's V all inf: query heads of KV head 0 stay finite and equal
    # to what they give alone (no tile reads past S into the next head)
    b, h, kv, s = POISON_SHAPE
    rep = h // kv
    for dh, dtype in ([(d, torch.bfloat16) for d in POISON_HEAD_DIMS]
                      + [(256, torch.float32)]):
        q, k, v = qkv(b, h, kv, s, dh, dtype)
        v[:, 1] = float("inf")
        got = fa.flash_attention(q, k, v, softcap=50.0)[:, :rep]
        alone = fa.flash_attention(q[:, :rep].contiguous(),
                                   k[:, :1].contiguous(),
                                   v[:, :1].contiguous(), softcap=50.0)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()) and torch.equal(got, alone),
              f"poisoned neighbour Dh={dh} {dtype}: head 0 is not finite "
              "or differs from head 0 alone")
        print(f"  poisoned neighbour Dh={dh} S={s} {str(dtype)[6:]}: KV "
              "head 0 finite and bitwise equal to it alone", flush=True)

    timed = {}
    for name, (b, h, kv, s, dh), softcap in (
            ("gemma2_2b", (SERVE_B, 8, 4, SERVE_S, 256), 50.0),
            ("moonshot_v1_16b_a3b", (SERVE_B, 16, 16, SERVE_S, 128), None)):
        timed[name] = flash_time(torch, dev, name, (b, h, kv, s, dh),
                                 softcap=softcap)
    return dict(flash_errors=errs, flash_timed=timed)


def flash_time(torch, dev, name, shape, *, causal=True, window=0,
               softcap=None) -> dict:
    """The bf16 flash kernel at a model's prefill shape ``(B, H, KV, S,
    Dh)``: two calls bitwise equal, then ms a call (CUDA events) beside
    the twin's, one ``scaled_dot_product_attention`` call's and the bound,
    and the device time a launch (profiler).  SDPA (causal as the layer
    is, k and v repeated to H heads) computes the same function only
    without a softcap and a window that bites (``same_function``); it is
    timed either way, as the yardstick of the kernel's time."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as fref

    b, h, kv, s, dh = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((b, n, s, dh), generator=gen, device=dev
                           ).to(torch.bfloat16) for n in (h, kv, kv))

    def call(i=0):
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)

    first, second = call(), call()
    torch.cuda.synchronize()
    check(torch.equal(first, second),
          f"two flash calls at the {name} shape differ")
    ms = cuda_time_ms(call, 50, torch)
    plain_ms = cuda_time_ms(
        lambda i: fref.flash_attention(q, k, v, causal, window, softcap),
        10, torch)
    same = softcap is None and (window == 0 or window >= s)
    ke, ve = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    lib_ms = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=causal), 50, torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    dev_us = kernel_device_us(prof, FLASH_KERNEL_KEYS)
    # every visible (query, key) pair is a Dh product for s and one for
    # P V, two operations a multiply-add; a window past S hides nothing
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4 * dh * b * h * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bnd, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    print(f"flash_attention at {name}'s {b}x{h}/{kv}x{s}x{dh} bf16 "
          f"(causal {causal}, window {window}, softcap {softcap}): "
          f"{ms:.4f} ms a call ({flops / ms / 1e9:.2f} TFLOP/s, "
          f"{ms / bnd:.2f}x its bound; device "
          f"{f'{dev_us:.1f} us' if dev_us else 'not measured'}), bound "
          f"{bnd:.5f} ms ({by}), twin {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms ({ms / lib_ms:.2f}x "
          f"its time; {'the' if same else 'not the'} same function); two "
          "calls bitwise equal", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                same_function=same,
                device_us=dev_us, flops=flops, bytes=nbytes, bound_ms=bnd,
                bound_by=by, tflops=flops / ms / 1e9)


def flash_build_report(lib, log: str) -> dict:
    """Registers and spills of each flash kernel instantiation from the
    ptxas report in the build log, and its wgmma / TMA instructions in the
    SASS (cuobjdump, where the toolkit has it).  Fails if a bf16
    instantiation spills, has no HGMMA or UTMALDG, or is missing from the
    report (a cached build returns the log kept beside its library)."""
    import os
    import re
    import shutil

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(flash_fwd_\w*?kernel)"
                      r"I\w*?Li(\d+)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            found[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            found[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name]["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = {}
    if os.path.exists(tool):
        dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300).stdout
        for part in dump.split("Function : ")[1:]:
            m = re.match(r"\w*?(flash_fwd_\w*?kernel)I\w*?Li(\d+)E", part)
            if m:
                sass[f"{m.group(1)}<{m.group(2)}>"] = {
                    op: len(re.findall(rf"\b{op}\b", part))
                    for op in ("HGMMA", "UTMALDG")}
    for name, info in found.items():
        print(f"  {name}: {info.get('registers')} registers, "
              f"{info.get('spill_stores')} / {info.get('spill_loads')} bytes "
              f"spilled (stores / loads); SASS "
              f"{sass.get(name, 'not read (no cuobjdump)')}", flush=True)
        if "wgmma" in name:
            check(info.get("spill_stores") == 0
                  and info.get("spill_loads") == 0,
                  f"{name} spills: {info}")
            check(not sass or (sass[name]["HGMMA"] > 0
                               and sass[name]["UTMALDG"] > 0),
                  f"{name} has no HGMMA or UTMALDG: {sass.get(name)}")
    from repro_torch.kernels import flash_attention as fa

    check(sum("wgmma" in n for n in found) == len(fa.HEAD_DIMS),
          f"ptxas reported {sorted(found)}")
    return dict(ptxas=found, sass=sass)


def sched_step_build_report(log: str) -> dict:
    """Registers, stack frame and spills of each ``sched_step_kernel``
    instantiation from the ptxas report in the build log (a cached build
    returns the log kept beside its library).  Fails on a stack frame or a
    spill, or if an instantiation is missing."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?sched_step_kernel"
                      r"ILi(\d+)E", line)
        if m:
            name = f"sched_step_kernel<{m.group(1)}>"
            found[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            found[name].update(stack_frame=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name]["registers"] = int(m.group(1))
            name = None
    for name, info in found.items():
        print(f"  {name}: {info.get('registers')} registers, "
              f"{info.get('stack_frame')} bytes stack frame, "
              f"{info.get('spill_stores')} / {info.get('spill_loads')} bytes "
              "spilled (stores / loads)", flush=True)
        check(info.get("stack_frame") == 0 and info.get("spill_stores") == 0
              and info.get("spill_loads") == 0,
              f"{name} uses local memory: {info}")
    check(sorted(found) == ["sched_step_kernel<1024>",
                            "sched_step_kernel<128>"],
          f"ptxas reported {sorted(found)}")
    return found


def serve_phase(torch, dev, reg):
    """Phase 6: serve gemma2_2b at full width through the flash kernel and
    hold it against its plain twin.  Returns (the kernel's row, report)."""
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cb.get("gemma2_2b")
    B, S, GEN = SERVE_B, SERVE_S, SERVE_GEN
    out = {}
    t_phase = time.perf_counter()

    # the path a user calls, with the launch counts zeroed just before and
    # read just after
    reg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = serve.main(list(SERVE_ARGV))
    torch.cuda.synchronize()
    out["main_wall_s"] = time.perf_counter() - t0
    launches = reg.launch_counts()
    check(launches["flash_attention"] == cfg.n_layers == 26,
          f"serving took {launches['flash_attention']} flash launches for "
          f"{cfg.n_layers} attention layers")
    zero = dict.fromkeys(reg.KERNELS, 0)
    check(g.launches == {"prefill": dict(zero, flash_attention=26),
                         "decode": zero},
          f"kernel launches by phase: {g.launches}")
    check(not any(launches[k] for k in SIM_KERNELS),
          f"a simulator kernel ran while serving: {launches}")
    check(tuple(g.ids.shape) == (B, GEN)
          and bool(((g.ids >= 0) & (g.ids < cfg.vocab)).all()),
          f"generated ids of shape {tuple(g.ids.shape)} out of range")
    check(bool(torch.isfinite(g.prefill_logits.float()).all()),
          "non-finite prefill logits")
    out.update(launches=launches, first_prefill_s=g.prefill_s,
               first_decode_tok_per_s=B * (GEN - 1) / g.decode_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ids_lane0=g.ids[0].tolist())
    print(f"serve: gemma2_2b {B}x{S} + {GEN} tokens through serve.main: "
          f"{launches['flash_attention']} flash launches (prefill "
          f"{g.launches['prefill']['flash_attention']}, decode "
          f"{g.launches['decode']['flash_attention']}); first "
          f"prefill {g.prefill_s:.4f} s, decode "
          f"{out['first_decode_tok_per_s']:.1f} tok/s; peak "
          f"{out['peak_gib']:.2f} GiB; lane 0 ids {out['ids_lane0']}",
          flush=True)
    del g

    # the same weights again, warm; then through the plain twin
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.as_tensor(batch_for(cfg, 0, B, S)["tokens"], device=dev)
    serve.generate(params, cfg, {"tokens": tokens}, GEN)
    warm = serve.generate(params, cfg, {"tokens": tokens}, GEN)
    check(bool(torch.isfinite(warm.prefill_logits.float()).all()),
          "non-finite prefill logits (warm)")
    ops.set_impl("ref")
    try:
        plain = serve.generate(params, cfg, {"tokens": tokens}, GEN)
    finally:
        ops.set_impl(None)
    out.update(
        prefill_s=warm.prefill_s,
        decode_tok_per_s=B * (GEN - 1) / warm.decode_s,
        plain_prefill_s=plain.prefill_s,
        greedy_agreement=float((plain.ids == warm.ids).float().mean()),
        bf16_logits_max_abs_diff=float(
            (plain.prefill_logits.float()
             - warm.prefill_logits.float()).abs().max()))
    print(f"serve (warm): prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_tok_per_s']:.1f} tok/s; plain path prefill "
          f"{out['plain_prefill_s']:.4f} s; greedy bf16 ids agree on "
          f"{100 * out['greedy_agreement']:.2f} % (not gated), last logits "
          f"max abs diff {out['bf16_logits_max_abs_diff']:.4g}", flush=True)
    # where the time goes: a traced prefill alone, then a prefill and 3
    # decode steps (decoding is the difference)
    out["traced"] = {
        k: traced_generate(torch, serve, params, cfg, tokens, gen,
                           FLASH_KERNEL_KEYS)
        for k, gen in (("prefill", 1), ("prefill_and_3_steps", 4))}
    for k, t in out["traced"].items():
        print(f"serve (traced, {k}): device busy {t['device_busy_ms']:.2f} "
              f"ms of {t['wall_ms']:.2f} ms wall "
              f"({100 * t['device_busy_share']:.1f} %), {t['launches']} "
              f"kernel launches, flash {t['flash_ms']:.3f} ms "
              f"({100 * t['kernel_share_of_device']:.1f} % of device "
              f"time); top: {t['top'][:4]}", flush=True)
    del params, warm, plain

    # the full model in float32: kernel against the plain path
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params = tfm.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": tokens[:2]}
    with torch.inference_mode():
        k_last, _ = tfm.prefill(params, cfg32, batch, S)
        ops.set_impl("ref")
        try:
            r_last, _ = tfm.prefill(params, cfg32, batch, S)
        finally:
            ops.set_impl(None)
    torch.cuda.synchronize()
    err = float((k_last - r_last).abs().max())
    out.update(f32_logits_max_abs_err=err,
               f32_logits_max_abs=float(r_last.abs().max()),
               f32_logits_share_below_29=float(
                   (r_last.abs() < 29.0).float().mean()))
    check(bool(torch.isfinite(k_last).all()) and err <= F32_LOGITS_TOL,
          f"float32 gemma2_2b: kernel and plain last logits differ by "
          f"{err} (> {F32_LOGITS_TOL})")
    print(f"serve (float32, 2x{S}): last-position logits, kernel against "
          f"plain path, max abs err {err:.3g} (<= {F32_LOGITS_TOL}; "
          f"|logit| <= {out['f32_logits_max_abs']:.3f}, "
          f"{100 * out['f32_logits_share_below_29']:.1f} % below 29)",
          flush=True)
    del params, k_last, r_last

    # the kernel against its twin, call by call, and its time
    out.update(flash_checks(torch, dev))
    t = out["flash_timed"]["gemma2_2b"]
    ms, plain_ms, lib_ms, bnd, by = (t[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))
    errs = out["flash_errors"]
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces=reg.KERNELS["flash_attention"].replaces,
               launches=launches["flash_attention"],
               max_abs_err=max(errs["serve_local"], errs["serve_full"]),
               ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
               library_ms=lib_ms)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving phase took {out['phase_s']:.1f} s", flush=True)
    return row, out


#: the serving run of phase 7: rwkv6_1_6b at full width, the same batch and
#: lengths as gemma2_2b's
RWKV_ARGV = ("--arch", "rwkv6_1_6b", "--batch", str(SERVE_B),
             "--prompt-len", str(SERVE_S), "--gen", str(SERVE_GEN),
             "--seed", "0")
#: the RWKV6 kernel against its twin: (label, B, H, T, Dh, dtype, nonzero
#: initial state, layout, decays) — the serving shape in the model's layout
#: and packed, float32 from a nonzero state, a ragged T, one step, the
#: small heads and a long sequence; then the kernel's edges: one (b, h) at
#: each head dim, T on either side of one and of two tiles (32 steps at Dh =
#: 64, 16 at 16 and 32), and decays near 1 and near 0 from a nonzero state.
#: "model": (B, T, H, Dh) buffers viewed as (B, H, T, Dh), as time_mix
#: hands them over; "packed": contiguous (B, H, T, Dh).  Decays: sigmoid of
#: a standard normal, or of 6 or -6 plus a tenth of one ("near1", "near0")
RWKV_CASES = (
    ("serve_model", 4, 32, 1024, 64, "bfloat16", False, "model", None),
    ("serve_bf16", 4, 32, 1024, 64, "bfloat16", False, "packed", None),
    ("f32_state", 2, 32, 1024, 64, "float32", True, "packed", None),
    ("ragged_1000", 1, 32, 1000, 64, "bfloat16", True, "packed", None),
    ("one_step", 4, 32, 1, 64, "float32", True, "packed", None),
    ("dh16", 2, 4, 256, 16, "float32", True, "packed", None),
    ("dh32", 2, 8, 512, 32, "bfloat16", True, "model", None),
    ("long_8192", 1, 32, 8192, 64, "bfloat16", False, "packed", None),
    ("b1h1_dh16", 1, 1, 77, 16, "bfloat16", True, "packed", None),
    ("b1h1_dh32", 1, 1, 77, 32, "float32", True, "packed", None),
    ("b1h1_dh64", 1, 1, 77, 64, "bfloat16", True, "model", None),
    *((f"t{t}", 2, 32, t, 64, "float32", True, "packed", None)
      for t in (31, 32, 33, 63, 64, 65)),
    ("t33_bf16", 2, 32, 33, 64, "bfloat16", True, "model", None),
    *((f"t{t}_dh{dh}", 2, 8, t, dh, "bfloat16", True, "packed", None)
      for dh in (16, 32) for t in (15, 17, 31, 33)),
    ("decay_near1", 2, 32, 300, 64, "float32", True, "packed", "near1"),
    ("decay_near0", 2, 32, 300, 64, "bfloat16", True, "model", "near0"),
)
#: the centre of the decays' sigmoid by ``decay``
RWKV_DECAY = {None: 0.0, "near1": 6.0, "near0": -6.0}
#: atol = rtol on the output by its type (as FLASH_TOL), and on every final
#: state, which is float32 whatever the inputs
RWKV_STATE_TOL = 1e-4
#: the float32 rwkv6_1_6b, kernel against plain path: prefill logits and
#: 3 decode steps, atol = rtol
RWKV_F32_TOL = 1e-3


def rwkv_inputs(torch, B, H, T, Dh, dtype, nonzero_state, gen, dev,
                layout="packed", decay=None):
    """r, k, v, w, u, state drawn as the JAX package's kernel test draws
    them: k and v by 0.3, sigmoid decays, u and the state by 0.1; with
    ``decay`` the decays are sigmoid(+-6 + 0.1 z).  In the "model" layout
    r, k, v, w are (B, T, H, Dh) buffers viewed as (B, H, T, Dh)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dt = getattr(torch, dtype)
    r = randn(B, H, T, Dh).to(dt)
    k = (randn(B, H, T, Dh) * 0.3).to(dt)
    v = (randn(B, H, T, Dh) * 0.3).to(dt)
    z = randn(B, H, T, Dh)
    w = torch.sigmoid(z if decay is None else RWKV_DECAY[decay] + 0.1 * z
                      ).to(dt)
    u = randn(H, Dh) * 0.1
    state = randn(B, H, Dh, Dh) * 0.1 if nonzero_state else \
        torch.zeros((B, H, Dh, Dh), device=dev)
    if layout == "model":
        r, k, v, w = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (r, k, v, w))
    return r, k, v, w, u, state


def rwkv6_build_report(rk, log: str, B: int, H: int) -> dict:
    """The RWKV6 kernel's launch at B x H for each head dim (blocks,
    threads, shared bytes, as the library reports them) beside ptxas's
    registers, stack frame and spills for each instantiation (from the
    build log; a cached build returns the log kept beside its library).
    Fails on local memory, or if an instantiation is missing."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?rwkv6_kernelI"
                      r"(f|13__nv_bfloat16)Li(\d+)E", line)
        if m:
            name = (("float32" if m.group(1) == "f" else "bfloat16"),
                    int(m.group(2)))
            found[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            found[name].update(stack_frame=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name]["registers"] = int(m.group(1))
            name = None
    for dtype in ("bfloat16", "float32"):
        for dh in rk.HEAD_DIMS:
            info = found.get((dtype, dh), {})
            info["launch"] = rk.launch_shape(B, H, dh)
            print(f"  rwkv6_kernel<{dtype}, {dh}> at B={B} H={H}: "
                  f"{info['launch']['blocks']} blocks of "
                  f"{info['launch']['threads']} threads, "
                  f"{info['launch']['shared_bytes']} shared bytes; "
                  f"{info.get('registers')} registers, "
                  f"{info.get('stack_frame')} bytes stack frame, "
                  f"{info.get('spill_stores')} / {info.get('spill_loads')} "
                  "bytes spilled (stores / loads)", flush=True)
            check(info.get("stack_frame") == 0
                  and info.get("spill_stores") == 0
                  and info.get("spill_loads") == 0,
                  f"rwkv6_kernel<{dtype}, {dh}> uses local memory: {info}")
    check(len(found) == 2 * len(rk.HEAD_DIMS),
          f"ptxas reported {sorted(found)}")
    return {f"{dtype}/{dh}": info for (dtype, dh), info in found.items()}


def rwkv_phase(torch, dev, reg):
    """Phase 7: serve rwkv6_1_6b at full width through the RWKV6 kernel and
    hold it against its plain twin.  Returns (the kernel's row, report)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cb.get("rwkv6_1_6b")
    B, S, GEN = SERVE_B, SERVE_S, SERVE_GEN
    out = {}
    t_phase = time.perf_counter()
    out["build"] = rwkv6_build_report(rk, rk.build()[1], B, cfg.n_heads)

    # the path a user calls, with the launch counts zeroed just before and
    # read just after
    reg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = serve.main(list(RWKV_ARGV))
    torch.cuda.synchronize()
    out["main_wall_s"] = time.perf_counter() - t0
    launches = reg.launch_counts()
    zero = dict.fromkeys(reg.KERNELS, 0)
    check(launches == dict(zero, rwkv6_scan=cfg.n_layers),
          f"serving rwkv6_1_6b launched {launches} for {cfg.n_layers} RWKV "
          "layers")
    check(g.launches == {"prefill": dict(zero, rwkv6_scan=cfg.n_layers),
                         "decode": zero},
          f"kernel launches by phase: {g.launches}")
    check(tuple(g.ids.shape) == (B, GEN)
          and bool(((g.ids >= 0) & (g.ids < cfg.vocab)).all()),
          f"generated ids of shape {tuple(g.ids.shape)} out of range")
    check(bool(torch.isfinite(g.prefill_logits.float()).all()),
          "non-finite prefill logits")
    out.update(launches=launches, first_prefill_s=g.prefill_s,
               first_decode_tok_per_s=B * (GEN - 1) / g.decode_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ids_lane0=g.ids[0].tolist())
    print(f"serve_rwkv: rwkv6_1_6b {B}x{S} + {GEN} tokens through "
          f"serve.main: {launches['rwkv6_scan']} rwkv6_scan launches "
          f"(prefill {g.launches['prefill']['rwkv6_scan']}, decode "
          f"{g.launches['decode']['rwkv6_scan']}); first prefill "
          f"{g.prefill_s:.4f} s, decode {out['first_decode_tok_per_s']:.1f} "
          f"tok/s; peak {out['peak_gib']:.2f} GiB; lane 0 ids "
          f"{out['ids_lane0']}", flush=True)
    del g

    # the same weights again, warm; then through the plain twin
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.as_tensor(batch_for(cfg, 0, B, S)["tokens"], device=dev)
    serve.generate(params, cfg, {"tokens": tokens}, GEN)
    warm = serve.generate(params, cfg, {"tokens": tokens}, GEN)
    check(bool(torch.isfinite(warm.prefill_logits.float()).all()),
          "non-finite prefill logits (warm)")
    ops.set_impl("ref")
    try:
        plain = serve.generate(params, cfg, {"tokens": tokens}, GEN)
    finally:
        ops.set_impl(None)
    out.update(
        prefill_s=warm.prefill_s,
        decode_tok_per_s=B * (GEN - 1) / warm.decode_s,
        plain_prefill_s=plain.prefill_s,
        greedy_agreement=float((plain.ids == warm.ids).float().mean()),
        bf16_logits_max_abs_diff=float(
            (plain.prefill_logits.float()
             - warm.prefill_logits.float()).abs().max()))
    print(f"serve_rwkv (warm): prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_tok_per_s']:.1f} tok/s; plain path prefill "
          f"{out['plain_prefill_s']:.4f} s; greedy bf16 ids agree on "
          f"{100 * out['greedy_agreement']:.2f} % (not gated), last logits "
          f"max abs diff {out['bf16_logits_max_abs_diff']:.4g}", flush=True)
    out["traced"] = {
        k: traced_generate(torch, serve, params, cfg, tokens, gen,
                           "rwkv6_kernel")
        for k, gen in (("prefill", 1), ("prefill_and_3_steps", 4))}
    for k, t in out["traced"].items():
        print(f"serve_rwkv (traced, {k}): device busy "
              f"{t['device_busy_ms']:.2f} ms of {t['wall_ms']:.2f} ms wall "
              f"({100 * t['device_busy_share']:.1f} %), {t['launches']} "
              f"kernel launches, rwkv6_scan {t['kernel_ms']:.3f} ms "
              f"({100 * t['kernel_share_of_device']:.1f} % of device "
              f"time); top: {t['top'][:5]}", flush=True)
    del params, warm, plain

    # the full model in float32 at batch 2: kernel against the plain path,
    # the prefill, then 3 decode steps from each prefill's own state
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params = tfm.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": tokens[:2]}
    steps = torch.as_tensor(batch_for(cfg, 1, 2, 3)["tokens"], device=dev)
    logits = {}
    with torch.inference_mode():
        for impl in (None, "ref"):
            ops.set_impl(impl)
            try:
                last, state = tfm.prefill(params, cfg32, batch, S + 3)
                seq = [last]
                for t in range(3):
                    step, state = tfm.decode_step(params, cfg32, state,
                                                  steps[:, t])
                    seq.append(step)
            finally:
                ops.set_impl(None)
            logits[impl] = (seq, state)
    torch.cuda.synchronize()
    (k_seq, k_state), (r_seq, r_state) = logits[None], logits["ref"]
    errs = [float((a - b).abs().max()) for a, b in zip(k_seq, r_seq)]
    out.update(f32_logits_max_abs_err=errs[0],
               f32_decode_max_abs_err=max(errs[1:]),
               f32_logits_max_abs=float(r_seq[0].abs().max()),
               f32_state_max_abs_err=float(
                   (k_state.caches[0]["rwkv_state"]
                    - r_state.caches[0]["rwkv_state"]).abs().max()))
    check(all(bool(torch.isfinite(a).all()) and within(a, b, RWKV_F32_TOL)
              for a, b in zip(k_seq, r_seq)),
          f"float32 rwkv6_1_6b: kernel and plain logits differ by {errs} "
          f"(prefill, 3 decode steps; beyond {RWKV_F32_TOL})")
    print(f"serve_rwkv (float32, 2x{S}): kernel against plain path, "
          f"last-position logits max abs err {errs[0]:.3g}, 3 decode steps "
          f"{max(errs[1:]):.3g} (atol = rtol = {RWKV_F32_TOL}; |logit| <= "
          f"{out['f32_logits_max_abs']:.3f}); state after decoding "
          f"{out['f32_state_max_abs_err']:.3g}", flush=True)
    del params, logits, k_seq, r_seq, k_state, r_state

    # the kernel against its twin, call by call, output and final state
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for label, b, h, t, dh, dtype, nonzero, layout, decay in RWKV_CASES:
        args = rwkv_inputs(torch, b, h, t, dh, dtype, nonzero, gen, dev,
                           layout, decay)
        got, got_state = rk.rwkv6(*args)
        want, want_state = rk.plain(*args)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        errs[label] = float((got.float() - want.float()).abs().max())
        state_err = float((got_state - want_state).abs().max())
        check(got.dtype == args[0].dtype
              and got.stride() == args[0].stride()
              and within(got, want, tol)
              and within(got_state, want_state, RWKV_STATE_TOL),
              f"rwkv6_scan {label}: max abs err {errs[label]} (tol {tol}), "
              f"state {state_err} (tol {RWKV_STATE_TOL}), out strides "
              f"{got.stride()} for input strides {args[0].stride()}")
        print(f"  rwkv6 {label:12s} B={b} H={h} T={t} Dh={dh} {dtype} "
              f"{layout} state={'random' if nonzero else 'zero'} decays="
              f"{decay or 'sigmoid'}: max abs err "
              f"{errs[label]:.3g} (tol {tol}), state {state_err:.3g} (tol "
              f"{RWKV_STATE_TOL})", flush=True)
    out["rwkv_errors"] = errs

    # its time at the serving shape, in the model's layout (the main
    # path's) and packed, beside the twin's; no single PyTorch call
    # computes the recurrence, so there is no library time
    b, h, t, dh = B, cfg.n_heads, S, cfg.head_dim
    timed = {}
    for layout in ("model", "packed"):
        args = rwkv_inputs(torch, b, h, t, dh, "bfloat16", False, gen, dev,
                           layout)
        ms = cuda_time_ms(lambda i: rk.rwkv6(*args), 50, torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                rk.rwkv6(*args)
            torch.cuda.synchronize()
        timed[layout] = dict(ms=ms,
                             device_us=kernel_device_us(prof, "rwkv6_kernel"))
    plain_ms = cuda_time_ms(lambda i: rk.plain(*args), 3, torch)
    # per (b, h, t), an FMA counted as two: out_d = sum_k r_k S_kd
    # + v_d a_t and S_kd <- w_k S_kd + k_k v_d take 5 Dh^2 operations, the
    # scalar a_t = sum_k r_k u_k k_k and its term of out 5 Dh more; r, k,
    # v, w read and out written once, u read, the state in and out
    ops_n = (5 * dh * dh + 5 * dh) * b * h * t
    nbytes = (5 * args[0].numel() * args[0].element_size()
              + args[4].numel() * 4 + 2 * args[5].numel() * 4)
    bnd, by = bound_ms(nbytes, ops_n)
    ms, dev_us = timed["model"]["ms"], timed["model"]["device_us"]
    out["rwkv_timed"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             device_us=dev_us,
                             packed_ms=timed["packed"]["ms"],
                             packed_device_us=timed["packed"]["device_us"],
                             ops=ops_n, bytes=nbytes, bound_ms=bnd,
                             bound_by=by, gops=ops_n / ms / 1e6)
    for layout, tm in timed.items():
        du = tm["device_us"]
        print(f"rwkv6_scan at {b}x{h}x{t}x{dh} bf16, {layout} layout: "
              f"{tm['ms']:.4f} ms a call ({ops_n / tm['ms'] / 1e9:.3f} "
              f"TFLOP/s, {tm['ms'] / bnd:.2f}x its bound; device "
              f"{f'{du:.1f} us' if du else 'time not measured'})",
              flush=True)
    print(f"rwkv6_scan bound {bnd:.5f} ms ({by}; {ops_n} operations, "
          f"{nbytes} bytes), twin {plain_ms:.4f} ms, no library call",
          flush=True)
    row = dict(name="rwkv6_scan", route="cuda",
               source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
               replaces=reg.KERNELS["rwkv6_scan"].replaces,
               launches=launches["rwkv6_scan"],
               max_abs_err=errs["serve_model"], ms=ms, plain_ms=plain_ms,
               bound_ms=bnd, bound_by=by, library_ms=None)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"rwkv serving phase took {out['phase_s']:.1f} s", flush=True)
    return row, out


#: the serving run of phase 8: moonshot_v1_16b_a3b at full width, the same
#: batch and lengths as gemma2_2b's and rwkv6_1_6b's
MOE_ARGV = ("--arch", "moonshot_v1_16b_a3b", "--batch", str(SERVE_B),
            "--prompt-len", str(SERVE_S), "--gen", str(SERVE_GEN),
            "--seed", "0")
#: the dispatch kernel against its twin beside the model's own layer-0
#: routing: (label, T, D, k, E, C, dtype, token groups) — the decode shape,
#: the prefill shape in float32, a T that is not a multiple of 256, top-1,
#: a capacity small enough that most slots drop, two token groups (G * E =
#: 128 buffers) and an odd row of 13 bf16 values (2-byte copies)
MOE_CASES = (
    ("decode", 4, 2048, 6, 64, 8, "bfloat16", 1),
    ("f32", 4096, 2048, 6, 64, 480, "float32", 1),
    ("ragged_1000", 1000, 2048, 6, 64, 120, "bfloat16", 1),
    ("top1", 4096, 2048, 1, 64, 80, "bfloat16", 1),
    ("tight", 4096, 2048, 6, 64, 48, "bfloat16", 1),
    ("groups_2", 4096, 2048, 6, 64, 240, "bfloat16", 2),
    ("odd_row", 1000, 13, 6, 64, 120, "bfloat16", 1),
)
#: the dispatch kernel's two CUDA kernels, as the profiler names them
MOE_KERNEL_KEYS = ("map_rows", "copy_rows")


def moe_inputs(torch, balance, T, D, k, E, C, dtype, G, gen, dev):
    """x and the (virtual expert, pos) tables of an NA-RP routing of random
    logits, as ``models.moe`` hands them to the dispatch."""
    x = torch.randn((T, D), generator=gen, device=dev).to(
        getattr(torch, dtype))
    logits = torch.randn((T, E), generator=gen, device=dev) * 2.0
    tg = torch.arange(T, dtype=torch.int32, device=dev) // (T // G)
    r = balance.route(logits, k, C, balance.default_expert_groups(E, 16, dev),
                      token_group=tg, n_token_groups=G)
    ve = torch.where(r.expert >= 0, tg[:, None] * E + r.expert, -1)
    return x, ve, r.pos


def moe_phase(torch, dev, reg):
    """Phase 8: serve moonshot_v1_16b_a3b at full width through the flash
    and MoE-dispatch kernels and hold the dispatch against its plain twin.
    Returns (the dispatch kernel's row, report)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cb
    from repro_torch.core import balance
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as mref
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cb.get("moonshot_v1_16b_a3b")
    L = cfg.n_layers
    B, S, GEN = SERVE_B, SERVE_S, SERVE_GEN
    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out["free_gib_at_start"] = torch.cuda.mem_get_info()[0] / 2**30

    # the path a user calls, with the launch counts zeroed just before and
    # read just after
    reg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = serve.main(list(MOE_ARGV))
    torch.cuda.synchronize()
    out["main_wall_s"] = time.perf_counter() - t0
    launches = reg.launch_counts()
    zero = dict.fromkeys(reg.KERNELS, 0)
    check(launches == dict(zero, flash_attention=L,
                           moe_dispatch=L * GEN),
          f"serving moonshot launched {launches} for {L} MoE layers, "
          f"{GEN - 1} decode steps")
    check(g.launches == {
        "prefill": dict(zero, flash_attention=L, moe_dispatch=L),
        "decode": dict(zero, moe_dispatch=L * (GEN - 1))},
          f"kernel launches by phase: {g.launches}")
    check(tuple(g.ids.shape) == (B, GEN)
          and bool(((g.ids >= 0) & (g.ids < cfg.vocab)).all()),
          f"generated ids of shape {tuple(g.ids.shape)} out of range")
    check(bool(torch.isfinite(g.prefill_logits.float()).all()),
          "non-finite prefill logits")
    out.update(launches=launches, first_prefill_s=g.prefill_s,
               first_decode_tok_per_s=B * (GEN - 1) / g.decode_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ids_lane0=g.ids[0].tolist())
    check(out["peak_gib"] * 2**30 < 80e9,
          f"peak memory {out['peak_gib']:.2f} GiB")
    print(f"serve_moe: moonshot_v1_16b_a3b {B}x{S} + {GEN} tokens through "
          f"serve.main: prefill {g.launches['prefill']['flash_attention']} "
          f"flash + {g.launches['prefill']['moe_dispatch']} moe_dispatch "
          f"launches, decode {g.launches['decode']['moe_dispatch']} "
          f"moe_dispatch; first prefill {g.prefill_s:.4f} s, decode "
          f"{out['first_decode_tok_per_s']:.1f} tok/s; peak "
          f"{out['peak_gib']:.2f} GiB ({out['free_gib_at_start']:.2f} GiB "
          f"free before); lane 0 ids {out['ids_lane0']}", flush=True)
    del g

    # the same weights again, warm, and traced
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.as_tensor(batch_for(cfg, 0, B, S)["tokens"], device=dev)
    serve.generate(params, cfg, {"tokens": tokens}, GEN)
    warm = serve.generate(params, cfg, {"tokens": tokens}, GEN)
    check(bool(torch.isfinite(warm.prefill_logits.float()).all()),
          "non-finite prefill logits (warm)")
    out.update(prefill_s=warm.prefill_s,
               decode_tok_per_s=B * (GEN - 1) / warm.decode_s,
               decode_step_s=warm.decode_s / (GEN - 1))
    print(f"serve_moe (warm): prefill {out['prefill_s']:.4f} s, decode "
          f"{out['decode_tok_per_s']:.1f} tok/s "
          f"({1e3 * out['decode_step_s']:.1f} ms a step)", flush=True)
    del warm
    out["traced"] = {
        k: traced_generate(torch, serve, params, cfg, tokens, gen,
                           MOE_KERNEL_KEYS)
        for k, gen in (("prefill", 1), ("prefill_and_3_steps", 4))}
    for k, t in out["traced"].items():
        print(f"serve_moe (traced, {k}): device busy "
              f"{t['device_busy_ms']:.2f} ms of {t['wall_ms']:.2f} ms wall "
              f"({100 * t['device_busy_share']:.1f} %), {t['launches']} "
              f"kernel launches, moe_dispatch {t['kernel_ms']:.3f} ms "
              f"({100 * t['kernel_share_of_device']:.1f} % of device "
              f"time), flash {t['flash_ms']:.3f} ms; top: {t['top'][:6]}",
              flush=True)

    # the routing counters of the prefill's layers, and layer 0's dispatch
    # inputs, taken as the model hands them over
    layer0 = []
    dispatch = ops.moe_dispatch

    def first_dispatch(x, expert, pos, **kw):
        if not layer0:
            layer0.append((x.clone(), expert.clone(), pos.clone(), kw))
        return dispatch(x, expert, pos, **kw)

    ops.moe_dispatch = first_dispatch
    try:
        with torch.inference_mode():
            _, aux = tfm.forward(params, cfg, {"tokens": tokens})
    finally:
        ops.moe_dispatch = dispatch
    counters = {k: int(v) for k, v in aux.items() if k != "lb_loss"}
    out.update(routing=counters, lb_loss_sum=float(aux["lb_loss"]))
    slots = L * B * S * cfg.moe.top_k
    check(counters["ntasks_static"] + counters["ntasks_stolen_local"]
          + counters["ntasks_stolen_remote"] + counters["ntasks_dropped"]
          == slots, f"routing counters {counters} do not add up to {slots}")
    print(f"serve_moe routing, summed over the prefill's {L} layers "
          f"({slots} slots): {counters}, lb_loss {out['lb_loss_sum']:.4f}",
          flush=True)

    # the kernel in the model: prefill and 3 decode steps with only the
    # dispatch swapped for its plain twin, bit for bit
    steps = torch.as_tensor(batch_for(cfg, 1, B, 3)["tokens"], device=dev)
    seqs = {}
    with torch.inference_mode():
        for impl in (None, "ref"):
            ops.set_impl(impl, "moe_dispatch")
            try:
                last, state = tfm.prefill(params, cfg, {"tokens": tokens},
                                          S + 3)
                seq = [last]
                for t in range(3):
                    step, state = tfm.decode_step(params, cfg, state,
                                                  steps[:, t])
                    seq.append(step)
            finally:
                ops.set_impl(None)
            seqs[impl] = seq
            del state
    torch.cuda.synchronize()
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(seqs[None], seqs["ref"])]
    out["model_bitwise"] = all(torch.equal(a, b)
                               for a, b in zip(seqs[None], seqs["ref"]))
    check(out["model_bitwise"], f"moonshot with the dispatch kernel and with "
          f"its twin: logits differ by {diffs} (prefill, 3 decode steps)")
    print(f"serve_moe: prefill logits and 3 decode steps bitwise equal with "
          f"the dispatch kernel and with its plain twin (|logit| <= "
          f"{float(seqs[None][0].float().abs().max()):.3f})", flush=True)
    del params, seqs

    # the kernel against its twin, call by call, bit for bit
    gen = torch.Generator(device=dev).manual_seed(0)
    x0, e0, p0, kw0 = layer0[0]
    cases = [("serve_layer0", x0, e0, p0, kw0["n_experts"],
              kw0["capacity"])]
    for label, T, D, k, E, C, dtype, G in MOE_CASES:
        x, ve, pos = moe_inputs(torch, balance, T, D, k, E, C, dtype, G, gen,
                                dev)
        cases.append((label, x, ve, pos, G * E, C))
    errs = {}
    for label, x, ve, pos, E, C in cases:
        got = md.moe_dispatch(x, ve, pos, n_experts=E, capacity=C)
        want = mref.moe_dispatch(x, ve, pos, E, C)
        torch.cuda.synchronize()
        errs[label] = float((got.float() - want.float()).abs().max())
        check(got.dtype == x.dtype and torch.equal(got, want),
              f"moe_dispatch {label}: max abs err {errs[label]}")
        print(f"  moe_dispatch {label:12s} T={x.shape[0]} D={x.shape[1]} "
              f"k={ve.shape[1]} buffers={E}x{C} {str(x.dtype)[6:]}: kept "
              f"{int((ve >= 0).sum())} of {ve.numel()} slots, bitwise "
              "equal", flush=True)
    out["moe_errors"] = errs
    check(tuple(x0.shape) == (B * S, cfg.d_model)
          and (kw0["n_experts"], kw0["capacity"]) == (64, 480),
          f"layer 0 dispatched {tuple(x0.shape)} into {kw0}")

    # its time at the prefill shape (layer 0's own routing), beside the
    # twin's and one library call's; and at the decode shape
    E, C = kw0["n_experts"], kw0["capacity"]
    ms = cuda_time_ms(lambda i: md.moe_dispatch(x0, e0, p0, n_experts=E,
                                                capacity=C), 50, torch)
    plain_ms = cuda_time_ms(lambda i: mref.moe_dispatch(x0, e0, p0, E, C),
                            20, torch)
    flat = (e0.long() * C + p0.long()).reshape(-1)
    keep = (e0 >= 0).reshape(-1)
    idx = torch.where(keep, flat, E * C)
    src = torch.repeat_interleave(x0, e0.shape[1], dim=0)
    lib_ms = cuda_time_ms(lambda i: torch.zeros(
        (E * C + 1, x0.shape[1]), dtype=x0.dtype, device=dev).index_put_(
        (idx,), src, accumulate=True), 20, torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            md.moe_dispatch(x0, e0, p0, n_experts=E, capacity=C)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if any(k in e.key for k in MOE_KERNEL_KEYS)]
    n_calls = sum(e.count for e in rows if "copy_rows" in e.key)
    dev_us = (sum(e.device_time_total for e in rows) / n_calls
              if n_calls else None)
    _, xd, ed, pd, _, _ = cases[1]
    decode_ms = cuda_time_ms(lambda i: md.moe_dispatch(
        xd, ed, pd, n_experts=64, capacity=8), 200, torch)
    # x read once, the two tables read once, the buffer written once; no
    # arithmetic
    nbytes = (x0.numel() * x0.element_size() + 2 * e0.numel() * 4
              + E * C * x0.shape[1] * x0.element_size())
    bnd, by = bound_ms(nbytes, 0)
    out["moe_timed"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            device_us=dev_us, bytes=nbytes, bound_ms=bnd,
                            bound_by=by, decode_ms=decode_ms,
                            gb_per_s=nbytes / ms / 1e6)
    print(f"moe_dispatch at T={x0.shape[0]} D={x0.shape[1]} k={e0.shape[1]} "
          f"-> {E}x{C} bf16: {ms:.4f} ms a call ({nbytes / ms / 1e6:.1f} "
          f"GB/s, {ms / bnd:.2f}x its bound; device "
          f"{f'{dev_us:.1f} us' if dev_us else 'time not measured'}), bound "
          f"{bnd:.5f} ms ({by}; {nbytes} bytes), twin {plain_ms:.4f} ms, "
          f"index_put_ {lib_ms:.4f} ms; decode shape {decode_ms:.4f} ms",
          flush=True)
    row = dict(name="moe_dispatch", route="cuda",
               source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
               replaces=reg.KERNELS["moe_dispatch"].replaces,
               launches=launches["moe_dispatch"],
               max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
               bound_ms=bnd, bound_by=by, library_ms=lib_ms)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"moe serving phase took {out['phase_s']:.1f} s", flush=True)
    return row, out


#: phase 11: hymba_1_5b and pixtral_12b served as a user runs them (the
#: same batch and lengths as gemma2_2b's; pixtral's prompt is 256 patches
#: and 768 text tokens), hubert_xlarge's encoder forward on 4 x 1024 frames
HYMBA_ARGV = ("--arch", "hymba_1_5b", "--batch", str(SERVE_B),
              "--prompt-len", str(SERVE_S), "--gen", str(SERVE_GEN),
              "--seed", "0")
PIXTRAL_ARGV = ("--arch", "pixtral_12b", "--batch", str(SERVE_B),
                "--prompt-len", str(SERVE_S), "--gen", str(SERVE_GEN),
                "--seed", "0")
#: the flash kernel at the three models' prefill layers: (model, (B, H, KV,
#: S, Dh), causal, window); no softcap, and hymba's window of 1024 does not
#: bite at S = 1024, so SDPA computes the same function at all three
HYBRID_FLASH_SHAPES = (
    ("hymba_1_5b", (SERVE_B, 25, 5, SERVE_S, 64), True, 1024),
    ("pixtral_12b", (SERVE_B, 32, 8, SERVE_S, 128), True, 0),
    ("hubert_xlarge", (SERVE_B, 16, 16, SERVE_S, 80), False, 0),
)
def serve_main_run(torch, reg, serve, argv, cfg, label):
    """``serve.main(argv)`` with the launch counts zeroed just before and
    read just after: one flash launch per layer in the prefill, no kernel
    while decoding, finite logits, ids in range.  Returns (generation,
    report)."""
    B, GEN = SERVE_B, SERVE_GEN
    reg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = serve.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = reg.launch_counts()
    zero = dict.fromkeys(reg.KERNELS, 0)
    L = cfg.n_layers
    check(launches == dict(zero, flash_attention=L),
          f"serving {label} launched {launches} for {L} attention layers")
    check(g.launches == {"prefill": dict(zero, flash_attention=L),
                         "decode": zero},
          f"{label}: kernel launches by phase: {g.launches}")
    check(tuple(g.ids.shape) == (B, GEN)
          and bool(((g.ids >= 0) & (g.ids < cfg.vocab)).all()),
          f"{label}: generated ids of shape {tuple(g.ids.shape)} out of "
          "range")
    check(bool(torch.isfinite(g.prefill_logits.float()).all()),
          f"{label}: non-finite prefill logits")
    out = dict(main_wall_s=wall, launches=launches,
               first_prefill_s=g.prefill_s,
               first_decode_tok_per_s=B * (GEN - 1) / g.decode_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ids_lane0=g.ids[0].tolist())
    print(f"serve_hybrid: {label} {B}x{SERVE_S} + {GEN} tokens through "
          f"serve.main: prefill {g.launches['prefill']['flash_attention']} "
          f"flash launches, decode none; first prefill {g.prefill_s:.4f} s, "
          f"decode {out['first_decode_tok_per_s']:.1f} tok/s; peak "
          f"{out['peak_gib']:.2f} GiB; lane 0 ids {out['ids_lane0']}",
          flush=True)
    return g, out


def f32_generate_check(torch, dev, cfg, batch, steps, max_len, label):
    """The float32 model through the kernels and through their plain twins
    (``set_impl("ref")``): the last-position prefill logits, then a decode
    step per column of ``steps``, each run from its own prefill's state;
    every logit within ``F32_LOGITS_TOL`` (atol = rtol).  Returns the max
    abs errors (prefill, decode)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm

    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    seqs = {}
    with torch.inference_mode():
        for impl in (None, "ref"):
            ops.set_impl(impl)
            try:
                last, state = tfm.prefill(params, cfg, batch, max_len)
                seq = [last]
                for t in range(steps.shape[1]):
                    step, state = tfm.decode_step(params, cfg, state,
                                                  steps[:, t])
                    seq.append(step)
            finally:
                ops.set_impl(None)
            seqs[impl] = seq
            del state
    torch.cuda.synchronize()
    del params
    errs = [float((a - b).abs().max()) for a, b in zip(seqs[None],
                                                       seqs["ref"])]
    check(all(bool(torch.isfinite(a).all()) and within(a, b, F32_LOGITS_TOL)
              for a, b in zip(seqs[None], seqs["ref"])),
          f"float32 {label}: kernel and plain logits differ by {errs} "
          f"(prefill, {steps.shape[1]} decode steps; beyond "
          f"{F32_LOGITS_TOL})")
    big = float(seqs["ref"][0].abs().max())
    print(f"serve_hybrid (float32, {cfg.n_layers} layers, "
          f"{batch['tokens'].shape[0]}x{max_len - steps.shape[1]}): {label} "
          f"kernel against plain path, last-position logits max abs err "
          f"{errs[0]:.3g}, {steps.shape[1]} decode steps {max(errs[1:]):.3g} "
          f"(atol = rtol = {F32_LOGITS_TOL}; |logit| <= {big:.3f})",
          flush=True)
    return errs[0], max(errs[1:])


def hybrid_phase(torch, dev, reg):
    """Phase 11: serve hymba_1_5b and pixtral_12b at full width through
    the flash kernel, run hubert_xlarge's encoder forward through it (Dh
    = 80, bidirectional), hold each float32 model to its plain twin, and
    time flash at the three prefill shapes.  Returns (the flash launches
    of the three main-path runs, report)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, GEN = SERVE_B, SERVE_S, SERVE_GEN
    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out["free_gib_at_start"] = torch.cuda.mem_get_info()[0] / 2**30
    launches = {}

    def card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                if k != "targets"}

    def decode_tokens(cfg):
        """Three teacher-forced decode tokens for each of 2 lanes."""
        return torch.randint(0, cfg.vocab, (2, 3), device=dev,
                             generator=torch.Generator(device=dev
                                                       ).manual_seed(1))

    def warm_and_traced(label, cfg, batch):
        """The same weights again, warm, and a traced prefill."""
        params = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        serve.generate(params, cfg, batch, GEN)
        warm = serve.generate(params, cfg, batch, GEN)
        check(bool(torch.isfinite(warm.prefill_logits.float()).all()),
              f"{label}: non-finite prefill logits (warm)")
        traced = traced_generate(torch, serve, params, cfg, batch, 1,
                                 FLASH_KERNEL_KEYS)
        del params
        r = dict(prefill_s=warm.prefill_s,
                 decode_tok_per_s=B * (GEN - 1) / warm.decode_s,
                 decode_step_s=warm.decode_s / (GEN - 1),
                 traced_prefill=traced)
        print(f"serve_hybrid (warm): {label} prefill {r['prefill_s']:.4f} s, "
              f"decode {r['decode_tok_per_s']:.1f} tok/s "
              f"({1e3 * r['decode_step_s']:.1f} ms a step); traced prefill: "
              f"device busy {traced['device_busy_ms']:.2f} ms of "
              f"{traced['wall_ms']:.2f} ms wall "
              f"({100 * traced['device_busy_share']:.1f} %), "
              f"{traced['launches']} kernel launches, flash "
              f"{traced['flash_ms']:.3f} ms; top: {traced['top'][:5]}",
              flush=True)
        return r

    # hymba_1_5b: parallel attention + SSM heads, 32 layers
    cfg = cb.get("hymba_1_5b")
    g, rep = serve_main_run(torch, reg, serve, HYMBA_ARGV, cfg, "hymba_1_5b")
    launches["hymba_1_5b"] = rep["launches"]["flash_attention"]
    del g
    batch = card(batch_for(cfg, 0, B, S))
    rep.update(warm_and_traced("hymba_1_5b", cfg, batch))
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    rep["f32_logits_max_abs_err"], rep["f32_decode_max_abs_err"] = \
        f32_generate_check(torch, dev, cfg32,
                           {"tokens": batch["tokens"][:2]},
                           decode_tokens(cfg), S + 3, "hymba_1_5b")
    out["hymba_1_5b"] = rep
    del batch
    torch.cuda.empty_cache()

    # pixtral_12b: 256 image patches before 768 text tokens, 40 layers
    cfg = cb.get("pixtral_12b")
    g, rep = serve_main_run(torch, reg, serve, PIXTRAL_ARGV, cfg,
                            "pixtral_12b")
    launches["pixtral_12b"] = rep["launches"]["flash_attention"]
    del g
    batch = card(batch_for(cfg, 0, B, S))
    check(batch["tokens"].shape[1] + cfg.frontend_len == S
          and tuple(batch["patches"].shape) == (B, cfg.frontend_len,
                                                cfg.frontend_dim),
          f"pixtral batch {[tuple(v.shape) for v in batch.values()]}")
    rep.update(warm_and_traced("pixtral_12b", cfg, batch))
    torch.cuda.empty_cache()
    # 49 GB of float32 weights at full depth, with every earlier model
    # freed
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    b2 = {k: v[:2] for k, v in batch.items()}
    rep["f32_logits_max_abs_err"], rep["f32_decode_max_abs_err"] = \
        f32_generate_check(torch, dev, cfg32, b2, decode_tokens(cfg),
                           S + 3, "pixtral_12b")
    out["pixtral_12b"] = rep
    del batch, b2
    torch.cuda.empty_cache()

    # hubert_xlarge: the encoder's forward on 512-wide frames, 48
    # bidirectional layers at Dh = 80 (encoder-only: no serve.main)
    cfg = cb.get("hubert_xlarge")
    rep = {}
    frames = card(batch_for(cfg, 0, B, S))
    check(tuple(frames["frames"].shape) == (B, S, cfg.frontend_dim),
          f"hubert frames {tuple(frames['frames'].shape)}")
    params = tfm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    calls = []
    kernel = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], kw.get("causal", True),
                      kw.get("window", 0)))
        return kernel(q, k, v, **kw)

    reg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = tfm.forward(params, cfg, frames)
        torch.cuda.synchronize()
        rep["first_forward_s"] = time.perf_counter() - t0
    finally:
        fa.flash_attention = kernel
    got = reg.launch_counts()
    zero = dict.fromkeys(reg.KERNELS, 0)
    check(got == dict(zero, flash_attention=cfg.n_layers),
          f"hubert_xlarge's forward launched {got} for {cfg.n_layers} "
          "attention layers")
    check(calls == [(cfg.head_dim, False, 0)] * cfg.n_layers,
          f"hubert_xlarge's flash calls (Dh, causal, window): "
          f"{sorted(set(calls))} x {len(calls)}")
    check(tuple(logits.shape) == (B, S, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"hubert logits {tuple(logits.shape)} or not finite")
    launches["hubert_xlarge"] = got["flash_attention"]
    rep.update(launches=got,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    with torch.inference_mode():
        tfm.forward(params, cfg, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tfm.forward(params, cfg, frames)
        torch.cuda.synchronize()
        rep["forward_s"] = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tfm.forward(params, cfg, frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rep["traced_forward"] = trace_summary(torch, prof, wall * 1e6,
                                          FLASH_KERNEL_KEYS)
    t = rep["traced_forward"]
    print(f"serve_hybrid: hubert_xlarge forward {B}x{S} frames: "
          f"{got['flash_attention']} flash launches (Dh {cfg.head_dim}, "
          "causal=False); "
          f"first {rep['first_forward_s']:.4f} s, warm "
          f"{rep['forward_s']:.4f} s; peak {rep['peak_gib']:.2f} GiB; "
          f"traced: device busy {t['device_busy_ms']:.2f} ms of "
          f"{t['wall_ms']:.2f} ms wall ({100 * t['device_busy_share']:.1f} "
          f"%), {t['launches']} kernel launches, flash {t['flash_ms']:.3f} "
          f"ms; top: {t['top'][:5]}", flush=True)
    del params, logits
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params = tfm.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    f2 = {"frames": frames["frames"][:2]}
    with torch.inference_mode():
        k_log, _ = tfm.forward(params, cfg32, f2)
        ops.set_impl("ref")
        try:
            r_log, _ = tfm.forward(params, cfg32, f2)
        finally:
            ops.set_impl(None)
    torch.cuda.synchronize()
    err = float((k_log - r_log).abs().max())
    rep["f32_logits_max_abs_err"] = err
    check(bool(torch.isfinite(k_log).all())
          and within(k_log, r_log, F32_LOGITS_TOL),
          f"float32 hubert_xlarge: kernel and plain logits differ by {err} "
          f"(beyond {F32_LOGITS_TOL})")
    print(f"serve_hybrid (float32, 2x{S}): hubert_xlarge kernel against "
          f"plain path, every position's logits max abs err {err:.3g} "
          f"(atol = rtol = {F32_LOGITS_TOL}; |logit| <= "
          f"{float(r_log.abs().max()):.3f})", flush=True)
    out["hubert_xlarge"] = rep
    del params, k_log, r_log, frames, f2
    torch.cuda.empty_cache()

    # flash at the three prefill shapes; beside the five-call profile (which
    # may record no launch this late in a process, after the long traces),
    # the device time a launch in the model's own traced prefill
    out["flash_timed"] = {
        name: flash_time(torch, dev, name, shape, causal=causal,
                         window=window)
        for name, shape, causal, window in HYBRID_FLASH_SHAPES}
    for name, t in out["flash_timed"].items():
        tr = out[name].get("traced_prefill") or out[name]["traced_forward"]
        t["device_us_in_model"] = 1e3 * tr["flash_ms"] / launches[name]
        print(f"flash_attention in {name}'s traced model run: "
              f"{t['device_us_in_model']:.1f} us of device time a launch",
              flush=True)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"hybrid and frontend phase took {out['phase_s']:.1f} s",
          flush=True)
    return sum(launches.values()), out


#: phase 10: the committed smoke artifacts, and the benchmark harness's two
#: machines (``benchmarks/common.py``'s ``SIM`` with ``BENCH_SMOKE=1`` and
#: without)
TUNED = ROOT / "experiments" / "tuned"
TUNE_SMOKE = dict(n_workers=16, n_zones=4, max_steps=60_000, stack_cap=64)
TUNE_BENCH = dict(n_workers=32, n_zones=4, max_steps=200_000, stack_cap=64)
#: the apps phase 10 (b) tunes at bench scale, in the paper's order (cut
#: the slowest first if the script outgrows its time limit), and the ones
#: phase 3 already runs at that scale, whose picks also go through
#: ``reference``
TUNE_BENCH_APPS = ("fib", "nqueens", "fp", "health", "uts", "fft",
                   "strassen", "sort", "align")
TUNE_REFERENCE_APPS = ("fib", "uts")


def tune_phase(torch, dev, reg):
    """10. Table I by search: the DLB-knob tuner on ``cuda_fused``, over
    the 18 committed smoke artifacts (a), then at bench scale (b), then
    one bench tune twice through a fresh result cache.  Returns the
    phase's ``sched_step`` launches and its report."""
    import tempfile

    from repro_torch import apps
    from repro_torch.core import sweep, tune
    from repro_torch.core.cache import ResultCache
    from repro_torch.core.plan import CaseSpec
    from repro_torch.core.spec import (DLB_BALANCERS, SLB_SPEC, RuntimeSpec,
                                       dlb_spec)
    from repro_torch.core.state import SimConfig

    t_phase = time.perf_counter()
    out = {}

    def tuned(g, spec, cfg, ref, cache=None):
        """One search as ``benchmarks/tune_apps.py`` runs it, with its wall
        and its ``sched_step`` launches."""
        n0 = reg.launch_counts()["sched_step"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = tune.tune_spec(g, spec, cfg, extra=(tune.TunedParams(**ref),),
                           rounds=2, survivors=4, cache=cache, device=dev)
        torch.cuda.synchronize()
        return (r, time.perf_counter() - t0,
                reg.launch_counts()["sched_step"] - n0)

    def cases(g, cfg, knobs, **kw):
        """Makespans of (spec, knobs) pairs in one ``run_cases`` call."""
        res = sweep.run_cases(g, [CaseSpec(
            spec=sp, n_workers=cfg.n_workers, n_zones=cfg.n_zones, **k)
            for sp, k in knobs], cfg=cfg, device=dev, **kw)
        check(bool(res.completed.all()), f"{g.name}: a case did not complete")
        return [int(t) for t in res.time_ns]

    # (a) the committed artifacts, field for field and byte for byte
    paths = sorted((TUNED / "smoke").glob("*.json"))
    check(len(paths) == 18, f"{len(paths)} smoke artifacts, not 18")
    cfg = SimConfig(**TUNE_SMOKE)
    live_sig = tune.sim_signature(cfg)
    arts, rows = {}, []
    reg.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for path in paths:
            art = arts[path] = json.loads(path.read_text())
            app, spec = art["app"], RuntimeSpec.coerce(art["spec_slug"])
            g = apps.build(app, scale="smoke")
            r, wall, n = tuned(g, spec, cfg, art["ref"]["params"])
            label = f"{app} {spec.balance}"
            got = dict(params=r["params"].asdict(), seeds=list(r["seeds"]),
                       **{k: r[k] for k in ("makespan_ns", "n_configs",
                                            "n_sims")})
            check(got == {k: art[k] for k in got},
                  f"artifact {label}: the port found {got}")
            slb_ns, ref_ns = cases(g, cfg, [(SLB_SPEC, {}),
                                            (spec, art["ref"]["params"])])
            check((slb_ns, ref_ns) == (art["slb_ns"],
                                       art["ref"]["makespan_ns"]),
                  f"artifact {label}: SLB {slb_ns}, reference {ref_ns}")
            written = Path(tune.save_artifact(
                app, spec, r, cfg, smoke=True, slb_ns=slb_ns,
                ref=dict(params=art["ref"]["params"], makespan_ns=ref_ns),
                tuned_dir=tmp))
            check(written.name == path.name,
                  f"save_artifact wrote {written.name}, not {path.name}")
            # the committed file is in save_artifact's format; it predates
            # two fields (the physics digest gained CostModel.req_bytes,
            # the record its objective), which a file written today carries
            check(path.read_bytes() == (json.dumps(
                art, indent=1, sort_keys=True) + "\n").encode(),
                f"{path.name} is not in save_artifact's format")
            live = dict(art, sim_signature=live_sig, objective="makespan")
            check(written.read_bytes() == (json.dumps(
                live, indent=1, sort_keys=True) + "\n").encode(),
                f"artifact {label}: the file written differs from the "
                "committed one beyond sim_signature and objective")
            kw = dict(smoke=True, tuned_dir=str(TUNED))
            check(tune.load_tuned(app, spec, n_workers=cfg.n_workers,
                                  n_zones=cfg.n_zones,
                                  max_steps=cfg.max_steps, **kw) == art,
                  f"load_tuned refused {path.name} at its scale")
            check((tune.load_tuned(app, spec, cfg=cfg, **kw) is None)
                  == (art["sim_signature"] != live_sig),
                  f"load_tuned(cfg=...) on {path.name}")
            check(tune.load_tuned(app, spec, smoke=True, cfg=cfg,
                                  tuned_dir=tmp) == json.loads(
                                      written.read_text()),
                  f"load_tuned refused the {path.name} just written")
            rows.append(dict(app=app, balance=spec.balance,
                             params=got["params"],
                             makespan_ns=r["makespan_ns"], ref_ns=ref_ns,
                             slb_ns=slb_ns, n_sims=r["n_sims"],
                             launches=n, wall_s=wall))
            p = r["params"]
            print(f"  {label:14s} {p.n_victim}/{p.n_steal}/{p.t_interval}/"
                  f"{p.p_local} {r['makespan_ns']} ns (reference {ref_ns}, "
                  f"SLB {slb_ns}), {r['n_sims']} sims in {n} launches, "
                  f"{wall:.3f} s", flush=True)
    smoke_launches = reg.launch_counts()["sched_step"]
    wall = sum(x["wall_s"] for x in rows)
    sims = sum(x["n_sims"] for x in rows)
    n_stale = sum(a["sim_signature"] != live_sig for a in arts.values())
    out["smoke"] = dict(
        artifacts=len(rows), sims=sims, wall_s=wall, sims_per_s=sims / wall,
        tune_launches=sum(x["launches"] for x in rows),
        launches=smoke_launches, live_sim_signature=live_sig,
        stale_signatures=n_stale, rows=rows)
    print(f"tune (a): {len(rows)} committed artifacts reproduced on "
          f"cuda_fused: {sims} sims in {wall:.3f} s ({sims / wall:.1f} "
          f"sims/s), {out['smoke']['tune_launches']} sched_step launches "
          f"({smoke_launches} with the SLB and reference runs); files equal "
          f"but for sim_signature ({n_stale} committed under the digest "
          f"before req_bytes, live {live_sig}) and objective", flush=True)

    # (b) the same search at bench scale, seeded with each app's
    # hand-tuned reference
    refs = {a["app"]: a["ref"]["params"] for a in arts.values()}
    cfg = SimConfig(**TUNE_BENCH)
    rows = []
    reg.reset_launches()
    for app in TUNE_BENCH_APPS:
        g = apps.build(app, scale="bench")
        (slb_ns,) = cases(g, cfg, [(SLB_SPEC, {})])
        for balance in DLB_BALANCERS:
            spec = dlb_spec(balance)
            r, wall, n = tuned(g, spec, cfg, refs[app])
            pick = r["params"].asdict()
            (ref_ns,) = cases(g, cfg, [(spec, refs[app])])
            check(r["makespan_ns"] <= ref_ns, f"bench {app} {balance}: "
                  f"pick {r['makespan_ns']} > reference {ref_ns}")
            (serial_ns,) = cases(g, cfg, [(spec, pick)], strategy="serial")
            check(serial_ns == r["makespan_ns"], f"bench {app} {balance}: "
                  f"serial re-run {serial_ns} != {r['makespan_ns']}")
            ref_backend_ns = None
            if app in TUNE_REFERENCE_APPS:
                (ref_backend_ns,) = cases(g, cfg, [(spec, pick)],
                                          strategy="serial",
                                          backend="reference")
                check(ref_backend_ns == r["makespan_ns"],
                      f"bench {app} {balance}: reference backend "
                      f"{ref_backend_ns} != {r['makespan_ns']}")
            rows.append(dict(app=app, balance=balance, params=pick,
                             makespan_ns=r["makespan_ns"], ref_ns=ref_ns,
                             slb_ns=slb_ns, n_configs=r["n_configs"],
                             n_sims=r["n_sims"], launches=n, wall_s=wall,
                             sims_per_s=r["n_sims"] / wall,
                             reference_backend_ns=ref_backend_ns))
            print(f"  {app:8s} {balance} {pick['n_victim']}/"
                  f"{pick['n_steal']}/{pick['t_interval']}/"
                  f"{pick['p_local']} {r['makespan_ns']} ns (reference "
                  f"{ref_ns}, SLB {slb_ns}, {slb_ns / r['makespan_ns']:.3f}x"
                  f" over SLB), {r['n_sims']} sims in {n} launches, "
                  f"{wall:.3f} s ({r['n_sims'] / wall:.1f} sims/s); serial"
                  + (", reference" if ref_backend_ns is not None else "")
                  + " equal", flush=True)
    wall = sum(x["wall_s"] for x in rows)
    sims = sum(x["n_sims"] for x in rows)
    out["bench"] = dict(
        tunes=len(rows), sims=sims, wall_s=wall, sims_per_s=sims / wall,
        tune_launches=sum(x["launches"] for x in rows),
        launches=reg.launch_counts()["sched_step"],
        beats_reference=sum(x["makespan_ns"] < x["ref_ns"] for x in rows),
        rows=rows)
    print(f"tune (b): {len(rows)} bench-scale tunes (W={cfg.n_workers}), "
          f"{sims} sims in {wall:.3f} s ({sims / wall:.1f} sims/s), "
          f"{out['bench']['tune_launches']} sched_step launches; every pick "
          f"<= its reference ({out['bench']['beats_reference']} strictly "
          "below)", flush=True)

    # one bench tune twice through a fresh result cache: the second takes
    # every case from it and launches nothing
    with tempfile.TemporaryDirectory() as tmp:
        store = ResultCache(tmp)
        g = apps.build("fib", scale="bench")
        cold, cold_s, cold_n = tuned(g, dlb_spec("na_ws"), cfg, refs["fib"],
                                     cache=store)
        misses = store.misses
        warm, warm_s, warm_n = tuned(g, dlb_spec("na_ws"), cfg, refs["fib"],
                                     cache=store)
        check(warm == cold, f"the warm tune differs: {warm} vs {cold}")
        check(store.hits == warm["n_sims"] and store.misses == misses
              and warm_n == 0, f"warm tune: {store.hits} hits, "
              f"{store.misses - misses} misses, {warm_n} launches")
    out["cache"] = dict(cold_s=cold_s, warm_s=warm_s, cold_launches=cold_n,
                        warm_launches=warm_n, sims=cold["n_sims"])
    print(f"tune cache: fib na_ws at bench scale cold {cold_s:.3f} s "
          f"({cold_n} launches), warm {warm_s:.3f} s (all {store.hits} "
          "cases from the cache, no launch)", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"tune phase took {out['phase_s']:.1f} s", flush=True)
    launches = (out["smoke"]["tune_launches"] + out["bench"]["tune_launches"]
                + cold_n)
    return launches, out


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.exists():
        return fail("run from the repository root (src/repro_torch and "
                    "tests/golden_modes.json not found)")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device available")
    sys.path.insert(0, str(SRC))
    try:
        return run(torch)
    except SmokeFailure as e:
        return fail(str(e))


def run(torch) -> int:
    import numpy as np

    from repro_torch import apps, step_bench
    from repro_torch.core import executors, plan, scheduler, sweep, xqueue
    from repro_torch.core.spec import LATTICE, MODE_SPECS, RuntimeSpec
    from repro_torch.core.state import (CTR, CTR_NAMES, NC, SimConfig,
                                        batch_of_one, graph_arrays,
                                        make_params, stack, to_numpy,
                                        tree_map)
    from repro_torch.core.taskgraph import build as build_graph
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import registry as reg
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import sched_queue as sq
    from repro_torch.kernels import sched_step as ss

    dev = torch.device("cuda")
    card = smi_line()
    print(card, flush=True)
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}

    # 1. build the kernels: one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        builds = {name: pool.submit(fn) for name, fn in
                  (("sched_queue", sq.build), ("sched_step", ss.build),
                   ("flash_attention", fa.build), ("rwkv6_scan", rk.build),
                   ("moe_dispatch", md.build))}
        logs = {name: f.result() for name, f in builds.items()}
    report["build_s"] = time.perf_counter() - t0
    for name, (path, log) in logs.items():
        print(log.strip())
        print(f"built {path.name}", flush=True)
    print(f"built {len(logs)} sources in {report['build_s']:.2f} s",
          flush=True)
    report["flash_build"] = flash_build_report(*logs["flash_attention"])
    report["sched_step_build"] = sched_step_build_report(
        logs["sched_step"][1])

    # 2. the goldens, bitwise: run_schedule on cuda and cuda_fused, then
    # run_cases on cuda_fused with every executor
    golden = json.loads(GOLDEN.read_text())
    graphs = {n: build_graph(b, **kw)
              for n, (b, kw) in golden["graphs"].items()}

    def golden_ok(label, time_ns, steps, counters, c):
        want = dict(c["counters"], **{n: 0 for n in CTR_NAMES
                                      if n not in c["counters"]})
        got = {n: counters[n] for n in want}
        check(time_ns == c["time_ns"] and steps == c["steps"]
              and got == want,
              f"golden {label} {c['graph']}/{c['mode']} differs: time_ns "
              f"{time_ns} vs {c['time_ns']}, steps {steps} vs "
              f"{c['steps']}, counters {got}")

    for backend in ("cuda", "cuda_fused"):
        gcfg = SimConfig(**golden["cfg"], backend=backend)
        for c in golden["cases"]:
            r = scheduler.run_schedule(
                graphs[c["graph"]], spec=RuntimeSpec.from_mode(c["mode"]),
                cfg=gcfg, params=make_params(**golden["knobs"], device=dev),
                device=dev)
            check(r.completed, f"golden {c} incomplete on {backend}")
            golden_ok(backend, r.time_ns, r.steps, r.counters, c)
    names = list(graphs)
    gcfg = SimConfig(**golden["cfg"])
    gspecs = [plan.CaseSpec(spec=RuntimeSpec.from_mode(c["mode"]),
                            n_workers=gcfg.n_workers, n_zones=gcfg.n_zones,
                            graph=names.index(c["graph"]), **golden["knobs"])
              for c in golden["cases"]]
    open_specs = [plan.CaseSpec(spec="na_ws", n_workers=gcfg.n_workers,
                                n_zones=gcfg.n_zones, graph=gi,
                                arrivals="poisson:2", **golden["knobs"])
                  for gi in range(len(names))]
    for strategy in ("serial", "batched", "sharded"):
        for extra in ([], open_specs):
            res = sweep.run_cases(list(graphs.values()), gspecs + extra,
                                  cfg=gcfg, strategy=strategy,
                                  backend="cuda_fused", device=dev)
            check(bool(res.completed.all()), f"run_cases {strategy} "
                  "incomplete")
            for i, c in enumerate(golden["cases"]):
                golden_ok(f"run_cases/{strategy}", int(res.time_ns[i]),
                          int(res.steps[i]),
                          {n: int(v[i]) for n, v in res.counters.items()}, c)
    print(f"goldens: {len(golden['cases'])} cases bitwise on cuda and "
          "cuda_fused (run_schedule), and on cuda_fused through run_cases "
          "(serial, batched, sharded; closed and mixed open batches)",
          flush=True)

    # 3. the first slice's main path at full width: cuda and cuda_fused
    # against reference, leaf by leaf
    main_runs = [(name, m, MODE_SPECS[m], SimConfig(), None)
                 for name in ("fib", "uts") for m in MODE_SPECS]
    main_runs += [(name, "na_ws", MODE_SPECS["na_ws"],
                   SimConfig(n_workers=48), "quad_socket_48")
                  for name in ("fib", "uts")]
    bench = {name: apps.build(name, scale="bench") for name in ("fib", "uts")}
    backends = ("cuda", "cuda_fused", "reference")
    wall = {b: 0.0 for b in backends}
    steps = 0
    cases = []
    main_results = {}
    reg.reset_launches()
    for name, mode, spec, cfg, topo in main_runs:
        out = {}
        for backend in backends:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[backend] = scheduler.run(
                bench[name], spec=spec,
                cfg=dataclasses.replace(cfg, backend=backend),
                topology=topo, device=dev)
            torch.cuda.synchronize()
            out[backend + "_s"] = time.perf_counter() - t0
            wall[backend] += out[backend + "_s"]
        res = scheduler.result(out["cuda_fused"])
        check(res.completed, f"{name}/{mode}/{topo} did not complete")
        for backend in ("cuda", "cuda_fused"):
            check(states_equal(out[backend].state, out["reference"].state,
                               to_numpy),
                  f"{name}/{mode}/{topo}: {backend} and reference final "
                  "states differ")
        main_results[(name, spec, topo)] = res
        steps += res.steps
        cases.append(dict(graph=bench[name].name, mode=mode,
                          topology=topo or "flat", n_workers=cfg.n_workers,
                          n_tasks=bench[name].n_tasks, steps=res.steps,
                          time_ns=res.time_ns,
                          **{b + "_s": out[b + "_s"] for b in backends}))
        print(f"  {name:4s} {mode:8s} {topo or 'flat':15s} W={cfg.n_workers}"
              f" steps={res.steps} " + " ".join(
                  f"{b}={out[b + '_s']:.3f}s" for b in backends)
              + "  bitwise", flush=True)
    main_launches = reg.launch_counts()
    check(all(main_launches[k] for k in SIM_KERNELS),
          f"a kernel never launched on the main path: {main_launches}")
    check(main_launches["sched_step"] == len(main_runs),
          f"cuda_fused took {main_launches['sched_step']} launches for "
          f"{len(main_runs)} runs")
    # one ctr_add launch per run of counter bumps: at most 12 a step
    check(main_launches["ctr_add"] <= 12 * steps,
          f"cuda took {main_launches['ctr_add']} ctr_add launches for "
          f"{steps} steps")
    print(f"main path: {steps} steps, {main_launches['ctr_add']} ctr_add "
          f"launches on cuda ({main_launches['ctr_add'] / steps:.2f} a "
          "step)", flush=True)
    report["main_path"] = dict(cases=cases, steps=steps, wall_s=wall,
                               launches=main_launches)

    # 4. this slice's path: the batched sweep at full width, one call
    machines = ((None, 64), ("quad_socket_48", 48), ("two_node_2x24", 96))
    sweep_graphs = [bench["fib"], bench["uts"]]
    sweep_specs = [plan.CaseSpec(spec=sp, n_workers=w, n_zones=8, graph=gi,
                                 topology=topo)
                   for gi in range(len(sweep_graphs)) for sp in LATTICE
                   for topo, w in machines]
    scfg = SimConfig(backend="cuda_fused")
    executors.reset_engine_stats()
    torch.cuda.synchronize()
    reg.reset_launches()
    t0 = time.perf_counter()
    swept = sweep.run_cases(sweep_graphs, sweep_specs, cfg=scfg,
                            strategy="batched", device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = reg.launch_counts()
    sweep_stats = dict(executors.ENGINE_STATS)
    check(bool(swept.completed.all()), "the sweep left cases incomplete")
    n_chunks = len({s.spec for s in sweep_specs})
    check(sweep_launches["sched_step"] == n_chunks,
          f"the batched sweep took {sweep_launches['sched_step']} launches "
          f"for {n_chunks} chunks")
    # every case's raw result against the serial executor's
    splan = plan.build_plan(sweep_graphs, sweep_specs)
    ctx = executors.ExecContext(
        cfg=dataclasses.replace(scfg, n_workers=splan.w_pad),
        gq_cap=splan.gq_cap, graphs=sweep_graphs,
        garr=[graph_arrays(g, splan.t_pad, device=dev)
              for g in sweep_graphs], device=dev)
    for chunk in splan.chunks:
        a = executors.EXECUTORS["vmap"].run_chunk(ctx, sweep_specs, chunk)
        b = executors.EXECUTORS["serial"].run_chunk(ctx, sweep_specs, chunk)
        for field in a._fields:
            check(np.array_equal(getattr(a, field), getattr(b, field)),
                  f"batched and serial ChunkRaw.{field} differ in the "
                  f"{chunk.spec.slug} chunk")
    # the cases phase 3 ran
    matched = 0
    for i, s in enumerate(sweep_specs):
        key = (("fib", "uts")[s.graph], s.spec, s.topology and s.topology.name)
        r = main_results.get(key)
        if r is None or s.n_workers != r.n_workers:
            continue
        matched += 1
        check(int(swept.time_ns[i]) == r.time_ns
              and int(swept.steps[i]) == r.steps
              and all(int(swept.counters[n][i]) == r.counters[n]
                      for n in CTR_NAMES),
              f"sweep case {key} differs from its phase-3 run")
    check(matched == len(main_runs), f"matched {matched} phase-3 runs")
    # the cluster preset against reference, at smoke scale
    smoke = [apps.build(n, scale="smoke") for n in ("fib", "uts")]
    cl_specs = [plan.CaseSpec(spec=sp, n_workers=96, graph=gi,
                              topology="two_node_2x24")
                for gi in range(len(smoke)) for sp in LATTICE]
    t0 = time.perf_counter()
    cl = {b: sweep.run_cases(smoke, cl_specs, cfg=SimConfig(backend=b),
                             strategy=("batched" if b == "cuda_fused"
                                       else "serial"), device=dev)
          for b in ("cuda_fused", "reference")}
    cluster_s = time.perf_counter() - t0
    for field in ("time_ns", "steps", "completed"):
        check(np.array_equal(getattr(cl["cuda_fused"], field),
                             getattr(cl["reference"], field)),
              f"two_node_2x24 smoke: cuda_fused {field} differs")
    for n in CTR_NAMES:
        check(np.array_equal(cl["cuda_fused"].counters[n],
                             cl["reference"].counters[n]),
              f"two_node_2x24 smoke: counter {n} differs")
    sweep_steps = int(swept.steps.sum())
    report["sweep"] = dict(
        cases=len(sweep_specs), chunks=n_chunks, wall_s=sweep_s,
        configs_per_s=len(sweep_specs) / sweep_s,
        steps=sweep_steps, steps_per_s=sweep_steps / sweep_s,
        launches=sweep_launches, engine=sweep_stats,
        cluster_smoke=dict(cases=len(cl_specs), wall_s=cluster_s,
                           steps=int(cl["reference"].steps.sum())),
        rows=[dict(graph=sweep_graphs[s.graph].name, spec=s.spec.slug,
                   topology=s.topology.name if s.topology else "flat",
                   n_workers=s.n_workers, steps=int(swept.steps[i]),
                   time_ns=int(swept.time_ns[i]))
              for i, s in enumerate(sweep_specs)])
    print(f"sweep: {len(sweep_specs)} cases in {n_chunks} launches, "
          f"{sweep_s:.3f} s, {len(sweep_specs) / sweep_s:.1f} configs/s, "
          f"{sweep_steps / sweep_s:.0f} steps/s; batched == serial; "
          f"{matched} phase-3 runs equal; two_node_2x24 smoke == reference "
          f"({len(cl_specs)} cases)", flush=True)

    # 5. each kernel against its plain twin, and its time, at the main
    # path's shapes (launches here are not counted: the counts were read)
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
    # ctr_add: ctr[:, col] += val, one pair; and the spawn phase's run of 7
    # pairs (bool and int32 values, a repeated column) in one launch,
    # beside 7 `+=` calls
    ctr = t(rs.integers(0, 10**6, (W, NC)).astype(np.int32))
    val = t(rs.integers(0, 100, W).astype(np.int32))
    col = 15
    pairs7 = [(c, t(rs.random(W) < 0.5) if c % 2 else
               t(rs.integers(0, 100, W).astype(np.int32)))
              for c in (4, 14, 9, 10, 11, 16, 14)]
    err = max(max_err([sq.ctr_add(ctr.clone(), col, val)],
                      [sq.PLAIN["ctr_add"](ctr, col, val)]),
              max_err([sq.ctr_add(ctr.clone(), pairs7)],
                      [sq.PLAIN["ctr_add"](ctr, pairs7)]))
    work = ctr.clone()
    ms = cuda_time_ms(lambda i: sq.ctr_add(work, col, val), n_time, torch)
    plain_ms = cuda_time_ms(lambda i: sq.PLAIN["ctr_add"](ctr, col, val),
                            n_time, torch)

    def library(i):
        work[:, col] += val

    def library7(i):
        for c, v in pairs7:
            work[:, c] += v

    lib_ms = cuda_time_ms(library, n_time, torch)
    ms7 = cuda_time_ms(lambda i: sq.ctr_add(work, pairs7), n_time, torch)
    lib7_ms = cuda_time_ms(library7, n_time, torch)
    ms_again = cuda_time_ms(lambda i: sq.ctr_add(work, col, val), n_time,
                            torch)
    lib_again = cuda_time_ms(library, n_time, torch)
    report["ctr_add_timed"] = dict(one_ms=[ms, ms_again],
                                   one_library_ms=[lib_ms, lib_again],
                                   seven_ms=ms7, seven_library_ms=lib7_ms)
    print(f"ctr_add: one pair {ms:.5f} / {ms_again:.5f} ms against "
          f"`ctr[:, col] += val` {lib_ms:.5f} / {lib_again:.5f}; 7 pairs "
          f"in one launch {ms7:.5f} ms against 7 `+=` {lib7_ms:.5f}",
          flush=True)
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
    copies = None

    # push and pop_first at the fused kernel's wider widths (n_active below
    # the width and None), then 50 calls in turn on one queue, each against
    # its twin; the kernels write in place, the twins return new queues
    queue_err = {"push": 0, "pop_first": 0}

    def held(name, got, want):
        queue_err[name] = max(queue_err[name], max_err(got[0], want[0]),
                              max_err(got[1:], want[1:]))

    def clone(xq):
        return xqueue.XQ(*(x.clone() for x in xq))

    for w in (144, 200):
        xw, pw, (rw, mw, nw) = step_bench.queue_inputs(dev, W=w, seed=w)
        held("push", sq.push(clone(xw), *pw), sq.PLAIN["push"](xw, *pw))
        for na in (nw, None):
            held("pop_first", sq.pop_first(clone(xw), rw, mw, na),
                 sq.PLAIN["pop_first"](xw, rw, mw, na))
    on_card, on_twin = clone(xq0), xq0
    for i in range(50):
        if i % 2 == 0:
            lanes = (producer, t(rs.integers(0, W, W).astype(np.int32)),
                     t(rs.integers(0, 5000, W).astype(np.int32)), tsv,
                     t(rs.random(W) < 0.75))
            got = sq.push(on_card, *lanes)
            want = sq.PLAIN["push"](on_twin, *lanes)
            held("push", got, want)
        else:
            rot_i = t(rs.integers(0, 1000, W).astype(np.int32))
            na = None if i % 4 == 1 else n_act
            got = sq.pop_first(on_card, rot_i, pmask, na)
            want = sq.PLAIN["pop_first"](on_twin, rot_i, pmask, na)
            held("pop_first", got, want)
        on_card, on_twin = got[0], want[0]
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], queue_err.get(k["name"], 0))
    print(f"push, pop_first == twins at W=64, 144 and 200 and over 50 calls "
          f"in turn on one queue (max abs err {queue_err})", flush=True)
    # their host path taken apart, beside the launch floor
    qo = step_bench.queue_ops(dev)
    report["queue_ops"] = qo
    for name in ("push", "pop_first", "launch_floor"):
        r = qo[name]
        print(f"{name}: {r['ms']:.5f} ms a call, host {r['host_us']:.2f} us"
              + (f" (checks {r['checks_host_us']:.2f}, allocations "
                 f"{r['alloc_host_us']:.2f})" if "checks_host_us" in r
                 else "") + f", device {r['device_us']} us a launch",
              flush=True)
    print(f"ctr_add: device {qo['ctr_add']['device_us']} us a launch (one "
          f"pair), {qo['ctr_add']['device_us_seven']} (seven)", flush=True)

    # sched_step, max_iters = 1, on mid-run states: NA-WS (transfer, thief
    # loop), NA-RP and gomp (join claims), flat, NUMA and cluster
    fracs = (0.1, 0.3, 0.5, 0.7, 0.9)
    twin_cfgs = [("fib", "na_ws", None, 64, fracs),
                 ("uts", "na_ws", "two_node_2x24", 96, fracs),
                 ("fib", "gomp", None, 64, fracs),
                 ("uts", "na_rp", "quad_socket_48", 48, fracs[::2]),
                 ("fib", "xgomp", "two_node_2x24", 96, fracs[::2])]
    step_err, n_states, events = 0, 0, {"stolen": 0, "req_sent": 0,
                                        "exec": 0}
    big = SimConfig().max_steps
    for gname, mode, topo, w, fr in twin_cfgs:
        cfg = SimConfig(n_workers=w, backend="cuda_fused")
        full = scheduler.run(bench[gname], spec=MODE_SPECS[mode], cfg=cfg,
                             topology=topo, device=dev)
        n_steps = int(full.state.step_i)
        runs = [scheduler.run(bench[gname], spec=MODE_SPECS[mode],
                              cfg=dataclasses.replace(
                                  cfg, max_steps=max(int(f * n_steps), 1)),
                              topology=topo, device=dev) for f in fr]
        st = stack([r.state for r in runs])
        g_b = stack([r.graph for r in runs])
        c_b = stack([r.case for r in runs])
        want = ss.run_lanes(tree_map(torch.clone, st), g_b, c_b,
                            costs=cfg.costs, max_steps=big, max_iters=1)
        got = ss.sched_step(tree_map(torch.clone, st), g_b, c_b,
                            costs=cfg.costs, max_steps=big, max_iters=1)
        torch.cuda.synchronize()
        step_err = max(step_err, max_abs_err(got, want, to_numpy))
        check(bool((got.step_i == st.step_i + 1).all()),
              f"{gname}/{mode}/{topo}: a mid-run state did not step")
        delta = (want.ctr.long() - st.ctr.long()).sum(dim=(0, 1))
        for k in events:
            events[k] += int(delta[CTR[k]])
        n_states += len(runs)
    check(n_states >= 20, f"only {n_states} mid-run states")
    check(step_err == 0, f"sched_step disagrees with its twin (max abs err "
          f"{step_err})")
    print(f"sched_step == twin on {n_states} mid-run states (step events: "
          f"{events})", flush=True)

    # its time: one step of a mid-run fib(16) NA-WS state at W=64
    cfg = SimConfig(backend="cuda_fused")
    mid = scheduler.run(bench["fib"], spec=MODE_SPECS["na_ws"],
                        cfg=dataclasses.replace(cfg, max_steps=40),
                        device=dev)
    st1, g1, c1 = (batch_of_one(x) for x in (mid.state, mid.graph, mid.case))
    pool = iter([tree_map(torch.clone, st1) for _ in range(n_time + 10)])
    ms = cuda_time_ms(lambda i: ss.sched_step(
        next(pool), g1, c1, costs=cfg.costs, max_steps=big, max_iters=1),
        n_time, torch)
    pool = iter([tree_map(torch.clone, st1) for _ in range(30)])
    plain_ms = cuda_time_ms(lambda i: ss.run_lanes(
        next(pool), g1, c1, costs=cfg.costs, max_steps=big, max_iters=1),
        20, torch)
    after = ss.run_lanes(tree_map(torch.clone, st1), g1, c1,
                         costs=cfg.costs, max_steps=big, max_iters=1)
    d = (after.ctr.long() - st1.ctr.long()).sum(dim=(0, 1))
    pushes, pops, moved = (int(d[CTR["static_push"]]), int(d[CTR["exec"]]),
                           int(d[CTR["stolen"]]))
    # per-lane state read and written (12 int32 vectors, the int64 PRNG,
    # the counter row), the (W, W) heads and tails the gate and the scans
    # read, queue slots (task + stamp) and stack entries moved, and the
    # task arrays an execution touches
    step_bytes = (2 * W * (12 * 4 + 8 + NC * 4) + 2 * W * W * 4
                  + 8 * (pushes + pops) + 16 * moved + 16 * pushes
                  + 32 * pops)
    b, by = bound_ms(step_bytes, 10 * W * W)
    kernels.append(dict(name="sched_step", max_abs_err=step_err, ms=ms,
                        plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=None))
    # beside it: a gomp step, a whole run in one launch (fib(16) NA-WS at
    # W=64, as phase 3 runs it) and the sweep's chunk launches
    gomp_ms = step_bench.step_ms(bench["uts"], "gomp", dev)
    run_ms = step_bench.whole_run_ms(bench["fib"], "na_ws", dev)
    chunk = step_bench.sweep_times(bench, dev)
    report["sched_step_timed"] = dict(
        step=int(mid.state.step_i), pushes=pushes, pops=pops, moved=moved,
        bytes=step_bytes, naws_step_ms=ms, gomp_step_ms=gomp_ms,
        whole_run_ms=run_ms, sweep=chunk)
    print(f"sched_step: a NA-WS step {ms:.5f} ms, a gomp step "
          f"{gomp_ms:.5f} ms, a whole fib(16) NA-WS run in one launch "
          f"{run_ms:.4f} ms; sweep chunk launches {chunk['chunk_wall_ms']:.3f}"
          f" ms wall, {chunk['chunk_device_ms']} ms device each "
          f"({chunk['configs_per_s']:.1f} configs/s)", flush=True)

    # each launch shape of the kernel against reference over a whole run:
    # W=64 (128 threads) in phase 3; here W=144 (1024 threads, heads and
    # tails in shared memory) and W=200 (1024 threads, in device memory)
    wide = apps.build("fib", n=12)
    for w, topo in ((144, "quad_socket_48"), (200, None)):
        out = {b: scheduler.run(wide, spec=MODE_SPECS["na_ws"],
                                cfg=SimConfig(n_workers=w, backend=b),
                                topology=topo, device=dev)
               for b in ("cuda_fused", "reference")}
        check(states_equal(out["cuda_fused"].state, out["reference"].state,
                           to_numpy),
              f"W={w} {topo}: cuda_fused and reference final states differ")
        print(f"  W={w} {topo or 'flat'} (heads and tails in "
              f"{'shared' if ss.resident(w) else 'device'} memory): "
              f"{int(out['reference'].state.step_i)} steps, cuda_fused == "
              "reference", flush=True)
    check(not ss.resident(200) and ss.resident(144),
          "the W=200 run did not take the device-memory instantiation")

    for k in kernels:
        check(k["max_abs_err"] == 0, f"kernel {k['name']} disagrees with its "
              f"plain twin (max abs err {k['max_abs_err']})")
        src = "sched_step.cu" if k["name"] == "sched_step" else \
            "sched_queue.cu"
        k.update(route="cuda", source=f"src/repro_torch/kernels/csrc/{src}",
                 replaces=reg.KERNELS[k["name"]].replaces,
                 # each kernel's launches on the path it serves: the queue
                 # kernels on phase 3's cuda runs, sched_step on the sweep
                 # (and, added after phase 10, the tuner)
                 launches=(sweep_launches if k["name"] == "sched_step"
                           else main_launches)[k["name"]])

    # 6. this slice's path: serving gemma2_2b at full width
    flash_row, report["serve"] = serve_phase(torch, dev, reg)
    kernels.append(flash_row)

    # 7. this slice's path: serving rwkv6_1_6b at full width
    rwkv_row, report["serve_rwkv"] = rwkv_phase(torch, dev, reg)
    kernels.append(rwkv_row)

    # 8. this slice's path: serving moonshot_v1_16b_a3b at full width
    moe_row, report["serve_moe"] = moe_phase(torch, dev, reg)
    kernels.append(moe_row)

    # 11. this slice's path: hymba_1_5b and pixtral_12b served,
    # hubert_xlarge's forward, all through the flash kernel
    hybrid_launches, report["serve_hybrid"] = hybrid_phase(torch, dev, reg)
    # flash's launches over every main-path run that goes through it
    flash_row["launches"] += (
        report["serve_moe"]["launches"]["flash_attention"] + hybrid_launches)
    flash_row["max_abs_err"] = max(
        report["serve"]["flash_errors"][k] for k in (
            "serve_local", "serve_full", "hymba_local", "pixtral",
            "hubert_bf16"))

    # 10. this slice's path: Table I by search on cuda_fused
    tune_launches, report["tune"] = tune_phase(torch, dev, reg)
    check(tune_launches > 0, "the tuner never launched sched_step")
    for k in kernels:
        if k["name"] == "sched_step":
            k["launches"] += tune_launches
    report["kernels"] = kernels
    print(json.dumps({"report": report}))

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in keys}
                                  for kk in kernels]}))
    print(json.dumps({"main_path_wall_s": wall, "main_path_steps": steps,
                      "steps_per_s": {b: steps / s for b, s in wall.items()},
                      "launches": main_launches}))
    print(json.dumps({"sweep": {k: v for k, v in report["sweep"].items()
                                if k != "rows"}}))
    print(json.dumps({"serve": {k: report["serve"][k] for k in (
        "prefill_s", "decode_tok_per_s", "first_prefill_s",
        "first_decode_tok_per_s", "f32_logits_max_abs_err",
        "greedy_agreement")}}))
    print(json.dumps({"serve_rwkv": {k: report["serve_rwkv"][k] for k in (
        "prefill_s", "decode_tok_per_s", "first_prefill_s",
        "first_decode_tok_per_s", "plain_prefill_s",
        "f32_logits_max_abs_err", "f32_decode_max_abs_err",
        "greedy_agreement", "peak_gib")}}))
    print(json.dumps({"serve_moe": {k: report["serve_moe"][k] for k in (
        "prefill_s", "decode_tok_per_s", "first_prefill_s",
        "first_decode_tok_per_s", "peak_gib", "routing",
        "model_bitwise")}}))
    hy = report["serve_hybrid"]
    print(json.dumps({"serve_hybrid": dict(
        {m: {k: hy[m][k] for k in (
            "prefill_s", "decode_tok_per_s", "first_prefill_s",
            "first_decode_tok_per_s", "f32_logits_max_abs_err",
            "f32_decode_max_abs_err", "peak_gib",
            "forward_s", "first_forward_s") if k in hy[m]}
         for m in ("hymba_1_5b", "pixtral_12b", "hubert_xlarge")},
        flash_launches=hy["launches"],
        flash_timed={m: {k: t[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_us", "device_us_in_model", "same_function")}
            for m, t in hy["flash_timed"].items()})}))
    print(json.dumps({"tune": {
        part: {k: v for k, v in report["tune"][part].items() if k != "rows"}
        for part in ("smoke", "bench", "cache")}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
