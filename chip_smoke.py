#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

In order, it
1. prints the card's name and power limit (nvidia-smi), then builds the
   port's five CUDA sources from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together, timing the build and
   printing the compiler's register report; then each flash kernel
   instantiation's registers and spills and its HGMMA and UTMALDG count in
   the SASS (cuobjdump), failing if a bf16 (wgmma) instantiation (two per
   head dim of ``HEAD_DIMS``, 80 included: without and with the lse store
   of training) spills or lacks either, and
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
   with batch 4, prompt 1024, 8 new tokens, launch counts zeroed just
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
   (the kept slots' rows into a zeroed buffer) and its bound (the rows of
   x that a kept slot reads, the tables, the buffer); at the prefill and
   the decode shape what a call puts on the stream (the phase fails on a
   memset or any operation but one dispatch kernel a call), its device
   µs and the wrapper's host µs;
9. after phase 18, prints the ``kernels`` JSON line (``sched_step``'s
   launches are the sweep's and the tuner's, ``flash_attention``'s those
   of phases 6, 8, 11, 12's two training runs, 13's hymba and moonshot,
   14's gradient, 15's and 16's mesh runs, 17's tensor-parallel rank 0
   and 18's FSDP rank 0s, ``rwkv6_scan``'s phase 7's, 13's and 16's
   rwkv6, ``moe_dispatch``'s
   phase 8's, 13's moonshot, 15's mesh run and 17's rank 0), the
   end-to-end rates, the ``serve_hybrid`` line of
   phase 11, the tuner's summary, the ``train`` line of phase 12, the
   ``train_families`` line of phase 13, the ``distributed`` line of phase
   14, the ``sharded`` line of phase 15, the ``dryrun`` line of phase 16,
   the ``tp`` line of phase 17, the ``fsdp`` line of phase 18, the ``seq``
   line of phase 19, the card line and last the device line;
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
   call (the same function at all three);
12. runs the thirteenth slice's path, training, after phase 10 and before
   the lines of 9, every earlier model freed first: (a) the flash
   backward (``FlashAttention``: the kernel's forward with its lse output,
   the reference's chunked ``_attn_bwd`` ported) against the twin's
   ``autograd.Function`` on ``TRAIN_FLASH_CASES`` (gemma2_2b's training
   shape in bf16 and float32 with a window of 4096 and one of 256 that
   bites, repro_100m's, a ragged S = 1000, hubert's bidirectional Dh = 80,
   a hymba local layer's and moonshot's): out within 2e-2 / 1e-4, lse
   within 1e-3 / 1e-5, dq, dk, dv within 3e-2 / 1e-4 of their largest
   magnitude, two calls bitwise; then at gemma2's shape the forward with
   and without lse, forward + backward beside the twin's, the backward
   alone and one ``scaled_dot_product_attention`` forward + backward; (b)
   gemma2_2b trained at full width (26 layers, d_model 2304, vocab 256000;
   bf16 weights and float32 AdamW state from seed 0) through
   ``launch.train.run`` (what ``main`` runs) at batch 4 × 1024 for 6
   steps, launch counts zeroed just before and read just after: exactly
   2 × 26 flash launches a step (every layer's forward again in the
   backward's recompute of its checkpointed group), no other kernel,
   every loss and gradient norm finite; the peak memory, the warm step
   seconds and tokens/s, and a traced step (flash forward, GEMMs, the
   backward's attention, the CE, AdamW, the device-busy share); (c) the
   float32 model at full depth, batch 2 × 1024: ``loss_fn`` and every
   gradient through the kernels and through their twins
   (``ops.set_impl("ref")``), the loss within 1e-4 and the gradient norm
   within 1e-3 (relative), every leaf's error printed; (d) repro_100m
   (float32, the FMA flash kernel) as the quick example runs it (60 steps
   of 4 × 128, checkpoints every 20, a node failure at step 30): the loss
   falls, one restart from step 20 or later, 2 × 12 flash launches a step
   run; then 14 steps uninterrupted against 10, save, restore and 4 more,
   the last losses within 1e-5;
13. runs the fourteenth slice's path, training the RWKV6, MoE and hybrid
   families, after phase 12 and before the lines of 9, every earlier
   model freed first: (a) ``RWKV6Scan`` (the kernel's forward, the
   backward as torch ops) against autograd through its twin on
   ``FAMILY_RWKV_CASES`` (rwkv6_1_6b's training shape in bf16 and float32
   in the model's layout, a ragged T = 1000, Dh = 16 and 32, from a
   nonzero state): out and state as phase 7 holds them, dr, dk, dv, dw, du
   and the initial state's gradient within 3e-2 / 1e-4 of their largest
   magnitude, two calls bitwise, then the backward's time beside its
   bound and the twin's; the differentiable SSM scan on the card against
   the CPU (float32, 1e-5) and its backward's time at hymba's shape; (b)
   rwkv6_1_6b and (c) hymba_1_5b at full width and depth through
   ``launch.train.run`` at 4 × 1024 for 3 steps, launch counts zeroed just
   before and read just after (exactly 2 × 24 ``rwkv6_scan``, and 2 × 32
   ``flash_attention``, launches a step and no other kernel), every loss
   and gradient norm finite, the peak memory, warm step seconds and
   tokens/s, and a traced step; (d) moonshot_v1_16b_a3b at full width and
   4 of its 48 layers through ``make_train_step`` and AdamW, the same way
   (2 × 4 flash and 2 × 4 dispatch launches a step), its routing counters
   and a traced step, then ``MoEDispatch``'s gradient bitwise against the
   twin's at layer 0's own routing and with most slots dropped, and its
   time; (e) each model in float32 at full width, 4 layers (hymba 16),
   batch 2 × 1024, through the kernels against the twins: rwkv6 and hymba
   the loss within 1e-4 and the gradient norm within 1e-3 (relative),
   moonshot with only the dispatch swapped loss and every gradient
   bitwise;
14. runs the fifteenth slice's path, the distributed pieces on a world of
   one, after phase 13 and before the lines of 9, every earlier model
   freed first: (a) a one-rank NCCL process group (a ``file://`` store in
   a temporary directory, destroyed at the end of the phase), the port's
   ``make_test_mesh(1, 1)`` on the card by default with ``dp_axes``,
   ``tp_size`` and ``dp_size`` checked, and ``make_production_mesh()``
   refused for want of 256 ranks; (b) gemma2_2b at full width and depth
   (bf16, seed-0 weights): one ``loss_fn`` value and gradient on phase
   12's 4 x 1024 batch (2 x 26 flash launches and no other kernel), then
   ``ef_compress_grads(grads, ef_init(params))`` on the card: ``g_hat``
   and ``e'`` of four leaves and of a seeded 1000-element tensor (bf16 and
   float32, a ragged last block) bitwise equal to the same function on the
   CPU; a second call from the returned residual holds ``g + e == g_hat +
   e'`` within float32 rounding plus ``g_hat``'s bf16 rounding (float32
   rounding alone on the float32 tensor); its ms a call (CUDA events),
   device ms and launches (profiler), peak memory and bound (12 bytes a
   parameter); (c) ``hierarchical_psum_grads`` (intra ``("data",)`` and
   ``("data", "model")``) and ``flat_psum_grads`` over that gradient on a
   (1, 1, 1) ``("pod", "data", "model")`` mesh, each bitwise its input,
   timed; (d) ``param_shardings`` and ``opt_shardings`` of gemma2_2b's
   parameters and AdamW state as DTensors on the (1, 1) mesh
   (``distribute_tree``), every ``full_tensor()`` bitwise its leaf, and
   ``count_params`` 2 614 341 888, the leaves' sum;
15. runs the sixteenth slice's path, the sharded step, after phase 14 and
   before the lines of 9, on a one-rank NCCL world (a ``file://`` store in
   a temporary directory, destroyed at the end of the phase): (a)
   gemma2_2b at full width and depth and moonshot_v1_16b_a3b at full
   width and 4 layers (bf16, seed 0, 4 x 1024) through the one-device
   ``make_train_step`` and then, from the same weights, through the
   sharded one on the ``make_test_mesh(1, 1)`` mesh (the state as DTensors
   from ``shard_train_state``), 3 steps each, launch counts zeroed just
   before each run and read just after: every metric and every parameter
   bitwise, the same launches (2 x 26 flash a gemma2 step; 2 x 4 flash
   and 2 x 4 dispatch a moonshot step), the warm step seconds and peak
   memory of both printed beside phase 12's step; (b) moonshot's MoE
   layer at full width, T = 4096 tokens as 4 data shards through
   ``models.moe.route_dispatch_shards`` (one dispatch launch a shard,
   into 64 x 120 x 2048 each), buffers, routing tables and counters
   bitwise the dispatch twin's, timed; (c) gemma2_2b's mesh-bound prefill
   (4 x 1024, weights as DTensors) and 3 serve steps through
   ``serve.generate_on_mesh``: ids and prefill logits bitwise
   ``serve.generate``'s, 26 flash launches; (d) phase 12's repro_100m
   checkpoint through ``checkpoint.restore_resharded`` onto the mesh,
   every ``full_tensor()`` bitwise ``restore``'s; the checkpoint is then
   removed;
16. runs the seventeenth slice's path, the dry-run without HLO, after
   phase 15 and before the lines of 9: (a) ``python -m
   repro_torch.launch.dryrun --arch rwkv6_1_6b --shape long_500k
   --multi-pod --force`` in a subprocess on the default device (fake
   tensors on the card) and again with ``--device cpu``: ``[OK]``,
   ``fits_hbm``, 512 devices, and the two records equal in every count;
   (b) gemma2_2b (26 layers, 4 x 1024, bf16, one microbatch: phase 15's
   step) and rwkv6_1_6b (24 layers, 4 x 1024: phase 13's model, its
   backward's step loops scaled) traced by ``dryrun.trace_cell`` on a
   one-rank fake mesh, then each run for real on a one-rank NCCL (1, 1)
   mesh: a first step, a warm step timed and its peak memory read, and a
   third step under ``hlo_analysis.analyze``, launch counts zeroed just
   before the real steps and read just after (2 x 26 flash, 2 x 24
   RWKV6 launches a step): the FLOPs and HBM bytes of the trace equal
   to the real step's, the traced peak within 25 % of the warm step's
   ``max_memory_allocated()``, ``dryrun.HBM_PER_CHIP`` the card's
   ``total_memory``; (c) each step's roofline ``compute_s`` and
   ``memory_s`` beside its measured warm seconds, as a ratio (no gate);
17. runs the eighteenth slice's path, tensor and expert parallelism over
   ``"model"``, after phase 16: (a) phase 15 (a)'s one-rank (1, 1) mesh
   steps, which ran this code at tp = 1 (each leaf's local piece), read
   back: every metric and parameter bitwise the one-device step's (not
   run again); (b) flash at yi_9b's tp = 16 rank shape (2 q heads after the GQA
   + TP expansion, 4 x 1024, Dh 128, bf16) within 2e-2 of its twin,
   timed; (c) the dispatch into moonshot's tp = 16 rank's 4 experts (T =
   4096, D = 2048, k = 6) bitwise its twin, timed beside its bound and
   ``index_put_`` (each the median of 7 timed runs), with its device µs
   and the wrapper's host µs a call; then, with nothing
   timed, (d) ``train_4k`` of gemma2_2b and moonshot (yi_9b's and
   mistral_nemo_12b's cells since phase 18 left out) on both production
   meshes dry-run on the card's fake tensors (one subprocess each, all
   started before phase 13 with phases 18 (a)'s and 19 (a)'s, below the
   card's work in the host's scheduler), gemma2_2b's (16, 16) cell also
   on the CPU's, those records equal; (e) a tensor-parallel world of two
   gloo processes on the card (a (1, 2) mesh; NCCL takes one rank a
   device) runs moonshot at full width, 2 layers, float32 (gemma2_2b's
   tensor-parallel path runs in phase 18 (b)'s world since phase 19):
   each rank's pieces through ``loss_fn``'s value and gradient,
   ``make_prefill_step`` and ``make_serve_step`` against the whole
   weights in the same process (loss, gradients and logits within
   ``TP_TOL``, ids equal, every rank's routing alike and within
   ``TP_ROUTE_FLIPS`` of the whole run's, the same launches), then phase
   18 (b) and (c);
18. runs the nineteenth slice's path, FSDP's per-layer gathers over
   ``"data"``, after phase 17: (a) ``train_4k`` of llama4_maverick and
   nemotron on both production meshes dry-run on the card's fake
   tensors (started with phase 17 (d)'s), nemotron's (2, 16, 16) cell
   (fault F6's: microbatches the data shards do not divide) also on the
   CPU's, those records equal; llama4's cells and nemotron's (16, 16)
   fit, and each cell's ``coll_by_op`` holds FSDP's all-gathers and its
   gradients' reduce-scatters; with nothing timed, after phase 17 (e),
   (b) a (2, 2)
   ``("data", "model")`` world of four gloo processes on the card runs
   gemma2_2b with ``fsdp`` at full width, 2 layers, float32, as
   DTensors made from each rank's own blocks (FSDP and tensor
   parallelism in one leaf): 2 train steps with 1 and with 2
   microbatches of 4 x 256 tokens, a prefill and 4 greedy decode steps
   (caches of 264 slots) through the
   mesh-bound steps, against the one-device steps on the whole weights
   (losses, ``grad_norm``, the last step's AdamW moments and logits
   within ``TP_TOL``,
   ids equal, flash launched alike on every rank); (c) nemotron_4_340b
   at full width, 1 layer, bf16: a 2 x 512 prefill on the whole weights
   in this process, then on a data = 2 world of two processes (logits
   within 2e-2 of the largest, each process's peak memory below the
   whole run's);
19. runs the twentieth slice's path, the KV caches' sequence split, after
   phase 18: (a) nemotron_4_340b's and llama4_maverick's ``decode_32k``
   and gemma2_2b's ``long_500k`` on the (16, 16) mesh dry-run on the
   card's fake tensors and on the CPU's (started with phase 17 (d)'s),
   the records equal, each below the GiB a rank of the step that kept the
   rank's heads' caches whole (nemotron's below 20, llama4's below 15)
   and counting the merge's all-reduces; (b) in phase 18 (b)'s world, the
   serve's caches on each rank hold every KV head and 264 / 2 slots (the
   rank's block over ``"model"``), the 4 greedy decode steps' logits
   within 1e-5 of the whole weights'; then one lane of the same prompt,
   the one-device prefill's state placed by ``shard_decode_state``,
   decodes 4 greedy steps with its caches split 4 ways over ``("data",
   "model")`` (264 / 4 slots a rank): ids equal, logits within 1e-5.

Any mismatch or exception exits non-zero.  Without a CUDA device, or run
outside the repository, it exits non-zero and prints no result.  It also
prints the seconds its phases took and one ``{"report": ...}`` line with
every case's steps and times.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import statistics
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

    def label(m):
        # kernel<Dh>, or kernel<Dh, lse> for the instantiation with the store
        return (f"{m.group(1)}<{m.group(2)}"
                f"{', lse' if m.group(3) == '1' else ''}>")

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(flash_fwd_\w*?kernel)"
                      r"I\w*?Li(\d+)ELb([01])E", line)
        if m:
            name = label(m)
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
            m = re.match(r"\w*?(flash_fwd_\w*?kernel)I\w*?Li(\d+)ELb([01])E",
                         part)
            if m:
                sass[label(m)] = {
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

    check(sum("wgmma" in n for n in found) == 2 * len(fa.HEAD_DIMS),
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
#: batch and prompt as gemma2_2b's and rwkv6_1_6b's and MOE_GEN new tokens
#: (a decode step is host-bound, 0.4-0.8 s: fewer steps than theirs keep
#: the script inside its time limit)
MOE_GEN = 8
MOE_ARGV = ("--arch", "moonshot_v1_16b_a3b", "--batch", str(SERVE_B),
            "--prompt-len", str(SERVE_S), "--gen", str(MOE_GEN),
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
#: the dispatch's CUDA kernels (one a call: its bulk-copy path, or its
#: vector path for rows that are not 16-byte multiples), as the profiler
#: names them
MOE_KERNEL_KEYS = ("moe_dispatch_bulk", "moe_dispatch_vec")
#: unsynchronised calls a dispatch's host µs is the mean of: fewer at the
#: prefill shape, whose device time a call is larger than the host's, so
#: the launch queue does not fill
MOE_HOST_CALLS = {"serve": 200, "decode": 1000, "tp": 1000}


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


def dispatch_calls(torch, call, n_profiled: int, n_host: int) -> dict:
    """One dispatch call taken apart on the card: the CUDA operations
    (kernels, memsets, copies) it puts on the stream and their device µs,
    per call over ``n_profiled`` profiled calls
    (``step_bench.stream_ops``), the dispatch kernels among them; the
    wrapper's host µs a call (``time.perf_counter`` around ``n_host``
    calls, not synchronised)."""
    from repro_torch import step_bench

    call()
    torch.cuda.synchronize()
    out = step_bench.stream_ops(lambda i: call(), n_profiled)
    out["kernels_per_call"] = sum(
        per_call for name, per_call in out["ops"].items()
        if any(k in name for k in MOE_KERNEL_KEYS))
    if out["ops_per_call"] < 1:
        # the trace lost records even behind its filler: its counts hold
        # no operation it did not see, its device time is not measured
        out["device_us"] = None
    t0 = time.perf_counter()
    for _ in range(n_host):
        call()
    out["host_us"] = (time.perf_counter() - t0) / n_host * 1e6
    torch.cuda.synchronize()
    return out


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
    B, S, GEN = SERVE_B, SERVE_S, MOE_GEN
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
    # the warm-up needs the prefill and one decode step only (serve.main
    # ran the whole path in this process; a decode step takes 0.4-0.8 s)
    serve.generate(params, cfg, {"tokens": tokens}, 2)
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
    check(set(md.KERNEL_NAMES.values()) == set(MOE_KERNEL_KEYS),
          f"dispatch kernels {md.KERNEL_NAMES} are not {MOE_KERNEL_KEYS}")
    E, C = kw0["n_experts"], kw0["capacity"]
    ms = cuda_time_ms(lambda i: md.moe_dispatch(x0, e0, p0, n_experts=E,
                                                capacity=C), 50, torch)
    plain_ms = cuda_time_ms(lambda i: mref.moe_dispatch(x0, e0, p0, E, C),
                            20, torch)
    nbytes, rows_read, (lib_ms,), lib = dispatch_cost(torch, x0, e0, p0,
                                                      E, C)
    lib_same = bool(torch.equal(lib, mref.moe_dispatch(x0, e0, p0, E, C)))
    del lib
    _, xd, ed, pd, _, _ = cases[1]
    decode_ms = cuda_time_ms(lambda i: md.moe_dispatch(
        xd, ed, pd, n_experts=64, capacity=8), 200, torch)
    # what a call puts on the stream, its device µs and the wrapper's host
    # µs, at the prefill and the decode shape
    calls = {
        "serve": dispatch_calls(torch, lambda: md.moe_dispatch(
            x0, e0, p0, n_experts=E, capacity=C), 5, MOE_HOST_CALLS["serve"]),
        "decode": dispatch_calls(torch, lambda: md.moe_dispatch(
            xd, ed, pd, n_experts=64, capacity=8), 20,
            MOE_HOST_CALLS["decode"])}
    for label, c in calls.items():
        # one kernel a call: no other operation (no memset) in the trace,
        # and no more dispatch kernels than calls (a trace that lost
        # records may hold fewer)
        other = [name for name in c["ops"]
                 if not any(k in name for k in MOE_KERNEL_KEYS)]
        check(not other and c["kernels_per_call"] <= 1,
              f"moe_dispatch at the {label} shape: {c['ops_per_call']} "
              f"CUDA operations a call ({c['ops']}), not one kernel")
    dev_us = calls["serve"]["device_us"]
    bnd, by = bound_ms(nbytes, 0)
    out["moe_timed"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            library_same=lib_same, rows_read=rows_read,
                            device_us=dev_us, bytes=nbytes, bound_ms=bnd,
                            bound_by=by, decode_ms=decode_ms,
                            gb_per_s=nbytes / ms / 1e6, calls=calls)
    print(f"moe_dispatch at T={x0.shape[0]} D={x0.shape[1]} k={e0.shape[1]} "
          f"-> {E}x{C} bf16: {ms:.4f} ms a call ({nbytes / ms / 1e6:.1f} "
          f"GB/s, {ms / bnd:.2f}x its bound; device "
          f"{f'{dev_us:.1f} us' if dev_us else 'time not measured'}), bound "
          f"{bnd:.5f} ms ({by}; {nbytes} bytes), twin {plain_ms:.4f} ms, "
          f"index_put_ of the kept rows {lib_ms:.4f} ms (equal: "
          f"{lib_same}); decode shape {decode_ms:.4f} ms",
          flush=True)
    for label, c in calls.items():
        print(f"moe_dispatch at the {label} shape: "
              f"{c['ops_per_call']:g} CUDA operations a call "
              f"({c['ops']}; {c['memsets_per_call']:g} memsets), device "
              f"{fmt_us(c['device_us'])}, host {c['host_us']:.2f} us a "
              "call",
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


#: phase 12: training.  (a) the flash backward, kernel (forward and lse)
#: against twin: (label, B, H, KV, S, Dh, dtype, window, softcap, causal):
#: gemma2_2b's training shape (a local layer's window of 4096 hides
#: nothing at S = 1024; a window of 256 bites), repro_100m's, a ragged S
#: in both types, hubert's bidirectional Dh = 80, and (phase 13's models)
#: a hymba local layer's and moonshot's
TRAIN_FLASH_CASES = (
    ("gemma2_local_bf16", 4, 8, 4, 1024, 256, "bfloat16", 4096, 50.0, True),
    ("gemma2_w256_bf16", 4, 8, 4, 1024, 256, "bfloat16", 256, 50.0, True),
    ("gemma2_local_f32", 4, 8, 4, 1024, 256, "float32", 4096, 50.0, True),
    ("gemma2_w256_f32", 4, 8, 4, 1024, 256, "float32", 256, 50.0, True),
    ("repro_100m_f32", 4, 10, 5, 128, 64, "float32", 0, None, True),
    ("ragged_bf16", 2, 4, 2, 1000, 128, "bfloat16", 0, None, True),
    ("ragged_f32", 2, 4, 2, 1000, 64, "float32", 0, 30.0, True),
    ("hubert_f32", 2, 16, 16, 512, 80, "float32", 0, None, False),
    ("hymba_local_bf16", 4, 25, 5, 1024, 64, "bfloat16", 1024, None, True),
    ("moonshot_bf16", 4, 16, 16, 1024, 128, "bfloat16", 0, None, True),
)
#: per output type: out (atol = rtol), lse (atol = rtol), and dq / dk / dv
#: relative to each tensor's largest magnitude.  bf16: the kernel rounds P
#: to bf16 before P V and its out is bf16, so the backward's Drow differs
#: at 2^-8; float32: sums in another order
TRAIN_FLASH_TOL = {"bfloat16": dict(out=2e-2, lse=1e-3, grad=3e-2),
                   "float32": dict(out=1e-4, lse=1e-5, grad=1e-4)}
#: (b) gemma2_2b at full width through the train driver: bf16 weights,
#: float32 AdamW state, batch 4 x 1024, 6 steps, no checkpoints
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 6
TRAIN_ARGV = ("--arch", "gemma2_2b", "--steps", str(TRAIN_STEPS),
              "--global-batch", str(TRAIN_B), "--seq", str(TRAIN_S),
              "--seed", "0", "--log-every", "1")
#: (c) the float32 model at full depth, kernels against twins: the loss
#: relative to the twin's, and the global gradient norm
TRAIN_F32_B = 2
TRAIN_F32_LOSS_TOL, TRAIN_F32_GNORM_TOL = 1e-4, 1e-3
#: (d) repro_100m through the train driver as the quick example runs it
#: (a node failure at step 30, checkpoints every 20), then a resume
QUICK_ARGV = ("--arch", "repro_100m", "--steps", "60", "--global-batch",
              "4", "--seq", "128", "--ckpt-every", "20", "--fault-at", "30",
              "--log-every", "10", "--seed", "0")
RESUME_TOL = 1e-5
#: the profiler ranges the port marks on the training path
TRAIN_RANGES = ("flash_attention_backward", "cross_entropy",
                "cross_entropy_backward", "adamw_update", "rwkv6_backward",
                "moe_dispatch_backward", "ssm_scan_backward")
GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass")


def rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def train_flash_checks(torch, dev):
    """(a): ``FlashAttention`` (the kernel's forward with lse, the ported
    backward) against the twin's ``autograd.Function`` on
    ``TRAIN_FLASH_CASES``; two calls bitwise; then at gemma2_2b's training
    shape the forward with and without lse, forward + backward against
    the twin's, the backward alone and one ``scaled_dot_product_attention``
    forward + backward (a yardstick)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as fref

    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, h, kv, s, dh, dtype):
        q, k, v = (torch.randn((b, n, s, dh), generator=gen, device=dev
                               ).to(dtype).requires_grad_(True)
                   for n in (h, kv, kv))
        dout = torch.randn((b, h, s, dh), generator=gen, device=dev
                           ).to(dtype)
        return q, k, v, dout

    def fwd_bwd(fn, q, k, v, dout):
        out = fn(q, k, v)
        return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)

    errs = {}
    for label, b, h, kv, s, dh, dtype, window, softcap, causal in \
            TRAIN_FLASH_CASES:
        q, k, v, dout = inputs(b, h, kv, s, dh, getattr(torch, dtype))
        tol = TRAIN_FLASH_TOL[dtype]

        def kern(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal, window=window,
                                      softcap=softcap)

        def twin(q, k, v):
            return fref.flash_attention(q, k, v, causal, window, softcap)

        got = fwd_bwd(kern, q, k, v, dout)
        want = fwd_bwd(twin, q, k, v, dout)
        with torch.no_grad():
            lse = fa.launch_forward(q, k, v, causal, window, softcap, True)[1]
            lse_want = fref._attn_fwd(q, k, v, causal, window, softcap,
                                      1024, 1024)[1]
        again = fwd_bwd(kern, q, k, v, dout)
        torch.cuda.synchronize()
        e = dict(out=float((got[0].float() - want[0].float()).abs().max()),
                 lse=float((lse - lse_want).abs().max()),
                 **{n: rel_err(g, w) for n, g, w in
                    zip(("dq", "dk", "dv"), got[1:], want[1:])})
        errs[label] = e
        check(got[0].dtype == q.dtype and within(got[0], want[0], tol["out"]),
              f"flash backward {label}: out max abs err {e['out']} beyond "
              f"{tol['out']}")
        check(within(lse, lse_want, tol["lse"]),
              f"flash backward {label}: lse max abs err {e['lse']} beyond "
              f"{tol['lse']}")
        check(all(g.dtype == w.dtype for g, w in zip(got[1:], (q, k, v)))
              and max(e[n] for n in ("dq", "dk", "dv")) <= tol["grad"],
              f"flash backward {label}: gradients {e} beyond {tol['grad']} "
              "of their largest magnitude")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash backward {label}: two calls differ")
        print(f"  flash train {label:18s} B={b} H={h} KV={kv} S={s} Dh={dh} "
              f"{dtype} causal={causal} window={window} softcap={softcap}: "
              f"out {e['out']:.3g}, lse {e['lse']:.3g}, dq/dk/dv "
              f"{e['dq']:.3g}/{e['dk']:.3g}/{e['dv']:.3g} of max (tol "
              f"{tol}); two calls bitwise", flush=True)

    # the time at gemma2_2b's training shape (bf16, a local layer)
    b, h, kv, s, dh = TRAIN_B, 8, 4, TRAIN_S, 256
    q, k, v, dout = inputs(b, h, kv, s, dh, torch.bfloat16)
    window, softcap = 4096, 50.0
    with torch.no_grad():
        out, lse = fa.launch_forward(q, k, v, True, window, softcap, True)
    timed = dict(
        fwd_ms=cuda_time_ms(lambda i: fa.launch_forward(
            q, k, v, True, window, softcap, False), 50, torch),
        fwd_lse_ms=cuda_time_ms(lambda i: fa.launch_forward(
            q, k, v, True, window, softcap, True), 50, torch),
        fwd_bwd_ms=cuda_time_ms(lambda i: fwd_bwd(
            lambda q, k, v: fa.flash_attention(
                q, k, v, window=window, softcap=softcap), q, k, v, dout),
            10, torch),
        twin_fwd_bwd_ms=cuda_time_ms(lambda i: fwd_bwd(
            lambda q, k, v: fref.flash_attention(q, k, v, True, window,
                                                 softcap), q, k, v, dout),
            10, torch),
        bwd_ms=cuda_time_ms(lambda i: fref._attn_bwd(
            q, k, v, out, lse, dout, True, window, softcap, 1024, 1024),
            10, torch))
    ke, ve = (t.detach().repeat_interleave(h // kv, dim=1).requires_grad_(True)
              for t in (k, v))
    timed["sdpa_fwd_bwd_ms"] = cuda_time_ms(lambda i: fwd_bwd(
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True),
        q, ke, ve, dout), 10, torch)
    # the backward's products: s, dp, dq, dk and dv over every (query,
    # key) pair of the full S x S chunk, in float32
    bwd_flops = 5 * 2 * b * h * s * s * dh
    timed["bwd_bound_ms"] = bwd_flops / PEAK_OPS_PER_S * 1e3
    print(f"flash at gemma2_2b's training shape {b}x{h}/{kv}x{s}x{dh} bf16 "
          f"(window {window}, softcap {softcap}): forward {timed['fwd_ms']:.4f}"
          f" ms, with lse {timed['fwd_lse_ms']:.4f} ms; forward + backward "
          f"{timed['fwd_bwd_ms']:.3f} ms (twin {timed['twin_fwd_bwd_ms']:.3f}"
          f", scaled_dot_product_attention {timed['sdpa_fwd_bwd_ms']:.3f}, "
          f"not the same function: no softcap); the backward alone "
          f"{timed['bwd_ms']:.3f} ms ({bwd_flops / 1e9:.1f} GFLOP of float32"
          f" products, {timed['bwd_bound_ms']:.3f} ms at 67 TFLOP/s)",
          flush=True)
    return dict(flash_train_errors=errs, flash_train_timed=timed)


def train_trace_summary(torch, prof, wall_us,
                        kernels=(("flash_fwd", FLASH_KERNEL_KEYS),)) -> dict:
    """A traced train step: device busy share, the GEMMs' kernel time and
    that of each of ``kernels`` (``(label, name keys)``: the flash forward
    by default), and the device time of the ranges the port marks
    (``TRAIN_RANGES``: the backwards in torch ops, the cross-entropy and
    its backward, AdamW): the kernels launched by the ops that run inside
    each range on its thread.  Read from the profiler's raw events, not
    its ``events()`` tree, which takes minutes to build for the 10^5-10^6
    launches of an RWKV6 or hymba step."""
    import bisect
    from collections import defaultdict

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    by_name = defaultdict(lambda: [0, 0])        # name -> [ns, launches]
    by_corr = defaultdict(int)                   # launching op -> kernel ns
    ops = defaultdict(list)                      # thread -> [(start, op)]
    spans = []                                   # (thread, start, end, name)
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        if dt == cuda and not e.is_user_annotation():
            d = e.duration_ns()
            row = by_name[e.name()]
            row[0] += d
            row[1] += 1
            by_corr[e.linked_correlation_id()] += d
        elif dt == cpu and e.linked_correlation_id() == 0:
            if e.name() in TRAIN_RANGES:
                spans.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                              e.name()))
            else:
                ops[e.start_thread_id()].append((e.start_ns(),
                                                 e.correlation_id()))
    for v in ops.values():
        v.sort()
    ranges = dict.fromkeys(TRAIN_RANGES, 0)
    for thread, start, end, name in spans:
        v = ops[thread]
        lo = bisect.bisect_left(v, (start, -1))
        hi = bisect.bisect_right(v, (end, float("inf")))
        ranges[name] += sum(by_corr.get(c, 0) for _, c in v[lo:hi])
    busy_ns = sum(ns for ns, _ in by_name.values())

    def kernel_ms(keys):
        return sum(ns for name, (ns, _) in by_name.items()
                   if any(k.lower() in name.lower() for k in keys)) / 1e6

    return dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_ns / 1e6,
        device_busy_share=busy_ns / 1e3 / wall_us,
        launches=sum(n for _, n in by_name.values()),
        **{f"{label}_ms": kernel_ms(keys) for label, keys in kernels},
        gemm_ms=kernel_ms(GEMM_KEYS),
        **{f"{n}_ms": (ns / 1e6 if ns else None) for n, ns in ranges.items()},
        top=[(name[:70], ns / 1e3, n) for name, (ns, n) in sorted(
            by_name.items(), key=lambda kv: -kv[1][0])[:8]])


def train_phase(torch, dev, reg):
    """Phase 12: the flash backward against its twin; gemma2_2b trained at
    full width through ``launch.train``; the float32 model's gradients,
    kernels against twins; repro_100m through the quick example's run
    (fault, recovery) and a resume.  Returns (the flash launches of the
    two main-path runs, report)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init, global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out["free_gib_at_start"] = torch.cuda.mem_get_info()[0] / 2**30

    # (a) the flash backward, kernel against twin
    out.update(train_flash_checks(torch, dev))
    torch.cuda.empty_cache()

    # (b) gemma2_2b at full width through the train driver, launch counts
    # zeroed just before and read just after
    cfg = cb.get("gemma2_2b")
    reg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.run(list(TRAIN_ARGV))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = reg.launch_counts()
    # every layer's forward runs once in the step's forward and once more
    # in the backward, which recomputes each checkpointed group
    # (_remat_group(13) = 1: every pattern step is a group)
    want = 2 * cfg.n_layers * TRAIN_STEPS
    check(launches == dict(dict.fromkeys(reg.KERNELS, 0),
                           flash_attention=want),
          f"gemma2_2b training launched {launches}; expected {want} "
          "flash_attention launches (2 a layer a step) and nothing else")
    check(len(run.losses) == TRAIN_STEPS and all(
        math.isfinite(x) for x in run.losses + run.grad_norms),
        f"gemma2_2b losses {run.losses}, grad norms {run.grad_norms}")
    step_s = sum(run.step_s[1:]) / len(run.step_s[1:])
    out["gemma2_2b"] = dict(
        wall_s=wall, flash_launches=launches["flash_attention"],
        flash_launches_per_step=launches["flash_attention"] / TRAIN_STEPS,
        losses=run.losses, grad_norms=run.grad_norms, step_s=run.step_s,
        warm_step_s=step_s, tokens_per_s=TRAIN_B * TRAIN_S / step_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    g = out["gemma2_2b"]
    print(f"train: gemma2_2b {TRAIN_B}x{TRAIN_S}, {TRAIN_STEPS} steps "
          f"through train.run: {g['flash_launches']} flash launches "
          f"({g['flash_launches_per_step']:.0f} a step), losses "
          f"{[round(x, 4) for x in run.losses]}, grad norms "
          f"{[round(x, 3) for x in run.grad_norms]}; warm step "
          f"{step_s:.4f} s ({g['tokens_per_s']:.0f} tokens/s; first "
          f"{run.step_s[0]:.3f} s); peak {g['peak_gib']:.2f} GiB", flush=True)
    # a traced step on the trained state
    train_step = steps.make_train_step(cfg, dev, total_steps=TRAIN_STEPS)
    batch = batch_for(cfg, TRAIN_STEPS, TRAIN_B, TRAIN_S)
    params, opt = run.params, run.opt
    del run
    params, opt, _ = train_step(params, opt, batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics = train_step(params, opt, batch,
                                          TRAIN_STEPS + 1)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    g["traced"] = t = train_trace_summary(torch, prof, wall_us)
    print(f"train (traced step): device busy {t['device_busy_ms']:.1f} ms of "
          f"{t['wall_ms']:.1f} ms wall ({100 * t['device_busy_share']:.1f} "
          f"%), {t['launches']} kernel launches; flash forward "
          f"{t['flash_fwd_ms']:.2f} ms, GEMMs {t['gemm_ms']:.1f} ms, the "
          f"backward's attention {t['flash_attention_backward_ms']} ms, CE "
          f"{t['cross_entropy_ms']} + {t['cross_entropy_backward_ms']} ms, "
          f"AdamW {t['adamw_update_ms']} ms; top: {t['top'][:5]}",
          flush=True)
    del params, opt, metrics, prof, train_step
    torch.cuda.empty_cache()

    # (c) the float32 model at full depth: loss and gradients through the
    # kernels and through their twins
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params = tfm.init_params(
        cfg32, torch.Generator(device=dev).manual_seed(0), dev
    ).requires_grad_(True)
    leaves = tfm.tree_leaves(params)
    names = ["/".join(p) for p, _ in tfm.tree_items(params)]
    batch = {"tokens": torch.as_tensor(
        batch_for(cfg, 0, TRAIN_F32_B, TRAIN_S)["tokens"], device=dev)}

    def loss_and_grads():
        loss, _ = tfm.loss_fn(params, cfg32, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    k_loss, k_grads = loss_and_grads()
    ops.set_impl("ref")
    try:
        r_loss, r_grads = loss_and_grads()
    finally:
        ops.set_impl(None)
    k_gn, r_gn = float(global_norm(k_grads)), float(global_norm(r_grads))
    leaf_errs = {n: rel_err(a, b)
                 for n, a, b in zip(names, k_grads, r_grads)}
    loss_err = abs(float(k_loss) - float(r_loss)) / abs(float(r_loss))
    gn_err = abs(k_gn - r_gn) / r_gn
    out["f32"] = dict(loss=float(k_loss), twin_loss=float(r_loss),
                      loss_rel_err=loss_err, grad_norm=k_gn,
                      twin_grad_norm=r_gn, grad_norm_rel_err=gn_err,
                      leaf_rel_errs=leaf_errs)
    check(math.isfinite(float(k_loss)) and loss_err <= TRAIN_F32_LOSS_TOL
          and gn_err <= TRAIN_F32_GNORM_TOL,
          f"float32 gemma2_2b: loss {float(k_loss)} vs {float(r_loss)}, "
          f"grad norm {k_gn} vs {r_gn}")
    print(f"train (float32, {TRAIN_F32_B}x{TRAIN_S}, full depth): loss "
          f"{float(k_loss):.6f} (twin {float(r_loss):.6f}, rel err "
          f"{loss_err:.3g} <= {TRAIN_F32_LOSS_TOL}); grad norm {k_gn:.6f} "
          f"(twin {r_gn:.6f}, rel err {gn_err:.3g} <= {TRAIN_F32_GNORM_TOL});"
          f" every leaf, max abs err over max |twin|: "
          + ", ".join(f"{n} {e:.2g}" for n, e in leaf_errs.items()),
          flush=True)
    del params, leaves, k_grads, r_grads
    torch.cuda.empty_cache()

    # (d) repro_100m as the quick example runs it, then a resume; its
    # checkpoints stay for phase 15 (d), which removes them
    cfg100 = cb.get("repro_100m")
    d = out["ckpt_dir"] = tempfile.mkdtemp(prefix="repro_ckpt_")
    reg.reset_launches()
    t0 = time.perf_counter()
    run = train.run(list(QUICK_ARGV) + ["--ckpt-dir", d])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    quick_launches = reg.launch_counts()["flash_attention"]
    first, last5 = run.losses[0], sum(run.losses[-5:]) / 5
    # 12 layers in 4 checkpointed groups of 3: each forward twice a step
    want = 2 * cfg100.n_layers * len(run.losses)
    check(quick_launches == want,
          f"repro_100m: {quick_launches} flash launches, expected {want}")
    check(last5 < first and run.restarts == 1
          and (run.recovered_from or 0) >= 20,
          f"repro_100m: loss {first} -> {last5}, restarts {run.restarts}, "
          f"recovered from {run.recovered_from}")
    recovered = run.recovered_from
    del run

    def trained(n, start=0, state=None):
        step = steps.make_train_step(cfg100, dev, total_steps=14)
        if state is None:
            p = tfm.init_params(
                cfg100, torch.Generator(device=dev).manual_seed(0), dev)
            state = (p, adamw_init(p))
        p, o = state
        for i in range(start, n):
            p, o, m = step(p, o, batch_for(cfg100, i, 4, 128), i)
        return (p, o), float(m["loss"])

    _, l_full = trained(14)
    with tempfile.TemporaryDirectory() as d:
        state, _ = trained(10)
        tree = {"p": state[0], "o": state[1]}
        ckpt.save(d, 10, tree)
        restored, s = ckpt.restore(d, tree)
        del state, tree
        _, l_resumed = trained(14, 10, (restored["p"], restored["o"]))
    resume_err = abs(l_resumed - l_full) / abs(l_full)
    check(s == 10 and resume_err <= RESUME_TOL,
          f"resume: loss {l_resumed} vs uninterrupted {l_full}")
    out["repro_100m"] = dict(wall_s=wall, flash_launches=quick_launches,
                             first_loss=first, last5_loss=last5,
                             restarts=1, recovered_from=recovered,
                             resume_loss=l_resumed,
                             uninterrupted_loss=l_full,
                             resume_rel_err=resume_err)
    print(f"train: repro_100m 4x128, 60 steps with a fault at 30 through "
          f"train.run ({wall:.1f} s): loss {first:.4f} -> {last5:.4f} (mean "
          f"of the last 5), 1 restart from step {recovered}, "
          f"{quick_launches} flash launches; resume after 10 steps: loss {l_resumed:.6f} against "
          f"{l_full:.6f} uninterrupted (rel err {resume_err:.3g} <= "
          f"{RESUME_TOL})", flush=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"training phase took {out['phase_s']:.1f} s", flush=True)
    return launches["flash_attention"] + quick_launches, out


#: phase 13: training the RWKV6, MoE and hybrid families.  (a) RWKV6Scan
#: (the kernel's forward, ``ref.rwkv6_backward``) against autograd through
#: its twin: (label, B, H, T, Dh, dtype, layout) — rwkv6_1_6b's training
#: shape in both types in the model's layout, a ragged T, the smoke
#: config's and the JAX kernel tests' head dims; every one from a nonzero
#: state with nonzero cotangents of out and of the final state
FAMILY_RWKV_CASES = (
    ("train_bf16", 4, 32, 1024, 64, "bfloat16", "model"),
    ("train_f32", 4, 32, 1024, 64, "float32", "model"),
    ("ragged_1000", 2, 32, 1000, 64, "bfloat16", "packed"),
    ("dh16", 2, 4, 256, 16, "float32", "packed"),
    ("dh32", 2, 8, 256, 32, "bfloat16", "model"),
)
#: the gradients relative to each one's largest magnitude (as phase 12's)
FAMILY_GRAD_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
#: the differentiable SSM scan on the card against the CPU, float32, every
#: output and gradient relative to its largest magnitude: (B, T, Di, N);
#: then the backward alone at hymba_1_5b's training shape
FAMILY_SSM_SHAPE = (2, 300, 256, 16)
FAMILY_SSM_TOL = 1e-5
HYMBA_SSM_SHAPE = (4, 1024, 3200, 16)
#: (b)-(d): bf16 weights, float32 AdamW state, batch 4 x 1024, 3 steps;
#: moonshot at 4 of its 48 layers (each about 570 M parameters: the 48
#: need about 340 GB at 12 bytes a parameter, the 4 about 35 GB)
FAMILY_B, FAMILY_S, FAMILY_STEPS = 4, 1024, 3
MOONSHOT_TRAIN_LAYERS = 4
#: the dispatch's gradient, bitwise against the twin's: a capacity so tight
#: that most slots drop (label, T, D, k, E, C, dtype, token groups)
FAMILY_MOE_CASES = (("tight", 4096, 2048, 6, 64, 48, "bfloat16", 1),)
#: (e) float32 at full width, batch 2 x 1024, kernels against twins: 4
#: layers (hymba: 2 pattern steps, 16 layers); rwkv6 and hymba the loss
#: and the global gradient norm (relative), moonshot with only the dispatch
#: swapped for its twin bitwise
FAMILY_F32_B, FAMILY_F32_LAYERS, HYMBA_F32_LAYERS = 2, 4, 16


def family_argv(arch: str) -> list:
    return ["--arch", arch, "--steps", str(FAMILY_STEPS), "--global-batch",
            str(FAMILY_B), "--seq", str(FAMILY_S), "--seed", "0",
            "--log-every", "1"]


def family_rwkv_checks(torch, dev):
    """(a) for RWKV6: ``RWKV6Scan`` against autograd through the twin on
    ``FAMILY_RWKV_CASES`` (out and final state as phase 7 holds them, the
    six gradients within ``FAMILY_GRAD_TOL`` of their largest magnitude,
    two calls bitwise); then at the training shape the kernel's forward,
    the backward alone beside its bound, and forward + backward beside the
    twin's."""
    from repro_torch.kernels import ref as fref
    from repro_torch.kernels import rwkv6_scan as rk

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for label, B, H, T, Dh, dtype, layout in FAMILY_RWKV_CASES:
        leaves = [t.detach().requires_grad_(True) for t in rwkv_inputs(
            torch, B, H, T, Dh, dtype, True, gen, dev, layout)]
        dout = torch.randn((B, H, T, Dh), generator=gen, device=dev)
        dstate = torch.randn((B, H, Dh, Dh), generator=gen, device=dev)

        def fwd_bwd(fn):
            o, s = fn(*leaves)
            return (o.detach(), s.detach()) + torch.autograd.grad(
                (o.float() * dout).sum() + (s * dstate).sum(), leaves)

        got = fwd_bwd(rk.RWKV6Scan.apply)
        again = fwd_bwd(rk.RWKV6Scan.apply)
        want = fwd_bwd(rk.plain)
        torch.cuda.synchronize()
        names = ("dr", "dk", "dv", "dw", "du", "dstate")
        e = dict(out=float((got[0].float() - want[0].float()).abs().max()),
                 state=float((got[1] - want[1]).abs().max()),
                 **{n: rel_err(g, w) for n, g, w in
                    zip(names, got[2:], want[2:])})
        errs[label] = e
        tol = FAMILY_GRAD_TOL[dtype]
        check(within(got[0], want[0], FLASH_TOL[dtype])
              and within(got[1], want[1], RWKV_STATE_TOL),
              f"RWKV6Scan {label}: out / state max abs err {e['out']} / "
              f"{e['state']}")
        check(all(g.dtype == t.dtype and g.shape == t.shape
                  for g, t in zip(got[2:], leaves))
              and max(e[n] for n in names) <= tol,
              f"RWKV6Scan {label}: gradients {e} beyond {tol} of their "
              "largest magnitude")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"RWKV6Scan {label}: two calls differ")
        print(f"  rwkv6 train {label:12s} B={B} H={H} T={T} Dh={Dh} {dtype} "
              f"{layout}: out {e['out']:.3g}, state {e['state']:.3g}, "
              + ", ".join(f"{n} {e[n]:.3g}" for n in names)
              + f" of max (tol {tol}); two calls bitwise", flush=True)
        del leaves, got, again, want

    # the time at rwkv6_1_6b's training shape (bf16, the model's layout)
    B, H, T, Dh = FAMILY_B, 32, FAMILY_S, 64
    r, k, v, w, u, state = (t.detach().requires_grad_(True) for t in
                            rwkv_inputs(torch, B, H, T, Dh, "bfloat16", True,
                                        gen, dev, "model"))
    dout = torch.randn((B, H, T, Dh), generator=gen, device=dev
                       ).to(torch.bfloat16)
    dstate = torch.randn((B, H, Dh, Dh), generator=gen, device=dev)

    def fwd_bwd(fn):
        o, s = fn(r, k, v, w, u, state)
        return torch.autograd.grad((o, s), (r, k, v, w, u, state),
                                   (dout, dstate))

    with torch.no_grad():
        timed = dict(
            fwd_ms=cuda_time_ms(lambda i: rk.rwkv6(r, k, v, w, u, state),
                                20, torch),
            bwd_ms=cuda_time_ms(lambda i: fref.rwkv6_backward(
                r, k, v, w, u, state, dout, dstate), 3, torch))
    timed["fwd_bwd_ms"] = cuda_time_ms(
        lambda i: fwd_bwd(rk.RWKV6Scan.apply), 3, torch)
    timed["twin_fwd_bwd_ms"] = cuda_time_ms(lambda i: fwd_bwd(rk.plain), 2,
                                            torch)
    # the backward's float32 work a (b, h, t): the state again (k v^T, then
    # w S + k v^T: 3 Dh^2), the reverse recurrence (r g^T, then w dS +
    # r g^T: 3 Dh^2), dr = S g, dk = dS v, dv = dS^T k, dw = rowsum(dS S)
    # (2 Dh^2 each); its bytes: r, k, v, w, dout and their gradients in
    # bf16, the two states and their gradients in float32
    n = B * H * T
    nops = n * 14 * Dh * Dh
    nbytes = 9 * n * Dh * 2 + 4 * B * H * Dh * Dh * 4
    timed["bwd_bound_ms"], timed["bwd_bound_by"] = bound_ms(nbytes, nops)
    print(f"rwkv6 at the training shape {B}x{H}x{T}x{Dh} bf16: kernel "
          f"forward {timed['fwd_ms']:.4f} ms; the backward alone "
          f"{timed['bwd_ms']:.2f} ms (bound {timed['bwd_bound_ms']:.4f} ms "
          f"by {timed['bwd_bound_by']}: {nops / 1e9:.2f} GFLOP at 67 TFLOP/s)"
          f"; forward + backward {timed['fwd_bwd_ms']:.2f} ms (the twin's "
          f"through autograd {timed['twin_fwd_bwd_ms']:.2f})", flush=True)
    return dict(rwkv_grad_errors=errs, rwkv_timed=timed)


def family_ssm_checks(torch, dev):
    """(a) for the SSM scan: ``ref.ssm_scan`` under grad (``SSMScan``) on
    the card against the same on the CPU, float32, y, the final state and
    the seven gradients within ``FAMILY_SSM_TOL`` of their largest
    magnitude; then ``ssm_backward`` alone at hymba_1_5b's training
    shape."""
    from repro_torch.kernels import ref as fref

    gen = torch.Generator().manual_seed(0)

    def draw(B, T, Di, N):
        def randn(*shape):
            return torch.randn(shape, generator=gen)
        return [randn(B, T, Di), torch.nn.functional.softplus(
                    randn(B, T, Di)), -torch.exp(randn(Di, N)),
                randn(B, T, N), randn(B, T, N), 1.0 + 0.1 * randn(Di),
                randn(B, Di, N) * 0.5], randn(B, T, Di), randn(B, Di, N)

    args, gy, gh = draw(*FAMILY_SSM_SHAPE)

    def run(device):
        leaves = [a.to(device).requires_grad_(True) for a in args]
        y, h = fref.ssm_scan(*leaves)
        grads = torch.autograd.grad((y, h), leaves, (gy.to(device),
                                                     gh.to(device)))
        return [t.detach().cpu() for t in (y, h, *grads)]

    got, want = run(dev), run("cpu")
    names = ("y", "state", "dx", "ddt", "dA", "dBm", "dCm", "dD", "dstate0")
    errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
    check(max(errs.values()) <= FAMILY_SSM_TOL,
          f"ssm_scan on the card against the CPU: {errs} beyond "
          f"{FAMILY_SSM_TOL} of the largest magnitude")
    print(f"  ssm_scan under grad {FAMILY_SSM_SHAPE}, card against CPU: "
          + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
          + f" of max (tol {FAMILY_SSM_TOL})", flush=True)
    B, T, Di, N = HYMBA_SSM_SHAPE
    xf, dtf, Bf, Cf, gyf = (torch.randn(s, device=dev) for s in (
        (B, T, Di), (B, T, Di), (B, T, N), (B, T, N), (B, T, Di)))
    dtf = torch.nn.functional.softplus(dtf)
    Af = -torch.exp(torch.randn((Di, N), device=dev))
    h0 = torch.zeros((B, Di, N), device=dev)
    starts = []
    fref._ssm_steps(xf, dtf, Af, Bf, Cf, h0, starts)
    bwd_ms = cuda_time_ms(lambda i: fref.ssm_backward(
        xf, dtf, Af, Bf, Cf, starts, gyf, h0), 2, torch)
    print(f"ssm_backward at hymba_1_5b's training shape {HYMBA_SSM_SHAPE}: "
          f"{bwd_ms:.1f} ms a layer", flush=True)
    return dict(ssm_errors=errs, ssm_bwd_ms=bwd_ms)


def family_moe_checks(torch, dev, layer0):
    """(a) for the dispatch: ``MoEDispatch``'s gradient (one launch
    forward, the twin's gather backward) bitwise against autograd through
    the twin at moonshot's own layer-0 routing (``layer0``, taken in (d))
    and on ``FAMILY_MOE_CASES``; then the backward's time at layer 0's
    shape beside its bound (bytes: each kept row read, each token's row
    written, the tables read)."""
    from repro_torch.core import balance
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref as mref

    gen = torch.Generator(device=dev).manual_seed(0)
    x0, e0, p0, kw0 = layer0
    cases = [("train_layer0", x0, e0, p0, kw0["n_experts"],
              kw0["capacity"])]
    for label, T, D, k, E, C, dtype, G in FAMILY_MOE_CASES:
        x, ve, pos = moe_inputs(torch, balance, T, D, k, E, C, dtype, G, gen,
                                dev)
        cases.append((label, x, ve, pos, G * E, C))
    for label, x, ve, pos, E, C in cases:
        x = x.detach().requires_grad_(True)
        g = torch.randn((E, C, x.shape[1]), generator=gen, device=dev
                        ).to(x.dtype)
        out = md.MoEDispatch.apply(x, ve, pos, E, C)
        (got,) = torch.autograd.grad(out, x, g)
        (want,) = torch.autograd.grad(mref.moe_dispatch(x, ve, pos, E, C),
                                      x, g)
        torch.cuda.synchronize()
        check(got.dtype == x.dtype and torch.equal(got, want),
              f"MoEDispatch {label}: gradient max abs err "
              f"{float((got.float() - want.float()).abs().max())}")
        print(f"  moe_dispatch train {label:12s} T={x.shape[0]} "
              f"D={x.shape[1]} k={ve.shape[1]} buffers={E}x{C}: kept "
              f"{int((ve >= 0).sum())} of {ve.numel()} slots, gradient "
              "bitwise equal to the twin's", flush=True)
    E, C = kw0["n_experts"], kw0["capacity"]
    T, D = x0.shape
    g = torch.randn((E, C, D), generator=gen, device=dev).to(x0.dtype)
    bwd_ms = cuda_time_ms(lambda i: mref.moe_dispatch_backward(
        g, e0, p0, E, C), 20, torch)
    kept = int((e0 >= 0).sum())
    nbytes = (kept + T) * D * x0.element_size() + 2 * e0.numel() * 4
    bnd, by = bound_ms(nbytes, 0)
    print(f"moe_dispatch backward at layer 0's shape T={T} D={D} "
          f"k={e0.shape[1]} into {E}x{C} ({kept} kept slots): "
          f"{bwd_ms:.4f} ms (bound {bnd:.5f} ms by {by})", flush=True)
    return dict(moe_bwd_ms=bwd_ms, moe_bwd_bound_ms=bnd, moe_bwd_bound_by=by)


def family_phase(torch, dev, reg):
    """Phase 13: the backwards of the RWKV6 kernel, the SSM scan and the
    MoE dispatch per op; rwkv6_1_6b and hymba_1_5b trained at full width
    and depth through ``launch.train.run``, moonshot_v1_16b_a3b at full
    width and 4 layers through ``make_train_step``; each float32 model at
    4 layers (hymba 16) through the kernels against their twins.  Returns
    (the launches of the three main-path runs by kernel, report)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init, global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out["free_gib_at_start"] = torch.cuda.mem_get_info()[0] / 2**30
    main_launches = dict.fromkeys(reg.KERNELS, 0)
    part_s = out["part_s"] = {}
    last = [t_phase]

    def lap(label):
        now = time.perf_counter()
        part_s[label] = now - last[0]
        last[0] = now
        print(f"  phase 13 {label}: {part_s[label]:.1f} s", flush=True)

    # (a) the backwards per op
    out.update(family_rwkv_checks(torch, dev))
    lap("rwkv6 backward checks")
    out.update(family_ssm_checks(torch, dev))
    lap("ssm scan checks")
    torch.cuda.empty_cache()
    kern_keys = {"rwkv6_1_6b": (("rwkv6", ("rwkv6_kernel",)),),
                 "hymba_1_5b": (("flash_fwd", FLASH_KERNEL_KEYS),),
                 "moonshot_v1_16b_a3b": (("flash_fwd", FLASH_KERNEL_KEYS),
                                         ("moe_dispatch", MOE_KERNEL_KEYS))}

    def expected(cfg, steps_run):
        """2 launches of each layer's kernels a step (remat recomputes
        every checkpointed group)."""
        want = dict.fromkeys(reg.KERNELS, 0)
        kinds = tfm.pattern(cfg)
        n = cfg.n_layers // len(kinds)
        for kind in kinds:
            want["rwkv6_scan" if kind.rwkv else "flash_attention"] += \
                2 * n * steps_run
            want["moe_dispatch"] += 2 * n * steps_run * kind.moe
        return want

    def traced_step(arch, cfg, params, opt):
        step = steps.make_train_step(cfg, dev, total_steps=FAMILY_STEPS)
        batch = batch_for(cfg, FAMILY_STEPS, FAMILY_B, FAMILY_S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch, FAMILY_STEPS)
            float(metrics["loss"])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        t0 = time.perf_counter()
        t = train_trace_summary(torch, prof, wall_us, kern_keys[arch])
        del prof
        t["summary_s"] = time.perf_counter() - t0
        print(f"train {arch} (traced step): device busy "
              f"{t['device_busy_ms']:.1f} ms of {t['wall_ms']:.1f} ms wall "
              f"({100 * t['device_busy_share']:.1f} %), {t['launches']} "
              "kernel launches; "
              + ", ".join(f"{label} {t[label + '_ms']:.2f} ms"
                          for label, _ in kern_keys[arch])
              + f", GEMMs {t['gemm_ms']:.1f} ms, "
              + ", ".join(f"{n} {t[n + '_ms']}" for n in TRAIN_RANGES
                          if t[n + "_ms"] is not None)
              + f" ms; top: {t['top'][:5]}; summarised in "
              f"{t['summary_s']:.1f} s", flush=True)
        return t

    def report(arch, cfg, losses, grad_norms, step_s, wall, launches):
        warm = sum(step_s[1:]) / len(step_s[1:])
        r = dict(wall_s=wall, launches=launches, losses=losses,
                 grad_norms=grad_norms, step_s=step_s, warm_step_s=warm,
                 tokens_per_s=FAMILY_B * FAMILY_S / warm,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 n_layers=cfg.n_layers)
        print(f"train: {arch} ({cfg.n_layers} layers) {FAMILY_B}x{FAMILY_S},"
              f" {len(losses)} steps: launches "
              f"{ {k: v for k, v in launches.items() if v} }, losses "
              f"{[round(x, 4) for x in losses]}, grad norms "
              f"{[round(x, 3) for x in grad_norms]}; warm step {warm:.3f} s "
              f"({r['tokens_per_s']:.0f} tokens/s; first {step_s[0]:.3f} s);"
              f" peak {r['peak_gib']:.2f} GiB", flush=True)
        return r

    # (b), (c) rwkv6_1_6b and hymba_1_5b at full width and depth through
    # the train driver, launch counts zeroed just before and read just
    # after
    for arch in ("rwkv6_1_6b", "hymba_1_5b"):
        cfg = cb.get(arch)
        reg.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train.run(family_argv(arch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = reg.launch_counts()
        want = expected(cfg, FAMILY_STEPS)
        check(launches == want,
              f"{arch} training launched {launches}; expected {want}")
        check(len(run.losses) == FAMILY_STEPS and all(
            math.isfinite(x) for x in run.losses + run.grad_norms),
            f"{arch} losses {run.losses}, grad norms {run.grad_norms}")
        for k, v in launches.items():
            main_launches[k] += v
        out[arch] = report(arch, cfg, run.losses, run.grad_norms,
                           run.step_s, wall, launches)
        params, opt = run.params, run.opt
        del run
        lap(f"{arch} train.run")
        out[arch]["traced"] = traced_step(arch, cfg, params, opt)
        del params, opt
        torch.cuda.empty_cache()
        lap(f"{arch} traced step")

    # (d) moonshot_v1_16b_a3b at full width, 4 of its layers, through
    # make_train_step and the port's AdamW; layer 0's dispatch inputs of
    # the first step kept for (a)
    arch = "moonshot_v1_16b_a3b"
    cfg = dataclasses.replace(cb.get(arch), n_layers=MOONSHOT_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev).requires_grad_(True)
    opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
    step = steps.make_train_step(cfg, dev, total_steps=FAMILY_STEPS)
    layer0 = []
    dispatch = ops.moe_dispatch

    def first_dispatch(x, expert, pos, **kw):
        if not layer0:
            layer0.append((x.detach().clone(), expert.clone(), pos.clone(),
                           kw))
        return dispatch(x, expert, pos, **kw)

    losses, gnorms, step_s, routing = [], [], [], []
    reg.reset_launches()
    t0 = time.perf_counter()
    for i in range(FAMILY_STEPS):
        ops.moe_dispatch = first_dispatch if i == 0 else dispatch
        try:
            t1 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch_for(
                cfg, i, FAMILY_B, FAMILY_S), i)
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t1)
        finally:
            ops.moe_dispatch = dispatch
        gnorms.append(float(metrics["grad_norm"]))
        routing.append({k: int(metrics[k]) for k in tfm.AUX_KEYS
                        if k != "lb_loss"})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = reg.launch_counts()
    want = expected(cfg, FAMILY_STEPS)
    check(launches == want,
          f"{arch} training launched {launches}; expected {want}")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{arch} losses {losses}, grad norms {gnorms}")
    for k, v in launches.items():
        main_launches[k] += v
    out[arch] = report(arch, cfg, losses, gnorms, step_s, wall, launches)
    out[arch]["routing"] = routing
    print(f"train: {arch} routing counters a step (4 layers, "
          f"{FAMILY_B * FAMILY_S * cfg.moe.top_k * MOONSHOT_TRAIN_LAYERS} "
          f"slots): {routing}", flush=True)
    lap(f"{arch} steps")
    out[arch]["traced"] = traced_step(arch, cfg, params, opt)
    del params, opt, step, metrics
    torch.cuda.empty_cache()
    lap(f"{arch} traced step")
    x0, e0, p0, kw0 = layer0[0]
    cap = moe.capacity_for(cfg, FAMILY_B * FAMILY_S)      # 480 at 4 x 1024
    check(tuple(x0.shape) == (FAMILY_B * FAMILY_S, cfg.d_model)
          and (kw0["n_experts"], kw0["capacity"]) == (cfg.moe.n_experts,
                                                      cap),
          f"layer 0 dispatched {tuple(x0.shape)} into {kw0}")
    out.update(family_moe_checks(torch, dev, layer0[0]))
    del layer0, x0, e0, p0
    torch.cuda.empty_cache()
    lap("moe_dispatch backward checks")

    # (e) float32 at full width and 4 layers (hymba 16), kernels against
    # twins
    f32 = {}
    for arch, layers, swap in (
            ("rwkv6_1_6b", FAMILY_F32_LAYERS, ()),
            ("hymba_1_5b", HYMBA_F32_LAYERS, ()),
            ("moonshot_v1_16b_a3b", FAMILY_F32_LAYERS, ("moe_dispatch",))):
        cfg32 = dataclasses.replace(cb.get(arch), n_layers=layers,
                                    param_dtype="float32",
                                    compute_dtype="float32")
        params = tfm.init_params(
            cfg32, torch.Generator(device=dev).manual_seed(0), dev
        ).requires_grad_(True)
        leaves = tfm.tree_leaves(params)
        batch = {"tokens": torch.as_tensor(batch_for(
            cfg32, 0, FAMILY_F32_B, FAMILY_S)["tokens"], device=dev)}

        def loss_and_grads():
            loss, _ = tfm.loss_fn(params, cfg32, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        k_loss, k_grads = loss_and_grads()
        ops.set_impl("ref", *swap)
        try:
            r_loss, r_grads = loss_and_grads()
        finally:
            ops.set_impl(None)
        k_gn, r_gn = float(global_norm(k_grads)), float(global_norm(r_grads))
        loss_err = abs(float(k_loss) - float(r_loss)) / abs(float(r_loss))
        gn_err = abs(k_gn - r_gn) / r_gn
        leaf_err = max(rel_err(a, b) for a, b in zip(k_grads, r_grads))
        f32[arch] = dict(layers=layers, loss=float(k_loss),
                         twin_loss=float(r_loss), loss_rel_err=loss_err,
                         grad_norm=k_gn, twin_grad_norm=r_gn,
                         grad_norm_rel_err=gn_err, max_leaf_rel_err=leaf_err)
        if swap:
            bitwise = torch.equal(k_loss, r_loss) and all(
                torch.equal(a, b) for a, b in zip(k_grads, r_grads))
            f32[arch]["bitwise"] = bitwise
            check(bitwise, f"float32 {arch} with only the dispatch swapped: "
                  f"loss {float(k_loss)} vs {float(r_loss)}, largest leaf "
                  f"error {leaf_err}")
            gate = "loss and every gradient bitwise equal"
        else:
            check(math.isfinite(float(k_loss))
                  and loss_err <= TRAIN_F32_LOSS_TOL
                  and gn_err <= TRAIN_F32_GNORM_TOL,
                  f"float32 {arch}: loss {float(k_loss)} vs {float(r_loss)},"
                  f" grad norm {k_gn} vs {r_gn}")
            gate = (f"loss rel err {loss_err:.3g} <= {TRAIN_F32_LOSS_TOL}, "
                    f"grad norm rel err {gn_err:.3g} <= {TRAIN_F32_GNORM_TOL}")
        print(f"train (float32, {FAMILY_F32_B}x{FAMILY_S}, {layers} layers) "
              f"{arch}, kernels against "
              f"{'the dispatch twin' if swap else 'twins'}: loss "
              f"{float(k_loss):.6f} (twin {float(r_loss):.6f}), grad norm "
              f"{k_gn:.6f} (twin {r_gn:.6f}); {gate}; largest leaf error "
              f"{leaf_err:.3g} of its max", flush=True)
        del params, leaves, k_grads, r_grads, batch
        torch.cuda.empty_cache()
        lap(f"{arch} float32")
    out["f32"] = f32
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"family training phase took {out['phase_s']:.1f} s", flush=True)
    return main_launches, out


#: phase 14: the distributed pieces on a world of one.  (b) the leaves of
#: gemma2_2b's gradient held card against CPU, and a seeded tensor of 1000
#: elements (a ragged last block) in both types
DIST_LEAVES = ("streams.0.attn.wq", "streams.0.mlp.wd", "streams.0.ln1",
               "final_norm")
DIST_PAD_N = 1000
DIST_TIME_N = 5
#: read bf16 g and float32 e, write bf16 g_hat and float32 e'
EF_BYTES_PER_PARAM = 12
GEMMA2_PARAMS = 2_614_341_888


def bits_equal(a, b) -> bool:
    """Equal bit for bit: dtype, shape and every bit of every element."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool((a == b).all())


def dist_phase(torch, dev, reg):
    """Phase 14: (a) a one-rank process group and the port's meshes on it;
    (b) gemma2_2b's gradient at full width through ``ef_compress_grads``,
    card against CPU bitwise, error feedback's identity, its time beside
    its bound; (c) the tree and flat all-reduces on a (1, 1, 1) pod mesh,
    bitwise the identity; (d) the sharding rules' placements as DTensors,
    ``full_tensor`` bitwise.  Returns (the flash launches of (b)'s loss,
    report)."""
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init, ef_compress_grads, ef_init
    from repro_torch.runtime import flat_psum_grads, hierarchical_psum_grads

    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix="repro_dist_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        # (a) the meshes: the default device is the card's
        mesh = mesh_mod.make_test_mesh(
            1, 1, device=None if dev.type == "cuda" else dev)
        helpers = (mesh_mod.dp_axes(mesh), mesh_mod.tp_size(mesh),
                   mesh_mod.dp_size(mesh))
        check(mesh.device_type == dev.type
              and mesh.mesh_dim_names == ("data", "model")
              and helpers == (("data",), 1, 1),
              f"make_test_mesh(1, 1): {mesh}, helpers {helpers}")
        try:
            mesh_mod.make_production_mesh(device=dev)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        check(refused is not None and "needs 256 ranks" in refused,
              f"make_production_mesh on a world of one: {refused}")
        out["mesh"] = dict(device_type=mesh.device_type,
                           dp_axes=list(helpers[0]), tp_size=helpers[1],
                           dp_size=helpers[2], production_refused=refused)
        print(f"distributed (a): make_test_mesh(1, 1) on {mesh.device_type}:"
              f" dp_axes {helpers[0]}, tp_size {helpers[1]}, dp_size "
              f"{helpers[2]}; make_production_mesh refused: {refused}",
              flush=True)

        # (b) gemma2_2b's gradient (bf16, seed 0, phase 12's batch), then
        # error-feedback compression on the card
        cfg = cb.get("gemma2_2b")
        params = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev
        ).requires_grad_(True)
        leaves = tfm.tree_leaves(params)
        names = [".".join(p) for p, _ in tfm.tree_items(params)]
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 batch_for(cfg, 0, TRAIN_B, TRAIN_S).items()}
        reg.reset_launches()
        loss, _ = tfm.loss_fn(params, cfg, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = float(loss.detach())
        launches = reg.launch_counts()
        want = 2 * cfg.n_layers
        check(launches == dict(dict.fromkeys(reg.KERNELS, 0),
                               flash_attention=want),
              f"gemma2_2b's gradient launched {launches}; expected {want} "
              "flash_attention launches and nothing else")
        params.requires_grad_(False)
        n_params = sum(g.numel() for g in grads)
        check(math.isfinite(loss) and n_params == GEMMA2_PARAMS,
              f"gemma2_2b: loss {loss}, {n_params} parameters")
        out["grad"] = dict(loss=loss, n_params=n_params,
                           flash_launches=launches["flash_attention"])
        del loss, batch
        ef = tfm.tree_leaves(ef_init(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.max_memory_allocated()
        g_hat, e1 = ef_compress_grads(grads, ef)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        cpu = torch.device("cpu")
        for name in DIST_LEAVES:
            i = names.index(name)
            c_hat, c_e = ef_compress_grads([grads[i].to(cpu)],
                                           [ef[i].to(cpu)])
            check(bits_equal(g_hat[i].to(cpu), c_hat[0])
                  and bits_equal(e1[i].to(cpu), c_e[0]),
                  f"ef_compress_grads on {name}: card and CPU differ")
        rng = np.random.default_rng(14)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.from_numpy(rng.standard_normal(DIST_PAD_N).astype(
                np.float32)).to(dtype)
            e = torch.from_numpy((rng.standard_normal(DIST_PAD_N) * 0.01)
                                 .astype(np.float32))
            on_card = ef_compress_grads([g.to(dev)], [e.to(dev)])
            on_cpu = ef_compress_grads([g], [e])
            check(all(bits_equal(a[0].to(cpu), b[0])
                      for a, b in zip(on_card, on_cpu)),
                  f"ef_compress_grads on {DIST_PAD_N} {dtype} elements: "
                  "card and CPU differ")
            # one more call from the residual: g + e == g_hat + e' within
            # float32 rounding (g_hat in float32 here)
            if dtype == torch.float32:
                (h2,), (e2,) = ef_compress_grads([g], on_cpu[1])
                c = g + on_cpu[1][0]
                check(bool(((h2 + e2 - c).abs()
                            <= 2.0 ** -22 * c.abs()).all()),
                      "error feedback's identity fails on the float32 "
                      "tensor")
        # the second call over the gradient: g + e == g_hat + e' within
        # the bf16 rounding of g_hat (half an ulp, 2^-8 of it) and float32
        # rounding
        g_hat2, e2 = ef_compress_grads(grads, e1)
        worst = 0.0
        for g, e, h, r in zip(grads, e1, g_hat2, e2):
            c = g.float() + e
            err = (h.float() + r - c).abs()
            lim = 2.0 ** -8 * h.float().abs() + 2.0 ** -22 * c.abs()
            check(bool((err <= lim).all()),
                  "error feedback's identity fails on the gradient")
            worst = max(worst, float((err / lim.clamp_min(1e-30)).max()))
        del g_hat, e1, g_hat2, e2, c, err, lim
        torch.cuda.empty_cache()
        ms = cuda_time_ms(lambda i: ef_compress_grads(grads, ef),
                          DIST_TIME_N, torch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ef_compress_grads(grads, ef)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        traced = train_trace_summary(torch, prof, wall_us, kernels=())
        del prof
        b_ms, b_by = bound_ms(EF_BYTES_PER_PARAM * n_params, 0)
        out["grad"].update(
            leaves_bitwise=list(DIST_LEAVES), pad_case_bitwise=DIST_PAD_N,
            identity_worst_share_of_limit=worst, ef_ms=ms,
            ef_device_ms=traced["device_busy_ms"],
            ef_launches=traced["launches"], ef_wall_ms=traced["wall_ms"],
            ef_peak_gib=peak, bound_ms=b_ms, bound_by=b_by,
            bound_bytes=EF_BYTES_PER_PARAM * n_params,
            top=traced["top"][:4])
        print(f"distributed (b): gemma2_2b gradient ({n_params} parameters,"
              f" {want} flash launches); ef_compress_grads card == CPU "
              f"bitwise on {', '.join(DIST_LEAVES)} and {DIST_PAD_N} "
              f"elements (bf16, float32); second call g + e == g_hat + e' "
              f"(worst {worst:.3g} of the limit); {ms:.3f} ms a call, "
              f"device {traced['device_busy_ms']:.3f} ms in "
              f"{traced['launches']} launches, peak +{peak:.2f} GiB; bound "
              f"{b_ms:.3f} ms ({b_by}, {EF_BYTES_PER_PARAM} bytes a "
              f"parameter); top {traced['top'][:4]}", flush=True)

        # (c) the collectives on a (1, 1, 1) pod mesh: the identity
        pod = init_device_mesh(dev.type, (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
        runs = {
            "hierarchical_data": lambda: hierarchical_psum_grads(grads, pod),
            "hierarchical_data_model": lambda: hierarchical_psum_grads(
                grads, pod, intra_axes=("data", "model")),
            "flat_pod_data": lambda: flat_psum_grads(grads, pod,
                                                     ("pod", "data"))}
        out["collectives"] = {}
        for name, fn in runs.items():
            res = fn()
            check(isinstance(res, list) and all(
                bits_equal(a, b) for a, b in zip(res, grads)),
                f"{name} over one rank is not the identity")
            del res
            out["collectives"][name] = cuda_time_ms(lambda i: fn(), 3, torch)
        print("distributed (c): over one rank, bitwise the identity; ms a "
              "call over the gradient: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in out["collectives"].items()),
              flush=True)

        # (d) the placements as DTensors on the (1, 1) mesh
        opt = adamw_init(params)
        for m, v, g, p in zip(tfm.tree_leaves(opt.m), tfm.tree_leaves(opt.v),
                              grads, leaves):
            m.copy_(g)
            v.copy_(p)
        del grads, ef
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        p_specs = shd.param_shardings(params, cfg, mesh)
        o_specs = shd.opt_shardings(opt, params, cfg, mesh)
        n_leaves = n_shard = 0
        for tree, specs in ((params, p_specs), (opt.m, o_specs.m),
                            (opt.v, o_specs.v)):
            dtree = shd.distribute_tree(tree, specs, mesh)
            for (path, leaf), (_, d) in zip(tfm.tree_items(tree),
                                            tfm.tree_items(dtree)):
                check(bits_equal(d.full_tensor(), leaf.detach()),
                      f"{'.'.join(path)}: full_tensor differs")
                n_leaves += 1
                n_shard += any(pl.is_shard() for pl in d.placements)
            del dtree
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        count = shd.count_params(params)
        check(count == sum(p.numel() for p in leaves) == GEMMA2_PARAMS,
              f"count_params {count}")
        out["placements"] = dict(leaves=n_leaves, sharded=n_shard,
                                 count_params=count, wall_s=place_s)
        print(f"distributed (d): {n_leaves} leaves of params, m and v as "
              f"DTensors on the (1, 1) mesh ({n_shard} with a Shard), every "
              f"full_tensor bitwise; count_params {count}; {place_s:.1f} s",
              flush=True)
        del params, leaves, opt
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"distributed phase took {out['phase_s']:.1f} s", flush=True)
    return want, out


#: phase 15: the sharded step on a world of one.  (a) 3 steps of each
#: model on the (1, 1) mesh against the one-device step; (b) moonshot's
#: MoE layer of SHARD_T tokens routed as SHARD_G data shards through the
#: global view; (c) the mesh-bound prefill and SHARD_GEN - 1 serve steps
SHARD_STEPS = 3
SHARD_T, SHARD_G = 4096, 4
SHARD_GEN = 4


def sharded_phase(torch, dev, reg, ckpt_dir, one_device_step_s):
    """Phase 15: (a) gemma2_2b (full depth) and moonshot_v1_16b_a3b (4
    layers) trained 3 steps through the sharded ``make_train_step`` on a
    one-rank NCCL (1, 1) mesh, losses, metrics and parameters bitwise the
    one-device step's, launches equal; (b) moonshot's MoE layer routed as
    4 shards through ``route_dispatch_shards``, kernel against twin
    bitwise; (c) gemma2_2b's mesh-bound prefill and 3 serve steps bitwise
    ``serve.generate``; (d) phase 12's checkpoint through
    ``restore_resharded`` onto the mesh, bitwise.  ``ckpt_dir`` is
    removed at the end.  Returns (the launches of the mesh runs of (a) and
    (c) by kernel, report)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import base as cb
    from repro_torch.core import balance, prng
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as mref
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import serve, steps
    from repro_torch.launch import sharding as shd
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init

    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    main_launches = dict.fromkeys(reg.KERNELS, 0)
    cpu = torch.device("cpu")
    store = tempfile.mkdtemp(prefix="repro_shard_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_test_mesh(
            1, 1, device=None if dev.type == "cuda" else dev)
        check(mesh.device_type == dev.type, f"the mesh is on {mesh}")

        # (a) the sharded train step against the one-device step
        out["train"] = {}
        for arch, n_layers in (("gemma2_2b", None),
                               ("moonshot_v1_16b_a3b",
                                MOONSHOT_TRAIN_LAYERS)):
            cfg = cb.get(arch)
            if n_layers:
                cfg = dataclasses.replace(cfg, n_layers=n_layers)
            batches = [batch_for(cfg, i, TRAIN_B, TRAIN_S)
                       for i in range(SHARD_STEPS)]
            runs = {}
            for kind in ("one_device", "mesh"):
                params = tfm.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev)
                opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
                where = dev
                if kind == "mesh":
                    params, opt = steps.shard_train_state(cfg, mesh, params,
                                                          opt)
                    where = mesh
                torch.cuda.empty_cache()
                step = steps.make_train_step(cfg, where,
                                             total_steps=SHARD_STEPS)
                metrics, step_s = [], []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reg.reset_launches()
                for i, b in enumerate(batches):
                    t1 = time.perf_counter()
                    params, opt, m = step(params, opt, b, i)
                    float(m["loss"])           # waits for the step
                    step_s.append(time.perf_counter() - t1)
                    metrics.append({k: v.detach().to(cpu)
                                    for k, v in m.items()})
                launches = reg.launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
                final = [(leaf.full_tensor() if kind == "mesh"
                          else leaf.detach()).to(cpu)
                         for leaf in tfm.tree_leaves(params)]
                runs[kind] = dict(metrics=metrics, step_s=step_s,
                                  launches=launches, peak_gib=peak,
                                  final=final)
                del params, opt, step, m
                torch.cuda.empty_cache()
            one, sh = runs["one_device"], runs["mesh"]
            n = cfg.n_layers // len(tfm.pattern(cfg))
            want = dict.fromkeys(reg.KERNELS, 0)
            want["flash_attention"] = 2 * cfg.n_layers * SHARD_STEPS
            want["moe_dispatch"] = 2 * n * SHARD_STEPS * sum(
                k.moe for k in tfm.pattern(cfg))
            check(sh["launches"] == one["launches"] == want,
                  f"{arch}: the mesh step launched {sh['launches']}, the "
                  f"one-device step {one['launches']}; expected {want}")
            check(all(a.keys() == b.keys() and all(
                bits_equal(a[k], b[k]) for k in b)
                for a, b in zip(sh["metrics"], one["metrics"])),
                f"{arch}: the mesh step's metrics differ from the "
                "one-device step's")
            check(len(sh["final"]) == len(one["final"]) and all(
                bits_equal(a, b) for a, b in zip(sh["final"],
                                                 one["final"])),
                f"{arch}: the mesh step's parameters differ")
            for k, v in sh["launches"].items():
                main_launches[k] += v
            warm = {kind: sum(r["step_s"][1:]) / len(r["step_s"][1:])
                    for kind, r in runs.items()}
            losses = [float(m["loss"]) for m in sh["metrics"]]
            out["train"][arch] = dict(
                n_layers=cfg.n_layers, losses=losses,
                step_s={kind: r["step_s"] for kind, r in runs.items()},
                warm_step_s=warm,
                mesh_over_one_device=warm["mesh"] / warm["one_device"],
                peak_gib={kind: r["peak_gib"] for kind, r in runs.items()},
                launches={k: v for k, v in sh["launches"].items() if v},
                bitwise=True)
            print(f"sharded (a): {arch} ({cfg.n_layers} layers) "
                  f"{TRAIN_B}x{TRAIN_S}, {SHARD_STEPS} steps on the (1, 1) "
                  f"mesh: losses {losses}, metrics and every parameter "
                  f"bitwise the one-device step's; launches "
                  f"{out['train'][arch]['launches']} (the same); warm step "
                  f"{warm['mesh']:.4f} s against {warm['one_device']:.4f} s "
                  f"one-device ({warm['mesh'] / warm['one_device']:.4f}x; "
                  f"first {sh['step_s'][0]:.3f} / {one['step_s'][0]:.3f} s)"
                  f"; peak {sh['peak_gib']:.2f} / {one['peak_gib']:.2f} GiB"
                  + (f"; phase 12's warm step {one_device_step_s:.4f} s"
                     if arch == "gemma2_2b" else ""), flush=True)
            del runs, one, sh
        torch.cuda.empty_cache()

        # (b) moonshot's MoE layer as SHARD_G data shards, the global view
        cfg = cb.get("moonshot_v1_16b_a3b")
        E, D = cfg.moe.n_experts, cfg.d_model
        gen = torch.Generator(device=dev).manual_seed(15)
        x = torch.randn((SHARD_T, D), generator=gen, device=dev).to(
            cfg.cdtype)
        logits = x.float() @ layers._dense_init((D, E), torch.float32, gen,
                                                dev)
        cap = moe.capacity_for(cfg, SHARD_T // SHARD_G)
        groups = balance.default_expert_groups(E, 16, device=dev)
        rng = prng.fold_in(prng.PRNGKey(17), 0)
        reg.reset_launches()
        kern = moe.route_dispatch_shards(x, logits, cfg, cap, groups, rng,
                                         SHARD_G)
        torch.cuda.synchronize()
        b_launches = reg.launch_counts()["moe_dispatch"]
        ops.set_impl("ref", "moe_dispatch")
        try:
            twin = moe.route_dispatch_shards(x, logits, cfg, cap, groups,
                                             rng, SHARD_G)
        finally:
            ops.set_impl(None, "moe_dispatch")
        check(b_launches == SHARD_G,
              f"the global view launched moe_dispatch {b_launches} times")
        check(all(bits_equal(a, b) for a, b in zip(kern[:5], twin[:5]))
              and {k: int(v) for k, v in kern[5].items()}
              == {k: int(v) for k, v in twin[5].items()},
              "the shards' dispatch or routing differs from the twin's")
        shard_ms = cuda_time_ms(lambda i: moe.route_dispatch_shards(
            x, logits, cfg, cap, groups, rng, SHARD_G), 5, torch)
        # the dispatch alone at a shard's shape (shard 0: ve is the expert)
        t = SHARD_T // SHARD_G
        xs, es, ps = x[:t], kern[1][:t], kern[2][:t]
        d_ms = cuda_time_ms(lambda i: md.moe_dispatch(
            xs, es, ps, n_experts=E, capacity=cap), 50, torch)
        d_plain = cuda_time_ms(lambda i: mref.moe_dispatch(xs, es, ps, E,
                                                           cap), 20, torch)
        nbytes = (xs.numel() * xs.element_size() + 2 * es.numel() * 4
                  + E * cap * D * xs.element_size())
        d_bound, d_by = bound_ms(nbytes, 0)
        out["global_view"] = dict(
            T=SHARD_T, G=SHARD_G, capacity=cap, launches=b_launches,
            stats={k: int(v) for k, v in kern[5].items()},
            routed_ms=shard_ms, dispatch_ms=d_ms, dispatch_plain_ms=d_plain,
            dispatch_bound_ms=d_bound, dispatch_bound_by=d_by,
            bitwise=True)
        print(f"sharded (b): moonshot's MoE layer, T={SHARD_T} as "
              f"{SHARD_G} shards into {E} x {cap} x {D} each: "
              f"{b_launches} dispatch launches, buffers and routing bitwise "
              f"the twin's; counters {out['global_view']['stats']}; routing "
              f"+ dispatch of the 4 shards {shard_ms:.3f} ms; a shard's "
              f"dispatch {d_ms:.4f} ms (twin {d_plain:.4f} ms, bound "
              f"{d_bound:.5f} ms by {d_by})", flush=True)
        del x, logits, kern, twin, xs, es, ps
        torch.cuda.empty_cache()

        # (c) the mesh-bound prefill and serve steps against generate
        cfg = cb.get("gemma2_2b")
        params = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 batch_for(cfg, 0, SERVE_B, SERVE_S).items()}
        want = serve.generate(params, cfg, batch, SHARD_GEN)
        placed = shd.distribute_tree(params, shd.param_shardings(
            params, cfg, mesh), mesh)
        reg.reset_launches()
        got = serve.generate_on_mesh(placed, cfg, batch, SHARD_GEN, mesh)
        c_launches = reg.launch_counts()
        check(torch.equal(got.ids, want.ids)
              and bits_equal(got.prefill_logits, want.prefill_logits),
              "gemma2_2b: the mesh-bound prefill and serve steps differ "
              "from serve.generate")
        check(c_launches == dict(dict.fromkeys(reg.KERNELS, 0),
                                 flash_attention=cfg.n_layers),
              f"the mesh-bound prefill launched {c_launches}")
        for k, v in c_launches.items():
            main_launches[k] += v
        out["serve"] = dict(
            ids=got.ids.tolist(), prefill_s=got.prefill_s,
            decode_s=got.decode_s, generate_prefill_s=want.prefill_s,
            generate_decode_s=want.decode_s,
            flash_launches=c_launches["flash_attention"], bitwise=True)
        print(f"sharded (c): gemma2_2b {SERVE_B}x{SERVE_S}, prefill and "
              f"{SHARD_GEN - 1} serve steps on the mesh: ids "
              f"{got.ids[0].tolist()} (lane 0) and prefill logits bitwise "
              f"serve.generate's; {c_launches['flash_attention']} flash "
              f"launches; prefill {got.prefill_s:.3f} s (generate "
              f"{want.prefill_s:.3f} s), decode {got.decode_s:.3f} s "
              f"({want.decode_s:.3f} s)", flush=True)
        del params, placed, got, want, batch
        torch.cuda.empty_cache()

        # (d) phase 12's checkpoint restored onto the mesh
        cfg = cb.get("repro_100m")
        p_shape, o_shape = steps.init_shapes(cfg)
        template = {"params": p_shape, "opt": o_shape}
        plain, s_plain = ckpt.restore(ckpt_dir, template)
        specs = {"params": shd.param_shardings(p_shape, cfg, mesh),
                 "opt": shd.opt_shardings(o_shape, p_shape, cfg, mesh)}
        tree, s_mesh = ckpt.restore_resharded(ckpt_dir, template, specs,
                                              mesh)
        pairs = list(zip(tfm.tree_leaves(tree), tfm.tree_leaves(plain)))
        check(s_plain is not None and s_mesh == s_plain and all(
            a.device.type == dev.type and bits_equal(a.full_tensor().to(cpu),
                                                     b)
            for a, b in pairs),
            f"restore_resharded of step {s_mesh} differs from restore's "
            f"step {s_plain}")
        out["restore"] = dict(step=s_mesh, leaves=len(pairs), sharded=sum(
            any(pl.is_shard() for pl in a.placements) for a, _ in pairs),
            bitwise=True)
        print(f"sharded (d): phase 12's repro_100m checkpoint (step "
              f"{s_mesh}) restored onto the (1, 1) mesh: {len(pairs)} "
              f"DTensors ({out['restore']['sharded']} with a Shard) on "
              f"{dev.type}, every full_tensor bitwise restore's", flush=True)
        del tree, plain, pairs
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sharded phase took {out['phase_s']:.1f} s", flush=True)
    return main_launches, out


#: phase 16: the JAX dry-run test's cell through the port's dry-run CLI,
#: and the two traced steps held to their real runs
DRYRUN_ARGV = ("--arch", "rwkv6_1_6b", "--shape", "long_500k",
               "--multi-pod", "--force")
#: the counts two records of one cell must share
DRYRUN_COUNTS = ("hlo_flops_per_dev", "hlo_hbm_bytes_per_dev",
                 "coll_bytes_per_dev", "coll_by_op", "unknown_trip_loops",
                 "xla_cost_analysis_flops", "memory_per_device_bytes",
                 "arg_bytes", "temp_bytes", "out_bytes", "state_bytes_per_dev",
                 "kernels", "params", "model_flops", "n_devices", "mesh")
#: (b): the traced peak against the real step's max_memory_allocated()
DRYRUN_PEAK_TOL = 0.25
#: (b): the models traced and run, with the kernel each step launches
DRYRUN_STEPS = (("gemma2_2b", "flash_attention"),
                ("rwkv6_1_6b", "rwkv6_scan"))


def dryrun_cli(out_dir: str, device=None) -> dict:
    """Phase 16 (a): the dry-run CLI on the JAX test's cell in a
    subprocess; returns its record (and its wall seconds)."""
    import os

    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV,
            "--out", out_dir] + (["--device", device] if device else [])
    t0 = time.perf_counter()
    r = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)))
    wall = time.perf_counter() - t0
    check(r.returncode == 0 and "[OK]" in r.stdout,
          f"the dry-run on {device or 'the default device'} failed "
          f"(rc {r.returncode}): {r.stdout[-2000:]} {r.stderr[-3000:]}")
    with open(Path(out_dir) / "rwkv6_1_6b__long_500k__pod2.json") as f:
        rec = json.load(f)
    check(rec["fits_hbm"] and rec["n_devices"] == 512
          and rec["mesh"] == "2x16x16",
          f"the dry-run record on {device or 'the default device'}: "
          f"fits_hbm {rec['fits_hbm']}, {rec['n_devices']} devices, mesh "
          f"{rec['mesh']}")
    print(f"dryrun (a): {rec['arch']} x {rec['shape']} on {rec['device']} "
          f"fake tensors, {rec['n_devices']} ranks ({rec['mesh']}): "
          f"{rec['memory_per_device_bytes'] / 2**30:.3f} GiB a rank "
          f"(fits), {rec['hlo_flops_per_dev']:.4e} FLOPs, "
          f"{rec['hlo_hbm_bytes_per_dev']:.4e} bytes, collectives "
          f"{rec['coll_by_op']}; traced in {rec['trace_s']} s, "
          f"{wall:.1f} s of subprocess", flush=True)
    return dict(rec, wall_s=wall)


def dryrun_phase(torch, dev, reg):
    """Phase 16: (a) the dry-run CLI on the JAX test's cell, on the card's
    fake tensors and on the CPU's, the records equal in every count; (b)
    gemma2_2b and rwkv6_1_6b traced on a one-rank fake mesh, held to a
    real step on a one-rank NCCL mesh (FLOPs and bytes equal, the peak
    within ``DRYRUN_PEAK_TOL``); (c) the roofline seconds against the warm
    step.  Returns (the launches of (b)'s real steps by kernel, report)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import batch_for
    from repro_torch.launch import dryrun, hlo_analysis, steps
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init

    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    main_launches = dict.fromkeys(reg.KERNELS, 0)
    tmp = tempfile.mkdtemp(prefix="repro_dryrun_")
    try:
        # (a) the CLI on the card's fake tensors and on the CPU's, the two
        # subprocesses at once
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(dryrun_cli, str(
                Path(tmp) / (device or "default")), device)
                for device in (None, "cpu")]
            recs = {r["device"]: r for r in (f.result() for f in futures)}
        a, b = recs.values()
        diff = [k for k in DRYRUN_COUNTS if a[k] != b[k]]
        check(a["device"] != b["device"] and not diff,
              f"the dry-run records on {a['device']} and {b['device']} "
              f"differ in {diff}")
        out["cli"] = {k: {key: r[key] for key in DRYRUN_COUNTS + (
            "device", "trace_s", "wall_s", "fits_hbm", "compute_s",
            "memory_s", "collective_s", "dominant")}
            for k, r in recs.items()}
        print(f"dryrun (a): the {a['device']} and {b['device']} records are "
              f"equal in every count ({', '.join(DRYRUN_COUNTS)})",
              flush=True)

        # (b) the traced steps against the real ones
        hbm = torch.cuda.get_device_properties(0).total_memory \
            if dev.type == "cuda" else dryrun.HBM_PER_CHIP
        check(dryrun.HBM_PER_CHIP == hbm,
              f"dryrun.HBM_PER_CHIP {dryrun.HBM_PER_CHIP} is not the card's "
              f"total_memory {hbm}")
        cell = ShapeCell("phase16_train", "train", TRAIN_S, TRAIN_B)
        out["steps"] = {}
        for arch, kernel in DRYRUN_STEPS:
            cfg = cb.get(arch)
            t0 = time.perf_counter()
            with dryrun.fake_world(1):
                fake, meta = dryrun.trace_cell(
                    arch, cell.name, False, microbatches=1, cell=cell,
                    mesh_shape=(1, 1), cfg=cfg,
                    device=None if dev.type == "cuda" else dev)
            trace_wall = time.perf_counter() - t0
            check(fake.unknown_trip_loops == 0,
                  f"{arch}: {fake.unknown_trip_loops} loops not scaled")
            store = tempfile.mkdtemp(prefix="repro_dryrun_pg_", dir=tmp)
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"file://{store}/store", rank=0, world_size=1)
            try:
                mesh = mesh_mod.make_test_mesh(
                    1, 1, device=None if dev.type == "cuda" else dev)
                params = tfm.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev)
                opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
                p, o = steps.shard_train_state(cfg, mesh, params, opt)
                del params, opt
                step = steps.make_train_step(cfg, mesh, microbatches=1)
                # on the card before the steps, as the trace's batch is
                batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                            batch_for(cfg, i, TRAIN_B, TRAIN_S).items()}
                           for i in range(3)]
                reg.reset_launches()
                p, o, m = step(p, o, batches[0], 0)
                float(m["loss"])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                p, o, m = step(p, o, batches[1], 1)
                float(m["loss"])
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - t1
                peak = torch.cuda.max_memory_allocated()
                t1 = time.perf_counter()
                (p, o, m), real = hlo_analysis.analyze(step, p, o,
                                                       batches[2], 2)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                analyzed_s = time.perf_counter() - t1
                launches = reg.launch_counts()
            finally:
                dist.destroy_process_group()
            want = dict.fromkeys(reg.KERNELS, 0)
            want[kernel] = 2 * cfg.n_layers * 3
            check(launches == want, f"{arch}: the real steps launched "
                  f"{launches}; expected {want}")
            check(math.isfinite(loss), f"{arch}: the analyzed step's loss "
                  f"is {loss}")
            diff = {op: (fake.by_op.get(op), real.by_op.get(op))
                    for op in set(fake.by_op) | set(real.by_op)
                    if fake.by_op.get(op) != real.by_op.get(op)}
            check(fake.flops == real.flops
                  and fake.hbm_bytes == real.hbm_bytes,
                  f"{arch}: the trace counts {fake.flops!r} FLOPs and "
                  f"{fake.hbm_bytes!r} bytes, the real step "
                  f"{real.flops!r} and {real.hbm_bytes!r}; ops that differ "
                  f"(trace, real): {diff}")
            ratio = fake.peak_bytes / peak
            check(abs(ratio - 1.0) <= DRYRUN_PEAK_TOL,
                  f"{arch}: the traced peak {fake.peak_bytes / 2**30:.3f} "
                  f"GiB is {ratio:.3f}x the real step's "
                  f"{peak / 2**30:.3f} GiB")
            for k, v in launches.items():
                main_launches[k] += v
            terms = dryrun.roofline_terms(fake.flops, fake.hbm_bytes,
                                          fake.coll_bytes)
            roof = max(terms["compute_s"], terms["memory_s"])
            r = dict(
                n_layers=cfg.n_layers, batch=[TRAIN_B, TRAIN_S],
                flops=fake.flops, hbm_bytes=fake.hbm_bytes,
                coll_by_op=dict(fake.coll_by_op),
                flop_counter_flops=fake.flop_counter_flops,
                kernels=fake.kernels, traced_peak_gib=fake.peak_bytes / 2**30,
                traced_arg_gib=fake.arg_bytes / 2**30,
                real_peak_gib=peak / 2**30, peak_ratio=ratio,
                real_analyzed_peak_gib=real.peak_bytes / 2**30,
                trace_s=meta["trace_s"], trace_wall_s=trace_wall,
                warm_step_s=warm_s, analyzed_step_s=analyzed_s,
                compute_s=terms["compute_s"], memory_s=terms["memory_s"],
                roofline_s=roof, warm_over_roofline=warm_s / roof,
                launches={k: v for k, v in launches.items() if v},
                top_ops=sorted(([op, t["bytes"], t["flops"], t["calls"]]
                                for op, t in fake.by_op.items()),
                               key=lambda x: -x[1])[:8])
            out["steps"][arch] = r
            print(f"dryrun (b): {arch} ({cfg.n_layers} layers) "
                  f"{TRAIN_B}x{TRAIN_S}, one microbatch: traced on a "
                  f"one-rank fake mesh in {meta['trace_s']} s "
                  f"({trace_wall:.1f} s with set-up), {fake.flops:.6e} FLOPs "
                  f"and {fake.hbm_bytes:.6e} bytes, equal to the real "
                  f"step's under analyze ({analyzed_s:.2f} s); traced peak "
                  f"{r['traced_peak_gib']:.3f} GiB (arguments "
                  f"{r['traced_arg_gib']:.3f}) against the warm step's "
                  f"{r['real_peak_gib']:.3f} GiB ({ratio:.4f}x); launches "
                  f"{r['launches']}", flush=True)
            print(f"dryrun (c): {arch}: compute_s {terms['compute_s']:.5f}, "
                  f"memory_s {terms['memory_s']:.5f} (flops at "
                  f"{dryrun.PEAK_FLOPS:.3g}/s, bytes at "
                  f"{dryrun.HBM_BW:.3g}/s); the warm step {warm_s:.4f} s, "
                  f"{warm_s / roof:.2f}x the larger", flush=True)
            del p, o, m, step, real, fake
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out["hbm_per_chip"] = hbm
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dryrun phase took {out['phase_s']:.1f} s", flush=True)
    return main_launches, out


#: phase 17: tensor and expert parallelism over "model".  (b) flash at a
#: rank's shape of yi_9b at tp = 16 (H 32, KV 4: the expansion's 2 heads
#: a rank), (B, H, KV, S, Dh); (c) the dispatch at a rank's shape of
#: moonshot at tp = 16: 4 of the 64 experts (rank 5's, [20, 24))
TP_FLASH_SHAPE = (4, 2, 2, 1024, 128)
TP_MOE = dict(T=4096, D=2048, k=6, E=64, tp=16, rank=5)
#: (c)'s dispatch and ``index_put_`` are each the median of this many
#: timed runs
TP_TIMED_RUNS = 7
#: (d): the train cells dry-run on the card's fake tensors, beside the GiB
#: a rank on (16, 16) / (2, 16, 16) of the step that gathered every weight
#: whole (PERF.md section 5); TP_DRYRUN_CPU's cell also on the CPU's, the
#: two records equal, as phase 16 (a) holds its own cell.  yi_9b's and
#: mistral_nemo_12b's cells (PR 30's records in PERF.md section 5) are
#: left out since phase 18, to keep the script inside its time
TP_DRYRUN_ARCHS = {"moonshot_v1_16b_a3b": (281.9, 281.9),
                   "gemma2_2b": (111.3, 63.1)}
TP_DRYRUN_CPU = (("gemma2_2b", "pod1"),)
#: (e): a tensor-parallel world of TP_WORLD processes on the one card
#: (gloo: NCCL takes one rank a device), (arch, layers) at full width in
#: float32, TP_B x TP_S tokens and TP_GEN greedy tokens; the rank's
#: pieces against the whole weights in the same process within TP_TOL
#: (float32 sums in another order, relative to the largest magnitude);
#: those sums may decide a near tie of the router the other way, so a
#: routing table's tokens whose experts differ from the whole run's are
#: at most TP_ROUTE_FLIPS of its tokens, and every model rank's tables
#: are bitwise alike
TP_WORLD = 2
#: gemma2_2b's tensor-parallel path runs in phase 18 (b)'s world (with
#: ``fsdp``, through the real mesh-bound steps), so this one holds the
#: expert-parallel MoE layer alone
TP_WORLD_ARCHS = (("moonshot_v1_16b_a3b", 2),)
TP_B, TP_S, TP_GEN = 2, 1024, 4
TP_TOL = 1e-4
TP_ROUTE_FLIPS = 1e-2
TP_WORLD_TIMEOUT_S = 300


def dispatch_cost(torch, x, ve, pos, E, C, runs: int = 1):
    """The dispatch's least bytes on these inputs and one library call's
    time: the rows of ``x`` that a kept slot reads (each read once), both
    (T, k) tables read once and the (E, C, D) buffer written once, no
    arithmetic; the library call is ``index_put_`` of the kept slots' rows
    into a zeroed buffer (no slot is written twice, so no
    ``accumulate``).  Returns (bytes, rows read, the library call's ms in
    each of ``runs`` timed runs, the library call's buffer)."""
    keep = ve >= 0
    rows = int(keep.any(-1).sum())
    D, size = x.shape[1], x.element_size()
    nbytes = rows * D * size + 2 * ve.numel() * 4 + E * C * D * size
    flat = (ve.long() * C + pos.long())[keep]
    src = x[torch.nonzero(keep)[:, 0]]

    def library():
        return torch.zeros((E * C, D), dtype=x.dtype,
                           device=x.device).index_put_((flat,), src)

    lib_ms = [cuda_time_ms(lambda i: library(), 20, torch)
              for _ in range(runs)]
    return nbytes, rows, lib_ms, library().reshape(E, C, D)


def rank_pieces(params, cfg, mesh, rank: int):
    """The plain tensors of ``params`` that ``"model"`` rank ``rank`` of
    ``mesh`` holds: each leaf's block of the dim the rules
    (``sharding.param_shardings``) split over ``"model"``, as a DTensor
    ``Shard`` takes it, else the whole leaf."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm

    specs = shd.param_shardings(params, cfg, mesh)
    i = list(mesh.mesh_dim_names).index("model")
    tp = mesh.shape[i]

    def piece(path, leaf):
        node = specs
        for k in path:
            node = node[int(k)] if isinstance(node, (tuple, list)) \
                else node[k]
        pl = shd.placements(node, mesh)[i]
        if not pl.is_shard():
            return leaf
        return leaf.chunk(tp, pl.dim)[rank].contiguous()

    return tfm.tree_unflatten(params, [piece(path, leaf) for path, leaf
                                       in tfm.tree_items(params)])


def tp_world_rank(torch, rank: int, world: int, store: str, path: str,
                  device: str = "cuda") -> int:
    """One rank of phase 17 (e) (``chip_smoke.py --tp-rank``): a gloo
    world of ``world`` processes on the one card as a (1, world)
    ``("data", "model")`` mesh.  For each of ``TP_WORLD_ARCHS`` in
    float32, the same seed-0 weights run twice under the mesh-bound steps'
    hints: whole (the model replicated over ``"model"``, as the steps run
    RWKV6) and as this rank's pieces (tensor and expert parallelism, the
    launch counts zeroed just before and read just after).  Each run takes
    ``loss_fn``'s value and gradient on ``TP_B`` x ``TP_S`` tokens (the
    train step's core: the vocab-parallel embedding and cross-entropy,
    ``attn_apply`` on the rank's heads through the flash kernel,
    ``mlp_apply``'s column and row pieces, ``moe_apply`` through the
    dispatch kernel on the rank's experts), then ``make_prefill_step``
    and ``TP_GEN - 1`` ``make_serve_step`` calls (greedy ids over the
    vocab shards).  Writes the losses, each leaf's gradient error (the
    piece against the whole gradient's block), the prefill logits' error,
    the ids, the routing tables' differences from the whole run's and
    their digests, and the launches to ``path``
    (``device`` "cpu" rehearses it on the CPU, the kernels' twins
    standing in)."""
    import datetime
    import hashlib

    import torch.distributed as dist

    from repro_torch.configs import base as cb
    from repro_torch.core import balance, prng
    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import registry
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fa.build()
        md.build()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    # every MoE layer's routing table (one data shard: ``balance.route``),
    # tagged with the stage that routed it
    tables, stage, route = [], ["train"], balance.route

    def record(*a, **kw):
        res = route(*a, **kw)
        tables.append((stage[0], torch.stack([res.expert, res.pos])))
        return res

    balance.route = record
    try:
        mesh = mesh_mod.make_test_mesh(1, world, device=dev.type)
        r_model = mesh.get_local_rank("model")
        for arch, n_layers in TP_WORLD_ARCHS:
            cfg = dataclasses.replace(
                cb.get(arch), n_layers=n_layers, param_dtype="float32",
                compute_dtype="float32")
            params = tfm.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     batch_for(cfg, 0, TP_B, TP_S).items()}
            rng = prng.fold_in(prng.PRNGKey(17), 0)
            max_len = TP_S + TP_GEN
            runs = {}
            for kind, tp_on in (("whole", False), ("tp", True)):
                tree = rank_pieces(params, cfg, mesh, r_model) if tp_on \
                    else params
                tree = tfm.tree_unflatten(params, [
                    p.detach() for p in tfm.tree_leaves(tree)])
                tree.requires_grad_(True)
                leaves = tfm.tree_leaves(tree)
                sync()
                registry.reset_launches()
                stage[0] = "train"
                with steps._hints(mesh, tp=tp_on):
                    _, metrics = tfm.loss_fn(tree, cfg, batch, rng,
                                             ep_groups=world, dp_groups=1)
                    # the train step's share of the loss (one data shard)
                    share = metrics["ce"] + 0.01 * metrics["lb_loss"]
                    grads = torch.autograd.grad(share, leaves)
                pieces = [g.detach() for g in grads]
                del grads, leaves
                tree = tfm.tree_map(torch.Tensor.detach, tree)
                stage[0] = "prefill"
                logits, state = steps.make_prefill_step(cfg, mesh, max_len)(
                    tree, batch) if tp_on else _whole_prefill(
                        steps, tfm, cfg, mesh, tree, batch, max_len)
                logits = logits.to_local() if hasattr(
                    logits, "to_local") else logits
                tok = torch.argmax(logits, -1).to(torch.int32)
                ids = [tok]
                serve = steps.make_serve_step(cfg, mesh, TP_B, max_len) \
                    if tp_on else None
                stage[0] = "decode"
                for _ in range(TP_GEN - 1):
                    if tp_on:
                        tok, state = serve(tree, state, tok)
                        ids.append(tok.to_local())
                    else:
                        with torch.no_grad(), steps._hints(mesh):
                            lg, state = tfm.decode_step(
                                tree, cfg, state, tok, ep_groups=world,
                                dp_groups=1)
                        tok = torch.argmax(lg, -1).to(torch.int32)
                        ids.append(tok)
                sync()
                runs[kind] = dict(
                    loss=float(share.detach()),
                    ce=float(metrics["ce"].detach()),
                    lb_loss=float(metrics["lb_loss"].detach()), grads=pieces,
                    logits=logits.float(), ids=torch.stack(ids, 1),
                    tables=list(tables), launches=registry.launch_counts())
                del tables[:], tree, state
            whole, tp = runs["whole"], runs["tp"]
            want = tfm.tree_leaves(rank_pieces(tfm.tree_unflatten(
                params, whole["grads"]), cfg, mesh, r_model))
            grad_err = max(
                float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for g, w in zip(tp["grads"], want))
            logit_err = float((tp["logits"] - whole["logits"]).abs().max()
                              ) / float(whole["logits"].abs().max())
            out[arch] = dict(
                n_layers=n_layers, loss=[tp["loss"], whole["loss"]],
                loss_err=abs(tp["loss"] - whole["loss"]) / abs(whole["loss"]),
                ce=[tp["ce"], whole["ce"]],
                lb_loss=[tp["lb_loss"], whole["lb_loss"]],
                grad_err=grad_err, logit_err=logit_err,
                ids_equal=bool(torch.equal(tp["ids"], whole["ids"])),
                n_tables=[len(tp["tables"]), len(whole["tables"])],
                # the tables that differ from the whole run's: (index,
                # stage, tokens whose experts differ, tokens, entries
                # apart)
                tables_diff=[[i, a[0], int((a[1][0] != b[1][0]).any(
                    -1).sum()), a[1].shape[1], int((a[1] != b[1]).sum())]
                    for i, (a, b) in enumerate(zip(tp["tables"],
                                                   whole["tables"]))
                    if not torch.equal(a[1], b[1])],
                # every model rank routes alike: its tables' digests
                table_digest=[hashlib.sha1(t.cpu().numpy().tobytes()
                                           ).hexdigest()
                              for _, t in tp["tables"]],
                launches={k: v for k, v in tp["launches"].items() if v},
                whole_launches={k: v for k, v in whole["launches"].items()
                                if v},
                split_leaves=sum(g.numel() != w.numel() for g, w in zip(
                    tp["grads"], whole["grads"])),
                leaves=len(want))
            del runs, whole, tp, want, params, batch
            torch.cuda.empty_cache()
    finally:
        balance.route = route
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def _whole_prefill(steps, tfm, cfg, mesh, params, batch, max_len):
    """The whole-weight prefill under the steps' hints (the model
    replicated over ``"model"``): logits and the state of every head."""
    import torch

    with torch.no_grad(), steps._hints(mesh):
        return tfm.prefill(params, cfg, batch, max_len,
                           ep_groups=steps.tp_size(mesh), dp_groups=1)


def tp_world(torch, reg):
    """Phase 17 (e): ``TP_WORLD`` rank processes (:func:`tp_world_rank`)
    on the one card; each must exit 0 within ``TP_WORLD_TIMEOUT_S`` and
    hold its pieces to the whole weights: loss, every leaf's gradient and
    the prefill logits within ``TP_TOL``, the greedy ids equal, every
    rank's routing tables alike and at most ``TP_ROUTE_FLIPS`` of a
    table's tokens routed to other experts than in the whole run (a near
    tie), and the same kernels launched as many times as the whole
    run, flash on every rank and the dispatch wherever the config has MoE
    layers (:func:`tp_world_check`).  Returns (the launches of rank 0's
    tensor-parallel runs by kernel, report)."""
    import shutil

    ranks, tmp = spawn_world("--tp-rank", TP_WORLD, "tp (e)")
    shutil.rmtree(tmp, ignore_errors=True)
    return tp_world_check(ranks, reg)


def tp_world_check(ranks: list, reg):
    """(e)'s gates over every rank's results; returns (the launches of
    rank 0's tensor-parallel runs by kernel, report)."""
    from repro_torch.configs import base as cb
    from repro_torch.models import transformer as tfm

    launches = dict.fromkeys(reg.KERNELS, 0)
    for arch, n_layers in TP_WORLD_ARCHS:
        cfg = dataclasses.replace(cb.get(arch), n_layers=n_layers)
        has_moe = any(k.moe for k in tfm.pattern(cfg))
        for r, res in enumerate(ranks):
            a = res[arch]
            for key in ("loss_err", "grad_err", "logit_err"):
                check(a[key] <= TP_TOL, f"tp (e): {arch} rank {r}: {key} "
                      f"{a[key]:.3g} above {TP_TOL}")
            flips = max((d[2] / d[3] for d in a["tables_diff"]),
                        default=0.0)
            check(a["ids_equal"] and a["n_tables"][0] == a["n_tables"][1]
                  and flips <= TP_ROUTE_FLIPS
                  and a["table_digest"] == ranks[0][arch]["table_digest"],
                  f"tp (e): {arch} rank {r}: ids equal {a['ids_equal']}; "
                  f"routing tables {a['n_tables']}, apart from the whole "
                  f"run's {a['tables_diff']}, alike across ranks "
                  f"{a['table_digest'] == ranks[0][arch]['table_digest']}")
            check(a["launches"] == a["whole_launches"]
                  and a["launches"].get("flash_attention", 0) > 0
                  and (a["launches"].get("moe_dispatch", 0) > 0) == has_moe,
                  f"tp (e): {arch} rank {r}: launches {a['launches']}, the "
                  f"whole run's {a['whole_launches']}")
            check(a["split_leaves"] > 0, f"tp (e): {arch} rank {r}: no "
                  "leaf was split over \"model\"")
        a = ranks[0][arch]
        for k, v in a["launches"].items():
            launches[k] += v
        print(f"tp (e): {arch} ({n_layers} layers, float32, {TP_B}x{TP_S}) "
              f"on a (1, {TP_WORLD}) gloo world of {TP_WORLD} processes on "
              f"the card: {a['split_leaves']} of {a['leaves']} leaves split;"
              f" loss {a['loss'][0]:.6f} against {a['loss'][1]:.6f} whole; "
              f"largest errors (rank 0 / 1) loss "
              f"{ranks[0][arch]['loss_err']:.3g} / "
              f"{ranks[-1][arch]['loss_err']:.3g}, gradient "
              f"{ranks[0][arch]['grad_err']:.3g} / "
              f"{ranks[-1][arch]['grad_err']:.3g}, prefill logits "
              f"{ranks[0][arch]['logit_err']:.3g} / "
              f"{ranks[-1][arch]['logit_err']:.3g} (<= {TP_TOL}); "
              f"{TP_GEN} greedy ids equal; {a['n_tables'][0]} routing "
              f"tables, every rank's alike, apart from the whole run's "
              f"(index, stage, tokens of other experts, tokens, entries): "
              f"{a['tables_diff']}; launches {a['launches']} a rank",
              flush=True)
    return launches, dict(ranks=ranks, world=TP_WORLD, tol=TP_TOL,
                          route_flips=TP_ROUTE_FLIPS)


def train_cells(archs, cpu) -> list:
    """The :class:`Dryruns` cells of ``train_4k`` of each ``archs`` config
    on both meshes on the card's fake tensors, and the ``cpu`` cells
    (``(arch, mesh)``) again on the CPU's (phase 17 (d), phase 18
    (a))."""
    return [(arch, "train_4k", mp, "cuda") for arch in archs
            for mp in ("pod1", "pod2")] + [
        (arch, "train_4k", mp, "cpu") for arch, mp in cpu]


class Dryruns:
    """The dry-run of each cell ``(arch, shape, mesh, device)``, the card's
    fake tensors or the CPU's, one subprocess each (one thread), all
    started together, the longest first (phases 17 (d), 18 (a) and 19
    (a)); :meth:`wait` reads the records (each process must exit 0),
    :meth:`stop` kills any still running and removes the records."""

    def __init__(self, cells):
        import os
        import tempfile

        self.dir = Path(tempfile.mkdtemp(prefix="repro_dryrun_"))
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        self.procs = {}
        for arch, shape, mp, device in cells:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--force",
                    "--out", str(self.dir / device)]
            argv += (["--multi-pod"] if mp == "pod2" else []) + (
                ["--device", "cpu"] if device == "cpu" else [])
            # below the card's worlds in the host's scheduler
            self.procs[(arch, shape, mp, device)] = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=ROOT, env=env,
                preexec_fn=lambda: os.nice(10))

    def wait(self, timeout_s: float) -> dict:
        """``{(arch, mesh, device): record}`` once every process exits."""
        t0 = time.perf_counter()
        records = {}
        for key, proc in self.procs.items():
            try:
                log, _ = proc.communicate(timeout=max(
                    1.0, timeout_s - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"the dry-run of {key} passed "
                                   f"{timeout_s} s")
            check(proc.returncode == 0, f"the dry-run of {key} failed (rc "
                  f"{proc.returncode}): {log[-3000:]}")
            arch, shape, mp, device = key
            with open(self.dir / device / f"{arch}__{shape}__{mp}.json") \
                    as f:
                records[key] = json.load(f)
        return records

    def stop(self) -> None:
        import shutil

        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_records(records, archs, label, before) -> dict:
    """The ``train_4k`` records of :class:`Dryruns` by ``arch/mesh``, each
    without an error and, where the CPU traced it too, equal to the CPU's
    in every count; printed beside the GiB a rank ``archs`` gives for the
    step before (``before`` says what it did; None: it refused the
    cell)."""
    out = {}
    for arch, was_both in archs.items():
        for mp, was in zip(("pod1", "pod2"), was_both):
            a = records[(arch, "train_4k", mp, "cuda")]
            c = records.get((arch, "train_4k", mp, "cpu"))
            diff = [k for k in DRYRUN_COUNTS
                    if c is not None and a.get(k) != c.get(k)]
            check("error" not in a and not diff,
                  f"{arch} train_4k {mp}: the card's and the CPU's "
                  f"records differ in {diff} ({a.get('error')})")
            gib = a["memory_per_device_bytes"] / 2**30
            out[f"{arch}/{mp}"] = dict(
                gib=gib, before_gib=was, fits_hbm=a["fits_hbm"],
                mesh=a["mesh"], trace_s=a["trace_s"],
                cpu_trace_s=c and c["trace_s"],
                microbatches=a["microbatches"], probes=a.get("probes"),
                hlo_flops_per_dev=a["hlo_flops_per_dev"],
                hlo_hbm_bytes_per_dev=a["hlo_hbm_bytes_per_dev"],
                state_bytes_per_dev=a["state_bytes_per_dev"],
                coll_by_op=a["coll_by_op"],
                useful_flops_ratio=a["useful_flops_ratio"],
                compute_s=a["compute_s"], memory_s=a["memory_s"],
                collective_s=a["collective_s"], dominant=a["dominant"])
            held = (f"the card's and the CPU's records equal (traced in "
                    f"{a['trace_s']} / {c['trace_s']} s)" if c else
                    f"traced in {a['trace_s']} s")
            print(f"{label}: {arch} train_4k on {a['mesh']}: {gib:.2f} GiB "
                  f"a rank ({before}: "
                  f"{'refused' if was is None else f'{was} GiB'}), "
                  f"fits_hbm {a['fits_hbm']}; useful FLOPs "
                  f"{a['useful_flops_ratio']:.4f}; {held}", flush=True)
    return out


def tp_phase(torch, dev, reg, sharded, later: dict, beside=None):
    """Phase 17: (a) phase 15 (a)'s one-rank mesh steps (gemma2_2b,
    moonshot at 4 layers) already ran this slice's code at tp = 1, where
    the region is the identity, bitwise the one-device step (``sharded``,
    phase 15's report; not run again); (b) flash at a tp = 16 rank's shape
    of yi_9b against its twin; (c) the dispatch into a tp = 16 rank's 4
    experts of moonshot, bitwise its twin; then, with nothing timed, (e)
    a tp = 2 world of processes runs the model's tensor-parallel path on
    the card (:func:`tp_world`), then ``beside()`` (phase 18 (b) and (c);
    its result in ``later["beside"]``), and (d)'s train cells' dry-runs
    (:class:`Dryruns`, started before phase 13: ``later["tp_dryruns"]``)
    are read: the card's fake tensors, one cell also on the CPU's, those
    records equal.
    Returns ((e)'s rank 0 launches by kernel, report)."""
    from repro_torch.configs import base as cb
    from repro_torch.core import balance
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref as kref
    from repro_torch.models import moe

    out = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    # (a) phase 15 (a): the one-rank mesh steps of this code, bitwise
    out["one_rank"] = {}
    for arch, r in sharded["train"].items():
        check(r["bitwise"], f"{arch}: phase 15's one-rank mesh step was "
              "not bitwise the one-device step")
        out["one_rank"][arch] = {k: r[k] for k in (
            "n_layers", "warm_step_s", "launches", "bitwise")}
        print(f"tp (a): {arch} ({r['n_layers']} layers) on the (1, 1) mesh "
              f"(phase 15 (a), the tensor-parallel code at tp = 1): "
              f"bitwise the one-device step; launches {r['launches']}; "
              f"warm step {r['warm_step_s']['mesh']:.4f} s mesh / "
              f"{r['warm_step_s']['one_device']:.4f} s one-device",
              flush=True)

    # (b) flash at a tp = 16 rank's shape of yi_9b
    b, h, kv, s, dh = TP_FLASH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn((b, n, s, dh), generator=gen, device=dev
                           ).to(torch.bfloat16) for n in (h, kv, kv))
    got = fa.flash_attention(q, k, v, causal=True)
    want = kref.flash_attention(q, k, v, True, 0, None)
    err = float((got.float() - want.float()).abs().max())
    check(err <= FLASH_TOL["bfloat16"],
          f"flash at yi_9b's tp=16 rank shape: max abs err {err}")
    timed = flash_time(torch, dev, "yi_9b's tp=16 rank", TP_FLASH_SHAPE,
                       causal=True)
    out["flash"] = dict(timed, shape=list(TP_FLASH_SHAPE), max_abs_err=err)
    print(f"tp (b): flash at yi_9b's tp=16 rank shape {b}x{h}/{kv}x{s}"
          f"x{dh} bf16: max abs err {err:.3g} against the twin (<= "
          f"{FLASH_TOL['bfloat16']})", flush=True)
    del q, k, v, got, want

    # (c) the dispatch into a tp = 16 rank's experts of moonshot
    cfg = cb.get("moonshot_v1_16b_a3b")
    T, D, kk, E = (TP_MOE[key] for key in ("T", "D", "k", "E"))
    n_loc = E // TP_MOE["tp"]
    experts = (TP_MOE["rank"] * n_loc, n_loc)
    C = moe.capacity_for(cfg, T)
    gen = torch.Generator(device=dev).manual_seed(17)
    x, ve, pos = moe_inputs(torch, balance, T, D, kk, E, C, "bfloat16", 1,
                            gen, dev)
    e_loc = moe.local_experts(ve, experts)
    got = md.moe_dispatch(x, e_loc, pos, n_experts=n_loc, capacity=C)
    want = kref.moe_dispatch(x, e_loc, pos, n_loc, C)
    torch.cuda.synchronize()
    check(got.shape == (n_loc, C, D) and torch.equal(got, want),
          "the dispatch at moonshot's tp=16 rank shape differs from its "
          "twin")
    kept = int((e_loc >= 0).sum())
    # a launch-bound call whose times spread between runs: the median of
    # TP_TIMED_RUNS timed runs of each
    runs = [cuda_time_ms(lambda i: md.moe_dispatch(
        x, e_loc, pos, n_experts=n_loc, capacity=C), 50, torch)
        for _ in range(TP_TIMED_RUNS)]
    ms = statistics.median(runs)
    plain_ms = cuda_time_ms(lambda i: kref.moe_dispatch(
        x, e_loc, pos, n_loc, C), 20, torch)
    nbytes, rows, lib_runs, lib = dispatch_cost(
        torch, x, e_loc, pos, n_loc, C, runs=TP_TIMED_RUNS)
    lib_ms = statistics.median(lib_runs)
    bnd, by = bound_ms(nbytes, 0)
    calls = dispatch_calls(torch, lambda: md.moe_dispatch(
        x, e_loc, pos, n_experts=n_loc, capacity=C), 20,
        MOE_HOST_CALLS["tp"])
    out["dispatch"] = dict(T=T, D=D, k=kk, experts=list(experts),
                           capacity=C, kept_slots=kept, rows_read=rows,
                           ms=ms, ms_runs=runs, library_ms_runs=lib_runs,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           library_same=bool(torch.equal(lib, want)),
                           bytes=nbytes, bound_ms=bnd, bound_by=by,
                           bitwise=True, calls=calls)
    print(f"tp (c): moe_dispatch at moonshot's tp=16 rank shape, T={T} "
          f"D={D} k={kk} into experts [{experts[0]}, {experts[0] + n_loc})"
          f" x {C} bf16 ({kept} of {e_loc.numel()} slots kept, {rows} rows"
          f" of x read): bitwise the twin; {ms:.4f} ms a call (the "
          f"median of {TP_TIMED_RUNS} runs: {[round(t, 4) for t in runs]})"
          f" "
          f"({ms / bnd:.2f}x its bound {bnd:.5f} ms by {by}, {nbytes} "
          f"bytes), twin {plain_ms:.4f} ms, index_put_ of the kept rows "
          f"{lib_ms:.4f} ms (median of "
          f"{[round(t, 4) for t in lib_runs]}; equal to the twin's buffer: "
          f"{out['dispatch']['library_same']}); a call: "
          f"{calls['ops_per_call']:g} CUDA operations ({calls['ops']}),"
          f" device {fmt_us(calls['device_us'])}, the "
          f"wrapper's host "
          f"{calls['host_us']:.2f} us", flush=True)
    del x, ve, pos, e_loc, got, want, lib
    torch.cuda.empty_cache()

    # (d) the train cells' dry-run traces (started before phase 13 with
    # phases 18 (a)'s and 19 (a)'s: ``later["tp_dryruns"]``); (e) the
    # tensor-parallel world, then ``beside`` (phase 18 (b) and (c)), and
    # (d)'s records read (nothing in any is timed)
    t_d = time.perf_counter()
    dryruns = later["tp_dryruns"]
    try:
        launches, out["world"] = tp_world(torch, reg)
        out["world_s"] = time.perf_counter() - t_d
        if beside is not None:
            later["beside"] = beside()
        records = dryruns.wait(420)
    finally:
        dryruns.stop()
    out["dryrun_s"] = time.perf_counter() - t_d
    out["dryrun"] = dryrun_records(records, TP_DRYRUN_ARCHS, "tp (d)",
                                   "every weight gathered")
    print(f"tp (d), (e): the tp = 2 world ({out['world_s']:.1f} s), then "
          f"phase 18 (b), (c), then {len(records)} dry-runs read, in "
          f"{out['dryrun_s']:.1f} s", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"tp phase took {out['phase_s']:.1f} s", flush=True)
    return launches, out


#: phase 18: FSDP's per-layer gathers over "data".  (a) ``train_4k`` of
#: the two FSDP configs dry-run on both meshes on the card's fake tensors,
#: beside the GiB a rank of the step that gathered every FSDP leaf whole
#: over "data" (PERF.md section 5, PR 30; None: it refused the cell, fault
#: F6); FSDP_DRYRUN_CPU's cell (F6's) also on the CPU's, the records equal
FSDP_DRYRUN_ARCHS = {"llama4_maverick_400b_a17b": (255.3, 255.3),
                     "nemotron_4_340b": (186.6, None)}
FSDP_DRYRUN_CPU = (("nemotron_4_340b", "pod2"),)
#: (b) a (data, model) world of FSDP_WORLD processes on the one card:
#: FSDP_ARCH with ``fsdp`` at full width, FSDP_LAYERS layers, float32;
#: FSDP_STEPS train steps (of FSDP_TOTAL: the first at the warmup's
#: learning rate 0) with 1 and 2 microbatches of FSDP_B x FSDP_S tokens,
#: then a prefill and FSDP_GEN - 1 greedy decode steps, against the whole
#: weights in one process within TP_TOL
FSDP_WORLD = (2, 2)
FSDP_ARCH, FSDP_LAYERS = "gemma2_2b", 2
FSDP_B, FSDP_S, FSDP_STEPS, FSDP_TOTAL, FSDP_GEN = 4, 256, 2, 20, 5
#: (c) nemotron_4_340b at full width, 1 layer, bf16: a prefill of B x S
#: tokens on a data = ``world`` world of processes against one process's
#: prefill of the same weights, logits within ``tol`` of the largest
FSDP_BIG = dict(arch="nemotron_4_340b", layers=1, B=2, S=512, world=2,
                tol=2e-2)
#: phase 19: the KV caches' sequence split.  (a) decode cells dry-run on
#: the card's fake tensors and on the CPU's, the records equal, beside the
#: GiB a rank of the step that kept the rank's heads' caches whole
#: (PERF.md section 5, in brackets)
SEQ_DRYRUN_CELLS = {("nemotron_4_340b", "decode_32k"): 60.83,
                    ("llama4_maverick_400b_a17b", "decode_32k"): 32.10,
                    ("gemma2_2b", "long_500k"): 28.7}
#: (b) in phase 18 (b)'s world: the caches' slots (a multiple of the
#: world's 4 ranks, so that a one-lane batch splits them over "data" and
#: "model" together), decode logits within SEQ_TOL of the whole weights'
#: (relative to the largest)
SEQ_SLOTS = 4 * -(-(FSDP_S + FSDP_GEN) // 4)
SEQ_TOL = 1e-5


def fsdp_world_cfg():
    from repro_torch.configs import base as cb

    return dataclasses.replace(cb.get(FSDP_ARCH), n_layers=FSDP_LAYERS,
                               param_dtype="float32",
                               compute_dtype="float32", fsdp=True)


def fsdp_big_cfg():
    from repro_torch.configs import base as cb

    return dataclasses.replace(cb.get(FSDP_BIG["arch"]),
                               n_layers=FSDP_BIG["layers"])


def mesh_piece(t, placements, mesh):
    """This rank's block of ``t`` (whole on every rank) under
    ``placements`` on ``mesh``, as a DTensor ``Shard`` takes it (several
    shards of one dim nested in mesh order)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            t = t.chunk(mesh.shape[i], pl.dim)[coord[i]]
    return t


def leaf_placements(tree, cfg, mesh) -> dict:
    """``{path: placements}`` of ``tree``'s leaves under the rules
    (``sharding.param_shardings``) on ``mesh``."""
    from repro_torch.launch import sharding as shd

    specs = shd.param_shardings(tree, cfg, mesh)
    out = {}
    for path, _ in shd._flatten_paths(tree):
        node = specs
        for k in path:
            node = node[int(k)] if isinstance(node, (tuple, list)) \
                else node[k]
        out[path] = shd.placements(node, mesh)
    return out


def local_dtensors(tree, cfg, mesh, piece=None):
    """``tree``'s leaves as DTensors of ``mesh`` under the rules'
    placements, each made from this rank's own block
    (``DTensor.from_local``: no collective), in a tree of dicts;
    ``piece(path, leaf, placements)`` makes the block (default: the
    block of the whole leaf)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as shd

    leaves = dict(shd._flatten_paths(tree))
    mapping = {}
    for path, pl in leaf_placements(tree, cfg, mesh).items():
        # a copy: the steps update their DTensors' blocks in place
        block = piece(path, pl) if piece else mesh_piece(
            leaves[path].detach(), pl, mesh).clone(
                memory_format=torch.contiguous_format)
        mapping[path] = DTensor.from_local(block, mesh, pl,
                                           run_check=False)
    return shd._rebuild(tree, mapping)


def _rel(got, want) -> float:
    """The largest difference relative to the largest of ``want`` (on
    ``got``'s device)."""
    got, want = got.float(), want.to(got.device).float()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def fsdp_world_rank(torch, rank: int, world: int, store: str, path: str,
                    device: str = "cuda") -> int:
    """One rank of phase 18 (b) (``chip_smoke.py --fsdp-rank``): a gloo
    world of ``world`` processes on the one card as the ``FSDP_WORLD``
    ``("data", "model")`` mesh.  The whole weights (seed 0, every rank
    makes them) first go through the one-device step, prefill and decode,
    two ranks at a time (two processes' memory at once); the rank keeps
    its blocks of the results.  Then its pieces, DTensors made from
    its own blocks, go through the mesh-bound train, prefill and serve
    steps (FSDP's leaves gathered over ``"data"`` a layer at a time, the
    rank's heads and vocabulary over ``"model"``; the moments in the
    parameters' layout, so nothing leaves a rank but the model's
    collectives), the launch counts zeroed just before and read just
    after.  Writes each step's loss and ``grad_norm`` beside the whole
    run's, the moments' and the prefill logits' largest errors (relative
    to each leaf's largest), whether the ids are equal, the launches and
    the split leaves to ``path`` (``device`` "cpu" rehearses it on the
    CPU, the twin standing in for flash)."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.data.pipeline import batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import registry
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import tensor_parallel as tpo
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWState, adamw_init

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fa.build()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    t0 = time.perf_counter()
    # phase 19 (b): the mesh-bound serve step's logits (gathered over a
    # vocabulary split over "model"), read where it takes its greedy ids
    greedy0, mesh_logits = tfm.greedy_ids, []

    def greedy(logits, c):
        vp = tfm.vocab_piece(c)
        mesh_logits.append(logits if vp is None else
                           tpo.gather_over_model(logits, vp[0].mesh))
        return greedy0(logits, c)

    def decode_whole(state, tok):
        """FSDP_GEN - 1 greedy steps of the whole weights: (ids, each
        step's logits)."""
        ids, lgs = [tok], []
        for _ in range(FSDP_GEN - 1):
            lg, state = tfm.decode_step(params, cfg, state, tok)
            tok = torch.argmax(lg, -1).to(torch.int32)
            ids.append(tok)
            lgs.append(lg)
        return torch.stack(ids, 1), torch.stack(lgs)

    try:
        mesh = mesh_mod.make_test_mesh(*FSDP_WORLD, device=dev.type)
        cfg = fsdp_world_cfg()
        params = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                    batch_for(cfg, i, FSDP_B, FSDP_S).items()}
                   for i in range(FSDP_STEPS)]
        max_len = SEQ_SLOTS
        dp = mesh_mod.dp_size(mesh)
        rows = slice(mesh_mod.dp_index(mesh) * FSDP_B // dp,
                     (mesh_mod.dp_index(mesh) + 1) * FSDP_B // dp)
        pl = list(leaf_placements(params, cfg, mesh).values())

        def blocks(tree):
            return [mesh_piece(t, p, mesh).clone()
                    for t, p in zip(tfm.tree_leaves(tree), pl)]

        # the whole weights in one process, two ranks at a time
        whole = {}
        for r in range(0, world, 2):
            if r <= rank < r + 2:
                for mb in (1, 2):
                    p = tfm.tree_map(torch.clone, params)
                    o = adamw_init(p)
                    step = steps.make_train_step(
                        cfg, dev, microbatches=mb, total_steps=FSDP_TOTAL)
                    for i, b in enumerate(batches):
                        p, o, m = step(p, o, b, i)
                        whole[(mb, i)] = dict(
                            loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]))
                    # the moments after the last step (each step's
                    # gradient is in them)
                    whole[mb] = dict(m=blocks(o.m), v=blocks(o.v))
                    del p, o, step
                with torch.no_grad():
                    logits, state = tfm.prefill(params, cfg, batches[0],
                                                max_len)
                    ids, lgs = decode_whole(state, torch.argmax(
                        logits, -1).to(torch.int32))
                    # phase 19 (b): the first lane alone, its prefill's
                    # state kept (decoding writes into the caches)
                    lg1, one = tfm.prefill(params, cfg, {
                        k: v[:1] for k, v in batches[0].items()}, max_len)
                    whole["one_state"] = tfm.DecodeState(
                        caches=tuple({k: v.clone() for k, v in c.items()}
                                     for c in one.caches),
                        length=one.length.clone())
                    whole["one_ids"], whole["one_logits"] = decode_whole(
                        one, torch.argmax(lg1, -1).to(torch.int32))
                whole["logits"] = logits[rows].clone()
                whole["ids"] = ids[rows]
                whole["decode_logits"] = lgs[:, rows].clone()
                del logits, state, lgs, ids, lg1, one
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
            dist.barrier()
        out["whole_s"] = time.perf_counter() - t0
        # this rank's pieces through the mesh-bound steps
        registry.reset_launches()
        errs = dict(loss=0.0, grad_norm=0.0, m=0.0, v=0.0)
        for mb in (1, 2):
            p = local_dtensors(params, cfg, mesh)
            zeros = tfm.tree_map(lambda d: DTensor.from_local(
                torch.zeros_like(d.to_local()), mesh, d.placements,
                run_check=False), p)
            o = AdamWState(DTensor.from_local(
                torch.zeros((), dtype=torch.int32, device=dev), mesh,
                [Replicate()] * mesh.ndim, run_check=False), zeros,
                tfm.tree_map(lambda d: DTensor.from_local(
                    torch.zeros_like(d.to_local()), mesh, d.placements,
                    run_check=False), p))
            step = steps.make_train_step(cfg, mesh, microbatches=mb,
                                         total_steps=FSDP_TOTAL)
            for i, b in enumerate(batches):
                p, o, m = step(p, o, b, i)
                w = whole[(mb, i)]
                for k in ("loss", "grad_norm"):
                    out[f"{k}/{mb}/{i}"] = [float(m[k]), w[k]]
                    errs[k] = max(errs[k], abs(float(m[k]) - w[k])
                                  / abs(w[k]))
            for part in ("m", "v"):
                errs[part] = max([errs[part]] + [
                    _rel(d.to_local(), want) for d, want in zip(
                        tfm.tree_leaves(getattr(o, part)), whole[mb][part])])
            del p, o, step
        out["train_s"] = time.perf_counter() - t0 - out["whole_s"]
        p = local_dtensors(params, cfg, mesh)
        logits, state = steps.make_prefill_step(cfg, mesh, max_len)(
            p, batches[0])
        logits = logits.to_local()
        tok = steps.rows_on_mesh(torch.argmax(logits, -1).to(torch.int32),
                                 mesh)
        ids = [tok.to_local()]
        serve = steps.make_serve_step(cfg, mesh, FSDP_B, max_len)
        tfm.greedy_ids = greedy
        try:
            for _ in range(FSDP_GEN - 1):
                tok, state = serve(p, state, tok)
                ids.append(tok.to_local())
            # phase 19 (b): one lane, every rank its block of the first
            # lane's whole state over ("data", "model")
            one = steps.shard_decode_state(cfg, mesh, whole["one_state"])
            one_ids = [whole["one_ids"][:, 0]]
            serve1 = steps.make_serve_step(cfg, mesh, 1, max_len)
            for _ in range(FSDP_GEN - 1):
                tok1, one = serve1(p, one, one_ids[-1])
                one_ids.append(tok1.to_local())
        finally:
            tfm.greedy_ids = greedy0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = registry.launch_counts()
        out["serve_s"] = time.perf_counter() - t0 - out["whole_s"] \
            - out["train_s"]
        errs["logits"] = _rel(logits, whole["logits"])
        n = FSDP_GEN - 1
        out["seq"] = dict(
            slots=[list(c["k"].shape) for c in state.caches],
            one_slots=[list(c["k"].shape) for c in one.caches],
            decode_logits=_rel(torch.stack(mesh_logits[:n]),
                               whole["decode_logits"]),
            one_logits=_rel(torch.stack(mesh_logits[n:]),
                            whole["one_logits"]),
            one_ids_equal=bool(torch.equal(torch.stack(one_ids, 1),
                                           whole["one_ids"])))
        leaves = tfm.tree_leaves(p)
        out.update(
            errs=errs, ids_equal=bool(torch.equal(
                torch.stack(ids, 1), whole["ids"])),
            launches={k: v for k, v in launches.items() if v},
            leaves=len(leaves),
            fsdp_leaves=sum(shd.fsdp_dim(d) is not None for d in leaves),
            both_leaves=sum(shd.fsdp_dim(d) is not None
                            and shd.is_model_split(d) for d in leaves),
            local_bytes=sum(d.to_local().numel() * d.element_size()
                            for d in leaves),
            whole_bytes=sum(d.numel() * d.element_size() for d in leaves))
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def seeded_block(torch, shape, dtype, seed: int, index, dev, *,
                 scale: float):
    """The block ``index`` (one slice a dim) of a random leaf of ``shape``
    without making the leaf: N(0, ``scale``^2) drawn in float32 in slabs
    of at most 2^27 elements along its first dim longer than 1, each slab
    from its own generator (``seed``, slab), so every block of a leaf is
    cut from the same whole tensor; zeros for ``scale`` 0."""
    block = tuple(s.indices(n) for s, n in zip(index, shape))
    out_shape = tuple(b - a for a, b, _ in block)
    if scale == 0:
        return torch.zeros(out_shape, dtype=dtype, device=dev)
    c = next(i for i, n in enumerate(shape) if n > 1)
    per = max(1, (1 << 27) // (math.prod(shape) // shape[c]))
    parts = []
    for k, lo in enumerate(range(0, shape[c], per)):
        hi = min(shape[c], lo + per)
        a, b = max(lo, block[c][0]), min(hi, block[c][1])
        if a >= b:
            continue
        gen = torch.Generator(device=dev).manual_seed(seed * 100_003 + k)
        slab = torch.randn(shape[:c] + (hi - lo,) + shape[c + 1:],
                           generator=gen, device=dev) * scale
        idx = [slice(x, y) for x, y, _ in block]
        idx[c] = slice(a - lo, b - lo)
        parts.append(slab[tuple(idx)].to(dtype))
        del slab
    return torch.cat(parts, c)


def _leaf_scale(path, shape) -> float:
    """The init scale of a leaf of ``FSDP_BIG``'s weights: the embedding
    N(0, 1), a norm scale (one dim but a stack's) 0, a weight (in, out)
    N(0, 1 / in)."""
    dims = shape[1:] if path[0] == "streams" else shape
    if path == ("embed",):
        return 1.0
    return 0.0 if len(dims) <= 1 else dims[-2] ** -0.5


def block_index(shape, placements, mesh) -> tuple:
    """The slices of this rank's block of a leaf of ``shape`` under
    ``placements`` (as :func:`mesh_piece` cuts it)."""
    coord = mesh.get_coordinate()
    lo, n = [0] * len(shape), list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n[pl.dim] //= mesh.shape[i]
            lo[pl.dim] += coord[i] * n[pl.dim]
    return tuple(slice(a, a + k) for a, k in zip(lo, n))


def fsdp_big_params(torch, cfg, mesh, dev):
    """``FSDP_BIG``'s weights: the whole leaves (``mesh`` None) or this
    rank's blocks as DTensors of ``mesh``, each cut from the same seeded
    whole leaf (:func:`seeded_block`), in trees of dicts."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import transformer as tfm

    meta = tfm.init_params(cfg, None, "meta")
    leaves = shd._flatten_paths(meta)
    seed = {path: i for i, (path, _) in enumerate(leaves)}
    shape = {path: tuple(leaf.shape) for path, leaf in leaves}
    dtype = {path: leaf.dtype for path, leaf in leaves}
    if mesh is None:
        return shd._rebuild(meta, {path: seeded_block(
            torch, shape[path], dtype[path], seed[path],
            tuple(slice(None) for _ in shape[path]), dev,
            scale=_leaf_scale(path, shape[path])) for path in shape})
    return local_dtensors(meta, cfg, mesh, piece=lambda path, pl: (
        seeded_block(torch, shape[path], dtype[path], seed[path],
                     block_index(shape[path], pl, mesh), dev,
                     scale=_leaf_scale(path, shape[path]))))


def fsdp_big_batch(torch, cfg, dev):
    from repro_torch.data.pipeline import batch_for

    return {k: torch.as_tensor(v, device=dev) for k, v in batch_for(
        cfg, 0, FSDP_BIG["B"], FSDP_BIG["S"]).items()}


def fsdp_big_rank(torch, rank: int, world: int, store: str, path: str,
                  device: str = "cuda") -> int:
    """One rank of phase 18 (c) (``chip_smoke.py --fsdp-big-rank``): a
    gloo world of ``world`` processes on the one card as a (``world``, 1)
    ``("data", "model")`` mesh; the rank's blocks of ``FSDP_BIG``'s
    seeded weights (FSDP's leaves split over ``"data"``) prefill its rows
    through ``make_prefill_step``, the launch counts and the peak memory
    zeroed just before and read just after.  Writes the rank's logits
    (``path`` + ``.pt``), its peak, launches and bytes held to ``path``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import registry
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        fa.build()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = mesh_mod.make_test_mesh(world, 1, device=dev.type)
        cfg = fsdp_big_cfg()
        p = fsdp_big_params(torch, cfg, mesh, dev)
        batch = fsdp_big_batch(torch, cfg, dev)
        leaves = tfm.tree_leaves(p)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        registry.reset_launches()
        logits, _ = steps.make_prefill_step(cfg, mesh, FSDP_BIG["S"])(
            p, batch)
        logits = logits.to_local()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out = dict(
            peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if dev.type == "cuda" else None),
            launches={k: v for k, v in registry.launch_counts().items()
                      if v},
            rows=[mesh_mod.dp_index(mesh) * logits.shape[0],
                  (mesh_mod.dp_index(mesh) + 1) * logits.shape[0]],
            fsdp_leaves=sum(shd.fsdp_dim(d) is not None for d in leaves),
            leaves=len(leaves),
            local_gib=sum(d.to_local().numel() * d.element_size()
                          for d in leaves) / 2**30)
        torch.save(logits.cpu(), path + ".pt")
    finally:
        dist.destroy_process_group()
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def spawn_world(flag: str, world: int, label: str) -> tuple:
    """``world`` processes of ``chip_smoke.py flag rank world store
    path`` on the one card (phases 17 (e), 18 (b) and (c)); each must
    exit 0 within ``TP_WORLD_TIMEOUT_S``.  Returns (each rank's JSON
    result, the directory of their files, which the caller removes)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_world_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         str(world), f"{tmp}/store", f"{tmp}/rank{r}.json"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(world)]
    try:
        logs = []
        for r, proc in enumerate(procs):
            try:
                log, _ = proc.communicate(timeout=max(
                    1.0, TP_WORLD_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{label}: rank {r} passed "
                                   f"{TP_WORLD_TIMEOUT_S} s")
            logs.append(log)
        for r, proc in enumerate(procs):
            check(proc.returncode == 0, f"{label}: rank {r} failed (rc "
                  f"{proc.returncode}): {logs[r][-4000:]}")
        ranks = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ranks, tmp


def fsdp_world(torch, reg):
    """Phase 18 (b): :func:`fsdp_world_rank` on every rank of the
    ``FSDP_WORLD`` mesh; every loss, ``grad_norm``, AdamW moment and the
    prefill logits within ``TP_TOL`` of the whole weights', the greedy
    ids equal, flash launched on every rank and the same count on each,
    and leaves split over both axes.  Returns (rank 0's launches by
    kernel, report)."""
    import shutil

    world = math.prod(FSDP_WORLD)
    ranks, tmp = spawn_world("--fsdp-rank", world, "fsdp (b)")
    shutil.rmtree(tmp, ignore_errors=True)
    for r, a in enumerate(ranks):
        for k, e in a["errs"].items():
            check(e <= TP_TOL, f"fsdp (b): rank {r}: {k} {e:.3g} above "
                  f"{TP_TOL}")
        check(a["ids_equal"], f"fsdp (b): rank {r}: greedy ids differ "
              "from the whole weights'")
        check(a["launches"].get("flash_attention", 0) > 0
              and a["launches"] == ranks[0]["launches"],
              f"fsdp (b): rank {r}: launches {a['launches']}, rank 0's "
              f"{ranks[0]['launches']}")
        check(a["both_leaves"] > 0, f"fsdp (b): rank {r}: no leaf split "
              "over both \"data\" and \"model\"")
    a = ranks[0]
    print(f"fsdp (b): {FSDP_ARCH} (fsdp, {FSDP_LAYERS} layers, float32, "
          f"{FSDP_B}x{FSDP_S}) on a {FSDP_WORLD} (data, model) gloo world "
          f"of {world} processes on the card: {a['fsdp_leaves']} of "
          f"{a['leaves']} leaves split over \"data\" ({a['both_leaves']} "
          f"over both), {a['local_bytes'] / 2**30:.3f} of "
          f"{a['whole_bytes'] / 2**30:.3f} GiB of weights a rank; "
          f"{FSDP_STEPS} train steps with 1 and 2 microbatches, a prefill "
          f"and {FSDP_GEN - 1} greedy decode steps; largest errors over "
          f"the ranks against the whole weights "
          f"{ {k: max(r['errs'][k] for r in ranks) for k in a['errs']} } "
          f"(<= {TP_TOL}); ids equal; losses (mesh, whole) "
          f"{ {k: v for k, v in a.items() if k.startswith('loss/')} }; "
          f"launches {a['launches']} a rank; rank 0's seconds: the whole "
          f"runs in turn {a['whole_s']:.1f}, train {a['train_s']:.1f}, "
          f"serve {a['serve_s']:.1f}", flush=True)
    launches = dict.fromkeys(reg.KERNELS, 0)
    launches.update(a["launches"])
    return launches, dict(ranks=ranks, world=list(FSDP_WORLD), tol=TP_TOL)


def fsdp_big(torch, dev, reg):
    """Phase 18 (c): ``FSDP_BIG``'s prefill in this process on the whole
    weights (its peak read), the memory freed, then on a data =
    ``world`` world (:func:`fsdp_big_rank`): each rank's logits within
    ``tol`` of the largest whole logit, each rank's peak below the whole
    run's, flash launched on each rank.  Returns (rank 0's launches by
    kernel, report)."""
    import shutil

    from repro_torch.models import transformer as tfm

    cfg = fsdp_big_cfg()
    torch.cuda.empty_cache()
    params = fsdp_big_params(torch, cfg, None, dev)
    batch = fsdp_big_batch(torch, cfg, dev)
    whole_gib = sum(t.numel() * t.element_size()
                    for t in tfm.tree_leaves(params)) / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, _ = tfm.prefill(params, cfg, batch, FSDP_BIG["S"])
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated() / 2**30
    logits = logits.cpu()
    del params, batch, _
    torch.cuda.empty_cache()
    ranks, tmp = spawn_world("--fsdp-big-rank", FSDP_BIG["world"],
                             "fsdp (c)")
    try:
        errs = []
        for r, a in enumerate(ranks):
            got = torch.load(f"{tmp}/rank{r}.json.pt")
            want = logits[a["rows"][0]:a["rows"][1]]
            errs.append(float((got.float() - want.float()).abs().max())
                        / float(logits.float().abs().max()))
            check(errs[-1] <= FSDP_BIG["tol"], f"fsdp (c): rank {r}: "
                  f"logits {errs[-1]:.3g} of the largest apart")
            check(a["peak_gib"] is not None and a["peak_gib"] < whole_peak,
                  f"fsdp (c): rank {r}: peak {a['peak_gib']} GiB, the "
                  f"whole run's {whole_peak:.2f}")
            check(a["launches"].get("flash_attention", 0) > 0,
                  f"fsdp (c): rank {r}: launches {a['launches']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"fsdp (c): {FSDP_BIG['arch']} (1 layer, bf16, "
          f"{FSDP_BIG['B']}x{FSDP_BIG['S']} prefill) on a data = "
          f"{FSDP_BIG['world']} gloo world on the card: "
          f"{ranks[0]['fsdp_leaves']} of {ranks[0]['leaves']} leaves split"
          f" over \"data\"; weights {whole_gib:.2f} GiB whole, "
          f"{[a['local_gib'] for a in ranks]} GiB a rank; peak "
          f"{[a['peak_gib'] for a in ranks]} GiB a rank against "
          f"{whole_peak:.2f} GiB whole; logits {[f'{e:.3g}' for e in errs]}"
          f" of the largest apart (<= {FSDP_BIG['tol']}); launches "
          f"{ranks[0]['launches']} a rank", flush=True)
    launches = dict.fromkeys(reg.KERNELS, 0)
    launches.update(ranks[0]["launches"])
    return launches, dict(ranks=ranks, whole_gib=whole_gib,
                          whole_peak_gib=whole_peak, logit_errs=errs,
                          tol=FSDP_BIG["tol"])


def fsdp_dryrun_gates(cells: dict) -> None:
    """Phase 18 (a)'s gates on :func:`dryrun_records`' cells: llama4's
    cells and nemotron's (16, 16) fit the card's HBM (every FSDP leaf
    gathered whole they did not), and each cell's ``coll_by_op`` holds
    FSDP's gathers and their gradients' reduce-scatters: at least a
    microbatch's all-gathers of the rank's FSDP pieces (the operand, each
    once) and reduce-scatters of the whole layers (``data`` times the
    pieces) a microbatch."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm

    for key, c in cells.items():
        arch, mp = key.split("/")
        shape = tuple(int(n) for n in c["mesh"].split("x"))
        names = ("pod", "data", "model")[-len(shape):]

        class Desc:
            axis_names = names

        Desc.shape = dict(zip(names, shape))
        cfg = cb.get(arch)
        p_shape, _ = steps_mod.init_shapes(cfg)
        specs = shd.param_shardings(p_shape, cfg, Desc())
        pieces = 0
        for path, leaf in tfm.tree_items(p_shape):
            spec = specs
            for k in path:
                spec = spec[int(k)] if isinstance(spec, (tuple, list)) \
                    else spec[k]
            if "data" in spec:
                n = leaf.numel() * leaf.element_size()
                for e in spec:
                    for a in ((e,) if isinstance(e, str) else (e or ())):
                        n //= Desc.shape[a]
                pieces += n
        mb = c["microbatches"]
        coll = c["coll_by_op"]
        gathered = coll.get("all_gather_into_tensor", 0.0)
        scattered = coll.get("reduce_scatter_tensor", 0.0)
        check(gathered >= mb * pieces
              and scattered >= mb * Desc.shape["data"] * pieces,
              f"fsdp (a): {key}: all-gathers {gathered:.4g} and "
              f"reduce-scatters {scattered:.4g} bytes, below {mb} "
              f"microbatches of the rank's {pieces} bytes of FSDP pieces")
        if not (arch == "nemotron_4_340b" and mp == "pod2"):
            check(c["fits_hbm"], f"fsdp (a): {key} does not fit "
                  f"({c['gib']:.2f} GiB a rank)")
        c["fsdp_piece_bytes"] = pieces


def fsdp_worlds(torch, dev, reg):
    """Phase 18 (b) and (c), which run beside phase 17 (d)'s and 18 (a)'s
    dry-runs: (:func:`fsdp_world`, :func:`fsdp_big`).  Returns (their rank
    0 launches by kernel, report)."""
    out = {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, out["world"] = fsdp_world(torch, reg)
    out["world_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    big, out["big"] = fsdp_big(torch, dev, reg)
    out["big_s"] = time.perf_counter() - t0
    for k, v in big.items():
        launches[k] += v
    return launches, out


def fsdp_phase(torch, dev, reg, later: dict):
    """Phase 18: FSDP's per-layer gathers over ``"data"``.  (b) and (c)
    (:func:`fsdp_worlds`) ran in phase 17 after its world
    (``later["beside"]``); here (a)'s ``train_4k`` dry-runs of
    ``FSDP_DRYRUN_ARCHS`` (the card's fake tensors, F6's cell also the
    CPU's: ``later["dryruns"]``, started with phase 17 (d)'s) are read
    and gated (:func:`dryrun_records`, :func:`fsdp_dryrun_gates`).
    Returns ((b)'s and (c)'s rank 0 launches by kernel, report)."""
    t_phase = time.perf_counter()
    dryruns = later["dryruns"]
    try:
        records = dryruns.wait(420)
    finally:
        dryruns.stop()
    launches, out = later["beside"]
    out["dryrun"] = dryrun_records(records, FSDP_DRYRUN_ARCHS, "fsdp (a)",
                                   "every FSDP leaf gathered whole")
    fsdp_dryrun_gates(out["dryrun"])
    out["wait_s"] = time.perf_counter() - t_phase
    print(f"fsdp phase: (b) {out['world_s']:.1f} s and (c) "
          f"{out['big_s']:.1f} s in phase 17, then "
          f"{out['wait_s']:.1f} s for (a)'s", flush=True)
    return launches, out


def seq_phase(later: dict, fsdp: dict):
    """Phase 19: the KV caches' sequence split.  (a) ``SEQ_DRYRUN_CELLS``
    (started with phase 17 (d)'s dry-runs: ``later["seq_dryruns"]``) on
    the card's fake tensors and the CPU's, the records equal, each
    fitting the card (nemotron's below 20 GiB a rank, llama4's below 15)
    and counting the merge's all-reduces; (b) phase 18 (b)'s world's
    serve caches (``fsdp``, phase 18's report): every KV head and
    ``SEQ_SLOTS`` / 2 slots of each cache on each rank of the (2, 2)
    mesh, a one-lane decode's / 4 (the data axes folded in), decode
    logits within ``SEQ_TOL`` of the whole weights' and the one lane's
    ids equal.  Returns the report."""
    t_phase = time.perf_counter()
    dryruns = later["seq_dryruns"]
    try:
        records = dryruns.wait(420)
    finally:
        dryruns.stop()
    out = {"dryrun": {}}
    gates = {"nemotron_4_340b": 20.0, "llama4_maverick_400b_a17b": 15.0}
    for (arch, shape), before in SEQ_DRYRUN_CELLS.items():
        a = records[(arch, shape, "pod1", "cuda")]
        c = records[(arch, shape, "pod1", "cpu")]
        diff = [k for k in DRYRUN_COUNTS if a.get(k) != c.get(k)]
        check("error" not in a and "error" not in c and not diff,
              f"seq (a): {arch} {shape}: the card's and the CPU's records "
              f"differ in {diff} ({a.get('error')}, {c.get('error')})")
        gib = a["memory_per_device_bytes"] / 2**30
        check(a["fits_hbm"] and gib < gates.get(arch, before),
              f"seq (a): {arch} {shape}: {gib:.2f} GiB a rank")
        check(a["coll_by_op"].get("all_reduce", 0) > 0,
              f"seq (a): {arch} {shape}: no all-reduce counted")
        out["dryrun"][f"{arch}/{shape}"] = dict(
            gib=gib, before_gib=before, mesh=a["mesh"],
            trace_s=a["trace_s"], cpu_trace_s=c["trace_s"],
            coll_by_op=a["coll_by_op"], memory_s=a["memory_s"],
            collective_s=a["collective_s"], dominant=a["dominant"])
        print(f"seq (a): {arch} {shape} on {a['mesh']}: {gib:.2f} GiB a "
              f"rank (the rank's heads' caches whole: {before} GiB); the "
              f"card's and the CPU's records equal (traced in "
              f"{a['trace_s']} / {c['trace_s']} s); all-reduce "
              f"{a['coll_by_op']['all_reduce']:.4g} bytes", flush=True)
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    cfg = fsdp_world_cfg()
    kinds = tfm.pattern(cfg)
    n = cfg.n_layers // len(kinds)
    dp, tp = FSDP_WORLD
    slots = [layers._cache_len(cfg, k.attn, SEQ_SLOTS) for k in kinds]
    want = [[n, FSDP_B // dp, cfg.n_kv_heads, c // tp, cfg.head_dim]
            for c in slots]
    want_one = [[n, 1, cfg.n_kv_heads, c // (dp * tp), cfg.head_dim]
                for c in slots]
    ranks = [r["seq"] for r in fsdp["world"]["ranks"]]
    for r, a in enumerate(ranks):
        check(a["slots"] == want and a["one_slots"] == want_one,
              f"seq (b): rank {r}: caches {a['slots']} and one lane's "
              f"{a['one_slots']}, not {want} and {want_one}")
        check(a["decode_logits"] <= SEQ_TOL and a["one_logits"] <= SEQ_TOL,
              f"seq (b): rank {r}: decode logits {a['decode_logits']:.3g} "
              f"/ one lane {a['one_logits']:.3g} above {SEQ_TOL}")
        check(a["one_ids_equal"], f"seq (b): rank {r}: the one lane's ids "
              "differ from the whole weights'")
    out["world"] = dict(ranks=ranks, slots=want, one_slots=want_one,
                        tol=SEQ_TOL)
    print(f"seq (b): {FSDP_ARCH} on the {FSDP_WORLD} world (phase 18 (b)): "
          f"each rank's caches {want} (layers, lanes, KV heads, {slots} / "
          f"{tp} slots), a one-lane decode's {want_one} (over data and "
          f"model); decode logits within "
          f"{max(a['decode_logits'] for a in ranks):.3g} / one lane "
          f"{max(a['one_logits'] for a in ranks):.3g} of the whole "
          f"weights' (<= {SEQ_TOL}); ids equal", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"seq phase: {out['phase_s']:.1f} s waiting for (a)'s dry-runs",
          flush=True)
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.exists():
        return fail("run from the repository root (src/repro_torch and "
                    "tests/golden_modes.json not found)")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device available")
    sys.path.insert(0, str(SRC))
    worlds = {"--tp-rank": tp_world_rank, "--fsdp-rank": fsdp_world_rank,
              "--fsdp-big-rank": fsdp_big_rank}
    if sys.argv[1:2] and sys.argv[1] in worlds:
        # one rank of phase 17 (e)'s or 18 (b)'s or (c)'s world: rank,
        # world, store, output
        rank, world, store, path = sys.argv[2:6]
        return worlds[sys.argv[1]](torch, int(rank), int(world), store,
                                   path)
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

    t_script = time.perf_counter()
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

    # 12. this slice's path: training (gemma2_2b at full width, repro_100m
    # through the quick example's run), the flash backward against its twin
    train_launches, report["train"] = train_phase(torch, dev, reg)
    flash_row["launches"] += train_launches

    # the dry-runs of phases 17 (d), 18 (a) and 19 (a) (subprocesses below
    # the card's work in the host's scheduler), started here so that they
    # end before phase 17's worlds, which they would slow
    later = {"tp_dryruns": Dryruns(train_cells(TP_DRYRUN_ARCHS,
                                               TP_DRYRUN_CPU))}
    try:
        later["dryruns"] = Dryruns(train_cells(FSDP_DRYRUN_ARCHS,
                                               FSDP_DRYRUN_CPU))
        later["seq_dryruns"] = Dryruns([
            (arch, shape, "pod1", device)
            for arch, shape in SEQ_DRYRUN_CELLS for device in ("cuda", "cpu")])
        # 13. this slice's path: training rwkv6_1_6b, hymba_1_5b and
        # moonshot_v1_16b_a3b, the backwards of rwkv6_scan and moe_dispatch
        family_launches, report["train_families"] = family_phase(torch, dev,
                                                                 reg)
        for row in (flash_row, rwkv_row, moe_row):
            row["launches"] += family_launches[row["name"]]

        # 14. this slice's path: the distributed pieces on a world of one
        # (gemma2_2b's gradient through the flash kernel, then compressed,
        # all-reduced and placed as DTensors)
        dist_launches, report["distributed"] = dist_phase(torch, dev, reg)
        flash_row["launches"] += dist_launches

        # 15. this slice's path: the sharded step, the mesh-bound prefill and
        # serve steps and the elastic restore on a world of one
        shard_launches, report["sharded"] = sharded_phase(
            torch, dev, reg, report["train"]["ckpt_dir"],
            report["train"]["gemma2_2b"]["warm_step_s"])
        for row in (flash_row, moe_row):
            row["launches"] += shard_launches[row["name"]]

        # 16. this slice's path: the dry-run without HLO (the CLI on the JAX
        # test's cell; gemma2_2b's and rwkv6_1_6b's steps traced, then run)
        dryrun_launches, report["dryrun"] = dryrun_phase(torch, dev, reg)
        for row in (flash_row, rwkv_row):
            row["launches"] += dryrun_launches[row["name"]]

        # 17. this slice's path: tensor and expert parallelism (the one-rank
        # steps again, flash and the dispatch at a tp = 16 rank's shapes, a
        # tp = 2 world on the card, the train cells' dry-run)
        tp_launches, report["tp"] = tp_phase(
            torch, dev, reg, report["sharded"], later,
            beside=lambda: fsdp_worlds(torch, dev, reg))
        for row in (flash_row, moe_row):
            row["launches"] += tp_launches[row["name"]]

        # 18. this slice's path: FSDP's per-layer gathers over "data" (the two
        # FSDP configs' train cells dry-run, a (2, 2) world of gemma2_2b with
        # fsdp on the card, nemotron_4_340b's prefill on a data = 2 world)
        fsdp_launches, report["fsdp"] = fsdp_phase(torch, dev, reg, later)
        flash_row["launches"] += fsdp_launches["flash_attention"]

        # 19. this slice's path: the KV caches' sequence split (decode cells
        # dry-run; phase 18 (b)'s world's caches, split over "model" and, for
        # one lane, over "data" and "model")
        report["seq"] = seq_phase(later, report["fsdp"])
    finally:
        for key in ("tp_dryruns", "dryruns", "seq_dryruns"):
            if key in later:
                later[key].stop()
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_script
    print(f"the script's phases took {report['script_s']:.1f} s", flush=True)
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
    tr = report["train"]
    print(json.dumps({"train": dict(
        gemma2_2b={k: tr["gemma2_2b"][k] for k in (
            "warm_step_s", "tokens_per_s", "peak_gib",
            "flash_launches_per_step", "losses", "grad_norms")},
        traced_step={k: v for k, v in tr["gemma2_2b"]["traced"].items()
                     if k != "top"},
        f32={k: v for k, v in tr["f32"].items() if k != "leaf_rel_errs"},
        repro_100m=tr["repro_100m"],
        flash_train_timed=tr["flash_train_timed"],
        flash_train_max_errors={
            k: max(e[k] for e in tr["flash_train_errors"].values())
            for k in ("out", "lse", "dq", "dk", "dv")})}))
    tf = report["train_families"]
    print(json.dumps({"train_families": dict(
        {arch: dict({k: tf[arch][k] for k in (
            "n_layers", "warm_step_s", "tokens_per_s", "peak_gib",
            "losses", "grad_norms", "launches")},
            traced={k: v for k, v in tf[arch]["traced"].items()
                    if k != "top"})
         for arch in ("rwkv6_1_6b", "hymba_1_5b", "moonshot_v1_16b_a3b")},
        moonshot_routing=tf["moonshot_v1_16b_a3b"]["routing"],
        f32=tf["f32"], rwkv_timed=tf["rwkv_timed"],
        rwkv_grad_max_errors={
            k: max(e[k] for e in tf["rwkv_grad_errors"].values())
            for k in ("out", "state", "dr", "dk", "dv", "dw", "du",
                      "dstate")},
        ssm_errors=tf["ssm_errors"], ssm_bwd_ms=tf["ssm_bwd_ms"],
        moe_bwd_ms=tf["moe_bwd_ms"], moe_bwd_bound_ms=tf["moe_bwd_bound_ms"],
        phase_s=tf["phase_s"])}))
    di = report["distributed"]
    print(json.dumps({"distributed": dict(
        mesh=di["mesh"], grad={k: v for k, v in di["grad"].items()
                               if k != "top"},
        collectives_ms=di["collectives"], placements=di["placements"],
        phase_s=di["phase_s"])}))
    print(json.dumps({"sharded": report["sharded"]}))
    print(json.dumps({"dryrun": report["dryrun"]}))
    print(json.dumps({"tp": report["tp"]}))
    print(json.dumps({"fsdp": report["fsdp"]}))
    print(json.dumps({"seq": report["seq"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
