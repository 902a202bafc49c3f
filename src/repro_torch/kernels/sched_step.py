"""The fused whole-run CUDA kernel (``cuda_fused``), and its plain twin.

The port of the JAX package's whole-step megakernel
(``src/repro/kernels/sched_step.py``, ``build_fused_step``, the
``pallas_fused`` backend), written by hand in CUDA C++ for Hopper
(``csrc/sched_step.cu``).  One launch advances a *batch* of simulations:
one thread block per simulation, one thread per worker lane, every phase
of :func:`repro_torch.core.phases.step_pipeline` in the block with
``__syncthreads`` between a phase's cross-lane reads and its writes, and
the run loop itself inside the kernel: each block repeats the step while
:func:`~repro_torch.core.phases.run_gate` holds, for at most ``max_iters``
steps.  ``max_iters = 1`` is the TPU kernel's one step; a run passes
``max_steps`` and needs one launch and no host round trip.

Every leaf of ``(st, g, case)`` carries a leading batch axis (see
:func:`repro_torch.core.state.stack` / :func:`batch_of_one`).  On the card
the state is updated in place (the JAX kernel's ``input_output_aliases``)
and returned; on the CPU :func:`sched_step` takes the plain twin
:func:`run_lanes`, which runs ``step_pipeline`` over the plain PyTorch
ops lane by lane, and returns a new state.  Either way the caller uses the
returned state.  A failed build or launch raises; nothing falls back to
the twin on the card.

The kernel takes its launch shape from W alone: 128 threads up to W = 128,
1024 above, with the queue heads and tails in shared memory up to W = 156
and in device memory beyond (:func:`resident`); every shape gives the same
bits.

Build and binding are :mod:`repro_torch.kernels.registry`'s: nvcc into
``build/repro_torch_kernels/<hash>/libsched_step.so``, ``ctypes``, the
current stream, and one ``StepArgs`` struct (every pointer and scalar)
passed by address (the kernel takes it by value).  The launch adds one to ``registry.KERNELS["sched_step"]``.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch

from repro_torch.core import phases
from repro_torch.core.costs import CostModel
from repro_torch.core.phases import REFERENCE_OPS, StepOps
from repro_torch.core.state import (NC, GraphArrays, SimState, SweepCase,
                                    lane, leaves, stack)
from repro_torch.core.topology import DMAX
from repro_torch.kernels import registry as reg
from repro_torch.kernels import sched_queue as sq

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_step.cu"
#: CUDA's limit of threads in a block: one thread per worker lane
W_MAX = 1024

I32, F32, BOOL, I64 = torch.int32, torch.float32, torch.bool, torch.int64

#: the state's leaves in ``SimState`` order: (name, per-lane shape, dtype),
#: each letter of a shape one size: W lanes, S stack, Q queue, T tasks,
#: G global queue, C counters, D the padded domain count, R releases
_STATE = (
    ("xq_buf", "WWQ", I32), ("xq_ts", "WWQ", I32), ("xq_head", "WW", I32),
    ("xq_tail", "WW", I32), ("round", "W", I32), ("req_round", "W", I32),
    ("req_tid", "W", I32), ("rp_tgt", "W", I32), ("rp_left", "W", I32),
    ("g_buf", "G", I32), ("g_ts", "G", I32), ("g_head", "", I32),
    ("g_tail", "", I32), ("s_task", "WS", I32), ("s_cnt", "WS", I32),
    ("s_top", "W", I32), ("join_cnt", "T", I32), ("done", "T", BOOL),
    ("done_ns", "T", I32), ("creator", "T", I32), ("clock", "W", I32),
    ("rr", "W", I32), ("deq_rr", "W", I32), ("idle", "W", I32),
    ("rng", "W", I64), ("ctr", "WC", I32), ("n_done", "", I32),
    ("overflow", "", BOOL), ("step_i", "", I32), ("nlink", "W", I32),
)
_GRAPH = (
    ("dur", "T", I32), ("first_child", "T", I32), ("n_children", "T", I32),
    ("notify", "T", I32), ("join_dep", "T", I32), ("n_tasks", "", I32),
    ("payload", "T", I32),
)
_CASE = (
    ("queue_id", "", I32), ("barrier_id", "", I32), ("balance_id", "", I32),
    ("n_workers", "", I32), ("zone_size", "", I32), ("seed", "", I32),
    ("mem_bound", "", F32), ("n_victim", "", I32), ("n_steal", "", I32),
    ("t_interval", "", I32), ("p_local", "", F32), ("p_local_node", "", F32),
    ("n_domains", "", I32), ("dist", "DD", I32), ("flat", "", BOOL),
    ("node", "D", I32), ("bw", "DD", I32), ("cluster", "", BOOL),
    ("bneck_bw", "", I32), ("bw_scale", "", F32), ("closed", "", BOOL),
    ("release_ns", "R", I32),
)
_INTS = ("B", "W", "S", "Q", "T", "GQ", "R", "NCTR", "DM", "max_steps",
         "max_iters", "c_cache", "c_zone", "c_numa", "c_atomic", "c_contend",
         "c_lock", "c_pq_op", "c_alloc", "c_slot", "req_bytes")
_FLOATS = ("exec_remote_penalty", "exec_remote_penalty_m1",
           "exec_zone_penalty", "c_numa_f")


class StepArgs(ctypes.Structure):
    """Mirror of ``struct StepArgs`` in ``csrc/sched_step.cu``: every
    leaf's device pointer, in the order above, then the sizes, the
    integer costs and the float32 costs."""
    _fields_ = ([(n, ctypes.c_void_p) for n, _, _ in _STATE + _GRAPH + _CASE]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = reg.build(SOURCE)
    lib = ctypes.CDLL(str(path))
    lib.ss_run.argtypes = [ctypes.POINTER(StepArgs), ctypes.c_void_p]
    lib.ss_run.restype = ctypes.c_int
    lib.ss_resident.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ss_resident.restype = ctypes.c_int
    return lib


def build() -> tuple[Path, str]:
    """Build ``csrc/sched_step.cu`` (see :func:`registry.build`)."""
    return reg.build(SOURCE)


# ---------------- the plain twin ----------------
def run_lanes(st: SimState, g: GraphArrays, case: SweepCase, *,
              costs: CostModel, max_steps: int, max_iters: int,
              ops: StepOps = REFERENCE_OPS) -> SimState:
    """What the kernel computes, in plain PyTorch: for each lane of the
    batch in turn, repeat ``step_pipeline`` while ``run_gate`` holds, at
    most ``max_iters`` times.  Returns a new batched state."""
    out = []
    for b in range(st.clock.shape[0]):
        s, gb, cb = lane(st, b), lane(g, b), lane(case, b)
        for _ in range(max_iters):
            if not bool(phases.run_gate(s, gb, max_steps)):
                break
            s = phases.step_pipeline(s, g=gb, case=cb, costs=costs, ops=ops,
                                     max_steps=max_steps)
        out.append(s)
    return stack(out)


# ---------------- the kernel's wrapper ----------------
#: ``StepArgs`` as one packed record (no padding inside: the pointers come
#: first), built with one ``struct.pack`` instead of 84 ctypes fields
_ARGS = struct.Struct(f"<{len(_STATE + _GRAPH + _CASE)}Q{len(_INTS)}i"
                      f"{len(_FLOATS)}f")
_ARGS_PAD = bytes(ctypes.sizeof(StepArgs) - _ARGS.size)


def _sizes(st: SimState, g: GraphArrays, case: SweepCase) -> tuple:
    """The sizes ``(B, W, S, Q, T, G, C, D, R)`` of a batch."""
    B, W = st.clock.shape
    return (B, W, st.s_task.shape[-1], st.xq.buf.shape[-1], g.dur.shape[-1],
            st.g_buf.shape[-1], NC, DMAX, case.release_ns.shape[-1])


@functools.lru_cache(maxsize=256)
def _shapes(spec: tuple, sizes: tuple) -> tuple:
    n = dict(zip("BWSQTGCDR", sizes))
    return tuple((n["B"],) + tuple(n[d] for d in dims) for _, dims, _ in spec)


def _check_leaves(tree, spec, sizes, dev) -> list:
    """Check every leaf of ``tree`` against ``spec``
    (:func:`sched_queue._check`) and return their device addresses."""
    ts = leaves(tree)
    assert len(ts) == len(spec), (len(ts), len(spec))
    where = -1 if dev.type == "cpu" else dev.index
    out = []
    for t, shape, (name, _, dtype) in zip(ts, _shapes(spec, sizes), spec):
        sq._check(t, name, shape, dtype, where)
        out.append(t.data_ptr())
    return out


def sched_step(st: SimState, g: GraphArrays, case: SweepCase, *,
               costs: CostModel, max_steps: int, max_iters: int) -> SimState:
    """Advance a batch of simulations: each lane repeats the step while its
    run gate holds, at most ``max_iters`` times.  CUDA tensors launch the
    kernel (one launch for the whole batch, the state updated in place and
    returned); CPU tensors take :func:`run_lanes`."""
    if not st.clock.is_cuda:
        return run_lanes(st, g, case, costs=costs, max_steps=max_steps,
                         max_iters=max_iters)
    sizes = _sizes(st, g, case)
    if sizes[1] > W_MAX:
        raise ValueError(f"{sizes[1]} worker lanes exceed the {W_MAX} "
                         "threads of one CUDA block")
    dev = st.clock.device
    ptrs = (_check_leaves(st, _STATE, sizes, dev)
            + _check_leaves(g, _GRAPH, sizes, dev)
            + _check_leaves(case, _CASE, sizes, dev))
    c = costs
    B, W, S, Q, T, G, C, D, R = sizes
    ints = (B, W, S, Q, T, G, R, C, D, int(max_steps), int(max_iters),
            c.c_cache, c.c_zone, c.c_numa, c.c_atomic, c.c_contend, c.c_lock,
            c.c_pq_op, c.c_alloc, c.c_slot, c.req_bytes)
    # the float32 constants as PyTorch rounds the Python floats it mixes
    # with float32 tensors in phases.exec_phase
    floats = (c.exec_remote_penalty, c.exec_remote_penalty - 1.0,
              c.exec_zone_penalty, float(c.c_numa))
    args = StepArgs.from_buffer_copy(_ARGS.pack(*ptrs, *ints, *floats)
                                     + _ARGS_PAD)
    err = _library().ss_run(ctypes.byref(args), reg.stream())
    reg.launched("sched_step", err)
    return st


def resident(W: int) -> bool:
    """Whether the kernel keeps a W-lane block's queue heads and tails in
    shared memory (``ss_resident``: the rule ``ss_run`` applies); builds
    the kernel."""
    return bool(_library().ss_resident(W, DMAX))


#: the plain twin of the kernel (what the CPU path runs and what the kernel
#: is held against on the card)
PLAIN = {"sched_step": run_lanes}
