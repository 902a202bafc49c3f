"""Step backends: who runs the simulator's steps.

A backend supplies a *run loop*: "advance these states while ``run_gate``
holds, at most ``max_iters`` steps".  It works on a batch (every leaf with
a leading batch axis; one simulation is a batch of one):

* ``reference``  — the plain PyTorch ops (:data:`phases.REFERENCE_OPS`),
  the oracle every other backend is held against; the Python loop of
  :func:`repro_torch.kernels.sched_step.run_lanes`, lane by lane.
* ``cuda``       — the same Python loop over the hand-written CUDA queue
  kernels of :mod:`repro_torch.kernels.sched_queue` (the counterpart of
  the JAX package's per-op ``pallas`` backend).
* ``cuda_fused`` — the whole run loop in one CUDA launch for the whole
  batch (:mod:`repro_torch.kernels.sched_step`; the counterpart of the
  JAX package's ``pallas_fused``).  On CPU tensors it takes the kernel's
  plain twin.

Backends are bitwise identical by contract.  ``None`` follows the device:
``cuda_fused`` on a CUDA device, ``reference`` on the CPU.  Nothing reads
an environment variable.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.phases import REFERENCE_OPS, StepOps

BACKENDS = ("reference", "cuda", "cuda_fused")


def resolve_name(name: str | None, device: torch.device) -> str:
    """Normalize ``SimConfig.backend`` for a run on ``device``."""
    if name is None:
        return ("cuda_fused" if torch.device(device).type == "cuda"
                else "reference")
    if name not in BACKENDS:
        raise ValueError(f"unknown step backend {name!r}; "
                         f"available: {list(BACKENDS)}")
    return name


def step_ops(name: str) -> StepOps:
    """The queue-op kernel set the Python run loop of backend ``name``
    (``reference`` or ``cuda``) steps with.  The CUDA kernel module is
    imported only when asked for."""
    if name == "reference":
        return REFERENCE_OPS
    if name == "cuda":
        from repro_torch.kernels import sched_queue
        return sched_queue.cuda_ops()
    raise ValueError(f"backend {name!r} has no per-op kernel set; "
                     "available: ['reference', 'cuda']")


def run_loop(name: str) -> Callable:
    """Backend ``name``'s run loop, ``loop(st, g, case, *, costs,
    max_steps, max_iters) -> st`` over batched tuples of tensors.  The
    returned state may share storage with ``st``; callers use the return
    value."""
    from repro_torch.kernels import sched_step
    if name == "cuda_fused":
        return sched_step.sched_step
    return functools.partial(sched_step.run_lanes, ops=step_ops(name))
