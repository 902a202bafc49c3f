"""Step backends: who implements the phase pipeline's inner kernels.

* ``reference`` — the plain PyTorch ops (:data:`phases.REFERENCE_OPS`),
  the oracle every other backend is held against; runs on any device.
* ``cuda``      — the hand-written CUDA kernels of
  :mod:`repro_torch.kernels.sched_queue` for the XQueue push, the pop scan
  and the counter bump (the counterpart of the JAX package's per-op
  ``pallas`` backend).

Backends are bitwise identical by contract.  The backend follows the
device: ``None`` resolves to ``cuda`` on a CUDA device and to
``reference`` on the CPU.  Nothing reads an environment variable.
"""

from __future__ import annotations

import torch

from repro_torch.core.phases import REFERENCE_OPS, StepOps

BACKENDS = ("reference", "cuda")


def resolve_name(name: str | None, device: torch.device) -> str:
    """Normalize ``SimConfig.backend`` for a run on ``device``."""
    if name is None:
        return "cuda" if torch.device(device).type == "cuda" else "reference"
    if name not in BACKENDS:
        raise ValueError(f"unknown step backend {name!r}; "
                         f"available: {list(BACKENDS)}")
    return name


def step_ops(name: str) -> StepOps:
    """The kernel set of backend ``name``.  The CUDA kernel module is
    imported only when asked for."""
    if name == "reference":
        return REFERENCE_OPS
    if name == "cuda":
        from repro_torch.kernels import sched_queue
        return sched_queue.cuda_ops()
    raise ValueError(f"unknown step backend {name!r}; "
                     f"available: {list(BACKENDS)}")
