"""CUDA kernels for the scheduler's hot queue ops, and their plain twins.

The port of the JAX package's Pallas kernel set
(``src/repro/kernels/sched_queue.py``): the XQueue SPSC push, the rotated
pop scan and the counter-column bump, written by hand in CUDA C++ for
Hopper (``csrc/sched_queue.cu``), built and bound as every kernel of the
package is (:mod:`repro_torch.kernels.registry`: nvcc into
``build/repro_torch_kernels/<hash>/``, a plain C interface through
``ctypes``, the current stream; a failed build or launch raises).

Each wrapper checks device, dtype, shape and contiguity, then dispatches on
where its tensors lie: a CUDA tensor launches the kernel (and adds one to
that kernel's ``launches`` count); a CPU tensor takes the plain PyTorch
version.  There is no other fallback.  The kernels update ``xq`` and
``ctr`` in place and return the same tensors; the plain versions are
functional.  Both give the same values.

All three kernels are integer bookkeeping on at most a few hundred KiB and
are bound by launch latency on the card (see the source notes); the simple
one-thread-per-row / one-warp-per-row designs are kept for correctness.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core import xqueue
from repro_torch.core.phases import StepOps, ctr_add_ref
from repro_torch.core.xqueue import XQ
from repro_torch.kernels import registry as reg

I32 = torch.int32
SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_queue.cu"
#: the three kernels of this module's source (counted in
#: :data:`repro_torch.kernels.registry.KERNELS`)
QUEUE_KERNELS = ("ctr_add", "push", "pop_first")


def build() -> tuple[Path, str]:
    """Build ``csrc/sched_queue.cu`` (see :func:`registry.build`)."""
    return reg.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sq_ctr_add.argtypes = [ptr, ptr, i32, i32, i32, ptr]
    lib.sq_push.argtypes = [ptr] * 10 + [i32, i32, ptr]
    lib.sq_pop_first.argtypes = [ptr] * 12 + [i32, i32, ptr]
    for fn in (lib.sq_ctr_add, lib.sq_push, lib.sq_pop_first):
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------- counter bump ----------------
def ctr_add(ctr: torch.Tensor, col: int, val: torch.Tensor) -> torch.Tensor:
    """``ctr[:, col] += val`` — in place on the card, plain on the CPU."""
    W, nc = ctr.shape
    _check(ctr, "ctr", (W, nc), I32, ctr.device)
    _check(val, "val", (W,), I32, ctr.device)
    if not 0 <= col < nc:
        raise IndexError(f"counter column {col} out of range [0, {nc})")
    if not ctr.is_cuda:
        return ctr_add_ref(ctr, col, val)
    err = _library().sq_ctr_add(reg.ptr(ctr), reg.ptr(val), W, nc, col,
                                reg.stream())
    reg.launched("ctr_add", err)
    return ctr


# ---------------- SPSC push ----------------
def push(xq: XQ, producer: torch.Tensor, consumer: torch.Tensor,
         task: torch.Tensor, ts: torch.Tensor, mask: torch.Tensor):
    """:func:`repro_torch.core.xqueue.push` (same signature and result);
    on the card it writes ``xq`` in place and returns it."""
    W = xq.head.shape[0]
    Q = xqueue.capacity(xq)
    dev = xq.buf.device
    _check(xq.buf, "buf", (W, W, Q), I32, dev)
    _check(xq.ts, "ts", (W, W, Q), I32, dev)
    _check(xq.head, "head", (W, W), I32, dev)
    _check(xq.tail, "tail", (W, W), I32, dev)
    for name, t in (("producer", producer), ("consumer", consumer),
                    ("task", task), ("ts", ts)):
        _check(t, name, (W,), I32, dev)
    _check(mask, "mask", (W,), torch.bool, dev)
    if not xq.buf.is_cuda:
        return xqueue.push(xq, producer, consumer, task, ts, mask)
    ok = torch.empty(W, dtype=torch.bool, device=dev)
    err = _library().sq_push(
        *map(reg.ptr, (xq.buf, xq.ts, xq.head, xq.tail, producer, consumer,
                       task, ts, mask, ok)), W, Q, reg.stream())
    reg.launched("push", err)
    return xq, ok


# ---------------- pop scan ----------------
def pop_first(xq: XQ, rot: torch.Tensor, mask: torch.Tensor, n_active=None):
    """:func:`repro_torch.core.xqueue.pop_first` (same signature and
    result); on the card it advances ``xq.head`` in place.  ``n_active`` is
    a 0-dim int32 tensor on the queue's device (read by the kernel, never
    copied to the host)."""
    W = xq.head.shape[0]
    Q = xqueue.capacity(xq)
    dev = xq.buf.device
    if n_active is None:
        n_active = torch.tensor(W, dtype=I32, device=dev)
    _check(xq.buf, "buf", (W, W, Q), I32, dev)
    _check(xq.ts, "ts", (W, W, Q), I32, dev)
    _check(xq.head, "head", (W, W), I32, dev)
    _check(xq.tail, "tail", (W, W), I32, dev)
    _check(rot, "rot", (W,), I32, dev)
    _check(mask, "mask", (W,), torch.bool, dev)
    _check(n_active, "n_active", (), I32, dev)
    if not xq.buf.is_cuda:
        return xqueue.pop_first(xq, rot, mask, n_active)
    task = torch.empty(W, dtype=I32, device=dev)
    ts = torch.empty(W, dtype=I32, device=dev)
    src = torch.empty(W, dtype=I32, device=dev)
    found = torch.empty(W, dtype=torch.bool, device=dev)
    checked = torch.empty(W, dtype=I32, device=dev)
    err = _library().sq_pop_first(
        *map(reg.ptr, (xq.buf, xq.ts, xq.head, xq.tail, rot, mask, n_active,
                       task, ts, src, found, checked)), W, Q, reg.stream())
    reg.launched("pop_first", err)
    return xq, task, ts, src, found, checked


#: the plain PyTorch twin of each kernel (what the CPU path runs and what
#: the kernels are held against on the card)
PLAIN = {"ctr_add": ctr_add_ref, "push": xqueue.push,
         "pop_first": xqueue.pop_first}


def cuda_ops() -> StepOps:
    """The ``cuda`` :class:`~repro_torch.core.phases.StepOps` kernel set."""
    return StepOps(name="cuda", push=push, pop_first=pop_first,
                   ctr_add=ctr_add)
