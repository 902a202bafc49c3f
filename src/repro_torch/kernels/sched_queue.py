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
are bound by launch latency and by this module's host path on the card
(see the source notes), so each wrapper reads only cheap tensor
attributes, makes its outputs with ``empty_like`` of a checked argument
and passes its arguments as one packed bytes record.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import torch

from repro_torch.core import xqueue
from repro_torch.core.phases import (CTR_PAIRS_MAX, StepOps, ctr_add_ref,
                                     ctr_pairs)
from repro_torch.core.xqueue import XQ
from repro_torch.kernels import registry as reg

I32, BOOL = torch.int32, torch.bool
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
    lib.sq_ctr_add.argtypes = [ptr, i32, i32, i32, ctypes.c_char_p, ptr]
    # push, pop_first and the timing tools' empty launch: one packed record
    for fn in (lib.sq_push, lib.sq_pop_first, lib.sq_noop):
        fn.argtypes = [ctypes.c_char_p, ptr]
    for fn in (lib.sq_ctr_add, lib.sq_push, lib.sq_pop_first, lib.sq_noop):
        fn.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           where: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the device of index ``where`` (as ``Tensor.get_device()`` gives it: -1
    is the CPU).  Every wrapper checks every tensor on every launch, and on
    the card the host path is these kernels' cost, so only cheap attributes
    are read."""
    if t.get_device() != where:
        raise ValueError(f"{name} is on {t.device}, expected "
                         f"{'cpu' if where < 0 else f'cuda:{where}'}")
    if t.dtype is not dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------- counter bump ----------------
#: the host layout of a bump's pairs for ``sq_ctr_add``: n value pointers,
#: then n codes ``col * 2 + is_bool``
_PACK = [struct.Struct(f"<{n}Q{n}i") for n in range(CTR_PAIRS_MAX + 1)]


def ctr_add(ctr: torch.Tensor, col_or_pairs, val=None) -> torch.Tensor:
    """``ctr[:, col] += val``, or the same for each ``(col, val)`` pair of
    a sequence of up to 16 in order (:func:`phases.ctr_add_ref`); each value
    is a (W,) int32 or bool tensor.  On the card: one launch, in place; on
    the CPU: the plain twin.

    The host path is the cost of this kernel (its device work is a few
    hundred bytes), so the checks read only cheap tensor attributes, the
    pairs pass packed in one bytes object and the stream as a raw handle.
    """
    pairs = ctr_pairs(col_or_pairs, val)
    if ctr.dim() != 2:
        raise ValueError(f"ctr has shape {tuple(ctr.shape)}, expected "
                         "(W, n_counters)")
    W, nc = ctr.shape
    where = ctr.get_device()
    _check(ctr, "ctr", (W, nc), I32, where)
    ptrs, codes = [], []
    for col, v in pairs:
        is_bool = v.dtype is BOOL
        _check(v, "val", (W,), BOOL if is_bool else I32, where)
        if not 0 <= col < nc:
            raise IndexError(f"counter column {col} out of range [0, {nc})")
        ptrs.append(v.data_ptr())
        codes.append(2 * col + is_bool)
    if where < 0:
        return ctr_add_ref(ctr, pairs)
    err = _library().sq_ctr_add(ctr.data_ptr(), W, nc, len(pairs),
                                _PACK[len(pairs)].pack(*ptrs, *codes),
                                reg.stream())
    reg.launched("ctr_add", err)
    return ctr


# ---------------- the queue leaves ----------------
def _check_queues(xq: XQ) -> tuple:
    """Check the four leaves of ``xq``; return ``(W, Q, where)``.  W and Q
    are read once, from ``buf``, and the other leaves are held to them."""
    buf = xq.buf
    shape = buf.shape
    W, Q = shape[0], shape[-1]
    where = buf.get_device()
    _check(buf, "buf", (W, W, Q), I32, where)
    _check(xq.ts, "ts", (W, W, Q), I32, where)
    _check(xq.head, "head", (W, W), I32, where)
    _check(xq.tail, "tail", (W, W), I32, where)
    return W, Q, where


# ---------------- SPSC push ----------------
#: ``struct PushArgs`` of ``csrc/sched_queue.cu``: the pointers buf, ts,
#: head, tail, producer, consumer, task, tsv, mask and ok, then W and Q
_PUSH = struct.Struct("<10Q2i")
#: the widest W the kernel's one block of W threads holds: ``PUSH_W_MAX``
#: in ``csrc/sched_queue.cu``
PUSH_W_MAX = 1024


def _push_checks(xq: XQ, producer, consumer, task, ts, mask) -> tuple:
    """Check a push's arguments; return ``(W, Q, where)``."""
    W, Q, where = _check_queues(xq)
    if W > PUSH_W_MAX:
        raise ValueError(f"push takes at most {PUSH_W_MAX} workers, got {W}")
    lane = (W,)
    _check(producer, "producer", lane, I32, where)
    _check(consumer, "consumer", lane, I32, where)
    _check(task, "task", lane, I32, where)
    _check(ts, "ts", lane, I32, where)
    _check(mask, "mask", lane, BOOL, where)
    return W, Q, where


def _push_record(xq: XQ, producer, consumer, task, ts, mask, ok, W: int,
                 Q: int) -> bytes:
    return _PUSH.pack(xq.buf.data_ptr(), xq.ts.data_ptr(),
                      xq.head.data_ptr(), xq.tail.data_ptr(),
                      producer.data_ptr(), consumer.data_ptr(),
                      task.data_ptr(), ts.data_ptr(), mask.data_ptr(),
                      ok.data_ptr(), W, Q)


def push(xq: XQ, producer: torch.Tensor, consumer: torch.Tensor,
         task: torch.Tensor, ts: torch.Tensor, mask: torch.Tensor):
    """:func:`repro_torch.core.xqueue.push` (same signature and result);
    on the card it writes ``xq`` in place and returns it.

    On the card the host path is this kernel's cost (its device work is a
    few hundred bytes): the checks read only cheap attributes, ``ok`` is
    the one allocation (``empty_like(mask)``), the pointers, W and Q pass
    as one packed record, and the stream is the queue's device's.  W is at
    most :data:`PUSH_W_MAX` on every device."""
    W, Q, where = _push_checks(xq, producer, consumer, task, ts, mask)
    if where < 0:
        return xqueue.push(xq, producer, consumer, task, ts, mask)
    ok = torch.empty_like(mask)
    err = _library().sq_push(
        _push_record(xq, producer, consumer, task, ts, mask, ok, W, Q),
        reg.stream(where))
    reg.launched("push", err)
    return xq, ok


# ---------------- pop scan ----------------
#: ``struct PopArgs`` of ``csrc/sched_queue.cu``: the pointers buf, ts,
#: head, tail, rot, mask, n_active (0: none), task, ts, src, found and
#: checked, then W, Q and the n_active value, padded to 8 bytes
_POP = struct.Struct("<12Q3i4x")
#: the widest W the kernel's scan key (position << 16 | producer) holds:
#: ``POP_W_MAX`` in ``csrc/sched_queue.cu``
POP_W_MAX = 0xFFFF - 1


def _pop_checks(xq: XQ, rot, mask, n_active) -> tuple:
    """Check a pop's arguments; return ``(W, Q, where)``."""
    W, Q, where = _check_queues(xq)
    if W > POP_W_MAX:
        raise ValueError(f"pop_first takes at most {POP_W_MAX} workers, "
                         f"got {W}")
    _check(rot, "rot", (W,), I32, where)
    _check(mask, "mask", (W,), BOOL, where)
    if n_active is not None:
        _check(n_active, "n_active", (), I32, where)
    return W, Q, where


def _pop_outputs(rot: torch.Tensor, mask: torch.Tensor) -> tuple:
    """A pop's outputs ``(task, ts, src, found, checked)``: (W,) int32
    tensors like ``rot`` and a (W,) bool like ``mask``, each its own
    allocation.  ``empty_like`` of a checked tensor parses no dtype or
    device; on the card's host five of these cost less than one buffer and
    the five views of it that would hand it out (``PERF.md``)."""
    return (torch.empty_like(rot), torch.empty_like(rot),
            torch.empty_like(rot), torch.empty_like(mask),
            torch.empty_like(rot))


def _pop_record(xq: XQ, rot, mask, n_active, outs, W: int, Q: int) -> bytes:
    task, ts, src, found, checked = outs
    if n_active is None:
        na_ptr, na = 0, W
    else:
        na_ptr, na = n_active.data_ptr(), 0
    return _POP.pack(xq.buf.data_ptr(), xq.ts.data_ptr(), xq.head.data_ptr(),
                     xq.tail.data_ptr(), rot.data_ptr(), mask.data_ptr(),
                     na_ptr, task.data_ptr(), ts.data_ptr(), src.data_ptr(),
                     found.data_ptr(), checked.data_ptr(), W, Q, na)


def pop_first(xq: XQ, rot: torch.Tensor, mask: torch.Tensor, n_active=None):
    """:func:`repro_torch.core.xqueue.pop_first` (same signature and
    result); on the card it advances ``xq.head`` in place.  ``n_active`` is
    a 0-dim int32 tensor on the queue's device (read by the kernel, never
    copied to the host), or None for the width (passed by value).

    As for :func:`push`, the host path is the cost: cheap checks, the
    outputs made like the checked lanes (:func:`_pop_outputs`) and one
    packed record.  W is at most :data:`POP_W_MAX` on every device."""
    W, Q, where = _pop_checks(xq, rot, mask, n_active)
    if where < 0:
        return xqueue.pop_first(xq, rot, mask, n_active)
    outs = _pop_outputs(rot, mask)
    err = _library().sq_pop_first(
        _pop_record(xq, rot, mask, n_active, outs, W, Q), reg.stream(where))
    reg.launched("pop_first", err)
    return (xq, *outs)


#: the plain PyTorch twin of each kernel (what the CPU path runs and what
#: the kernels are held against on the card)
PLAIN = {"ctr_add": ctr_add_ref, "push": xqueue.push,
         "pop_first": xqueue.pop_first}


def cuda_ops() -> StepOps:
    """The ``cuda`` :class:`~repro_torch.core.phases.StepOps` kernel set."""
    return StepOps(name="cuda", push=push, pop_first=pop_first,
                   ctr_add=ctr_add)
