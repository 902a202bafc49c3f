"""CUDA kernels for the scheduler's hot queue ops, and their plain twins.

The port of the JAX package's Pallas kernel set
(``src/repro/kernels/sched_queue.py``): the XQueue SPSC push, the rotated
pop scan and the counter-column bump, written by hand in CUDA C++ for
Hopper (``csrc/sched_queue.cu``) and bound through a plain C interface:

* at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` builds the
  source into ``build/repro_torch_kernels/<hash>/`` at the repository root,
  keyed by a hash of the source and the flags;
* the library is loaded with ``ctypes``; every pointer and the stream pass
  as ``c_void_p``; kernels launch on ``torch.cuda.current_stream()``;
* each C entry point returns ``cudaGetLastError()`` and the wrapper raises
  if it is not 0.  A missing ``nvcc`` or a failed build raises too.

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
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core import xqueue
from repro_torch.core.phases import StepOps, ctr_add_ref
from repro_torch.core.xqueue import XQ

I32 = torch.int32
SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_queue.cu"
#: build output root: ``build/`` at the repository root (git-ignored)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its name, the TPU kernel it replaces, and
    how many times its wrapper launched it."""
    name: str
    replaces: str
    launches: int = 0


#: every hand-written kernel of the package, with its launch count (the
#: fused step of :mod:`repro_torch.kernels.sched_step`, the attention
#: forward of :mod:`repro_torch.kernels.flash_attention` and the RWKV6
#: recurrence of :mod:`repro_torch.kernels.rwkv6_scan` included)
KERNELS = {k.name: k for k in (
    Kernel("ctr_add", "src/repro/kernels/sched_queue.py:54"),
    Kernel("push", "src/repro/kernels/sched_queue.py:108"),
    Kernel("pop_first", "src/repro/kernels/sched_queue.py:144"),
    Kernel("sched_step", "src/repro/kernels/sched_step.py:121"),
    Kernel("flash_attention", "src/repro/kernels/flash_attention.py:105"),
    Kernel("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:67"),
)}
#: the three kernels of this module's source
QUEUE_KERNELS = ("ctr_add", "push", "pop_first")


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{source.name}")


def build(source: Path = SOURCE) -> tuple[Path, str]:
    """Compile one CUDA source into its own shared library if this
    source/flag hash has none yet.  Returns ``(library path, compiler
    log)`` (the log is empty when the library was already built)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_ROOT / digest / f"lib{source.stem}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(source), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


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


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err} ({torch.cuda.get_device_name()})")
    KERNELS[name].launches += 1


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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
    err = _library().sq_ctr_add(_p(ctr), _p(val), W, nc, col, _stream())
    _launched("ctr_add", err)
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
        _p(xq.buf), _p(xq.ts), _p(xq.head), _p(xq.tail), _p(producer),
        _p(consumer), _p(task), _p(ts), _p(mask), _p(ok), W, Q, _stream())
    _launched("push", err)
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
        _p(xq.buf), _p(xq.ts), _p(xq.head), _p(xq.tail), _p(rot), _p(mask),
        _p(n_active), _p(task), _p(ts), _p(src), _p(found), _p(checked),
        W, Q, _stream())
    _launched("pop_first", err)
    return xq, task, ts, src, found, checked


#: the plain PyTorch twin of each kernel (what the CPU path runs and what
#: the kernels are held against on the card)
PLAIN = {"ctr_add": ctr_add_ref, "push": xqueue.push,
         "pop_first": xqueue.pop_first}


def cuda_ops() -> StepOps:
    """The ``cuda`` :class:`~repro_torch.core.phases.StepOps` kernel set."""
    return StepOps(name="cuda", push=push, pop_first=pop_first,
                   ctr_add=ctr_add)
