"""The RWKV6-recurrence CUDA kernel, and its plain twin.

The port of the JAX package's Pallas kernel
(``src/repro/kernels/rwkv6_scan.py``, ``rwkv6_pallas``): the sequential
RWKV6 recurrence with its ``(Dh, Dh)`` float32 state kept on chip for the
whole sequence, written by hand in CUDA C++ for Hopper
(``csrc/rwkv6_scan.cu``; the source says what bounds it and what its design
does about it: each ``(b, h)`` split over blocks by value columns and
within a warp over lanes by keys, and load warps that bring in the next
tile while step warps run this one).  It is built and bound the way every
kernel of the package is (:mod:`repro_torch.kernels.registry`: nvcc into
``build/repro_torch_kernels/<hash>/``, ``ctypes``, the current stream) and
counted in the package's one registry, ``registry.KERNELS``.

:func:`rwkv6` checks its inputs, then dispatches on where they lie: a CUDA
tensor launches the kernel (one added to its ``launches`` count; a refused
launch raises), a CPU tensor takes the plain twin :func:`plain`.  Nothing
on the card falls back to the twin.

The kernel reads r, k, v and w through their strides (the head dim
contiguous, the four sharing one layout) and writes ``out`` in the layout
of ``r``: the model's ``(B, T, H, Dh)`` buffers viewed as ``(B, H, T, Dh)``
go in and come out without a transpose copy.  Unlike the TPU wrapper, which
walks ``T // 128 * 128`` steps and leaves the rest of the output unwritten,
it takes any T.

:class:`RWKV6Scan` makes the recurrence differentiable: its forward is
:func:`rwkv6` (the kernel on the card), its backward the gradient as torch
ops (:func:`repro_torch.kernels.ref.rwkv6_backward`); neither package has a
backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import registry as reg

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
#: head dims the kernel is instantiated for: the smoke config (16), the JAX
#: package's kernel tests (32) and rwkv6_1_6b (64)
HEAD_DIMS = (16, 32, 64)
#: the kernel's I/O types, by the code its C entry point takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> tuple[Path, str]:
    """Build ``csrc/rwkv6_scan.cu`` (see :func:`registry.build`)."""
    return reg.build(SOURCE)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/rwkv6_scan.cu`` (or an edited copy
    of it) and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_forward.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 6 + [ptr]
    lib.rwkv6_forward.restype = ctypes.c_int
    lib.rwkv6_launch_shape.argtypes = [i32] * 3 + [ptr]
    lib.rwkv6_launch_shape.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(build()[0])


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4:
        raise ValueError("r, k, v, w must be (B, H, T, Dh)")
    B, H, T, Dh = r.shape
    if min(B, H, T, Dh) < 1:
        raise ValueError(f"empty input of shape {tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
        if t.dtype != r.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, r {r.dtype}")
    if r.dtype not in DTYPES:
        raise TypeError(f"dtype {r.dtype} is not one of {list(DTYPES)}")
    for name, t, shape in (("u", u, (H, Dh)),
                           ("state", state, (B, H, Dh, Dh))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")


def plain(r, k, v, w, u, state):
    """The kernel's plain twin: ``ref.rwkv6_naive``, the steps one by one
    in time order (any T)."""
    return ref.rwkv6_naive(r, k, v, w, u, state)


def launch_shape(B: int, H: int, Dh: int) -> dict:
    """The launch :func:`rwkv6` makes for these sizes (either I/O type), as
    the library reports it (``rwkv6_launch_shape``; launches nothing):
    blocks, threads a block (step and load warps), shared bytes a block,
    value columns a lane, value columns a block and steps a tile."""
    shape = (ctypes.c_int * 6)()
    if _library().rwkv6_launch_shape(B, H, Dh, shape) != 0:
        raise ValueError(f"no launch for head dim {Dh}")
    return dict(zip(("blocks", "threads", "shared_bytes", "lane_columns",
                     "block_columns", "tile_steps"), shape))


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence.  r/k/v/w ``(B, H, T, Dh)`` float32 or bfloat16;
    u ``(H, Dh)`` and state ``(B, H, Dh, Dh)`` float32.  Returns (out
    ``(B, H, T, Dh)`` in ``r.dtype``, final state float32)."""
    _check(r, k, v, w, u, state)
    if not r.is_cuda:
        return plain(r, k, v, w, u, state)
    B, H, T, Dh = r.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} is not one of {HEAD_DIMS}")
    if any(t.stride() != r.stride() for t in (k, v, w)) or r.stride(3) != 1:
        raise ValueError("r, k, v, w must share one layout with the head "
                         f"dim contiguous (strides {r.stride()}, "
                         f"{k.stride()}, {v.stride()}, {w.stride()})")
    if not (u.is_contiguous() and state.is_contiguous()):
        raise ValueError("u and state must be contiguous")
    out = torch.empty_like(r)     # r's layout when r is dense, else packed
    s_out = torch.empty_like(state)
    err = _library().rwkv6_forward(
        *(t.data_ptr() for t in (r, k, v, w, u, state, out, s_out)),
        B, H, T, Dh, DTYPES[r.dtype], r.stride(0), r.stride(1), r.stride(2),
        out.stride(0), out.stride(1), out.stride(2), reg.stream())
    reg.launched("rwkv6_scan", err)
    return out, s_out


class RWKV6Scan(torch.autograd.Function):
    """:func:`rwkv6` saving its inputs, and ``ref.rwkv6_backward`` (range
    ``rwkv6_backward``).  Returns ``(out, state)``; the gradients come in
    each input's dtype and shape, so autograd takes them for strided views
    such as the model's ``(B, T, H, Dh)`` buffers seen as ``(B, H, T,
    Dh)``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return rwkv6(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dout, dstate):
        with torch.profiler.record_function("rwkv6_backward"):
            return ref.rwkv6_backward(*ctx.saved_tensors, dout, dstate)
