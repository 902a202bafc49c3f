"""The MoE-dispatch CUDA kernel, and its plain twin.

The port of the JAX package's Pallas kernel
(``src/repro/kernels/moe_dispatch.py``, ``moe_dispatch_pallas``): token
rows ``x (T, D)`` scattered into per-expert capacity buffers ``(E, C, D)``
by the ``(expert, pos)`` tables that routing (:mod:`repro_torch.core.balance`)
makes, written by hand in CUDA C++ for Hopper (``csrc/moe_dispatch.cu``;
the source says what bounds it and what its design does about it).  It is
built and bound the way every kernel of the package is
(:mod:`repro_torch.kernels.registry`: nvcc into
``build/repro_torch_kernels/<hash>/``, ``ctypes``, the current stream) and
counted in the package's one registry, ``registry.KERNELS``.

:func:`moe_dispatch` checks its inputs, then dispatches on where they lie:
a CUDA tensor launches the kernel (one added to its ``launches`` count; a
refused launch raises), a CPU tensor takes the plain twin
:func:`repro_torch.kernels.ref.moe_dispatch`.  Nothing on the card falls
back to the twin.

The contract, for every table routing can make (each kept ``(expert,
pos)`` pair unique and in range): row ``expert * C + pos`` holds ``x[t]``,
every other row is zero, and a slot with ``expert`` or ``pos`` -1 is
dropped.  Kernel and twin agree on it bit for bit: the kernel only moves
bytes.  Pairs that share a row are the one case where they differ: the
twin sums the rows (as the reference's ``.at[idx].add``), the kernel keeps
the row of the highest token (as the Pallas kernel's in-order last write).
Unlike the TPU wrapper, which dispatches only the first
``T // 256 * 256`` tokens, the kernel takes any T.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import registry as reg

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu"
#: the widths the kernel copies a row in, widest first
VEC_BYTES = (16, 8, 4, 2, 1)


def build() -> tuple[Path, str]:
    """Build ``csrc/moe_dispatch.cu`` (see :func:`registry.build`)."""
    return reg.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_dispatch.argtypes = ([ptr] * 5 + [i64, i32, i32, i64, i64, i32]
                                 + [ptr])
    lib.moe_dispatch.restype = ctypes.c_int
    return lib


def _check(x, expert, pos, n_experts: int, capacity: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), not {tuple(x.shape)}")
    if expert.dim() != 2 or expert.shape[0] != x.shape[0]:
        raise ValueError(f"expert {tuple(expert.shape)} is not (T, k) for x "
                         f"{tuple(x.shape)}")
    if tuple(pos.shape) != tuple(expert.shape):
        raise ValueError(f"pos {tuple(pos.shape)} does not match expert "
                         f"{tuple(expert.shape)}")
    for name, t in (("expert", expert), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected int32")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if n_experts < 1 or capacity < 1:
        raise ValueError(f"{n_experts} experts of capacity {capacity}")


def vec_bytes(*addresses_and_sizes: int) -> int:
    """The widest copy unit of :data:`VEC_BYTES` that divides every given
    address and byte count."""
    return next(v for v in VEC_BYTES
                if all(a % v == 0 for a in addresses_and_sizes))


def moe_dispatch(x: torch.Tensor, expert: torch.Tensor, pos: torch.Tensor,
                 *, n_experts: int, capacity: int) -> torch.Tensor:
    """Scatter the rows of x ``(T, D)`` into ``(n_experts, capacity, D)``
    buffers in ``x.dtype`` by the int32 ``(T, k)`` tables ``expert`` and
    ``pos`` (-1: dropped).  See the module docstring for the contract."""
    _check(x, expert, pos, n_experts, capacity)
    if not x.is_cuda:
        return ref.moe_dispatch(x, expert, pos, n_experts, capacity)
    for name, t in (("x", x), ("expert", expert), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T, D = x.shape
    k = expert.shape[1]
    out = torch.empty((n_experts, capacity, D), dtype=x.dtype,
                      device=x.device)
    row_of = torch.empty(n_experts * capacity, dtype=torch.int32,
                         device=x.device)
    row_bytes = D * x.element_size()
    err = _library().moe_dispatch(
        *(t.data_ptr() for t in (x, expert, pos, out, row_of)), T * k, k,
        capacity, n_experts * capacity, row_bytes,
        vec_bytes(x.data_ptr(), out.data_ptr(), row_bytes), reg.stream())
    reg.launched("moe_dispatch", err)
    return out
