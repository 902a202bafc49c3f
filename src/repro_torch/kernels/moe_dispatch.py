"""The MoE-dispatch CUDA kernel, and its plain twin.

The port of the JAX package's Pallas kernel
(``src/repro/kernels/moe_dispatch.py``, ``moe_dispatch_pallas``): token
rows ``x (T, D)`` scattered into per-expert capacity buffers ``(E, C, D)``
by the ``(expert, pos)`` tables that routing (:mod:`repro_torch.core.balance`)
makes, written by hand in CUDA C++ for Hopper (``csrc/moe_dispatch.cu``).
It is built and bound the way every kernel of the package is
(:mod:`repro_torch.kernels.registry`: nvcc into
``build/repro_torch_kernels/<hash>/``, ``ctypes``, the current stream) and
counted in the package's one registry, ``registry.KERNELS``.

What bounds it is bytes: the rows of x that kept slots read, the tables,
and the buffer written once (0.0426 ms at the moonshot prefill shape on an
H100's 3.35 TB/s; 0.0041 ms at a tp = 16 rank's 4 experts, where the
host's work for a call is larger than the device's).  The design (the
source says more): one cooperative launch a call and nothing else on
the stream, its grid sized by the occupancy API, in two phases with one
grid barrier between them: each kept slot's token into a row map by a
64-bit ``atomicMax`` of ``(generation << 32) | token``, then the rows
written token-major, so a row of x is read once.  The map is kept one a
device and stream (:func:`_row_map`) and a call counts only the entries
of its own generation, so it needs no memset between calls.  Rows whose
size and both base addresses are multiples of 16 bytes move by Hopper's
bulk asynchronous copies through a ring of shared-memory buffers, every
other row by a warp's widest vector copy (:func:`copy_path`).  Its times
on the card are in PERF.md (section 6, row 7), from ``chip_smoke.py``
phases 8 and 17 (c) and ``python3 -m repro_torch.step_bench
--dispatch-only``.

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
the row of the highest token (as the Pallas kernel's in-order last write;
``ref.moe_dispatch_rows`` is that row map).
Unlike the TPU wrapper, which dispatches only the first
``T // 256 * 256`` tokens, the kernel takes any T.

:class:`MoEDispatch` makes the dispatch differentiable in x: its forward
is :func:`moe_dispatch` (the kernel on the card), its backward the gather
of ``ref.moe_dispatch_backward``, the twin's autograd backward op for op,
so the kernel's gradient equals the twin's bit for bit.
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
#: :func:`copy_path`'s value for the bulk asynchronous copies
BULK = 0
#: the CUDA kernel of each copy path, as the profiler names it
KERNEL_NAMES = {"bulk": "moe_dispatch_bulk", "vector": "moe_dispatch_vec"}


def build() -> tuple[Path, str]:
    """Build ``csrc/moe_dispatch.cu`` (see :func:`registry.build`)."""
    return reg.build(SOURCE)


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``csrc/moe_dispatch.cu`` (or an edited
    copy of it) and declare its entry point."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_dispatch.argtypes = ([ptr] * 5 + [i64, i32, i32, i64, i64, i32,
                                              ctypes.c_ulonglong, ptr])
    lib.moe_dispatch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(build()[0])


def _check(x, expert, pos, n_experts: int, capacity: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (T, D), not {tuple(x.shape)}")
    shape = expert.shape
    if len(shape) != 2 or shape[0] != x.shape[0]:
        raise ValueError(f"expert {tuple(shape)} is not (T, k) for x "
                         f"{tuple(x.shape)}")
    if pos.shape != shape:
        raise ValueError(f"pos {tuple(pos.shape)} does not match expert "
                         f"{tuple(shape)}")
    device = x.device
    for name, t in (("expert", expert), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected int32")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    if n_experts < 1 or capacity < 1:
        raise ValueError(f"{n_experts} experts of capacity {capacity}")


def vec_bytes(*addresses_and_sizes: int) -> int:
    """The widest copy unit of :data:`VEC_BYTES` that divides every given
    address and byte count: the lowest set bit of them all, at most 16."""
    bits = 0
    for a in addresses_and_sizes:
        bits |= a
    return min(bits & -bits, VEC_BYTES[0]) if bits else VEC_BYTES[0]


def copy_path(x_addr: int, out_addr: int, row_bytes: int) -> int:
    """How the kernel copies rows of ``row_bytes`` bytes from ``x_addr`` to
    ``out_addr``: :data:`BULK` (Hopper's bulk asynchronous copies) where
    the row size and both addresses are multiples of 16 bytes, which those
    copies need; else a warp's vector copies in the widest unit that
    divides all three (8, 4, 2 or 1 bytes, :func:`vec_bytes`)."""
    unit = vec_bytes(x_addr, out_addr, row_bytes)
    return BULK if unit == 16 else unit


#: the largest generation of a row map (its entries keep it in 32 bits)
GENERATIONS = 2**32 - 1
#: the kernel's row map, one a (device, stream): ``[map, its address, the
#: last call's generation]``.  Its 64-bit entries are ``(generation << 32)
#: | token``, and a call counts only the entries of its own generation, so
#: the map needs no reset between calls; it is zeroed when it is made
#: (larger, when a call needs more rows) and when the generations run out
_ROW_MAPS: dict = {}


def _row_map(device: int, stream: int, n_rows: int) -> tuple[int, int]:
    """The address of a row map of at least ``n_rows`` entries for
    ``stream`` of ``device``, and this call's generation on it."""
    have = _ROW_MAPS.get((device, stream))
    if have is None or have[0].numel() < n_rows:
        rows = torch.zeros((n_rows,), dtype=torch.int64,
                           device=torch.device("cuda", device))
        have = _ROW_MAPS[(device, stream)] = [rows, rows.data_ptr(), 0]
    if have[2] == GENERATIONS:
        have[0].zero_()
        have[2] = 0
    have[2] += 1
    return have[1], have[2]


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
    n_rows = n_experts * capacity
    out = x.new_empty((n_experts, capacity, D))
    row_bytes = D * x.element_size()
    x_addr, out_addr = x.data_ptr(), out.data_ptr()
    device = x.get_device()
    stream = reg.stream(device)
    rows, generation = _row_map(device, stream, n_rows)
    err = _library().moe_dispatch(
        x_addr, expert.data_ptr(), pos.data_ptr(), out_addr, rows, T * k, k,
        capacity, n_rows, row_bytes, copy_path(x_addr, out_addr, row_bytes),
        generation, stream)
    reg.launched("moe_dispatch", err)
    return out


class MoEDispatch(torch.autograd.Function):
    """:func:`moe_dispatch`, and ``ref.moe_dispatch_backward`` (range
    ``moe_dispatch_backward``) for x; the int32 tables get no gradient."""

    @staticmethod
    def forward(ctx, x, expert, pos, n_experts, capacity):
        ctx.save_for_backward(expert, pos)
        ctx.sizes = (n_experts, capacity)
        return moe_dispatch(x, expert, pos, n_experts=n_experts,
                            capacity=capacity)

    @staticmethod
    def backward(ctx, g):
        expert, pos = ctx.saved_tensors
        with torch.profiler.record_function("moe_dispatch_backward"):
            dx = ref.moe_dispatch_backward(g, expert, pos, *ctx.sizes)
        return dx, None, None, None, None
