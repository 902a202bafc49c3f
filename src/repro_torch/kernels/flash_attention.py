"""The flash-attention forward CUDA kernel, and its plain twin.

The port of the JAX package's Pallas kernel
(``src/repro/kernels/flash_attention.py``, ``flash_attention_pallas``):
causal / sliding-window / bidirectional attention forward with an online
softmax, float32
accumulators and a tanh softcap, written by hand in CUDA C++ for Hopper
(``csrc/flash_attention.cu``; the source says what bounds it and what its
design does about it).  The input type picks the kernel
(:data:`KERNEL_NAMES`): bfloat16 runs ``flash_fwd_wgmma_kernel`` on the
tensor cores (``wgmma``, TMA loads), float32 runs ``flash_fwd_kernel`` on
float32 FMAs.  It is built and bound the way every kernel of the
package is (:mod:`repro_torch.kernels.registry`: nvcc into
``build/repro_torch_kernels/<hash>/``, ``ctypes``, the current stream) and
counted in the package's one registry, ``registry.KERNELS``.

:func:`flash_attention` checks its inputs, then dispatches on where they
lie: a CUDA tensor launches the kernel (one added to its ``launches``
count; a refused launch raises), a CPU tensor takes the plain twin
:func:`repro_torch.kernels.ref.flash_attention`.  Nothing on the card falls
back to the twin.

Unlike the TPU wrapper, the kernel reads KV head ``h // (H // KV)``
directly instead of repeating k and v to ``H`` heads, and takes any
sequence length (the TPU wrapper leaves the rows past ``S // 128 * 128``
unwritten).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import registry as reg

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
#: head dims the kernel is instantiated for (multiples of 16 up to 256:
#: the smoke configs, repro_100m and hymba's 64, hubert's 80, the 128-wide
#: heads, nemotron, gemma2)
HEAD_DIMS = (16, 32, 64, 80, 128, 192, 256)
#: the kernel's I/O types, by the code its C entry point takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the CUDA kernel each I/O type runs, as the profiler names it
KERNEL_NAMES = {torch.float32: "flash_fwd_kernel",
                torch.bfloat16: "flash_fwd_wgmma_kernel"}


def build() -> tuple[Path, str]:
    """Build ``csrc/flash_attention.cu`` (see :func:`registry.build`)."""
    return reg.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fa_forward.argtypes = ([ptr] * 4 + [i32] * 9
                               + [ctypes.c_float, ctypes.c_float, ptr])
    lib.fa_forward.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, Dh), (B, KV, S, Dh)")
    B, H, S, Dh = q.shape
    KV = k.shape[1]
    if tuple(k.shape) != (B, KV, S, Dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         "heads")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype} is not one of {list(DTYPES)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float | None = None) -> torch.Tensor:
    """Attention forward.  q ``(B, H, S, Dh)``; k, v ``(B, KV, S, Dh)``;
    float32 or bfloat16; returns ``(B, H, S, Dh)`` in ``q.dtype``."""
    _check(q, k, v)
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal, window, softcap)
    B, H, S, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} is not one of {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("bfloat16 q, k and v must start on a 16-byte "
                         "boundary (TMA)")
    out = torch.empty_like(q)
    err = _library().fa_forward(
        *(t.data_ptr() for t in (q, k, v, out)), B, H, k.shape[1], S, Dh,
        DTYPES[q.dtype], int(causal), int(window), int(softcap is not None),
        float(softcap or 0.0), float(Dh ** -0.5), reg.stream())
    reg.launched("flash_attention", err)
    return out
