"""Public kernel API with implementation dispatch (the port of the JAX
package's ``kernels/ops.py``: its attention, RWKV6, SSM and MoE entry
points).

Models call these wrappers.  ``set_impl`` forces a path, for every op that
has a kernel or for the ops it names:

  set_impl("ref")     always the plain PyTorch twin (``kernels/ref.py``)
  set_impl("cuda")    always the CUDA kernel; a CPU tensor raises
  set_impl(None)      by the tensor (default): a CUDA tensor launches the
                      kernel, a CPU tensor takes the plain twin
  set_impl("ref", "moe_dispatch")   only that op's twin, the rest as set

``decode_attention``, ``rwkv6_decode``, ``ssm_scan``, ``ssm_decode`` and
``moe_combine`` have no kernel in either package: they are the plain ops.
The JAX ``rwkv6`` and ``ssm_scan`` read a chunk from the environment
(``REPRO_RWKV_CHUNK``, ``REPRO_SSM_CHUNK``); the chunk does not change the
result (the chunked forms run the same sequential steps), so here neither
takes one: ``rwkv6``'s twin walks the steps one by one
(``ref.rwkv6_naive``), and so does ``ssm_scan`` (``ref.ssm_scan``).

Gradients: every op is differentiable on both paths.  On the card,
where grad is enabled and an input requires it, each kernel runs inside
an ``autograd.Function`` whose forward is the launch and whose backward
is plain PyTorch (neither package has a backward kernel):
``flash_attention`` the reference's chunked ``_attn_bwd``, ``rwkv6``
``ref.rwkv6_backward`` (:class:`~repro_torch.kernels.rwkv6_scan.RWKV6Scan`),
``moe_dispatch`` the twin's gather
(:class:`~repro_torch.kernels.moe_dispatch.MoEDispatch`); without grad
they launch the kernel alone.  On the CPU the twins are differentiated by
autograd (flash through its own ``autograd.Function``).  ``ssm_scan``
runs its steps through ``ref.SSMScan`` under grad on either device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as rk

IMPLS = (None, "ref", "cuda")
#: the ops that have a kernel
KERNEL_OPS = ("flash_attention", "rwkv6", "moe_dispatch")
_FORCE = dict.fromkeys(KERNEL_OPS)


def _plain(op: str, x, name: str) -> bool:
    """Whether ``op`` takes its plain twin; raises when it is forced to the
    kernel with a tensor ``x`` (argument ``name``) that is not on the
    card."""
    if _FORCE[op] == "cuda" and not x.is_cuda:
        raise RuntimeError(f"set_impl('cuda') needs CUDA tensors; {name} is "
                           f"on {x.device}")
    return _FORCE[op] == "ref"


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def set_impl(impl, *ops) -> None:
    """Force ``impl`` (one of :data:`IMPLS`) for the named ops, or for every
    op of :data:`KERNEL_OPS` when none is named."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    for op in ops:
        if op not in _FORCE:
            raise ValueError(f"{op!r} is not one of {KERNEL_OPS}")
    for op in ops or KERNEL_OPS:
        _FORCE[op] = impl


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None,
                    q_chunk=1024, kv_chunk=1024):
    if _plain("flash_attention", q, "q"):
        return ref.flash_attention(q, k, v, causal, window, softcap,
                                   q_chunk, kv_chunk)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0,
                     softcap=None):
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, softcap=softcap)


def rwkv6(r, k, v, w, u, state):
    if _plain("rwkv6", r, "r"):
        return rk.plain(r, k, v, w, u, state)
    if r.is_cuda and _needs_grad(r, k, v, w, u, state):
        return rk.RWKV6Scan.apply(r, k, v, w, u, state)
    return rk.rwkv6(r, k, v, w, u, state)


def rwkv6_decode(r, k, v, w, u, state):
    return ref.rwkv6_decode(r, k, v, w, u, state)


def ssm_scan(x, dt, A, Bm, Cm, D, state):
    return ref.ssm_scan(x, dt, A, Bm, Cm, D, state)


def ssm_decode(x, dt, A, Bm, Cm, D, state):
    return ref.ssm_decode(x, dt, A, Bm, Cm, D, state)


def moe_dispatch(x, expert, pos, *, n_experts: int, capacity: int):
    if _plain("moe_dispatch", x, "x"):
        return ref.moe_dispatch(x, expert, pos, n_experts, capacity)
    if x.is_cuda and _needs_grad(x):
        return md.MoEDispatch.apply(x, expert, pos, n_experts, capacity)
    return md.moe_dispatch(x, expert, pos, n_experts=n_experts,
                           capacity=capacity)


def moe_combine(y, expert, pos, weight, *, n_tokens: int):
    return ref.moe_combine(y, expert, pos, weight, n_tokens)
