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

Under an analysis (:mod:`repro_torch.kernels.trace_hooks`, driven by
:mod:`repro_torch.launch.hlo_analysis`) the three kernel ops record their
cost by formula (:func:`flash_cost`, :func:`rwkv6_cost`,
:func:`moe_dispatch_cost`: the bounds of PERF.md's kernel table) and run
with the count paused: on real tensors the kernel (or twin) as always, its
outputs copied into the kernel's layout; on fake tensors empty tensors of
the kernel's shapes.  Under grad each goes through an ``autograd.Function``
whose backward is the torch-ops backward of the card (``ref._attn_bwd``,
``ref.rwkv6_backward``, ``ref.moe_dispatch_backward``), on every device,
so a trace counts the same on the CPU as on the card.  With no analysis
active none of this runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.kernels import trace_hooks

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
    if trace_hooks.counting() is not None:
        args = (q, k, v, causal, window, softcap, q_chunk, kv_chunk)
        if _needs_grad(q, k, v):
            return _CountedFlash.apply(*args)
        return _counted_flash(*args, with_lse=False)[0]
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
    if trace_hooks.counting() is not None:
        if _needs_grad(r, k, v, w, u, state):
            return _CountedRWKV6.apply(r, k, v, w, u, state)
        return _counted_rwkv6(r, k, v, w, u, state)
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
    if trace_hooks.counting() is not None:
        if _needs_grad(x):
            return _CountedDispatch.apply(x, expert, pos, n_experts,
                                          capacity)
        return _counted_dispatch(x, expert, pos, n_experts, capacity)
    if _plain("moe_dispatch", x, "x"):
        return ref.moe_dispatch(x, expert, pos, n_experts, capacity)
    if x.is_cuda and _needs_grad(x):
        return md.MoEDispatch.apply(x, expert, pos, n_experts, capacity)
    return md.moe_dispatch(x, expert, pos, n_experts=n_experts,
                           capacity=capacity)


def moe_combine(y, expert, pos, weight, *, n_tokens: int, dtype=None):
    return ref.moe_combine(y, expert, pos, weight, n_tokens, dtype)


# ---------------------------------------------------------------------------
# under an analysis: the kernels by formula
# ---------------------------------------------------------------------------

def attention_pairs(S: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of an ``S``-long sequence that the mask keeps
    (``ref._block_mask``): ``k <= q`` when causal, ``q - k < window`` when
    windowed."""
    if not causal:
        # row q keeps the keys k > q - window: S less max(0, q - window + 1)
        m = max(0, S - window) if window > 0 else 0
        return S * S - m * (m + 1) // 2
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def flash_cost(q, k, v, causal: bool, window: int, with_lse: bool):
    """(operations, bytes) of one flash-attention forward: every kept
    (query, key) pair is a Dh product for the scores and one for P V, two
    operations a multiply-add; q, k, v read and out written once (and the
    float32 lse written, in training)."""
    B, H, S, Dh = q.shape
    flops = 4 * Dh * B * H * attention_pairs(S, causal, window)
    nbytes = 2 * _nbytes(q) + _nbytes(k, v) + (4 * B * H * S if with_lse
                                               else 0)
    return flops, nbytes


def rwkv6_cost(r, u, state):
    """(operations, bytes) of one RWKV6 recurrence: 5 Dh^2 + 5 Dh float32
    operations a (b, h, t); r, k, v, w read and out written once, u read,
    the state read and written."""
    B, H, T, Dh = r.shape
    return ((5 * Dh * Dh + 5 * Dh) * B * H * T,
            5 * _nbytes(r) + _nbytes(u) + 2 * _nbytes(state))


def moe_dispatch_cost(x, expert, n_experts: int, capacity: int):
    """(operations, bytes) of one dispatch: no arithmetic; x read once,
    the two int32 tables read once, the (E, C, D) buffer written once."""
    return 0, (_nbytes(x) + 2 * _nbytes(expert)
               + n_experts * capacity * x.shape[1] * x.element_size())


def _kernel_layout(out, like):
    """``out`` in a fresh ``empty_like(like)``: the layout the kernel
    writes (a twin's result may be laid out otherwise)."""
    buf = torch.empty_like(like)
    buf.copy_(out)
    return buf


def _counted_flash(q, k, v, causal, window, softcap, q_chunk, kv_chunk, *,
                   with_lse: bool):
    """``(out, lse)`` of one counted forward (lse None without it)."""
    a = trace_hooks.ACTIVE
    a.record("flash_attention", *flash_cost(q, k, v, causal, window,
                                            with_lse))
    B, H, S, _ = q.shape
    with a.paused():
        if a.is_fake(q):
            lse = q.new_empty((B, H, S), dtype=torch.float32)
            return torch.empty_like(q), lse if with_lse else None
        if _plain("flash_attention", q, "q") or not q.is_cuda:
            if with_lse:
                out, lse = ref._attn_fwd(q, k, v, causal, window, softcap,
                                         q_chunk, kv_chunk)
            else:
                out, lse = ref.flash_attention(
                    q, k, v, causal, window, softcap, q_chunk, kv_chunk), None
            return _kernel_layout(out, q), lse
        fa._check(q, k, v)
        return fa.launch_forward(q, k, v, causal, window, softcap, with_lse)


class _CountedFlash(torch.autograd.Function):
    """The counted forward (with lse) and the reference's chunked backward,
    counted op by op."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_chunk, kv_chunk):
        out, lse = _counted_flash(q, k, v, causal, window, softcap, q_chunk,
                                  kv_chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ref._attn_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def _counted_rwkv6(r, k, v, w, u, state):
    a = trace_hooks.ACTIVE
    a.record("rwkv6_scan", *rwkv6_cost(r, u, state))
    with a.paused():
        if a.is_fake(r):
            return torch.empty_like(r), torch.empty_like(state)
        if _plain("rwkv6", r, "r") or not r.is_cuda:
            out, s = rk.plain(r, k, v, w, u, state)
            return _kernel_layout(out, r), s
        return rk.rwkv6(r, k, v, w, u, state)


class _CountedRWKV6(torch.autograd.Function):
    """The counted recurrence and ``ref.rwkv6_backward`` (its loops
    scaled)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _counted_rwkv6(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dout, dstate):
        return ref.rwkv6_backward(*ctx.saved_tensors, dout, dstate)


def _counted_dispatch(x, expert, pos, n_experts, capacity):
    a = trace_hooks.ACTIVE
    a.record("moe_dispatch", *moe_dispatch_cost(x, expert, n_experts,
                                                capacity))
    with a.paused():
        if a.is_fake(x):
            return x.new_empty((n_experts, capacity, x.shape[1]))
        if _plain("moe_dispatch", x, "x") or not x.is_cuda:
            buf = ref.moe_dispatch(x, expert, pos, n_experts, capacity)
            out = x.new_empty(buf.shape)
            out.copy_(buf)
            return out
        return md.moe_dispatch(x, expert, pos, n_experts=n_experts,
                               capacity=capacity)


class _CountedDispatch(torch.autograd.Function):
    """The counted dispatch and ``ref.moe_dispatch_backward``."""

    @staticmethod
    def forward(ctx, x, expert, pos, n_experts, capacity):
        ctx.save_for_backward(expert, pos)
        ctx.sizes = (n_experts, capacity)
        return _counted_dispatch(x, expert, pos, n_experts, capacity)

    @staticmethod
    def backward(ctx, g):
        expert, pos = ctx.saved_tensors
        dx = ref.moe_dispatch_backward(g, expert, pos, *ctx.sizes)
        return dx, None, None, None, None
