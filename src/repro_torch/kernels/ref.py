"""Plain PyTorch references (oracles) for the model stack's kernels: the
port of the JAX package's ``kernels/ref.py``.

``flash_attention`` is the plain twin of the hand-written CUDA kernel of
:mod:`repro_torch.kernels.flash_attention`: the CPU path, and what the
kernel is held against on the card.  It keeps the reference's chunking
(``S // min(chunk, S)`` chunks, so ``S`` must be a multiple of the chunk
when it is longer than one), its finite ``NEG_INF`` mask value and its
``l`` clamp, in the same order of operations.

Layout: q ``(B, H, S, Dh)``; k, v ``(B, KV, S, Dh)``; GQA via
``H % KV == 0`` (query head ``h`` reads KV head ``h // (H // KV)``).

Its gradient is the reference's custom VJP: :class:`FlashAttention`
saves ``(q, k, v, out, lse)`` from ``_attn_fwd`` and its backward is the
chunked ``_attn_bwd`` (``_bwd_q_iter`` per query chunk, the reference's
loop nest, ``Drow = rowsum(dout * out)`` in float32, dq / dk / dv cast to
the input types).  ``flash_attention`` goes through it where grad is
enabled and an input requires grad.  The kernel's own backward on the card
(:class:`repro_torch.kernels.flash_attention.FlashAttention`) is this
``_attn_bwd`` too, fed the kernel's out and lse: neither package has a
backward kernel.

``rwkv6_chunked`` is the plain twin of the RWKV6-recurrence kernel of
:mod:`repro_torch.kernels.rwkv6_scan`; ``rwkv6_naive`` is the step-by-step
oracle and ``rwkv6_decode`` the one-token step (no kernel in either
package).  All three compute in float32 and return ``out`` in ``r.dtype``
and the state in float32.  Layout: r, k, v, w ``(B, H, T, Dh)``; u
``(H, Dh)``; the state ``(B, H, Dh, Dh)`` maps key dim to value dim.
``rwkv6_backward`` is the recurrence's gradient as torch ops, the backward
of the kernel's ``autograd.Function``; the twins are differentiated by
autograd.

``ssm_scan`` and ``ssm_decode`` are the selective-SSM scan and step of
hymba's parallel SSM heads; neither package has a kernel for them.
``ssm_scan`` walks the steps (any T) in place without grad, and through
:class:`SSMScan` (the same loop forward, ``ssm_backward`` backward) with
it; ``ssm_chunked`` keeps the reference's chunking for the parity tests.
Layout: x, dt ``(B, T, Di)``; A ``(Di, N)``; Bm, Cm ``(B, T, N)``; the
state ``(B, Di, N)``.

Under an analysis (:mod:`repro_torch.kernels.trace_hooks`) the step loops
(``_rwkv6_steps``, ``rwkv6_backward``, ``_ssm_steps``, ``ssm_backward``)
are counted from short prefixes and scaled to their length; their walks
(``_rwkv6_walk``, ``_rwkv6_backward_walk``, ``_ssm_walk``,
``_ssm_backward_walk``) are what runs otherwise.

``moe_dispatch`` is the plain twin of the MoE-dispatch kernel of
:mod:`repro_torch.kernels.moe_dispatch` (the reference's scatter, with the
duplicates summed), ``moe_dispatch_backward`` its gradient (the kernel's
backward); ``moe_combine`` has no kernel in either package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import trace_hooks

NEG_INF = -1e30


def _softcap(s, cap: Optional[float]):
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def _softcap_grad(s_capped, cap: Optional[float]):
    """d softcap / d s, expressed from the *capped* value."""
    if cap is None:
        return torch.ones_like(s_capped)
    return 1.0 - (s_capped / cap) ** 2


def _block_mask(qpos, kpos, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def _attn_fwd(q, k, v, causal, window, softcap, q_chunk, kv_chunk):
    """Chunked online-softmax forward.  Returns ``(out, lse)``: out in
    ``q.dtype`` ``(B, H, S, Dh)``, lse float32 ``(B, H, S)``."""
    B, H, S, Dh = q.shape
    KV = k.shape[1]
    rep = H // KV
    scale = Dh ** -0.5
    Cq = min(q_chunk, S)
    Ck = min(kv_chunk, S)
    nq, nk = S // Cq, S // Ck
    qr = q.reshape(B, KV, rep, nq, Cq, Dh)
    dev = q.device
    outs, lses = [], []
    for i in range(nq):
        q_blk = qr[:, :, :, i].float() * scale
        qpos = i * Cq + torch.arange(Cq, device=dev)
        acc = torch.zeros((B, KV, rep, Cq, Dh), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, KV, rep, Cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, rep, Cq), dtype=torch.float32,  # noqa: E741
                        device=dev)
        for j in range(nk):
            k_blk = k[:, :, j * Ck:(j + 1) * Ck].float()
            v_blk = v[:, :, j * Ck:(j + 1) * Ck].float()
            s = torch.einsum("bgrqd,bgkd->bgrqk", q_blk, k_blk)
            s = _softcap(s, softcap)
            kpos = j * Ck + torch.arange(Ck, device=dev)
            s = torch.where(_block_mask(qpos, kpos, causal, window), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)  # noqa: E741
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p, v_blk)
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
        lses.append(m + torch.log(l_safe))
    out = torch.stack(outs, dim=3).reshape(B, H, S, Dh)
    lse = torch.stack(lses, dim=3).reshape(B, H, S)
    return out, lse


def _attn_bwd(q, k, v, out, lse, dout, causal, window, softcap,
              q_chunk, kv_chunk):
    """The reference's chunked backward: for each key chunk ``j`` (its
    ``lax.scan``) a loop over the query chunks (its ``fori_loop``), dq
    accumulated in float32 across key chunks.  Returns (dq, dk, dv) in the
    types of q, k and v."""
    B, H, S, Dh = q.shape
    KV = k.shape[1]
    rep = H // KV
    scale = Dh ** -0.5
    Cq = min(q_chunk, S)
    Ck = min(kv_chunk, S)
    nq, nk = S // Cq, S // Ck
    dev = q.device

    qf = (q.float() * scale).reshape(B, KV, rep, S, Dh)
    kf = k.float()
    vf = v.float()
    dof = dout.float().reshape(B, KV, rep, S, Dh)
    lsef = lse.reshape(B, KV, rep, S)
    # D_i = rowsum(dout * out)
    Drow = torch.sum(dof * out.float().reshape(B, KV, rep, S, Dh), dim=-1)

    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(nk):
        k_blk = kf[:, :, j * Ck:(j + 1) * Ck]
        v_blk = vf[:, :, j * Ck:(j + 1) * Ck]
        kpos = j * Ck + torch.arange(Ck, device=dev)
        dk_j = torch.zeros((B, KV, Ck, Dh), dtype=torch.float32, device=dev)
        dv_j = torch.zeros((B, KV, Ck, Dh), dtype=torch.float32, device=dev)
        for i in range(nq):
            dk_j, dv_j = _bwd_q_iter(i, dk_j, dv_j, dq, qf, dof, lsef, Drow,
                                     k_blk, v_blk, kpos, Cq, causal, window,
                                     softcap, scale)
        dks.append(dk_j)
        dvs.append(dv_j)
    dk = torch.cat(dks, dim=2)
    dv = torch.cat(dvs, dim=2)
    return (dq.reshape(B, H, S, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_q_iter(i, dk_j, dv_j, dq, qf, dof, lsef, Drow, k_blk, v_blk, kpos,
                Cq, causal, window, softcap, scale):
    """Query chunk ``i`` against one key chunk: adds its share to ``dq`` in
    place and returns the key chunk's (dk_j, dv_j)."""
    part = slice(i * Cq, (i + 1) * Cq)
    q_blk = qf[:, :, :, part]
    do_blk = dof[:, :, :, part]
    lse_blk = lsef[:, :, :, part]
    dr_blk = Drow[:, :, :, part]
    qpos = i * Cq + torch.arange(Cq, device=qf.device)
    s_raw = torch.einsum("bgrqd,bgkd->bgrqk", q_blk, k_blk)
    s = _softcap(s_raw, softcap)
    mask = _block_mask(qpos, kpos, causal, window)
    s_m = torch.where(mask, s, NEG_INF)
    p = torch.exp(s_m - lse_blk[..., None])
    dp = torch.einsum("bgrqd,bgkd->bgrqk", do_blk, v_blk)
    ds = p * (dp - dr_blk[..., None])
    ds = ds * _softcap_grad(torch.where(mask, s, 0.0), softcap)
    dq_blk = torch.einsum("bgrqk,bgkd->bgrqd", ds, k_blk) * scale
    dk_j = dk_j + torch.einsum("bgrqk,bgrqd->bgkd", ds, q_blk)
    dv_j = dv_j + torch.einsum("bgrqk,bgrqd->bgkd", p, do_blk)
    dq[:, :, :, part] += dq_blk
    return dk_j, dv_j


class FlashAttention(torch.autograd.Function):
    """``_attn_fwd`` saving ``(q, k, v, out, lse)``, and ``_attn_bwd``: the
    reference's ``_flash_fwd_rule`` and ``_flash_bwd_rule``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_chunk, kv_chunk):
        out, lse = _attn_fwd(q, k, v, causal, window, softcap, q_chunk,
                             kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attn_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=True, window=0, softcap=None,
                    q_chunk=1024, kv_chunk=1024):
    """Chunked attention with online softmax; O(S * chunk) live memory.
    Differentiable in q, k and v (:class:`FlashAttention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    q_chunk, kv_chunk)
    out, _ = _attn_fwd(q, k, v, causal, window, softcap, q_chunk, kv_chunk)
    return out


def attention_naive(q, k, v, causal=True, window=0, softcap=None):
    """Quadratic oracle used to validate flash_attention on small shapes."""
    B, H, S, Dh = q.shape
    KV = k.shape[1]
    rep = H // KV
    qr = q.reshape(B, KV, rep, S, Dh).float() * Dh ** -0.5
    s = torch.einsum("bgrqd,bgkd->bgrqk", qr, k.float())
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    s = torch.where(_block_mask(pos, pos, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    return out.reshape(B, H, S, Dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, window=0, softcap=None):
    """Single-token attention against a (B, KV, S_max, Dh) cache.
    ``cache_len`` (B,) masks unwritten positions; window > 0 restricts to the
    last `window` positions."""
    B, H, Dh = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    qr = q.reshape(B, KV, rep, Dh).float() * Dh ** -0.5
    s = torch.einsum("bgrd,bgkd->bgrk", qr, k_cache.float())
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    ok = pos < cache_len[:, None]
    if window > 0:
        ok &= pos >= (cache_len[:, None] - window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bgkd->bgrd", p, v_cache.float())
    return out.reshape(B, H, Dh).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, filled, softcap=None):
    """:func:`decode_attention`'s softmax over one rank's block of a cache
    split along its slots, unnormalised: ``(m, l, o)``, the float32 row
    maxima ``(B, KV, rep)``, sums of exponentials and outputs ``(B, KV,
    rep, Dh)`` of the block.  ``filled`` ``(B, n)`` marks the block's
    filled slots; the rest are masked with ``NEG_INF`` after the softcap,
    so a block with none contributes nothing to the merge."""
    B, H, Dh = q.shape
    KV = k_cache.shape[1]
    rep = H // KV
    qr = q.reshape(B, KV, rep, Dh).float() * Dh ** -0.5
    s = torch.einsum("bgrd,bgkd->bgrk", qr, k_cache.float())
    s = _softcap(s, softcap)
    s = torch.where(filled[:, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1)
    e = torch.exp(s - m[..., None])
    o = torch.einsum("bgrk,bgkd->bgrd", e, v_cache.float())
    return m, e.sum(dim=-1), o


def decode_attention_merge(m, l, o, dtype, reduce_max=None,
                           reduce_sum=None):
    """The exact softmax of the blocks whose :func:`decode_attention_partial`
    are ``(m, l, o)``: every block rescaled to the maximum over the blocks,
    the sums of exponentials and outputs summed in float32 and divided,
    then cast to ``dtype`` once.  ``reduce_max`` / ``reduce_sum`` take the
    elementwise maximum / sum of a float32 tensor over the ranks that
    share the split (one all-reduce each); None for a single block.
    Returns ``(B, H, Dh)``."""
    big = m if reduce_max is None else reduce_max(m)
    w = torch.exp(m - big)
    part = torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1)
    if reduce_sum is not None:
        part = reduce_sum(part)
    out = part[..., :-1] / part[..., -1:]
    B, KV, rep, Dh = o.shape
    return out.reshape(B, KV * rep, Dh).to(dtype)


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent per-channel decay linear attention
# ---------------------------------------------------------------------------

def _rwkv6_step(s, rt, kt, vt, wt, u):
    """One step on (B, H, Dh) float32 rows: ``out = r (S + diag(u) k^T v)``,
    ``S <- diag(w) S + k^T v``.  Returns (S, out)."""
    kv = kt[..., :, None] * vt[..., None, :]               # (B, H, Dh, Dh)
    out = torch.einsum("bhk,bhkd->bhd", rt, s + u[None, :, :, None] * kv)
    return wt[..., :, None] * s + kv, out


def _rwkv6_steps(rf, kf, vf, wf, uf, s):
    """The recurrence over the T steps of float32 ``(B, H, T, Dh)`` rows
    from the state ``s``.  Returns (state, out).  Under an analysis the
    loop is scaled (:mod:`repro_torch.kernels.trace_hooks`)."""
    a = trace_hooks.counting()
    if a is None:
        return _rwkv6_walk(rf, kf, vf, wf, uf, s)
    return a.loop(rf.shape[2], RWKV_STEP_BLOCK, lambda n: _rwkv6_walk(
        *(x[:, :, :n] for x in (rf, kf, vf, wf)), uf, s),
        lambda: _rwkv6_walk(rf, kf, vf, wf, uf, s))


def _rwkv6_walk(rf, kf, vf, wf, uf, s):
    outs = []
    for t in range(rf.shape[2]):
        s, out = _rwkv6_step(s, rf[:, :, t], kf[:, :, t], vf[:, :, t],
                             wf[:, :, t], uf)
        outs.append(out)
    return s, torch.stack(outs, dim=2)


def rwkv6_naive(r, k, v, w, u, state):
    """Step-by-step oracle, any T.  Returns (out (B, H, T, Dh) in
    ``r.dtype``, state (B, H, Dh, Dh) float32)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    state, out = _rwkv6_steps(rf, kf, vf, wf, u.float(), state.float())
    return out.to(r.dtype), state


def rwkv6_chunked(r, k, v, w, u, state, chunk=64):
    """The recurrence in ``T // C`` chunks of ``C = min(chunk, T)`` steps,
    as the reference chunks it (the sequential form inside each chunk, so
    it equals ``rwkv6_naive``).  A T that is longer than the chunk and not
    a multiple of it raises ``ValueError`` (the reference fails on a
    reshape there)."""
    T = r.shape[2]
    C = min(chunk, T)
    if C < 1 or T % C:
        raise ValueError(f"T = {T} is not a multiple of the chunk {C}")
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    s = state.float()
    outs = []
    for i in range(T // C):
        part = slice(i * C, (i + 1) * C)
        s, out = _rwkv6_steps(rf[:, :, part], kf[:, :, part],
                              vf[:, :, part], wf[:, :, part], uf, s)
        outs.append(out)
    return torch.cat(outs, dim=2).to(r.dtype), s


def rwkv6_decode(r, k, v, w, u, state):
    """One-token RWKV6 step.  r/k/v/w: (B, H, Dh); state: (B, H, Dh, Dh).
    Returns (out in ``r.dtype``, new state float32)."""
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    new, out = _rwkv6_step(state.float(), rf, kf, vf, wf, u.float())
    return out.to(r.dtype), new


#: steps whose states ``rwkv6_backward`` recomputes and walks in one block
RWKV_STEP_BLOCK = 64


def rwkv6_backward(r, k, v, w, u, state, dout, dstate):
    """The gradient of the RWKV6 recurrence (of ``rwkv6_naive``, and of the
    reference's ``rwkv6_chunked``, which the chunk does not change), as
    torch ops.  r/k/v/w ``(B, H, T, Dh)`` and u, state as the forward took
    them; ``dout`` the cotangent of ``out``, ``dstate`` of the final state.
    Returns (dr, dk, dv, dw, du, dstate0), each in its input's dtype.

    Going backward from ``dS_T = dstate``, with ``g_t = dout_t``:
    ``dr_t = S_{t-1} g_t + u k_t (v_t · g_t)``, ``du = Σ r_t k_t (v_t ·
    g_t)``, ``dk_t = dS_t v_t + r_t u (g_t · v_t)``, ``dv_t = dS_tᵀ k_t + g_t
    (r_t u · k_t)``, ``dw_t = Σ_d dS_t ⊙ S_{t-1}`` and ``dS_{t-1} = w_t ⊙
    dS_t + r_t ⊗ g_t``.  A first pass keeps the state at the start of each
    block of :data:`RWKV_STEP_BLOCK` steps; the blocks are then walked
    backward, each recomputing its states from its start and running the
    reverse recurrence (one ``addcmul`` a step each), the rest batched over
    the block.  Everything is float32, as the forward computes."""
    a = trace_hooks.counting()
    if a is None:
        return _rwkv6_backward_walk(r, k, v, w, u, state, dout, dstate)
    return a.loop(r.shape[2], RWKV_STEP_BLOCK, lambda n: (
        _rwkv6_backward_walk(*(x[:, :, :n] for x in (r, k, v, w)), u,
                             state, dout[:, :, :n], dstate)),
        lambda: _rwkv6_backward_walk(r, k, v, w, u, state, dout, dstate))


def _rwkv6_backward_walk(r, k, v, w, u, state, dout, dstate):
    B, H, T, Dh = r.shape
    # time-major (T, B, H, Dh) float32 views of the inputs
    rf, kf, vf, wf, gf = (a.float().permute(2, 0, 1, 3)
                          for a in (r, k, v, w, dout))
    uf = u.float()
    blocks = [slice(t0, min(t0 + RWKV_STEP_BLOCK, T))
              for t0 in range(0, T, RWKV_STEP_BLOCK)]

    def kv_of(part):
        return kf[part][..., :, None] * vf[part][..., None, :]

    starts = [state.float()]
    for part in blocks[:-1]:
        kv, wb, s = kv_of(part), wf[part], starts[-1]
        for t in range(kv.shape[0]):
            s = torch.addcmul(kv[t], wb[t][..., None], s)
        starts.append(s)
    dr, dk, dv, dw = (torch.empty((T, B, H, Dh), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((H, Dh), dtype=torch.float32, device=r.device)
    ds = dstate.float()
    for part, s0 in reversed(list(zip(blocks, starts))):
        rb, kb, vb, wb, gb = (a[part] for a in (rf, kf, vf, wf, gf))
        kv = kv_of(part)
        tb = kv.shape[0]
        # the states before each step of the block: S[t] = S_{t0 + t - 1}
        S = torch.empty_like(kv)
        S[0] = s0
        for t in range(tb - 1):
            torch.addcmul(kv[t], wb[t][..., None], S[t], out=S[t + 1])
        # the cotangents of the states after each step: dS[t] of S_{t0+t}
        rg = rb[..., :, None] * gb[..., None, :]
        dS = torch.empty_like(kv)
        dS[tb - 1] = ds
        for t in range(tb - 1, 0, -1):
            torch.addcmul(rg[t], wb[t][..., None], dS[t], out=dS[t - 1])
        ds = torch.addcmul(rg[0], wb[0][..., None], dS[0])
        vg = (vb * gb).sum(-1, keepdim=True)                # (tb, B, H, 1)
        ru = rb * uf
        dr[part] = torch.matmul(S, gb[..., None])[..., 0] + uf * kb * vg
        du += (rb * kb * vg).sum((0, 1))
        dk[part] = torch.matmul(dS, vb[..., None])[..., 0] + ru * vg
        dv[part] = (torch.matmul(kb[..., None, :], dS)[..., 0, :]
                    + gb * (ru * kb).sum(-1, keepdim=True))
        dw[part] = (dS * S).sum(-1)

    def back(a, like):         # (T, B, H, Dh) -> (B, H, T, Dh), its dtype
        return a.permute(1, 2, 0, 3).to(like.dtype)

    return (back(dr, r), back(dk, k), back(dv, v), back(dw, w),
            du.to(u.dtype), ds.to(state.dtype))


# ---------------------------------------------------------------------------
# Selective SSM scan (mamba-style, for hymba's parallel SSM heads)
# ---------------------------------------------------------------------------

#: steps whose elementwise terms ``ssm_scan`` computes in one pass
SSM_STEP_BLOCK = 64


def _ssm_steps(xf, dtf, Af, Bf, Cf, h, starts=None):
    """``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = C_t h_t``
    over the T steps of float32 ``(B, T, Di)`` / ``(B, T, N)`` rows, from
    the ``(B, Di, N)`` state ``h``.  The elementwise terms ``exp(dt A)``
    and ``(dt x) B`` of a block of steps are computed in one pass each (the
    same operations, so the same values); the Python loop is left with
    the recurrence, and the C·h contractions of a block run as one batched
    product.  ``starts``, when given, is a list that receives the state at
    the start of each block.  Returns (h, y (B, T, Di)).
    Under an analysis the loop is scaled
    (:mod:`repro_torch.kernels.trace_hooks`); ``starts`` then receives
    empty tensors of the start states' shape when the loop was not walked
    (fake inputs)."""
    a = trace_hooks.counting()
    if a is None:
        return _ssm_walk(xf, dtf, Af, Bf, Cf, h, starts)
    T = xf.shape[1]
    out = a.loop(T, SSM_STEP_BLOCK, lambda n: _ssm_walk(
        xf[:, :n], dtf[:, :n], Af, Bf[:, :n], Cf[:, :n], h,
        None if starts is None else []),
        lambda: _ssm_walk(xf, dtf, Af, Bf, Cf, h, starts))
    if starts is not None and not starts:
        starts.extend(a.empty_like(h)
                      for _ in range(math.ceil(T / SSM_STEP_BLOCK)))
    return out


def _ssm_walk(xf, dtf, Af, Bf, Cf, h, starts=None):
    T = xf.shape[1]
    ys = []
    for t0 in range(0, T, SSM_STEP_BLOCK):
        part = slice(t0, min(t0 + SSM_STEP_BLOCK, T))
        if starts is not None:
            starts.append(h.clone())
        # time-major (tb, B, ...) so that the rows of step t are contiguous
        dtb = dtf[:, part].transpose(0, 1)
        dA = torch.exp(dtb[..., None] * Af)                 # (tb, B, Di, N)
        dBx = ((dtb * xf[:, part].transpose(0, 1))[..., None]
               * Bf[:, part].transpose(0, 1)[:, :, None, :])
        hs = torch.empty_like(dA)
        for t in range(dA.shape[0]):
            torch.mul(dA[t], h, out=hs[t])
            h = hs[t].add_(dBx[t])
        ys.append(torch.matmul(hs, Cf[:, part].transpose(0, 1)[..., None])
                  [..., 0].transpose(0, 1))
    return h.clone(), torch.cat(ys, dim=1)


def ssm_backward(xf, dtf, Af, Bf, Cf, starts, gy, gh):
    """The gradient of :func:`_ssm_steps` (float32 throughout): given the
    block start states its forward kept and the cotangents ``gy`` of ``y``
    and ``gh`` of the final state, returns (dx, ddt, dA, dB, dC, dstate).

    The blocks are walked backward.  Each recomputes its states from its
    start (one ``addcmul`` a step), then runs the reverse recurrence of the
    state's cotangent ``G_t = G_{t+1} exp(dt_{t+1} A) + gy_t C_t`` (one a
    step); the rest are batched products over the block: ``exp(dt A)``'s
    cotangent ``G_t h_{t-1}``, ``(dt x) B``'s ``G_t``, ``C``'s ``gy_t
    h_t``."""
    a = trace_hooks.counting()
    if a is None:
        return _ssm_backward_walk(xf, dtf, Af, Bf, Cf, starts, gy, gh)
    return a.loop(xf.shape[1], SSM_STEP_BLOCK, lambda n: _ssm_backward_walk(
        xf[:, :n], dtf[:, :n], Af, Bf[:, :n], Cf[:, :n],
        starts[:math.ceil(n / SSM_STEP_BLOCK)], gy[:, :n], gh),
        lambda: _ssm_backward_walk(xf, dtf, Af, Bf, Cf, starts, gy, gh))


def _ssm_backward_walk(xf, dtf, Af, Bf, Cf, starts, gy, gh):
    T = xf.shape[1]
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    g = gh
    for t0, h0 in reversed(list(zip(range(0, T, SSM_STEP_BLOCK), starts))):
        part = slice(t0, min(t0 + SSM_STEP_BLOCK, T))
        dtb, xb, Bb, Cb, gyb = (a[:, part].transpose(0, 1)
                                for a in (dtf, xf, Bf, Cf, gy))
        eA = torch.exp(dtb[..., None] * Af)                 # (tb, B, Di, N)
        dtx = dtb * xb
        dBx = dtx[..., None] * Bb[:, :, None, :]
        tb = eA.shape[0]
        hs = torch.empty((tb + 1,) + tuple(h0.shape), dtype=h0.dtype,
                         device=h0.device)
        hs[0] = h0
        for t in range(tb):
            torch.addcmul(dBx[t], eA[t], hs[t], out=hs[t + 1])
        G = gyb[..., None] * Cb[:, :, None, :]
        G[tb - 1] += g
        for t in range(tb - 2, -1, -1):
            G[t].addcmul_(G[t + 1], eA[t + 1])
        g = G[0] * eA[0]
        dz = G * hs[:-1] * eA                 # the cotangent of dt A
        ddtx = torch.matmul(G, Bb[..., None])[..., 0]
        ddt[:, part] = ((dz * Af).sum(-1) + ddtx * xb).transpose(0, 1)
        dx[:, part] = (ddtx * dtb).transpose(0, 1)
        dA += torch.einsum("tbdn,tbd->dn", dz, dtb)
        dB[:, part] = torch.matmul(dtx[:, :, None, :], G)[:, :, 0] \
            .transpose(0, 1)
        dC[:, part] = torch.matmul(gyb[:, :, None, :], hs[1:])[:, :, 0] \
            .transpose(0, 1)
    return dx, ddt, dA, dB, dC, g


class SSMScan(torch.autograd.Function):
    """:func:`_ssm_steps` (the in-place step loop, so the same values)
    keeping its block start states, and :func:`ssm_backward`.  Inputs are
    the float32 x, dt, A, B, C and state; returns (y, final state)."""

    @staticmethod
    def forward(ctx, xf, dtf, Af, Bf, Cf, h):
        starts = []
        h, y = _ssm_steps(xf, dtf, Af, Bf, Cf, h, starts)
        ctx.save_for_backward(xf, dtf, Af, Bf, Cf, *starts)
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        xf, dtf, Af, Bf, Cf, *starts = ctx.saved_tensors
        with torch.profiler.record_function("ssm_scan_backward"):
            return ssm_backward(xf, dtf, Af, Bf, Cf, starts, gy, gh)


def ssm_scan(x, dt, A, Bm, Cm, D, state):
    """``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D
    x_t``, step by step, any T.  x/dt: (B, T, Di); A: (Di, N); Bm/Cm:
    (B, T, N); D: (Di,); state: (B, Di, N).  Everything is cast to float32
    first and ``h`` is carried in float32; returns (y in ``x.dtype``,
    state float32).  Differentiable in every input: where grad is enabled
    and an input requires it, the steps run through :class:`SSMScan`
    (the same forward values), else through the step loop alone."""
    xf, dtf = x.float(), dt.float()
    args = (xf, dtf, A.float(), Bm.float(), Cm.float(), state.float())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, h = SSMScan.apply(*args)
    else:
        h, y = _ssm_steps(*args)
    y = y + xf * D.float()[None, None, :]
    return y.to(x.dtype), h


def ssm_chunked(x, dt, A, Bm, Cm, D, state, chunk=256):
    """The scan in ``T // C`` chunks of ``C = min(chunk, T)`` steps, as the
    reference chunks it (the sequential form inside each chunk, so it
    equals ``ssm_scan``).  A T that is longer than the chunk and not a
    multiple of it raises ``ValueError`` (the reference fails on a reshape
    there)."""
    T = x.shape[1]
    C = min(chunk, T)
    if C < 1 or T % C:
        raise ValueError(f"T = {T} is not a multiple of the chunk {C}")
    ys = []
    for i in range(T // C):
        part = slice(i * C, (i + 1) * C)
        y, state = ssm_scan(x[:, part], dt[:, part], A, Bm[:, part],
                            Cm[:, part], D, state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def ssm_decode(x, dt, A, Bm, Cm, D, state):
    """One-token SSM step.  x/dt: (B, Di); Bm/Cm: (B, N); state: (B, Di,
    N).  Nothing is cast but ``dt`` inside the exponent: the rest follows
    type promotion, as in the reference (``dt`` is float32 there because
    ``dt_bias`` is, so ``h`` and ``y`` are float32).  Returns (y in
    ``x.dtype``, h)."""
    dA = torch.exp(dt.float()[..., None] * A[None])
    h = dA * state + dt[..., None] * x[..., None] * Bm[:, None, :]
    y = (torch.matmul(h, Cm[..., None].to(h.dtype))[..., 0]
         + x * D[None])
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# MoE dispatch / combine (the XQueue push / pop analogue)
# ---------------------------------------------------------------------------

def moe_dispatch(x, expert, pos, n_experts: int, capacity: int):
    """Scatter token rows into per-expert buffers.  x: (T, D); expert/pos:
    (T, k), -1 for a dropped slot.  Returns ``(E, C, D)`` in ``x.dtype``:
    row ``expert * C + pos`` holds ``x[t]`` for each kept slot ``(t, kk)``,
    every other row is zero.

    As in the reference, a slot with ``expert < 0`` or ``pos < 0`` is
    dropped, and so is a flat row past ``E * C`` (a sink row, sliced off:
    PyTorch raises where JAX's ``mode="drop"`` drops); slots that share a
    row are summed."""
    T, D = x.shape
    k = expert.shape[1]
    E, C = n_experts, capacity
    flat_e = expert.reshape(-1).long()
    flat_p = pos.reshape(-1).long()
    idx = flat_e * C + flat_p
    ok = (flat_e >= 0) & (flat_p >= 0) & (idx < E * C)
    idx = torch.where(ok, idx, E * C)
    src = torch.repeat_interleave(x, k, dim=0)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.index_put_((idx,), src, accumulate=True)
    return buf[:E * C].reshape(E, C, D)


def moe_dispatch_rows(expert, pos, n_experts: int, capacity: int):
    """The row map of the dispatch kernel's first phase: ``(E * C,)`` int64,
    each flat row's highest token among the kept slots that name it (a
    slot is dropped as :func:`moe_dispatch` drops it), -1 for a row that no
    slot names.  The kernel's buffer is ``x[map]`` with the -1 rows zero;
    it differs from :func:`moe_dispatch` only on rows that several slots
    share, where the twin sums them."""
    E, C = n_experts, capacity
    k = expert.shape[1]
    flat_e = expert.reshape(-1).long()
    flat_p = pos.reshape(-1).long()
    idx = flat_e * C + flat_p
    ok = (flat_e >= 0) & (flat_p >= 0) & (idx < E * C)
    token = torch.arange(expert.shape[0], device=expert.device
                         ).repeat_interleave(k)
    rows = torch.full((E * C + 1,), -1, dtype=torch.int64,
                      device=expert.device)
    rows.scatter_reduce_(0, torch.where(ok, idx, E * C), token, "amax")
    return rows[:E * C]


def moe_dispatch_backward(g, expert, pos, n_experts: int, capacity: int):
    """The gradient of :func:`moe_dispatch` in x: each kept slot's buffer
    row gathered back to its token and the k slots summed; a dropped slot
    (``expert`` or ``pos`` -1, or a flat row past ``E * C``) reads the zero
    sink row.  The ops and their order are autograd's backward of the
    twin (the slice into a zero buffer with its sink row, the
    ``index_put_``'s gather, ``repeat_interleave``'s sum over the k copies),
    so the two agree bit for bit.  g: ``(E, C, D)``; returns ``(T, D)`` in
    ``g.dtype``."""
    E, C = n_experts, capacity
    T, k = expert.shape
    D = g.shape[-1]
    flat_e = expert.reshape(-1).long()
    flat_p = pos.reshape(-1).long()
    idx = flat_e * C + flat_p
    ok = (flat_e >= 0) & (flat_p >= 0) & (idx < E * C)
    idx = torch.where(ok, idx, E * C)
    gbuf = torch.zeros((E * C + 1, D), dtype=g.dtype, device=g.device)
    gbuf[:E * C] = g.reshape(E * C, D)
    return gbuf[idx].view(T, k, D).sum(1, keepdim=True).view(T, D)


def moe_combine(y, expert, pos, weight, n_tokens: int, dtype=None):
    """Gather expert outputs back to tokens with their combine weights.
    y: (E, C, D); expert/pos/weight: (T, k).  Returns (T, D) in
    ``y.dtype`` (or ``dtype``): the weights are cast to ``y.dtype`` before
    the product and the k products summed in float32, as ``jnp.sum`` sums
    a bf16 array."""
    E, C, D = y.shape
    k = expert.shape[1]
    flat_e = expert.reshape(-1).long()
    flat_p = pos.reshape(-1).long()
    ok = (flat_e >= 0) & (flat_p >= 0)
    idx = torch.where(ok, flat_e * C + flat_p, 0)
    gathered = y.reshape(E * C, D)[idx]
    w = torch.where(ok, weight.reshape(-1), 0.0).to(y.dtype)
    gathered = gathered * w[:, None]
    return gathered.reshape(n_tokens, k, D).float().sum(dim=1).to(
        dtype or y.dtype)
