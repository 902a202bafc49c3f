"""Plain PyTorch references (oracles) for the model stack's kernels: the
port of the JAX package's ``kernels/ref.py`` but the attention backward.

``flash_attention`` is the plain twin of the hand-written CUDA kernel of
:mod:`repro_torch.kernels.flash_attention`: the CPU path, and what the
kernel is held against on the card.  It keeps the reference's chunking
(``S // min(chunk, S)`` chunks, so ``S`` must be a multiple of the chunk
when it is longer than one), its finite ``NEG_INF`` mask value and its
``l`` clamp, in the same order of operations.

Layout: q ``(B, H, S, Dh)``; k, v ``(B, KV, S, Dh)``; GQA via
``H % KV == 0`` (query head ``h`` reads KV head ``h // (H // KV)``).

The chunked backward (the reference's ``_attn_bwd``) belongs to training
and is not ported yet.

``rwkv6_chunked`` is the plain twin of the RWKV6-recurrence kernel of
:mod:`repro_torch.kernels.rwkv6_scan`; ``rwkv6_naive`` is the step-by-step
oracle and ``rwkv6_decode`` the one-token step (no kernel in either
package).  All three compute in float32 and return ``out`` in ``r.dtype``
and the state in float32.  Layout: r, k, v, w ``(B, H, T, Dh)``; u
``(H, Dh)``; the state ``(B, H, Dh, Dh)`` maps key dim to value dim.

``ssm_scan`` and ``ssm_decode`` are the selective-SSM scan and step of
hymba's parallel SSM heads; neither package has a kernel for them.
``ssm_scan`` walks the steps (any T); ``ssm_chunked`` keeps the
reference's chunking for the parity tests.  Layout: x, dt ``(B, T, Di)``;
A ``(Di, N)``; Bm, Cm ``(B, T, N)``; the state ``(B, Di, N)``.

``moe_dispatch`` is the plain twin of the MoE-dispatch kernel of
:mod:`repro_torch.kernels.moe_dispatch` (the reference's scatter, with the
duplicates summed); ``moe_combine`` has no kernel in either package.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(s, cap: Optional[float]):
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


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


def flash_attention(q, k, v, causal=True, window=0, softcap=None,
                    q_chunk=1024, kv_chunk=1024):
    """Chunked attention with online softmax; O(S * chunk) live memory."""
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


# ---------------------------------------------------------------------------
# Selective SSM scan (mamba-style, for hymba's parallel SSM heads)
# ---------------------------------------------------------------------------

#: steps whose elementwise terms ``ssm_scan`` computes in one pass
SSM_STEP_BLOCK = 64


def _ssm_steps(xf, dtf, Af, Bf, Cf, h):
    """``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = C_t h_t``
    over the T steps of float32 ``(B, T, Di)`` / ``(B, T, N)`` rows, from
    the ``(B, Di, N)`` state ``h``.  The elementwise terms ``exp(dt A)``
    and ``(dt x) B`` of a block of steps are computed in one pass each (the
    same operations, so the same values); the Python loop is left with
    the recurrence, and the C·h contractions of a block run as one batched
    product.  Returns (h, y (B, T, Di))."""
    T = xf.shape[1]
    ys = []
    for t0 in range(0, T, SSM_STEP_BLOCK):
        part = slice(t0, min(t0 + SSM_STEP_BLOCK, T))
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


def ssm_scan(x, dt, A, Bm, Cm, D, state):
    """``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D
    x_t``, step by step, any T.  x/dt: (B, T, Di); A: (Di, N); Bm/Cm:
    (B, T, N); D: (Di,); state: (B, Di, N).  Everything is cast to float32
    first and ``h`` is carried in float32; returns (y in ``x.dtype``,
    state float32)."""
    xf, dtf = x.float(), dt.float()
    h, y = _ssm_steps(xf, dtf, A.float(), Bm.float(), Cm.float(),
                      state.float())
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


def moe_combine(y, expert, pos, weight, n_tokens: int):
    """Gather expert outputs back to tokens with their combine weights.
    y: (E, C, D); expert/pos/weight: (T, k).  Returns (T, D) in
    ``y.dtype``: the weights are cast to ``y.dtype`` before the product and
    the k products summed in float32, as ``jnp.sum`` sums a bf16 array."""
    E, C, D = y.shape
    k = expert.shape[1]
    flat_e = expert.reshape(-1).long()
    flat_p = pos.reshape(-1).long()
    ok = (flat_e >= 0) & (flat_p >= 0)
    idx = torch.where(ok, flat_e * C + flat_p, 0)
    gathered = y.reshape(E * C, D)[idx]
    w = torch.where(ok, weight.reshape(-1), 0.0).to(y.dtype)
    gathered = gathered * w[:, None]
    return gathered.reshape(n_tokens, k, D).float().sum(dim=1).to(y.dtype)
