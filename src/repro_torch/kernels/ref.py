"""Plain PyTorch references (oracles) for the model stack's attention: the
port of the attention part of the JAX package's ``kernels/ref.py``.

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
