"""Shared neural layers: norms, RoPE, MLP variants, GQA attention with
full/local/bidirectional patterns, softcaps, and decode caches (ring buffers
for windowed layers).  The port of the JAX package's ``models/layers.py``.

Parameters are nested mappings of tensors (``p["wq"]``), either plain dicts
or the ``ParamTree`` modules of :mod:`repro_torch.models.transformer`;
weights are ``(in, out)`` and multiply as ``x @ W``, as in the JAX package.

The activation-sharding hints: the mesh-bound steps of
:mod:`repro_torch.launch.steps` declare the mesh's axes here for the
length of one call (:func:`axis_hints`), and the model reads them where
the JAX package does: the tensor-parallel KV head expansion of
:func:`attn_apply` and the shard-local routing of
:func:`repro_torch.models.moe.moe_apply`.  The hints are off unless a
step sets them, so plain calls need no mesh.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Activation-sharding hints.  In the JAX package ``hint`` pins a layout with
# ``with_sharding_constraint``; here every tensor is a rank's local tensor
# (the port keeps compute over "model" replicated), so ``hint`` is the
# identity and ``hint_spec`` says what layout the JAX package would pin.
# ``mesh`` is a ``DeviceMesh`` when each rank holds one data shard's rows
# (the multi-rank steps), or a mesh description (any object with
# ``axis_names`` and a ``shape`` mapping) when one process holds the global
# batch and loops over the shards (the global view).
# ---------------------------------------------------------------------------

_AXIS_HINTS = {"on": False, "dp": None, "dp_size": 0, "tp_size": 0,
               "mesh": None}


def set_axis_hints(*, dp_axes=None, dp_size=0, tp_size=0, mesh=None):
    _AXIS_HINTS.update(on=bool(dp_axes), dp=dp_axes, dp_size=dp_size,
                       tp_size=tp_size, mesh=mesh)


def clear_axis_hints():
    _AXIS_HINTS.update(on=False, dp=None, dp_size=0, tp_size=0, mesh=None)


@contextlib.contextmanager
def axis_hints(**hints):
    """:func:`set_axis_hints` for the length of a ``with`` block; the hints
    that were set before are restored on exit, also when the block
    raises."""
    saved = dict(_AXIS_HINTS)
    set_axis_hints(**hints)
    try:
        yield
    finally:
        _AXIS_HINTS.clear()
        _AXIS_HINTS.update(saved)


def hint_spec(shape, *axes) -> tuple:
    """The ``PartitionSpec`` entries the JAX package's ``hint`` pins for a
    tensor of ``shape``: per dim, ``"dp"`` becomes the data axes and
    ``"tp"`` ``"model"`` where the hinted size divides the dim, else
    ``None`` (trailing dims default to ``None``; a one-axis tuple is
    written as its name, as ``PartitionSpec`` writes it).  ``()`` when the
    hints are off."""
    h = _AXIS_HINTS
    if not h["on"]:
        return ()
    dp = h["dp"]
    if isinstance(dp, tuple) and len(dp) == 1:
        dp = dp[0]
    spec = []
    for i, dim in enumerate(shape):
        a = axes[i] if i < len(axes) else None
        if a == "dp" and h["dp_size"] and dim % h["dp_size"] == 0:
            spec.append(dp)
        elif a == "tp" and h["tp_size"] and dim % h["tp_size"] == 0:
            spec.append("model")
        else:
            spec.append(None)
    return tuple(spec)


def hint(x, *axes):
    """The identity on a rank's local tensor (see :func:`hint_spec` for the
    layout the JAX package pins)."""
    return x


def rank_local() -> bool:
    """True when the hints' mesh is a ``DeviceMesh``: each rank holds only
    its data shard's rows."""
    return _AXIS_HINTS["on"] and hasattr(_AXIS_HINTS["mesh"],
                                         "mesh_dim_names")


def _dense_init(shape, dtype, generator, device, scale=None, lead=()):
    """Normal weights scaled by ``fan_in ** -0.5`` (``shape[0]``), drawn in
    float32 and cast; ``lead`` prepends stacked-layer dims."""
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(lead) + tuple(shape), generator=generator,
                    device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rmsnorm(scale, x, eps=1e-6):
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * (1.0 + scale.float())).to(x.dtype)


def rope(x, pos, theta: float):
    """x: (..., S, H, Dh) or (..., H, Dh) with matching pos (..., S) or (...,).
    Rotates the two halves of the head dim (x[:half] with x[half:]), as
    the JAX package does."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[..., None] * freqs                   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # broadcast over H
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, d_ff: int, generator, device, lead=()):
    D = cfg.d_model

    def w(shape):
        return _dense_init(shape, cfg.pdtype, generator, device, lead=lead)

    if cfg.mlp_act == "sq_relu":
        return {"w1": w((D, d_ff)), "w2": w((d_ff, D))}
    return {"wg": w((D, d_ff)), "wu": w((D, d_ff)), "wd": w((d_ff, D))}


def _gelu_tanh(x):
    """``jax.nn.gelu`` as the JAX package calls it: its default is the tanh
    approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ModelConfig):
    if cfg.mlp_act == "sq_relu":
        h = x @ p["w1"]
        return torch.square(torch.relu(h)) @ p["w2"]
    act = F.silu if cfg.mlp_act == "silu_glu" else _gelu_tanh
    g = act(x @ p["wg"])
    u = x @ p["wu"]
    return (g * u) @ p["wd"]


# ---------------------------------------------------------------------------
# Attention (+ decode caches)
# ---------------------------------------------------------------------------

class AttnCache(NamedTuple):
    k: torch.Tensor        # (B, KV, C, Dh) — C = window (ring) or max_len
    v: torch.Tensor
    k_scale: torch.Tensor  # (B, KV, C) f32 — per-vector int8 scales (zeros
    v_scale: torch.Tensor  # when the cache dtype is bf16)


def _cache_dtype(cfg: ModelConfig):
    return torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.cdtype


def _quant_kv(x, quantize: bool):
    """x: (..., Dh) -> (stored, scale(...,)) with per-vector symmetric
    int8 quantization (or passthrough + zero scales)."""
    if not quantize:
        return x, torch.zeros(x.shape[:-1], dtype=torch.float32,
                              device=x.device)
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(stored, scale, dtype):
    if stored.dtype != torch.int8:
        return stored
    return (stored.float() * scale[..., None]).to(dtype)


def attn_init(cfg: ModelConfig, generator, device, lead=()):
    D, dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def w(shape, scale=None):
        return _dense_init(shape, cfg.pdtype, generator, device, scale,
                           lead=lead)

    p = {"wq": w((D, H * dh)), "wk": w((D, KV * dh)), "wv": w((D, KV * dh)),
         "wo": w((H * dh, D), scale=(H * dh) ** -0.5)}
    if cfg.qk_norm:
        p["qn"] = torch.zeros(tuple(lead) + (dh,), dtype=cfg.pdtype,
                              device=device)
        p["kn"] = torch.zeros(tuple(lead) + (dh,), dtype=cfg.pdtype,
                              device=device)
    return p


def _qkv(p, x, cfg: ModelConfig):
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, kind: str, pos0: int = 0):
    """Training / prefill attention.  kind: full | local | bidir.
    Returns (out, (k, v)) — k/v in (B, KV, S, Dh) for cache building."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    pos = pos0 + torch.arange(S, device=x.device)
    q = rope(q, pos[None, :], cfg.rope_theta)
    k = rope(k, pos[None, :], cfg.rope_theta)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    # GQA + TP, as the JAX package: when q heads shard over "model" but KV
    # heads do not, KV is expanded to H heads (numerically the identity)
    tp = _AXIS_HINTS["tp_size"] if _AXIS_HINTS["on"] else 0
    H, KV = cfg.n_heads, cfg.n_kv_heads
    ke, ve = kt, vt
    if tp and H % tp == 0 and KV % tp != 0 and H != KV:
        ke = kt.repeat_interleave(H // KV, dim=1)
        ve = vt.repeat_interleave(H // KV, dim=1)
    causal = kind != "bidir"
    window = cfg.window if kind == "local" else 0
    out = ops.flash_attention(qt, ke, ve, causal=causal, window=window,
                              softcap=cfg.attn_softcap)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ p["wo"], (kt, vt)


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    return min(cfg.window, max_len) if kind == "local" else max_len


def attn_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device="cpu") -> AttnCache:
    """Empty cache, stored in the config's ``kv_cache_dtype`` (the JAX
    signature's unused ``dtype`` argument is dropped)."""
    C = _cache_len(cfg, kind, max_len)
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    sdtype = _cache_dtype(cfg)
    return AttnCache(
        k=torch.zeros((batch, KV, C, dh), dtype=sdtype, device=device),
        v=torch.zeros((batch, KV, C, dh), dtype=sdtype, device=device),
        k_scale=torch.zeros((batch, KV, C), dtype=torch.float32,
                            device=device),
        v_scale=torch.zeros((batch, KV, C), dtype=torch.float32,
                            device=device))


def attn_cache_from_prefill(cfg: ModelConfig, kind: str, kt, vt, max_len: int
                            ) -> AttnCache:
    """Build a decode cache from prefill k/v (B, KV, S, Dh).  Windowed layers
    keep a ring of the last `window` positions at slots pos % window."""
    B, KV, S, dh = kt.shape
    C = _cache_len(cfg, kind, max_len)
    quant = cfg.kv_cache_dtype == "int8"
    sdtype = _cache_dtype(cfg)
    c = attn_cache_init(cfg, kind, B, max_len, device=kt.device)
    if kind == "local" and S > C:
        take = C
        src_pos = S - C + torch.arange(C, device=kt.device)
    else:
        take = min(S, C)
        src_pos = torch.arange(take, device=kt.device)
    slots = src_pos % C
    kq, ks = _quant_kv(kt[:, :, S - take:], quant)
    vq, vs = _quant_kv(vt[:, :, S - take:], quant)
    c.k[:, :, slots] = kq.to(sdtype)
    c.v[:, :, slots] = vq.to(sdtype)
    c.k_scale[:, :, slots] = ks
    c.v_scale[:, :, slots] = vs
    return c


def attn_decode(p, x, cfg: ModelConfig, kind: str, cache: AttnCache,
                cache_len):
    """One-token decode.  x: (B, D); cache_len: (B,) current lengths.
    Returns (out, cache).  Unlike the JAX package's functional update, the
    new k/v are written into ``cache`` in place (the cache is the largest
    state of decoding; a copy per step would double its traffic)."""
    B, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, H, dh)
    k = (x @ p["wk"]).reshape(B, KV, dh)
    v = (x @ p["wv"]).reshape(B, KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    q = rope(q, cache_len, cfg.rope_theta)
    k = rope(k, cache_len, cfg.rope_theta)
    C = cache.k.shape[2]
    slot = cache_len % C
    bidx = torch.arange(B, device=x.device)
    quant = cfg.kv_cache_dtype == "int8"
    kq, ks = _quant_kv(k, quant)
    vq, vs = _quant_kv(v, quant)
    cache.k[bidx, :, slot] = kq.to(cache.k.dtype)
    cache.v[bidx, :, slot] = vq.to(cache.v.dtype)
    cache.k_scale[bidx, :, slot] = ks
    cache.v_scale[bidx, :, slot] = vs
    # Ring semantics: slots hold the last min(len+1, C) positions (in
    # arbitrary ring order — softmax is permutation-invariant and RoPE was
    # applied at true positions before writing), so the only mask needed is
    # "slot is filled".
    eff_len = torch.clamp_max(cache_len + 1, C)
    out = ops.decode_attention(
        q, _dequant_kv(cache.k, cache.k_scale, cfg.cdtype),
        _dequant_kv(cache.v, cache.v_scale, cfg.cdtype), eff_len,
        window=0, softcap=cfg.attn_softcap)
    out = out.reshape(B, H * dh)
    return out @ p["wo"], cache
