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

Tensor parallelism: when a step also names the mesh whose ``"model"``
axis (of size tp > 1) splits the weights (``tp_mesh``), each weight the
sharding rules split over ``"model"`` is the rank's piece, and the layers
compute only that piece (:func:`tp_region`): :func:`mlp_apply` is
column-parallel in ``wg`` / ``wu`` / ``w1`` and row-parallel in ``wd`` /
``w2``; :func:`attn_apply` and :func:`attn_decode` run the rank's heads
(after the GQA + TP expansion, as the JAX package places them) and
``wo`` row-parallel.  A region starts at
:func:`repro_torch.models.tensor_parallel.into_tp` and its partial results
are summed by ``out_of_tp``; a leaf every model rank holds whole (a norm
scale, a weight whose dim tp does not divide) that a region reads enters
through ``into_tp`` too, so its gradient comes out whole on every rank.

FSDP: when a step also names the leaves a ``cfg.fsdp`` config's rules
split over ``"data"`` (``fsdp_mesh``, ``fsdp_dims``), the weights are the
rank's ``"data"`` pieces of those too, and the model gathers each one
whole over ``"data"`` just before its use (:func:`fsdp_gather`): one
layer at a time, inside the layer's checkpointed group, so the recompute
gathers again and no gathered layer outlives its group.

Sequence split (the JAX package's SP): when a prefill or serve step also
names the mesh whose axes split the decode caches (``seq_mesh``) and the
caches' ``max_len``, every attention cache holds all KV heads and the
rank's block of its slots (:func:`seq_plan`): the prefill writes the
block (:func:`attn_cache_from_prefill`) and :func:`attn_decode` attends
over it and merges the blocks' softmaxes across the ranks that share the
split.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import tensor_parallel as tpo

# ---------------------------------------------------------------------------
# Activation-sharding hints.  In the JAX package ``hint`` pins a layout with
# ``with_sharding_constraint``; here every tensor is a rank's local tensor
# (its piece over "model" is placed by the layers themselves, see
# ``tp_region``), so ``hint`` is the identity and ``hint_spec`` says what
# layout the JAX package would pin.
# ``mesh`` is a ``DeviceMesh`` when each rank holds one data shard's rows
# (the multi-rank steps), or a mesh description (any object with
# ``axis_names`` and a ``shape`` mapping) when one process holds the global
# batch and loops over the shards (the global view).
# ---------------------------------------------------------------------------

_AXIS_HINTS = {"on": False, "dp": None, "dp_size": 0, "tp_size": 0,
               "mesh": None}
#: the ``DeviceMesh`` whose ``"model"`` axis splits the weights the layers
#: are given (the rank's pieces; see :func:`tp_region`), None when they are
#: whole
_TP_MESH = {"mesh": None}
#: FSDP: the ``DeviceMesh`` whose ``"data"`` axis splits the weights the
#: layers are given, and the parameters' structure holding each leaf's
#: split dim or None (``launch.sharding.fsdp_dims``); both None when no
#: weight is split over ``"data"`` (see :func:`fsdp_gather`)
_FSDP = {"mesh": None, "dims": None}
#: the sequence split of the decode caches: the ``DeviceMesh`` whose axes
#: split their slots (:func:`seq_plan`) and the ``max_len`` they were made
#: for; both None when the caches are whole
_SEQ = {"mesh": None, "max_len": None}


def set_axis_hints(*, dp_axes=None, dp_size=0, tp_size=0, mesh=None,
                   tp_mesh=None, fsdp_mesh=None, fsdp_dims=None,
                   seq_mesh=None, max_len=None):
    _AXIS_HINTS.update(on=bool(dp_axes), dp=dp_axes, dp_size=dp_size,
                       tp_size=tp_size, mesh=mesh)
    _TP_MESH["mesh"] = tp_mesh
    _FSDP.update(mesh=fsdp_mesh if fsdp_dims is not None else None,
                 dims=fsdp_dims)
    _SEQ.update(mesh=seq_mesh, max_len=max_len if seq_mesh else None)


def clear_axis_hints():
    _AXIS_HINTS.update(on=False, dp=None, dp_size=0, tp_size=0, mesh=None)
    _TP_MESH["mesh"] = None
    _FSDP.update(mesh=None, dims=None)
    _SEQ.update(mesh=None, max_len=None)


@contextlib.contextmanager
def axis_hints(**hints):
    """:func:`set_axis_hints` for the length of a ``with`` block; the hints
    that were set before are restored on exit, also when the block
    raises."""
    saved, saved_tp, saved_fsdp, saved_seq = (
        dict(_AXIS_HINTS), _TP_MESH["mesh"], dict(_FSDP), dict(_SEQ))
    set_axis_hints(**hints)
    try:
        yield
    finally:
        _AXIS_HINTS.clear()
        _AXIS_HINTS.update(saved)
        _TP_MESH["mesh"] = saved_tp
        _FSDP.update(saved_fsdp)
        _SEQ.update(saved_seq)


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


class TPRegion(NamedTuple):
    """The tensor-parallel region of a step: the mesh, the ``"model"``
    size and this rank's coordinate on it."""
    mesh: object
    size: int
    rank: int


def tp_region():
    """The :class:`TPRegion` when the hints name a ``tp_mesh`` whose
    ``"model"`` axis has size tp > 1 (the layers' weights are the rank's
    pieces), else None."""
    mesh = _TP_MESH["mesh"]
    if not _AXIS_HINTS["on"] or mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    size = mesh.shape[names.index("model")]
    if size == 1:
        return None
    return TPRegion(mesh, size, mesh.get_local_rank("model"))


class SeqPlan(NamedTuple):
    """A rank's block of a decode cache split along its slots, as the JAX
    package's ``decode_state_shardings`` lays it out: slots ``[lo, lo +
    n)`` of the cache, split over the mesh axes ``axes`` (in mesh order)
    of the ``DeviceMesh`` ``mesh``."""
    lo: int
    n: int
    axes: tuple
    mesh: object


def seq_plan(C: int, mesh=None, rows: bool = True) -> SeqPlan | None:
    """The rank's :class:`SeqPlan` of a cache of ``C`` slots on ``mesh``
    (by default the hints' ``seq_mesh``, ``rows`` then
    :func:`rank_local`), by the JAX rule: over ``"model"`` when the data
    axes split the batch (``rows``); else over the data axes and
    ``"model"`` where their product divides C, else over ``"model"``.
    None where tp does not divide C (the cache whole on every rank, as
    JAX replicates it) and for a split of one rank.  A block's index
    over several axes is row-major in mesh order (pod, data, model), as
    ``devices_indices_map`` lays the blocks out."""
    if mesh is None:
        mesh = _SEQ["mesh"] if _AXIS_HINTS["on"] else None
        if mesh is None:
            return None
        rows = rank_local()
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    tp = sizes["model"]
    if not rows and C % (math.prod(sizes[a] for a in dp) * tp) == 0:
        axes = dp + ("model",)
    elif C % tp == 0:
        axes = ("model",)
    else:
        return None
    coord = dict(zip(names, mesh.get_coordinate()))
    block, size = 0, 1
    for a in axes:
        block, size = block * sizes[a] + coord[a], size * sizes[a]
    if size == 1:
        return None
    return SeqPlan(block * (C // size), C // size, axes, mesh)


def _gathered(node, dims, mesh, lead: int):
    """``node``'s leaves (nested dicts) gathered over ``"data"`` where
    ``dims`` (the same structure) names a split dim, less ``lead``
    stacked dims (a plain recursive function, not a closure)."""
    if isinstance(node, dict):
        return {k: _gathered(v, dims[k], mesh, lead)
                for k, v in node.items()}
    if dims is None:
        return node
    return tpo.gather_over(node, mesh, "data", dims - lead)


def fsdp_gather(tree, *path, lead: int = 0):
    """FSDP's gather of one use: ``tree`` (a leaf, or a layer's dict of
    leaves) at ``path`` of the parameters, each leaf that the hints'
    ``fsdp_dims`` split over ``"data"`` gathered whole over that axis
    (:func:`repro_torch.models.tensor_parallel.gather_over`: its gradient
    reduce-scattered back, summed over ``"data"``); ``lead`` the stacked
    dims ``tree`` lacks (1 for a layer of a stack).  ``tree`` as it is
    without FSDP hints."""
    dims = _FSDP["dims"]
    if not _AXIS_HINTS["on"] or dims is None:
        return tree
    for k in path:
        dims = dims[int(k)] if isinstance(dims, (tuple, list)) else dims[k]
    return _gathered(tree, dims, _FSDP["mesh"], lead)


def _split(t: TPRegion, w, dim: int, full: int) -> bool:
    """Whether the rules split the ``full``-wide dim ``dim`` of ``w`` over
    ``"model"`` (they split a dim that tp divides, as the JAX rules do);
    a weight that is not then the rank's piece raises."""
    if t is None or full % t.size:
        return False
    if w.shape[dim] != full // t.size:
        raise ValueError(f"a weight of shape {tuple(w.shape)} is not a "
                         f"rank's piece of {full} over {t.size} ranks")
    return True


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


def mlp_apply(p, x, cfg: ModelConfig, d_ff: int | None = None):
    """``d_ff``: the MLP's whole width (``cfg.d_ff`` unless given; shared
    experts are wider).  In a tensor-parallel region whose rules split that
    width, the rank computes its columns of ``wg`` / ``wu`` / ``w1`` and
    its rows of ``wd`` / ``w2``, and the parts are summed over
    ``"model"``."""
    t = tp_region()
    w_in = p["w1"] if cfg.mlp_act == "sq_relu" else p["wg"]
    split = _split(t, w_in, -1, d_ff or cfg.d_ff)
    if split:
        x = tpo.into_tp(x, t.mesh)
    if cfg.mlp_act == "sq_relu":
        h = x @ p["w1"]
        out = torch.square(torch.relu(h)) @ p["w2"]
    else:
        act = F.silu if cfg.mlp_act == "silu_glu" else _gelu_tanh
        g = act(x @ p["wg"])
        u = x @ p["wu"]
        out = (g * u) @ p["wd"]
    return tpo.out_of_tp(out, t.mesh) if split else out


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
    """Every head's q, k, v ``(..., heads, Dh)`` of ``x`` (..., D)."""
    lead = tuple(x.shape[:-1])
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(lead + (H, dh))
    k = (x @ p["wk"]).reshape(lead + (KV, dh))
    v = (x @ p["wv"]).reshape(lead + (KV, dh))
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    return q, k, v


class HeadPlan(NamedTuple):
    """A rank's attention heads in a tensor-parallel region.  ``kv``:
    ``"aligned"`` (tp divides KV: the rank's KV / tp heads, read by its q
    heads as in GQA), ``"expand"`` (tp divides H but not KV: the KV heads
    expanded to H, as the JAX package's GQA + TP expansion, and the
    rank's H / tp of them taken) or ``"all"`` (tp does not divide H: every
    head, on every rank, as the JAX rules leave them replicated)."""
    q_lo: int      # the q heads computed: [q_lo, q_lo + n_q)
    n_q: int
    kv: str
    n_kv: int      # the k / v heads the rank's attention reads


def head_plan(cfg: ModelConfig, t: TPRegion) -> HeadPlan | None:
    """The rank's :class:`HeadPlan`, or None where the rules split no
    attention weight (tp does not divide ``H * Dh``): then every weight
    is whole and the attention runs as on one device."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if t is None or (H * dh) % t.size:
        return None
    if H % t.size:
        return HeadPlan(0, H, "all", KV)
    n = H // t.size
    if KV % t.size == 0:
        return HeadPlan(t.rank * n, n, "aligned", KV // t.size)
    return HeadPlan(t.rank * n, n, "expand", n)


def take_kv_heads(y, cfg: ModelConfig, plan: HeadPlan, rank: int,
                  dim: int):
    """The rank's k / v heads (:class:`HeadPlan`) of ``y``, which holds
    all ``n_kv_heads`` on ``dim``: its block (aligned), the expansion's
    heads ``[q_lo, q_lo + n_q)``, head ``h`` reading KV head ``h // rep``
    (expand), or all of them."""
    if plan.kv == "all":
        return y
    if plan.kv == "aligned":
        return y.narrow(dim, rank * plan.n_kv, plan.n_kv)
    rep = cfg.n_heads // cfg.n_kv_heads
    a = plan.q_lo // rep
    b = (plan.q_lo + plan.n_q - 1) // rep + 1
    y = y.narrow(dim, a, b - a).repeat_interleave(rep, dim=dim)
    return y.narrow(dim, plan.q_lo - a * rep, plan.n_q)


def _tp_qkv(p, xin, cfg: ModelConfig, t: TPRegion, plan: HeadPlan,
            all_kv: bool = False):
    """The rank's q, k, v heads ``(..., heads, Dh)`` of ``xin`` (inside
    the region), and with ``all_kv`` every KV head's k and v (else None).
    Split columns that are not the rank's heads (an unaligned k / v split,
    or q when tp does not divide H) are gathered over ``"model"`` as
    activations, never as weights; a whole k / v weight enters the region
    through ``into_tp``.  Every KV head is what those gathers hold, or
    under ``"aligned"`` a gather of the rank's KV heads (never of the
    expansion)."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = tuple(xin.shape[:-1])
    _split(t, p["wq"], -1, H * dh)
    q = xin @ p["wq"]
    if plan.kv == "all":
        q = tpo.gather_over_model(q, t.mesh)
    q = q.reshape(lead + (plan.n_q, dh))

    def kv(w):
        """The rank's heads, and every KV head where they are not
        those."""
        if plan.kv == "aligned":
            _split(t, w, -1, KV * dh)
            return (xin @ w).reshape(lead + (plan.n_kv, dh)), None
        if _split(t, w, -1, KV * dh):
            y = tpo.gather_over_model(xin @ w, t.mesh)
        else:
            y = xin @ tpo.into_tp(w, t.mesh)
        y = y.reshape(lead + (KV, dh))
        return take_kv_heads(y, cfg, plan, t.rank, -2), y

    (k, k_all), (v, v_all) = kv(p["wk"]), kv(p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(tpo.into_tp(p["qn"], t.mesh), q)
        kn = tpo.into_tp(p["kn"], t.mesh)
        k = rmsnorm(kn, k)
        if all_kv and plan.kv == "expand":
            k_all = rmsnorm(kn, k_all)
    if not all_kv:
        return q, k, v, None
    if plan.kv == "aligned":
        k_all = tpo.gather_over_model(k, t.mesh, -2)
        v_all = tpo.gather_over_model(v, t.mesh, -2)
    elif plan.kv == "all":
        k_all = k
    return q, k, v, (k_all, v_all)


def _heads(p, x, cfg: ModelConfig, all_kv: bool = False):
    """``(q, k, v, region, plan, kv_all)``: the heads of ``x`` (..., D)
    that this rank computes, every head outside a tensor-parallel region
    (``plan`` None); ``kv_all`` every KV head's ``(k, v)`` with
    ``all_kv``, else None."""
    t = tp_region()
    plan = head_plan(cfg, t)
    if plan is None:
        q, k, v = _qkv(p, x, cfg)
        return q, k, v, t, plan, (k, v) if all_kv else None
    q, k, v, kv_all = _tp_qkv(p, tpo.into_tp(x, t.mesh), cfg, t, plan,
                              all_kv)
    return q, k, v, t, plan, kv_all


def _out(p, out, cfg: ModelConfig, t: TPRegion, plan: HeadPlan | None):
    """``wo`` on the heads' outputs ``(..., heads * Dh)``: in a
    tensor-parallel region row-parallel, summed over ``"model"`` (with
    every head on every rank, on the rank's block of rows of the
    concatenated heads)."""
    if plan is None:
        return out @ p["wo"]
    width = cfg.n_heads * cfg.head_dim
    _split(t, p["wo"], -2, width)
    if plan.kv == "all":
        out = out.narrow(-1, t.rank * (width // t.size), width // t.size)
    return tpo.out_of_tp(out @ p["wo"], t.mesh)


def attn_apply(p, x, cfg: ModelConfig, kind: str, pos0: int = 0, *,
               all_kv: bool = False):
    """Training / prefill attention.  kind: full | local | bidir.
    Returns (out, (k, v)) — k/v in (B, KV, S, Dh) for cache building: in
    a tensor-parallel region the rank's heads (:func:`head_plan`), with
    ``all_kv`` every KV head (what a decode cache holds)."""
    B, S, _ = x.shape
    q, k, v, t, plan, kv_all = _heads(p, x, cfg, all_kv)
    pos = pos0 + torch.arange(S, device=x.device)
    q = rope(q, pos[None, :], cfg.rope_theta)
    k = rope(k, pos[None, :], cfg.rope_theta)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    # GQA + TP, as the JAX package: when q heads shard over "model" but KV
    # heads do not, KV is expanded to H heads (numerically the identity;
    # a tensor-parallel region's plan has taken the rank's share already)
    tp = _AXIS_HINTS["tp_size"] if _AXIS_HINTS["on"] else 0
    H, KV = cfg.n_heads, cfg.n_kv_heads
    ke, ve = kt, vt
    if plan is None and tp and H % tp == 0 and KV % tp != 0 and H != KV:
        ke = kt.repeat_interleave(H // KV, dim=1)
        ve = vt.repeat_interleave(H // KV, dim=1)
    causal = kind != "bidir"
    window = cfg.window if kind == "local" else 0
    out = ops.flash_attention(qt, ke, ve, causal=causal, window=window,
                              softcap=cfg.attn_softcap)
    out = out.transpose(1, 2).reshape(B, S, -1)
    if all_kv and plan is not None and plan.kv != "all":
        kt = rope(kv_all[0], pos[None, :], cfg.rope_theta).transpose(1, 2)
        vt = kv_all[1].transpose(1, 2)
    return _out(p, out, cfg, t, plan), (kt, vt)


def _cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    return min(cfg.window, max_len) if kind == "local" else max_len


def attn_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device="cpu") -> AttnCache:
    """Empty cache, stored in the config's ``kv_cache_dtype`` (the JAX
    signature's unused ``dtype`` argument is dropped), of every KV head
    and, under the hints' sequence split, the rank's block of the slots
    (:func:`seq_plan`)."""
    C = _cache_len(cfg, kind, max_len)
    sp = seq_plan(C)
    n = C if sp is None else sp.n
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    sdtype = _cache_dtype(cfg)
    return AttnCache(
        k=torch.zeros((batch, KV, n, dh), dtype=sdtype, device=device),
        v=torch.zeros((batch, KV, n, dh), dtype=sdtype, device=device),
        k_scale=torch.zeros((batch, KV, n), dtype=torch.float32,
                            device=device),
        v_scale=torch.zeros((batch, KV, n), dtype=torch.float32,
                            device=device))


def attn_cache_from_prefill(cfg: ModelConfig, kind: str, kt, vt, max_len: int
                            ) -> AttnCache:
    """Build a decode cache from prefill k/v (B, KV, S, Dh) of every KV
    head: the positions a cache of ``max_len`` slots keeps (windowed
    layers a ring of the last ``window`` at slots ``pos % window``), in
    the rank's block of the slots under the hints' sequence split
    (:func:`seq_plan`; the whole cache without one).  Each slot's source
    position is found by arithmetic, so an empty slot is masked, never
    indexed."""
    B, KV, S, dh = kt.shape
    C = _cache_len(cfg, kind, max_len)
    sp = seq_plan(C)
    lo, n = (0, C) if sp is None else (sp.lo, sp.n)
    quant = cfg.kv_cache_dtype == "int8"
    sdtype = _cache_dtype(cfg)
    # the last ``take`` positions are kept, the i-th at slot (off + i) % C
    off = S - C if kind == "local" and S > C else 0
    take = min(S, C)
    i = (torch.arange(lo, lo + n, device=kt.device) - off) % C
    ok = i < take
    src = S - take + torch.where(ok, i, 0)
    kq, ks = _quant_kv(kt.index_select(2, src), quant)
    vq, vs = _quant_kv(vt.index_select(2, src), quant)
    zero = torch.zeros((), dtype=torch.float32, device=kt.device)
    return AttnCache(
        k=torch.where(ok[:, None], kq.to(sdtype), zero.to(sdtype)),
        v=torch.where(ok[:, None], vq.to(sdtype), zero.to(sdtype)),
        k_scale=torch.where(ok, ks, zero), v_scale=torch.where(ok, vs, zero))


def _write_slot(buf, bidx, slot, new, mine=None):
    """``buf[b, :, slot[b]] = new[b]``, for the lanes ``mine`` marks only
    (the others write back what the slot holds: no index leaves
    ``buf``)."""
    new = new.to(buf.dtype)
    if mine is not None:
        new = torch.where(mine.view((-1,) + (1,) * (new.dim() - 1)), new,
                          buf[bidx, :, slot])
    buf[bidx, :, slot] = new


def attn_decode(p, x, cfg: ModelConfig, kind: str, cache: AttnCache,
                cache_len):
    """One-token decode.  x: (B, D); cache_len: (B,) current lengths; in
    a tensor-parallel region the rank's heads.  The cache holds every KV
    head.  Under the hints' sequence split (:func:`seq_plan` of the
    hints' ``max_len``) it is the rank's block of the slots: the new k/v
    go into a lane's slot on the rank whose block holds it, every rank
    attends all H heads (q gathered over ``"model"``) over its own
    slots, and the blocks' softmaxes are merged exactly (one all-reduce
    max, one all-reduce sum over the plan's axes); the rank then keeps
    its heads' outputs for ``wo``.  Whole, the rank attends its heads
    over the cache as on one device.
    Returns (out, cache).  Unlike the JAX package's functional update, the
    new k/v are written into ``cache`` in place (the cache is the largest
    state of decoding; a copy per step would double its traffic)."""
    B, D = x.shape
    q, _, _, t, plan, (k, v) = _heads(p, x, cfg, all_kv=True)
    q = rope(q, cache_len, cfg.rope_theta)
    k = rope(k, cache_len, cfg.rope_theta)
    max_len = _SEQ["max_len"] if _AXIS_HINTS["on"] else None
    C = cache.k.shape[2] if max_len is None else _cache_len(cfg, kind,
                                                            max_len)
    sp = seq_plan(C)
    lo, n = (0, C) if sp is None else (sp.lo, sp.n)
    if cache.k.shape[2] != n:
        raise ValueError(f"a cache of {cache.k.shape[2]} slots is not this "
                         f"rank's {n} of {C}")
    slot = cache_len % C - lo
    mine = None
    if sp is not None:
        mine = (slot >= 0) & (slot < n)
        slot = slot.clamp(0, n - 1)
    bidx = torch.arange(B, device=x.device)
    quant = cfg.kv_cache_dtype == "int8"
    kq, ks = _quant_kv(k, quant)
    vq, vs = _quant_kv(v, quant)
    for buf, new in zip(cache, (kq, vq, ks, vs)):
        _write_slot(buf, bidx, slot, new, mine)
    # Ring semantics: slots hold the last min(len+1, C) positions (in
    # arbitrary ring order — softmax is permutation-invariant and RoPE was
    # applied at true positions before writing), so the only mask needed is
    # "slot is filled".
    eff_len = torch.clamp_max(cache_len + 1, C)
    kc = _dequant_kv(cache.k, cache.k_scale, cfg.cdtype)
    vc = _dequant_kv(cache.v, cache.v_scale, cfg.cdtype)
    if sp is None:
        if plan is not None:
            kc = take_kv_heads(kc, cfg, plan, t.rank, 1)
            vc = take_kv_heads(vc, cfg, plan, t.rank, 1)
        out = ops.decode_attention(q, kc, vc, eff_len, window=0,
                                   softcap=cfg.attn_softcap)
        return _out(p, out.reshape(B, -1), cfg, t, plan), cache
    mine_heads = plan is not None and plan.kv != "all"
    if mine_heads:
        q = tpo.gather_over_model(q, t.mesh, -2)
    filled = lo + torch.arange(n, device=x.device) < eff_len[:, None]
    m, l, o = ref.decode_attention_partial(q, kc, vc, filled,
                                           cfg.attn_softcap)
    out = ref.decode_attention_merge(
        m, l, o, q.dtype,
        reduce_max=lambda a: tpo.reduce_over(a, sp.mesh, sp.axes, "max"),
        reduce_sum=lambda a: tpo.reduce_over(a, sp.mesh, sp.axes))
    if mine_heads:
        out = out.narrow(1, plan.q_lo, plan.n_q)
    return _out(p, out.reshape(B, -1), cfg, t, plan), cache
