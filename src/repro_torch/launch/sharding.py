"""Sharding policy: parameter / optimizer / batch / decode-state specs and
their DTensor placements.  The port of the JAX package's
``launch/sharding.py``.

Rules:
  TP    attention heads, FFN columns, expert dim, vocab -> "model"
        (skipped per tensor when the dim is not divisible)
  DP    batch -> ("pod", "data") / "data"
  EP    MoE expert dim -> "model"
  FSDP  cfg.fsdp archs also shard the non-TP matrix dim over "data"
  ZeRO-1 optimizer m / v shard their largest replicated dim over "data"
        even when the parameters do not
  SP    decode KV caches shard the sequence dim over "model" (+ the data
        axes when the batch cannot shard, e.g. long_500k's batch of 1)

Stacked layer parameters (under "streams") have a leading scan dim, so
their spec starts with ``None``.

A spec is data: a tuple with one entry per tensor dim (or fewer, the rest
replicated), each ``None``, an axis name or a tuple of axis names, equal to
``tuple(PartitionSpec(...))`` of the JAX rule for the same path, shape,
config and mesh (a one-name tuple is written as the name, as
``PartitionSpec`` writes it).  The rules read the mesh through
:mod:`repro_torch.launch.mesh`, so they run on a ``DeviceMesh`` or on a
plain mesh description.  :func:`placements` turns a spec into DTensor
placements; several axes on one tensor dim must be listed in mesh order,
which is the order DTensor nests its shards in (every rule lists them so).

Leaf paths follow the JAX package's flattening: mapping keys sorted,
sequences and NamedTuples by index, so ``DecodeState.length`` has path
``("1",)`` and its spec is replicated.
"""

from __future__ import annotations

import math
from typing import Any

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, dp_axes, tp_size
from repro_torch.models.transformer import ParamTree


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _spec(*entries) -> tuple:
    """``entries`` as ``PartitionSpec`` keeps them: an empty axis tuple is
    ``None``, a one-axis tuple its name."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e

    return tuple(norm(e) for e in entries)


def _is_leaf(node) -> bool:
    return hasattr(node, "shape") or not isinstance(
        node, (dict, tuple, list, ParamTree, nn.ModuleList))


def _walk_paths(path: tuple, node, out: list) -> None:
    if _is_leaf(node):
        out.append((path, node))
    elif isinstance(node, (dict, ParamTree)):
        for k in sorted(node.keys()):
            _walk_paths(path + (k,), node[k], out)
    else:  # tuple / list / NamedTuple / ModuleList
        for i, v in enumerate(node):
            _walk_paths(path + (str(i),), v, out)


def _flatten_paths(tree) -> list:
    """``(path, leaf)`` pairs in the JAX package's order (plain recursive
    helpers, not closures, so no reference cycle keeps a leaf alive)."""
    out: list = []
    _walk_paths((), tree, out)
    return out


def _rebuild(tree, mapping: dict, path: tuple = ()):
    """``tree``'s structure holding ``mapping[path]`` at each leaf: a
    ``ParamTree`` becomes a dict, a ``ModuleList`` a tuple."""
    if _is_leaf(tree):
        return mapping[path]
    if isinstance(tree, (dict, ParamTree)):
        return {k: _rebuild(tree[k], mapping, path + (k,))
                for k in tree.keys()}
    children = [_rebuild(v, mapping, path + (str(i),))
                for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):          # NamedTuple
        return type(tree)(*children)
    return children if isinstance(tree, list) else tuple(children)


def param_pspec(path: tuple, shape: tuple, cfg: ModelConfig, mesh) -> tuple:
    tp = tp_size(mesh)
    n_data = axis_sizes(mesh)["data"]
    fsdp = "data" if cfg.fsdp else None
    stacked = "streams" in path
    dims = shape[1:] if stacked else shape
    name = path[-1]

    def fs(d):  # fsdp axis if divisible
        return fsdp if (fsdp and _div(d, n_data)) else None

    def tpx(d):  # tensor-parallel axis if divisible
        return "model" if _div(d, tp) else None

    spec: tuple
    if name == "embed":
        spec = (tpx(dims[0]), fs(dims[1]))
    elif name == "lm_head":
        spec = (fs(dims[0]), tpx(dims[1]))
    elif name in ("wq", "wk", "wv", "wg", "wu", "w1", "cm_k", "in_proj",
                  "cm_r") and len(dims) == 2:
        spec = (fs(dims[0]), tpx(dims[1]))
    elif name in ("wo", "wd", "w2", "cm_v", "out_proj") and len(dims) == 2:
        spec = (tpx(dims[0]), fs(dims[1]))
    elif name in ("wg", "wu") and len(dims) == 3:      # MoE experts (E,D,F)
        spec = (tpx(dims[0]), fs(dims[1]), None)
    elif name == "wd" and len(dims) == 3:              # MoE experts (E,F,D)
        spec = (tpx(dims[0]), None, fs(dims[1]))
    elif name == "x_proj":
        spec = (tpx(dims[0]), None)
    elif name == "conv":
        spec = (None, tpx(dims[1]))
    elif name == "dt_w":
        spec = (None, tpx(dims[1]))
    elif name == "A_log":
        spec = (tpx(dims[0]), None)
    else:
        spec = tuple(None for _ in dims)
    if stacked:
        spec = (None,) + spec
    return _spec(*spec)


def opt_pspec(pspec: tuple, path: tuple, shape: tuple, cfg: ModelConfig,
              mesh) -> tuple:
    """ZeRO-1: shard the largest still-replicated dim of m / v over
    ``"data"``."""
    spec = list(tuple(pspec) + (None,) * (len(shape) - len(tuple(pspec))))
    if "data" in spec or not shape:
        return _spec(*spec)
    dsz = axis_sizes(mesh)["data"]
    # biggest replicated-dim candidate
    cand = [(shape[i], i) for i, s in enumerate(spec)
            if s is None and _div(shape[i], dsz)]
    if cand:
        _, i = max(cand)
        spec[i] = "data"
    return _spec(*spec)


def param_shardings(params_shape: Any, cfg: ModelConfig, mesh):
    """A tree of parameters (or meta tensors) -> the same tree of specs."""
    return _rebuild(params_shape, {
        path: param_pspec(path, tuple(v.shape), cfg, mesh)
        for path, v in _flatten_paths(params_shape)})


def opt_shardings(opt_shape: Any, params_shape: Any, cfg: ModelConfig,
                  mesh):
    """Optimizer state (``AdamWState(step, m, v)``) specs with ZeRO-1."""
    def for_tree(tree):
        mapping = {}
        for path, v in _flatten_paths(tree):
            ps = param_pspec(path, tuple(v.shape), cfg, mesh)
            mapping[path] = opt_pspec(ps, path, tuple(v.shape), cfg, mesh)
        return _rebuild(tree, mapping)

    return type(opt_shape)(step=_spec(), m=for_tree(opt_shape.m),
                           v=for_tree(opt_shape.v))


def batch_shardings(batch_shape: dict, mesh) -> dict:
    """Every batch leaf: its leading dim over the data-parallel axes."""
    dp = dp_axes(mesh)
    return {k: _spec(dp, *[None] * (len(v.shape) - 1))
            for k, v in batch_shape.items()}


def decode_state_shardings(state_shape, cfg: ModelConfig, mesh):
    """Caches: batch over dp when divisible; the KV cache's seq dim over
    ``"model"`` (with the dp axes folded in when the batch cannot
    shard)."""
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    dpn = math.prod(sizes[a] for a in dp)
    tp = tp_size(mesh)

    def seq_axes(C, bax):
        if bax:
            return "model" if _div(C, tp) else None
        if _div(C, dpn * tp):
            return dp + ("model",)
        return "model" if _div(C, tp) else None

    def leaf_spec(path, v):
        shape = tuple(v.shape)
        name = path[-1]
        if name == "length":
            return _spec()
        # stacked (n_scan, B, ...) leaves
        b = shape[1] if len(shape) > 1 else 0
        bax = dp if _div(b, dpn) else None
        if name in ("k", "v") and len(shape) == 5:
            # (n, B, KV, C, Dh): seq dim C -> "model"
            return _spec(None, bax, None, seq_axes(shape[3], bax), None)
        if name in ("k_scale", "v_scale") and len(shape) == 4:
            # (n, B, KV, C): the cache's layout minus the head dim
            return _spec(None, bax, None, seq_axes(shape[3], bax))
        if name == "rwkv_state" and len(shape) == 5:
            # (n, B, H, dh, dh)
            hax = "model" if _div(shape[2], tp) else None
            return _spec(None, bax, hax, None, None)
        if name == "ssm_state" and len(shape) == 4:
            dax = "model" if _div(shape[2], tp) else None
            return _spec(None, bax, dax, None)
        if name == "ssm_conv" and len(shape) == 4:
            dax = "model" if _div(shape[3], tp) else None
            return _spec(None, bax, None, dax)
        if name in ("tm_last", "cm_last") and len(shape) == 3:
            return _spec(None, bax, None)
        return _spec(*(None,) * len(shape))

    return _rebuild(state_shape, {path: leaf_spec(path, v) for path, v
                                  in _flatten_paths(state_shape)})


def count_params(params_shape) -> int:
    return int(sum(math.prod(v.shape) for _, v in
                   _flatten_paths(params_shape)))


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on every mesh dim that the spec names for tensor dim
    ``d``, ``Replicate()`` on every other.  DTensor nests several shards of
    one tensor dim in mesh-dim order, the major-to-minor split of a
    ``PartitionSpec`` only when its axes are listed in mesh order, so any
    other order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(set(idx)):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} names the axis {names[i]} "
                                 "twice")
            out[i] = Shard(d)
    return tuple(out)


def tp_compute(cfg: ModelConfig) -> bool:
    """Whether the mesh-bound steps compute ``cfg`` over ``"model"`` (each
    rank its pieces of the leaves the rules split there): the attention,
    MLP and MoE families.  RWKV6's mixes and hymba's SSM heads are not
    split yet; their steps gather every leaf whole."""
    return cfg.family != "ssm" and not cfg.parallel_ssm


def model_piece(leaf):
    """The local tensor a rank computes with for a DTensor leaf placed by
    the rules (a plain tensor as it is): its ``"model"`` piece (the
    rules' split, :func:`param_pspec`: a dim tp does not divide stays
    whole) and, for a leaf FSDP splits over ``"data"``, its ``"data"``
    piece of that, which the model gathers one layer at a time
    (:func:`repro_torch.models.layers.fsdp_gather`).  Nothing is
    gathered here."""
    return leaf.to_local() if hasattr(leaf, "to_local") else leaf


def fsdp_dim(leaf):
    """The tensor dim that FSDP splits a DTensor leaf on over ``"data"``
    (its placement there, from :func:`param_pspec`'s ``fs``), or None:
    a plain tensor, a leaf the rules keep whole over ``"data"`` (a dim
    ``"data"`` does not divide stays whole, as in JAX), a data axis of
    one rank (where the split is the whole)."""
    if not hasattr(leaf, "placements"):
        return None
    names = tuple(leaf.device_mesh.mesh_dim_names)
    if "data" not in names or leaf.device_mesh.shape[
            names.index("data")] == 1:
        return None
    pl = leaf.placements[names.index("data")]
    return pl.dim if pl.is_shard() else None


def fsdp_dims(params):
    """``params``'s structure (a ``ParamTree`` as a dict, a ``ModuleList``
    a tuple) holding each leaf's :func:`fsdp_dim`; None when no leaf is
    split over ``"data"`` (a config without ``fsdp``, a data axis of one
    rank)."""
    leaves = _flatten_paths(params)
    dims = {path: fsdp_dim(leaf) for path, leaf in leaves}
    if all(d is None for d in dims.values()):
        return None
    return _rebuild(params, dims)


def is_model_split(leaf) -> bool:
    """Whether a DTensor leaf is split over ``"model"``."""
    names = tuple(leaf.device_mesh.mesh_dim_names)
    return "model" in names and leaf.placements[
        names.index("model")].is_shard()


def distribute_tree(tree, specs, mesh):
    """``tree``'s leaves as DTensors on ``mesh`` under ``specs`` (a tree of
    the same structure, as the ``*_shardings`` functions give), in a tree
    of their structure (a ``ParamTree`` becomes a dict)."""
    from torch.distributed.tensor import distribute_tensor

    def spec_at(path):
        node = specs
        for k in path:
            node = node[int(k)] if isinstance(node, (tuple, list)) else node[k]
        return node

    return _rebuild(tree, {
        path: distribute_tensor(v, mesh, placements(spec_at(path), mesh))
        for path, v in _flatten_paths(tree)})
