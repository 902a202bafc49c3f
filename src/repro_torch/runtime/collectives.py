"""Hierarchical (tree) collectives: the port of the JAX package's
``runtime/collectives.py``, the distributed-runtime form of the paper's
tree barrier.

A flat all-reduce over every chip is the "centralized barrier": every
gradient byte crosses the slow inter-pod links in full.  The tree version
follows the barrier's gather / release shape:

  gather   reduce-scatter inside the pod (each rank ends up owning
           1/size of the sum)
  exchange all-reduce of only that shard across the ``pod`` axis
  release  all-gather inside the pod

The JAX functions run inside ``shard_map`` with the axis names bound; these
take the rank's local tensor and the ``DeviceMesh`` and run the same hops
on its process groups.  Every rank calls them in the same order (the
groups of several axes are made collectively on first use).  Sum
semantics throughout; inputs are never written.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes

#: (default process group, mesh, axes) -> this rank's group over several
#: mesh axes
_GROUPS: dict = {}


def tree_map(fn, tree):
    """``tree`` (tensors in dicts, lists, tuples and NamedTuples) holding
    ``fn(leaf)`` at each leaf, called in the JAX package's leaf order
    (mapping keys sorted).  A plain recursive function, not a closure, so
    no reference cycle keeps a leaf alive; it imports nothing of the
    models, so the models can import this module."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if hasattr(tree, "_fields"):                       # NamedTuple
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, x) for x in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def _axes(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def _group_ranks(mesh, axes: tuple) -> list:
    """The ranks of every group over the mesh axes ``axes``: one list per
    product sub-mesh, ordered by the axes as listed (``("data",
    "model")``: data-major, as a ``psum_scatter`` over that tuple
    indexes)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    size = math.prod(mesh.shape[d] for d in dims)
    # the mesh's rank table is a real tensor, also under a fake-tensor
    # trace (the dry-run)
    with unset_fake_temporarily():
        ranks = np.array(mesh.mesh.tolist())
    return ranks.transpose(rest + dims).reshape(-1, size).tolist()


def _group(mesh, axes: tuple):
    """The process group over the mesh axes ``axes`` that holds this rank:
    the mesh's own for one axis, else one of :func:`_group_ranks`, made
    (collectively) on first use."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    world = dist.group.WORLD
    key = (world, mesh, axes)
    if key not in _GROUPS:
        for stale in [k for k in _GROUPS if k[0] is not world]:
            del _GROUPS[stale]   # groups of a destroyed world
        _GROUPS[key] = dist.new_subgroups_by_enumeration(
            _group_ranks(mesh, axes))[0]
    return _GROUPS[key]


# the names of newer torch releases where they exist (the older ones warn)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def tree_allreduce(x: torch.Tensor, mesh, *, intra_axes, inter_axis):
    """Hierarchical all-reduce (sum semantics) of this rank's ``x``:
    reduce-scatter over ``intra_axes`` (a mesh axis name or a tuple of
    them, e.g. ``("data",)`` or ``("data", "model")``), all-reduce of the
    shard over ``inter_axis`` (``"pod"``), all-gather over ``intra_axes``.
    Falls back to two flat all-reduces when the value does not split
    evenly."""
    intra = _axes(intra_axes)
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in intra)
    g_intra, g_inter = _group(mesh, intra), _group(mesh, (inter_axis,))
    flat = x.reshape(-1)
    n = flat.numel()
    if n % size != 0:        # tiny tensors: a flat reduce is cheaper anyway
        out = flat.clone()
        dist.all_reduce(out, group=g_intra)
        dist.all_reduce(out, group=g_inter)
        return out.reshape(x.shape)
    # gather: each rank ends up with the sum of its 1/size shard
    shard = flat.new_empty(n // size)
    _reduce_scatter(shard, flat.contiguous(), group=g_intra)
    # parent hop: only the shard crosses the inter-pod links
    dist.all_reduce(shard, group=g_inter)
    # release: broadcast back down the tree
    out = flat.new_empty(n)
    _all_gather(out, shard, group=g_intra)
    return out.reshape(x.shape)


def flat_psum_grads(grads, mesh, axes):
    """Baseline: one all-reduce of each leaf over all of ``axes`` at once
    (their product group)."""
    group = _group(mesh, _axes(axes))

    def one(g):
        out = g.clone()
        dist.all_reduce(out, group=group)
        return out

    return tree_map(one, grads)


def hierarchical_psum_grads(grads, mesh, *, intra_axes=("data",),
                            inter_axis="pod"):
    """:func:`tree_allreduce` of every leaf."""
    return tree_map(lambda g: tree_allreduce(
        g, mesh, intra_axes=intra_axes, inter_axis=inter_axis), grads)
