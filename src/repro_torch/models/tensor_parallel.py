"""The operations of a tensor-parallel region over the ``"model"`` axis
of a ``DeviceMesh``: what the JAX package's GSPMD inserts where a rank
computes only its ``"model"`` piece (:mod:`repro_torch.models.layers`,
``moe``, ``transformer``).

A tensor outside the region is the same on every model rank and so is
its gradient; inside, each rank holds its piece, and the gradient of a
value every rank holds is a part whose sum over ``"model"`` is the
whole.  At a ``"model"`` axis of size 1 each operation is the identity and
runs no collective; a mesh without that axis raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the names of newer torch releases where they exist (the older ones warn)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor



def model_group(mesh):
    """``(group, size)`` of the mesh's ``"model"`` axis; a mesh without
    one raises (nothing falls back to gathering the weights)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        raise ValueError(f"the mesh {names} has no \"model\" axis")
    size = mesh.shape[names.index("model")]
    return (mesh.get_group("model") if size > 1 else None), size


def _all_reduce(x, group, op=None):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def _gather(x, group, size: int, dim: int):
    """The pieces ``x`` of every rank of ``group`` concatenated along
    ``dim``, in rank order."""
    lead = x.movedim(dim, 0).contiguous()
    out = lead.new_empty((size * lead.shape[0],) + tuple(lead.shape[1:]))
    _all_gather(out, lead, group=group)
    return out.movedim(0, dim)


def _scatter_sum(g, group, size: int, dim: int):
    """``g`` summed over ``group``, the rank's block of ``dim`` kept."""
    lead = g.movedim(dim, 0).contiguous()
    out = lead.new_empty((lead.shape[0] // size,) + tuple(lead.shape[1:]))
    _reduce_scatter(out, lead, group=group)
    return out.movedim(0, dim)


class _IntoTP(torch.autograd.Function):
    """(i) Into the region: the identity; the gradient summed over
    ``"model"``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _OutOfTP(torch.autograd.Function):
    """(ii) Out of the region: the sum over ``"model"``; the gradient as
    it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """(iv) The pieces of every model rank concatenated along ``dim``; the
    gradient summed over ``"model"`` and the rank's block kept (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.size, ctx.dim), None, None, \
            None


def into_tp(x, mesh):
    """(i) ``x``, the same on every model rank, entering the region: the
    identity forward, its gradient summed over ``"model"`` (so the
    gradient of a leaf every model rank holds whole comes out whole)."""
    group, size = model_group(mesh)
    return x if size == 1 else _IntoTP.apply(x, group)


def out_of_tp(x, mesh):
    """(ii) The ranks' partial results summed over ``"model"``; the
    gradient passes as it is."""
    group, size = model_group(mesh)
    return x if size == 1 else _OutOfTP.apply(x, group)


def max_over_model(x, mesh):
    """(iii) The elementwise maximum over ``"model"``, without a gradient
    (the shift of a softmax over vocab-split logits)."""
    group, size = model_group(mesh)
    x = x.detach()
    return x if size == 1 else _all_reduce(x, group, dist.ReduceOp.MAX)


def gather_over_model(x, mesh, dim: int = -1):
    """(iv) The model ranks' pieces ``x`` concatenated along ``dim`` in
    rank order; the gradient reduce-scattered back (summed over
    ``"model"``, the rank's block kept)."""
    group, size = model_group(mesh)
    if size == 1:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherModel.apply(x, group, size, dim)
    return _gather(x, group, size, dim)
