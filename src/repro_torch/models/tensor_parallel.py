"""The operations of a tensor-parallel region over the ``"model"`` axis
of a ``DeviceMesh``, and the gather of FSDP's pieces over ``"data"``:
what the JAX package's GSPMD inserts where a rank computes only its
``"model"`` piece (:mod:`repro_torch.models.layers`, ``moe``,
``transformer``) or holds only its ``"data"`` piece of a weight.

A tensor outside the region is the same on every model rank and so is
its gradient; inside, each rank holds its piece, and the gradient of a
value every rank holds is a part whose sum over ``"model"`` is the
whole.  :func:`gather_over` concatenates the pieces of one mesh axis
and reduce-scatters the gradient back: over ``"model"`` the activations'
gather, over ``"data"`` FSDP's per-layer gather of a weight, whose
gradient so comes back summed over ``"data"`` in the rank's layout.  At
an axis of size 1 each operation is the identity and runs no
collective; a mesh without the axis raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the names of newer torch releases where they exist (the older ones warn)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor



def axis_group(mesh, axis: str):
    """``(group, size)`` of the mesh's axis ``axis`` (the group None at
    size 1); a mesh without it raises (nothing falls back to gathering
    the weights)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"the mesh {names} has no \"{axis}\" axis")
    size = mesh.shape[names.index(axis)]
    return (mesh.get_group(axis) if size > 1 else None), size


def model_group(mesh):
    """``(group, size)`` of the mesh's ``"model"`` axis."""
    return axis_group(mesh, "model")


def _all_reduce(x, group, op=None):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


#: the most bytes one gather's output (one reduce-scatter's input) moves
#: in a call: a larger one goes in blocks of its leading rows, so the
#: buffers it needs beside its output (its input made contiguous, and on
#: CUDA tensors gloo's copy of the whole output) hold at most a block
BLOCK_BYTES = 1 << 28


def _blocks(n: int, row_bytes: int, size: int) -> list:
    """``[a, b)`` blocks of ``n`` rows of ``row_bytes`` each, every block
    of the ``size`` ranks together within :data:`BLOCK_BYTES`."""
    step = max(1, BLOCK_BYTES // max(1, size * row_bytes))
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _gather(x, group, size: int, dim: int):
    """The pieces ``x`` of every rank of ``group`` concatenated along
    ``dim``, in rank order (in :func:`_blocks` of the other ranks'
    rows)."""
    lead = x.movedim(dim, 0)
    n, rest = lead.shape[0], tuple(lead.shape[1:])
    out = lead.new_empty((size * n,) + rest)
    blocks = _blocks(n, lead[0].numel() * lead.element_size() if n else 0,
                     size)
    if len(blocks) <= 1:
        _all_gather(out, lead.contiguous(), group=group)
    else:
        parts = out.view((size, n) + rest)
        for a, b in blocks:
            buf = lead.new_empty((size * (b - a),) + rest)
            _all_gather(buf, lead[a:b].contiguous(), group=group)
            parts[:, a:b].copy_(buf.view((size, b - a) + rest))
            del buf
    return out.movedim(0, dim)


def _scatter_sum(g, group, size: int, dim: int):
    """``g`` summed over ``group``, the rank's block of ``dim`` kept (in
    :func:`_blocks` of the rows)."""
    lead = g.movedim(dim, 0)
    n, rest = lead.shape[0] // size, tuple(lead.shape[1:])
    out = lead.new_empty((n,) + rest)
    blocks = _blocks(n, lead[0].numel() * lead.element_size() if n else 0,
                     size)
    if len(blocks) <= 1:
        _reduce_scatter(out, lead.contiguous(), group=group)
    else:
        parts = lead.unflatten(0, (size, n))
        for a, b in blocks:
            _reduce_scatter(out[a:b], parts[:, a:b].reshape(
                (size * (b - a),) + rest), group=group)
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


class _Gather(torch.autograd.Function):
    """(iv) The pieces of every rank of one mesh axis concatenated along
    ``dim``; the gradient summed over the axis and the rank's block kept
    (a reduce-scatter)."""

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


def reduce_over(x, mesh, axes: tuple, op: str = "sum"):
    """The elementwise sum (``op`` ``"max"``: maximum) of ``x`` over the
    ranks of the mesh axes ``axes``: one all-reduce over their product
    group (``runtime.collectives``), without a gradient (the merge of a
    softmax split along a decode cache's slots)."""
    from repro_torch.runtime.collectives import _group

    return _all_reduce(x.detach(), _group(mesh, tuple(axes)),
                       dist.ReduceOp.MAX if op == "max" else None)


def gather_over(x, mesh, axis: str, dim: int = -1):
    """(iv) The pieces ``x`` of the ranks of the mesh axis ``axis``
    concatenated along ``dim`` in rank order; the gradient
    reduce-scattered back (summed over ``axis``, the rank's block
    kept)."""
    group, size = axis_group(mesh, axis)
    if size == 1:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, group, size, dim)
    return _gather(x, group, size, dim)


def gather_over_model(x, mesh, dim: int = -1):
    """:func:`gather_over` the ``"model"`` axis."""
    return gather_over(x, mesh, "model", dim)
