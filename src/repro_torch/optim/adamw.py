"""AdamW with global-norm clipping and decoupled weight decay, a
configurable state dtype (bf16 m/v for the >=100B archs), and a cosine
schedule: the port of the JAX package's ``optim/adamw.py``.

``m`` and ``v`` are ``ParamTree``s of the parameters' structure, so a
checkpoint of ``{"params": p, "opt": state}`` has the JAX package's file
names.  Every scalar runs as a float32 tensor, as JAX's weak-typed float32
scalars do (``b1 ** step``, the bias corrections, the clip scale, the
learning rate), and each leaf's update keeps the reference's order of
operations.

:func:`adamw_update` writes each new leaf into the storage of the old one
(parameters, ``m`` and ``v``), as the JAX train step does with donated
buffers, and returns the same trees: a step keeps one copy of the state,
and one leaf's float32 temporaries at a time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.transformer import ParamTree, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32: updates taken
    m: ParamTree
    v: ParamTree


def adamw_init(params: ParamTree, state_dtype=torch.float32) -> AdamWState:
    """Zero moments in ``state_dtype`` beside each parameter, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf, leaf sums added in the JAX
    package's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params: ParamTree, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                 grad_norm=None):
    """Returns (new_params, new_state, metrics): ``params`` and the state's
    ``m`` and ``v`` updated in place, ``metrics = {"grad_norm"}``.
    ``grads`` is a tree of the parameters' structure, or their list in
    leaf order (:func:`tree_leaves`); ``lr`` a float32 scalar tensor.
    ``grad_norm``, when given, is the norm to clip by in place of
    ``grads``' own: the sharded step updates a rank's shards of every leaf
    and passes the whole gradient's norm."""
    with torch.profiler.record_function("adamw_update"):
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        flat_m = tree_leaves(state.m)
        flat_v = tree_leaves(state.v)
        if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
            raise ValueError(f"{len(flat_g)} gradients, {len(flat_m)} / "
                             f"{len(flat_v)} moments for {len(flat_p)} "
                             "parameters")
        gnorm = global_norm(flat_g) if grad_norm is None else grad_norm
        f32 = dict(dtype=torch.float32, device=gnorm.device)
        scale = torch.minimum(
            torch.ones((), **f32),
            torch.full((), clip_norm, **f32) / torch.clamp_min(gnorm, 1e-9))
        step = state.step + 1
        stepf = step.float()
        bc1 = 1.0 - torch.full((), b1, **f32) ** stepf
        bc2 = 1.0 - torch.full((), b2, **f32) ** stepf
        lr = torch.as_tensor(lr, **f32)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            # gf, mf, vf, mhat, vhat and pf as the reference names them;
            # the in-place steps keep its operations and their order
            gf = g.float() * scale
            mf = torch.mul(m.float(), b1)
            mf += (1 - b1) * gf
            vf = torch.mul(v.float(), b2)
            t = (1 - b2) * gf
            t *= gf
            vf += t
            del gf, t
            mhat = mf / bc1
            vhat = vf / bc2
            mhat /= vhat.sqrt_().add_(eps)
            del vhat
            pf = p.float()
            mhat += weight_decay * pf
            mhat *= lr
            p.copy_(pf - mhat)
            m.copy_(mf)
            v.copy_(vf)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm}


def cosine_schedule(step, *, peak_lr=3e-4, warmup=2000, total=100_000,
                    min_frac=0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * peak_lr`` at ``total``; a float32 scalar
    tensor on the step's device (the CPU for an int)."""
    stepf = torch.as_tensor(step).to(torch.float32)
    warm = stepf / max(warmup, 1)
    prog = torch.clamp((stepf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(stepf < warmup, warm, cos)
