"""The train step on one device: the port of the JAX package's
``launch/steps.py`` (``init_shapes`` and ``make_train_step``).

``make_train_step`` builds the canonical step: the loss's value and
gradient (summed in float32 over microbatches and divided, when there are
several), the cosine schedule and AdamW.  There is no mesh: the JAX
package's sharding constraints, ZeRO layout and donation are the identity
on one device (AdamW updates in place, as donated buffers would), and
``make_prefill_step`` and ``make_serve_step`` are mesh-bound (ROADMAP item
11d; serving runs :mod:`repro_torch.launch.serve`).  What the sharded step
builds on is ported: the rules (:mod:`repro_torch.launch.sharding`), the
meshes (:mod:`repro_torch.launch.mesh`), the tree all-reduce
(:mod:`repro_torch.runtime.collectives`) and the int8 compression
(:mod:`repro_torch.optim.grad_compress`).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule


def init_shapes(cfg: ModelConfig):
    """Parameters and optimizer state as meta tensors: shapes and types,
    no allocation."""
    p_shape = tfm.init_params(cfg, None, "meta")
    return p_shape, adamw_init(p_shape, getattr(torch, cfg.opt_state_dtype))


def make_train_step(cfg: ModelConfig, device, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, total_steps: int = 100_000):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``batch`` holds numpy arrays or tensors of the global
    batch; ``params`` (made trainable) and ``opt_state`` are updated in
    place and returned.  MoE layers route with ``fold_in(PRNGKey(17),
    step)`` over one expert group, as on the JAX package's one-device
    mesh.  Metrics: ``loss`` (the mean over microbatches), ``lr``,
    ``grad_norm`` and, from the last microbatch, ``ce`` and the aux
    sums."""
    device = torch.device(device)
    warmup = max(1, min(2000, total_steps // 10))

    def value_and_grad(params, leaves, batch, rng):
        # MoE routing's expert groups: the tensor-parallel size of the JAX
        # package's one-device mesh
        loss, metrics = tfm.loss_fn(params, cfg, batch, rng, ep_groups=1)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not read (hubert's token embedding) has a
        # zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch, step):
        params.requires_grad_(True)
        leaves = tfm.tree_leaves(params)
        rng = prng.fold_in(prng.PRNGKey(17), int(step))
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if microbatches > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for p in leaves]
            lsum = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss, metrics, grads = value_and_grad(params, leaves, mb,
                                                      rng)
                for acc, g in zip(gsum, grads):
                    acc += g
                del grads
                lsum = lsum + loss
            grads = [g / microbatches for g in gsum]
            del gsum
            loss = lsum / microbatches
        else:
            loss, metrics, grads = value_and_grad(params, leaves, batch, rng)
        lr = cosine_schedule(step, peak_lr=peak_lr, total=total_steps,
                             warmup=warmup).to(device)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        return params, opt_state, metrics

    return train_step
