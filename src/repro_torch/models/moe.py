"""BalancedMoE: the mixture-of-experts layer whose overflow handling is the
paper's dynamic load balancing (:mod:`repro_torch.core.balance`).  The
port of the JAX package's ``models/moe.py`` on one device: experts are the
workers, tokens the tasks, expert capacity the XQueue size, expert groups
the NUMA zones, and the layer returns the paper's counters as metrics.

A layer routes its tokens, dispatches them into ``(G * E, C, D)`` capacity
buffers (:func:`repro_torch.kernels.ops.moe_dispatch`: the hand-written
kernel on the card), runs the experts' SwiGLU as batched products over the
experts, combines the outputs back to tokens with the gate weights
(:func:`~repro_torch.kernels.ops.moe_combine`) and adds the shared
experts' MLP when the config has them.

Not ported here: the ``shard_map`` routing and combine of a mesh (the
sharded step, ROADMAP §1 item 11d); on one device the JAX package takes
the path ported here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import balance
from repro_torch.kernels import ops
from repro_torch.models import layers


def _experts(shape, fan_in: int, dtype, generator, device, lead=()):
    """Stacked expert weights N(0, 1/fan_in) drawn one layer (one index of
    ``lead``) at a time in float32 and cast into a preallocated tensor of
    ``dtype``, so that the float32 copy never exceeds one layer's leaf (a
    whole moonshot ``wg`` in float32 would be 35 GB)."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    for w in out.view((-1,) + tuple(shape)):
        w.copy_(torch.randn(tuple(shape), generator=generator, device=device,
                            dtype=torch.float32) * fan_in ** -0.5)
    return out


def moe_init(cfg: ModelConfig, generator, device, lead=()):
    """The JAX package's leaves: ``router`` ``(D, E)`` float32 whatever
    ``param_dtype`` is; ``wg``, ``wu`` ``(E, D, F)`` and ``wd`` ``(E, F, D)``
    in ``param_dtype``; ``shared`` an MLP of width ``F * n_shared`` when
    the config has shared experts.  ``lead`` prepends stacked-layer dims."""
    m = cfg.moe
    D, F_, E = cfg.d_model, m.d_expert_ff, m.n_experts
    p = {"router": layers._dense_init((D, E), torch.float32, generator,
                                      device, lead=lead),
         "wg": _experts((E, D, F_), D, cfg.pdtype, generator, device, lead),
         "wu": _experts((E, D, F_), D, cfg.pdtype, generator, device, lead),
         "wd": _experts((E, F_, D), F_, cfg.pdtype, generator, device, lead)}
    if m.n_shared:
        p["shared"] = layers.mlp_init(cfg, F_ * m.n_shared, generator,
                                      device, lead=lead)
    return p


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per (token group, expert): ``capacity_factor * n_tokens *
    top_k / n_experts``, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, (cap + 7) // 8 * 8)


def moe_apply(p, x, cfg: ModelConfig, *, ep_groups: int, rng,
              dp_groups: int = 1):
    """x: (B, S, D).  Returns (out, aux): aux holds the router's
    load-balance loss and the paper-style counters (float32 scalars).

    ``rng`` is the routing key (a pair of uint32 words, see
    :mod:`repro_torch.core.prng`); ``ep_groups`` the expert groups (their
    gcd with the expert count); ``dp_groups`` the token groups (their gcd
    with B): capacity and buffers are per (token group, expert), and a
    token is never routed out of its group."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E = m.n_experts
    G = math.gcd(dp_groups, B)     # token groups follow the batch split
    xt = x.reshape(T, D)
    cap = capacity_for(cfg, T // G)
    logits = xt.float() @ p["router"]
    groups = balance.default_expert_groups(E, math.gcd(ep_groups, E),
                                           device=x.device)
    token_group = torch.arange(T, dtype=torch.int32,
                               device=x.device) // (T // G)
    r = balance.route(logits, m.top_k, cap, groups, strategy=m.strategy,
                      p_local=m.p_local, key=rng, token_group=token_group,
                      n_token_groups=G)
    # dispatch into flat (G * E, C, D) virtual-expert buffers
    ve = torch.where(r.expert >= 0, token_group[:, None] * E + r.expert, -1)
    buf = ops.moe_dispatch(xt, ve, r.pos, n_experts=G * E, capacity=cap)
    buf = buf.reshape(G, E, cap, D)
    act = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    h = act * torch.einsum("gecd,edf->gecf", buf, p["wu"])
    y = torch.einsum("gecf,efd->gecd", h, p["wd"])
    out = ops.moe_combine(y.reshape(G * E, cap, D), ve, r.pos, r.weight,
                          n_tokens=T).reshape(B, S, D)
    if m.n_shared:
        out = out + layers.mlp_apply(p["shared"], x, cfg)
    aux = {"lb_loss": balance.load_balance_loss(r.probs, r.expert,
                                                m.top_k)}
    aux.update({k: v.float() for k, v in r.stats.items()})
    return out, aux
