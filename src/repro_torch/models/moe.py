"""BalancedMoE: the mixture-of-experts layer whose overflow handling is the
paper's dynamic load balancing (:mod:`repro_torch.core.balance`).  The
port of the JAX package's ``models/moe.py``: experts are the workers,
tokens the tasks, expert capacity the XQueue size, expert groups the NUMA
zones, and the layer returns the paper's counters as metrics.

A layer routes its tokens, dispatches them into ``(G * E, C, D)`` capacity
buffers (:func:`repro_torch.kernels.ops.moe_dispatch`: the hand-written
kernel on the card), runs the experts' SwiGLU as batched products over the
experts, combines the outputs back to tokens with the gate weights
(:func:`~repro_torch.kernels.ops.moe_combine`) and adds the shared
experts' MLP when the config has them.

Shard-local routing (the JAX package's ``shard_map`` path, taken when the
config sets ``shard_routing``, the axis hints are on with a mesh and there
are G > 1 token groups): each data shard routes only its own T / G tokens
with the key ``fold_in(rng, shard)`` (``shard`` the row-major index over
the data axes) and dispatches them into its own ``(E, C, D)`` buffer;
the routing counters are summed over the shards, ``max_load`` too, and
the combine works per shard on local expert ids.
:func:`route_dispatch_shard` is one shard's work.  Two callers use it:
:func:`route_dispatch_shards`, the global view of one process holding
every shard's tokens, and :func:`moe_apply` on a rank of a multi-rank
step, where the rank is one shard, the counters are all-reduced over the
data axes, and the load-balance loss is the rank's share of the global
one (:func:`load_balance_share`).

Expert parallelism: in a tensor-parallel region
(:func:`repro_torch.models.layers.tp_region`) whose rules split the
expert dim over ``"model"``, a rank holds experts ``[r E / tp, (r + 1) E
/ tp)`` of ``wg``, ``wu`` and ``wd``.  The model ranks of one data shard
hold the same tokens and route with the same key, so the routing is every
rank's (its counters and load-balance loss too, never summed over
``"model"``) and no token moves between ranks: the dispatch fills only the
rank's ``(E / tp, C, D)`` buffers, from its slots on local expert ids
(every other slot -1), the expert products run on them, and the rank's
part of the combine (float32) is summed over ``"model"``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import balance, prng
from repro_torch.kernels import ops
from repro_torch.launch.mesh import dp_index
from repro_torch.models import layers
from repro_torch.models import tensor_parallel as tpo
from repro_torch.runtime import collectives


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


def local_experts(expert, experts):
    """``expert`` ids (-1 dropped) on the rank's experts ``experts = (lo,
    n)``: ``expert - lo`` for the rank's, -1 for every other; ``expert``
    itself when ``experts`` is None (every expert here)."""
    if experts is None:
        return expert
    lo, n = experts
    return torch.where((expert >= lo) & (expert < lo + n), expert - lo, -1)


def route_dispatch_shard(xt, logits, cfg: ModelConfig, cap: int, groups,
                         rng, shard: int, *, experts=None):
    """One data shard's routing and dispatch: its tokens ``xt`` (t, D) and
    router ``logits`` (t, E) routed with ``fold_in(rng, shard)`` over one
    token group, dispatched into an ``(E, cap, D)`` buffer (with
    ``experts = (lo, n)``, the ``(n, cap, D)`` buffer of experts ``[lo, lo
    + n)`` only).  Returns ``(buf, ve, pos, weight, probs, stats)``:
    ``ve`` the virtual expert ``shard * E + expert`` (-1 where dropped),
    the rest as :func:`repro_torch.core.balance.route` gives them."""
    m = cfg.moe
    E = m.n_experts
    r = balance.route(logits, m.top_k, cap, groups, strategy=m.strategy,
                      p_local=m.p_local, key=prng.fold_in(rng, shard))
    n = E if experts is None else experts[1]
    buf = ops.moe_dispatch(xt, local_experts(r.expert, experts), r.pos,
                           n_experts=n, capacity=cap)
    ve = torch.where(r.expert >= 0, shard * E + r.expert, -1)
    return buf, ve, r.pos, r.weight, r.probs, r.stats


def route_dispatch_shards(xt, logits, cfg: ModelConfig, cap: int, groups,
                          rng, G: int, *, experts=None):
    """The global view: :func:`route_dispatch_shard` of each of ``G``
    contiguous token shards of ``xt`` (T, D).  Returns the ``(G, E, cap,
    D)`` buffers (``E`` the ``experts``' count when given), the ``(T, k)``
    routing tables and ``(T, E)`` probs in token order, and each counter
    summed over the shards."""
    t = xt.shape[0] // G
    parts = [route_dispatch_shard(xt[s * t:(s + 1) * t],
                                  logits[s * t:(s + 1) * t], cfg, cap,
                                  groups, rng, s, experts=experts)
             for s in range(G)]
    buf = torch.stack([part[0] for part in parts])
    ve, pos, weight, probs = (torch.cat([part[i] for part in parts])
                              for i in range(1, 5))
    stats = {k: sum(part[5][k] for part in parts) for k in parts[0][5]}
    return buf, ve, pos, weight, probs, stats


def combine_shards(y, ve, pos, weight, cfg: ModelConfig, *, experts=None,
                   dtype=None):
    """Each shard's expert outputs ``y[g]`` (E, C, D) back to its own
    tokens, on local expert ids (tokens never left their shard); the
    ``(T, k)`` tables are in token order, shard after shard.  With
    ``experts = (lo, n)``, ``y[g]`` holds experts ``[lo, lo + n)`` only
    and the result is their part; ``dtype`` the result's (``y``'s by
    default; the products are summed in float32 either way)."""
    E, G = cfg.moe.n_experts, y.shape[0]
    t = ve.shape[0] // G
    outs = []
    for g in range(G):
        ve_g = ve[g * t:(g + 1) * t]
        outs.append(ops.moe_combine(
            y[g], local_experts(torch.where(ve_g >= 0, ve_g % E, -1),
                                experts),
            pos[g * t:(g + 1) * t], weight[g * t:(g + 1) * t], n_tokens=t,
            dtype=dtype))
    return torch.cat(outs)


def load_balance_share(probs, expert, k: int, counts, n_tokens: int):
    """A rank's share of the Switch-Transformer loss over the global
    tokens: ``E * sum_e f_e * sum_local p_e / n_tokens``, with ``f_e =
    counts_e / (n_tokens * k)`` from the global assignment ``counts``
    (no gradient), so the shares of all ranks sum to the global loss and
    so do their gradients."""
    E = probs.shape[1]
    frac_tokens = counts / n_tokens / k
    return E * torch.sum(frac_tokens * (probs.sum(dim=0) / n_tokens))


def _expert_counts(expert, E: int, dtype):
    """Tokens assigned to each expert (a dropped slot, -1, to none)."""
    onehot = expert.long()[..., None] == torch.arange(E,
                                                      device=expert.device)
    return onehot.to(dtype).sum(dim=(0, 1))


def _sum_over_data(x, mesh, dp_axes):
    """``x`` all-reduced (summed) over the data axes of ``mesh``."""
    return collectives.flat_psum_grads([x], mesh, dp_axes)[0]


def moe_apply(p, x, cfg: ModelConfig, *, ep_groups: int, rng,
              dp_groups: int = 1):
    """x: (B, S, D).  Returns (out, aux): aux holds the router's
    load-balance loss and the paper-style counters (float32 scalars).

    ``rng`` is the routing key (a pair of uint32 words, see
    :mod:`repro_torch.core.prng`); ``ep_groups`` the expert groups (their
    gcd with the expert count); ``dp_groups`` the token groups (their gcd
    with B): capacity and buffers are per (token group, expert), and a
    token is never routed out of its group.  Under the axis hints of a
    mesh, with ``shard_routing`` and G > 1, the groups route shard-locally
    (see the module's docstring); on a rank of a multi-rank step ``x`` is
    the rank's rows and ``aux["lb_loss"]`` its share of the global
    loss."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E = m.n_experts
    hints = layers._AXIS_HINTS
    local = layers.rank_local()
    # the ranks whose rows make the global batch (each holds B of them)
    n_ranks = hints["dp_size"] if local else 1
    G = math.gcd(dp_groups, B * n_ranks)   # groups follow the batch split
    use_sm = (m.shard_routing and hints["on"] and hints["mesh"] is not None
              and G > 1)
    if local and n_ranks > 1 and not (use_sm and G == n_ranks):
        raise ValueError(
            f"{cfg.name}: a rank of a {n_ranks}-way data-parallel step "
            f"routes its own tokens only, which needs shard_routing and "
            f"dp_groups {n_ranks} (shard_routing={m.shard_routing}, "
            f"dp_groups={dp_groups})")
    xt = x.reshape(T, D)
    cap = capacity_for(cfg, T if local else T // G)
    logits = xt.float() @ p["router"]
    groups = balance.default_expert_groups(E, math.gcd(ep_groups, E),
                                           device=x.device)
    # expert parallelism: the rank's experts, its tokens entering the
    # region (their gradient, and the gate weights', summed over "model")
    t = layers.tp_region()
    experts, xd = None, xt
    if layers._split(t, p["wg"], 0, E):
        n_loc = E // t.size
        experts = (t.rank * n_loc, n_loc)
        xd = tpo.into_tp(xt, t.mesh)
    n_e = E if experts is None else experts[1]
    if use_sm and local:
        dp = hints["dp"]
        buf, ve, pos, weight, probs, stats = route_dispatch_shard(
            xd, logits, cfg, cap, groups, rng, dp_index(hints["mesh"]),
            experts=experts)
        buf = buf[None]
        expert = torch.where(ve >= 0, ve % E, -1)
        # the global assignment counts and counters, in one all-reduce
        # (float32 counts are exact below 2^24)
        total = _sum_over_data(torch.cat([
            _expert_counts(expert, E, probs.dtype),
            torch.stack([v.to(probs.dtype) for v in stats.values()])]),
            hints["mesh"], dp)
        lb = load_balance_share(probs, expert, m.top_k, total[:E],
                                T * n_ranks)
        stats = dict(zip(stats, total[E:]))
    elif use_sm:
        # the JAX package's shard_map splits the tokens over every data
        # shard, whatever G is (a microbatch of fewer rows than shards:
        # fault F6), each with the capacity of T / G tokens
        dpn = hints["dp_size"]
        buf, ve, pos, weight, probs, stats = route_dispatch_shards(
            xd, logits, cfg, cap, groups, rng, dpn if T % dpn == 0 else G,
            experts=experts)
        lb = balance.load_balance_loss(
            probs, torch.where(ve >= 0, ve % E, -1), m.top_k)
    else:
        token_group = torch.arange(T, dtype=torch.int32,
                                   device=x.device) // (T // G)
        r = balance.route(logits, m.top_k, cap, groups, strategy=m.strategy,
                          p_local=m.p_local, key=rng,
                          token_group=token_group, n_token_groups=G)
        # dispatch into flat (G * E, C, D) virtual-expert buffers (the
        # rank's (G * E / tp, C, D) under expert parallelism)
        ve = torch.where(r.expert >= 0, token_group[:, None] * E + r.expert,
                         -1)
        ve_d = ve
        if experts is not None:
            e_loc = local_experts(r.expert, experts)
            ve_d = torch.where(e_loc >= 0,
                               token_group[:, None] * n_e + e_loc, -1)
        buf = ops.moe_dispatch(xd, ve_d, r.pos, n_experts=G * n_e,
                               capacity=cap)
        buf = buf.reshape(G, n_e, cap, D)
        pos, weight, stats = r.pos, r.weight, r.stats
        lb = balance.load_balance_loss(r.probs, r.expert, m.top_k)
    act = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    h = act * torch.einsum("gecd,edf->gecf", buf, p["wu"])
    y = torch.einsum("gecf,efd->gecd", h, p["wd"])
    part = None              # the combine's dtype: float32 parts under EP
    if experts is not None:
        weight, part = tpo.into_tp(weight, t.mesh), torch.float32
    if use_sm:
        out = combine_shards(y, ve, pos, weight, cfg, experts=experts,
                             dtype=part)
    else:
        out = ops.moe_combine(y.reshape(G * n_e, cap, D), ve_d, pos,
                              weight, n_tokens=T, dtype=part)
    if experts is not None:
        out = tpo.out_of_tp(out, t.mesh).to(y.dtype)
    out = out.reshape(B, S, D)
    if m.n_shared:
        out = out + layers.mlp_apply(p["shared"], x, cfg,
                                     d_ff=m.d_expert_ff * m.n_shared)
    aux = {"lb_loss": lb}
    aux.update({k: v.float() for k, v in stats.items()})
    return out, aux
