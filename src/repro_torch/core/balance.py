"""The paper's DLB policies applied to MoE token routing: the port of the
JAX package's ``core/balance.py``.

Mapping: tokens = tasks, experts = workers, expert capacity = XQueue size,
expert groups (devices / pods) = NUMA zones.  Top-k routing with capacity
is the *static* load balancer: tokens beyond an expert's capacity are
dropped.  The dynamic policies redirect the overflow:

  na_rp  redirect-push: an overflow token goes to a random expert with
         free slots, preferring the originating expert's own group
         (locality-weighted, like the paper's P_local victim choice);
  na_ws  work-stealing flavour: availability dominates the score,
         locality breaks ties;
  drop   no redirection (the static baseline).

Targets are drawn with Gumbel noise over ``log(free slots) +
locality bonus``, in ``REDIRECT_ROUNDS`` vectorised rounds.  The noise is
``jax.random``'s, bit for bit, through :mod:`repro_torch.core.prng`.

Parity with the reference: ``lax.top_k`` breaks ties toward the lower
index and ``jnp.argsort`` is stable, so every sort here is
``torch.argsort(..., stable=True)`` (``torch.topk`` promises no tie order);
``argmax`` takes the first maximum in both; ``searchsorted`` is
``side="left"``; ``bincount`` counts the inactive entries in a sink bucket
``VE`` and counts in int32, as the reference casts its counts.  Nothing here
reads a value back to the host, so routing on the card never waits for
it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import prng

REDIRECT_ROUNDS = 2
I32 = torch.int32
STAT_KEYS = ("ntasks_static", "ntasks_stolen_local", "ntasks_stolen_remote",
             "ntasks_dropped", "max_load")


class RouteResult(NamedTuple):
    expert: torch.Tensor  # (T, k) int32 final expert id, -1 = dropped
    pos: torch.Tensor     # (T, k) int32 slot in its buffer, -1 = dropped
    weight: torch.Tensor  # (T, k) float32 combine weight (0 where dropped)
    probs: torch.Tensor   # (T, E) float32 router probabilities
    stats: dict           # the paper's counter analogues, int32 scalars


def _bincount(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Counts of ``0..n-1`` in ``idx``, whose entries ``n`` are the sink.
    A scatter-add of ones: ``torch.bincount`` on the card reads the largest
    entry back to the host, a sync in every routing round."""
    ones = torch.ones_like(idx, dtype=I32)
    return torch.zeros(n + 1, dtype=I32, device=idx.device).scatter_add_(
        0, idx.long(), ones)[:n]


def _rank_in_expert(flat_e: torch.Tensor, prio: torch.Tensor, n_experts: int,
                    active: torch.Tensor) -> torch.Tensor:
    """Rank of each entry among same-expert entries, ordered by descending
    priority (ties by position).  Inactive entries rank in a shadow bucket
    ``n_experts``."""
    N = flat_e.shape[0]
    e = torch.where(active, flat_e, n_experts)
    p1 = torch.argsort(-prio, stable=True)              # priority order
    p2 = torch.argsort(e[p1], stable=True)              # stable by expert
    perm = p1[p2]                                       # (expert, -prio)
    sorted_e = e[perm].contiguous()
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = (torch.arange(N, device=flat_e.device) - seg_start).to(I32)
    rank = torch.zeros(N, dtype=I32, device=flat_e.device)
    rank[perm] = pos_sorted
    return rank


def route(router_logits: torch.Tensor, k: int, capacity: int,
          expert_group: torch.Tensor, *, strategy: str = "na_rp",
          p_local: float = 0.9, key=None,
          token_group: torch.Tensor | None = None,
          n_token_groups: int = 1) -> RouteResult:
    """Capacity-constrained top-k routing with redirection.

    Args:
      router_logits: (T, E) router scores.
      k: experts per token.
      capacity: the most tokens per (token group, expert) pair.
      expert_group: (E,) int32 locality group per expert.
      strategy: "drop" | "na_rp" | "na_ws".
      p_local: probability mass on same-group redirects.
      key: the Gumbel key, a pair of uint32 words (``prng.PRNGKey``; a JAX
        key through ``numpy.asarray`` is taken too); ``PRNGKey(0)`` when
        None.
      token_group: (T,) int32 data-shard id per token (None: one group).
      n_token_groups: the count G of token groups.

    Capacity is per *virtual expert* (token group, expert), and redirection
    never leaves the token's own group.  Returns a :class:`RouteResult`
    whose ``pos`` is the slot within the (token group, expert) buffer;
    dispatch uses the flat row ``(tg * E + e) * capacity + pos``.
    """
    if strategy not in ("drop", "na_rp", "na_ws"):
        raise ValueError(f"unknown strategy {strategy!r}")
    T, E = router_logits.shape
    N = T * k
    VE = n_token_groups * E
    dev = router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    orig = torch.argsort(-probs, dim=-1, stable=True)[:, :k]   # lax.top_k
    gate_w = torch.gather(probs, 1, orig)
    flat_e = orig.reshape(N).to(I32)
    prio = gate_w.reshape(N)
    if token_group is None:
        tg = torch.zeros(N, dtype=I32, device=dev)
    else:
        tg = torch.repeat_interleave(token_group.to(I32), k)
    ve = tg * E + flat_e                           # virtual (group, expert)

    active = torch.ones(N, dtype=torch.bool, device=dev)
    rank0 = _rank_in_expert(ve, prio, VE, active)
    ok0 = rank0 < capacity
    count = _bincount(torch.where(ok0, ve, VE), VE)
    expert = torch.where(ok0, flat_e, -1)
    pos = torch.where(ok0, rank0, -1)
    ovf = ~ok0
    zero = torch.zeros((), dtype=I32, device=dev)
    n_primary = ok0.sum(dtype=I32)
    n_local, n_remote = zero, zero

    if strategy != "drop":
        key = prng.PRNGKey(0) if key is None else prng.as_key(key)
        loc_group = expert_group[flat_e.long()]                    # (N,)
        same = (loc_group[:, None] == expert_group[None, :]).float()
        # locality bonus: log-odds of the paper's P_local victim draw
        beta = math.log(max(p_local, 1e-4) / max(1.0 - p_local, 1e-4))
        if strategy == "na_ws":
            avail_w, loc_w = 4.0, 0.25 * beta   # availability-dominated
        else:
            avail_w, loc_w = 1.0, beta          # locality-dominated (NA-RP)
        cand_v = (tg[:, None] * E
                  + torch.arange(E, dtype=I32, device=dev)[None, :]).long()
        for r in range(REDIRECT_ROUNDS):
            free = (capacity - count).float()[cand_v]              # (N, E)
            score = avail_w * torch.log(torch.clamp(free, min=0.0) + 0.5)
            score = score + loc_w * same
            score = score - 1e9 * (free <= 0.0).float()
            g = prng.gumbel(prng.fold_in(key, r), (N, E), dev)
            tgt = torch.argmax(score + g, dim=-1).to(I32)
            tgt_v = tg * E + tgt
            rank = _rank_in_expert(tgt_v, prio, VE, ovf)
            slot = count[tgt_v.long()] + rank
            ok = ovf & (slot < capacity)
            expert = torch.where(ok, tgt, expert)
            pos = torch.where(ok, slot, pos)
            count = count + _bincount(torch.where(ok, tgt_v, VE), VE)
            local = expert_group[tgt.long()] == loc_group
            n_local = n_local + (ok & local).sum(dtype=I32)
            n_remote = n_remote + (ok & ~local).sum(dtype=I32)
            ovf = ovf & ~ok

    expert = expert.reshape(T, k)
    weight = torch.where(expert >= 0, gate_w, 0.0)
    stats = {
        "ntasks_static": n_primary,          # kept on the primary expert
        "ntasks_stolen_local": n_local,      # redirected, same group
        "ntasks_stolen_remote": n_remote,    # redirected, cross-group
        "ntasks_dropped": ovf.sum(dtype=I32),
        "max_load": count.max(),
    }
    return RouteResult(expert, pos.reshape(T, k), weight, probs, stats)


def load_balance_loss(probs: torch.Tensor, expert: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Switch-Transformer auxiliary loss over the final (post-redirect)
    assignment; a dropped slot (-1) counts for no expert."""
    T, E = probs.shape
    onehot = (expert.long()[..., None]
              == torch.arange(E, device=probs.device)).to(probs.dtype)
    frac_tokens = onehot.sum(dim=1).mean(dim=0) / k
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)


def default_expert_groups(n_experts: int, n_groups: int,
                          device="cpu") -> torch.Tensor:
    """Contiguous expert -> group map (expert parallelism places contiguous
    expert ranges on devices, so contiguity is physical locality)."""
    if n_experts % n_groups:
        raise ValueError(f"{n_groups} groups do not divide {n_experts} "
                         "experts")
    return torch.repeat_interleave(
        torch.arange(n_groups, dtype=I32, device=device),
        n_experts // n_groups)
