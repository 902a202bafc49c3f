"""MoE expert-dispatch task graphs, extracted from the model stack.

``models/moe.py`` routes ``T`` tokens to ``E`` experts (top-k, capacity
constrained); ``kernels/moe_dispatch.py`` then services each expert's
dispatch buffer as an independent unit of work.  That is exactly the
paper's fine-grained-imbalance problem — skewed per-expert token loads are
skewed task durations — so this module replays the routing *statistics* as
a deterministic :class:`~repro_torch.core.taskgraph.TaskGraph`:

* a single router task (the OpenMP ``single`` construct, like ``align``)
  spawns one *dispatch head* per non-empty expert — the dispatch kernel's
  per-expert launch, costed by that expert's scatter volume;
* each head spawns its expert's *token bundles* — Maroñas-style
  worksharing bundles of ``bundle`` tokens off the expert's dispatch
  buffer — **where the head runs**, so a popular expert floods one
  worker with work created at runtime: routing skew becomes the exact
  creation-time imbalance the paper's stealing policies attack
  (``bundle=None`` collapses each expert to a single task — maximal
  duration skew, critical-path-bound at high alpha);
* every bundle notifies one combine join (the all-to-all return +
  weighted sum in ``moe_apply``);
* durations run through the existing cycle cost model (``CYCLE_NS``),
  with the same ±5% jitter idiom as ``posp``.

The router statistics are a numpy mirror of ``core/balance.py``'s primary
top-k assignment: per-token expert scores are Zipf-skewed Gumbel draws
(sampling expert choices with probability ∝ rank^-alpha — ``alpha`` is the
load-skew knob; 0 = uniform), each expert keeps its ``capacity`` highest-
gate tokens (the same rank-by-priority rule ``balance.route`` applies) and
overflow tokens drop.  ``capacity`` follows ``models.moe.capacity_for``
exactly: ``max(8, ceil8(capacity_factor * T * k / E))`` —
``test_apps.py`` pins the two formulas against each other.

Everything is host-side numpy off one ``default_rng(seed)`` stream, so
graphs are bit-identical across hosts (golden digests pin this).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.taskgraph import CYCLE_NS, TaskGraph, _linearize, _Node

#: per-token expert-FFN service cost in cycles (three GEMV-shaped passes
#: over d_expert_ff; scaled for simulator range, not absolute realism)
TOKEN_CYC = 600.0

#: router + dispatch cost per token in cycles (logits einsum + scatter)
ROUTE_CYC = 15.0

#: combine cost per routed slot in cycles (weighted gather-sum)
COMBINE_CYC = 4.0

#: dispatch-head cost per kept token in cycles (per-expert gather/scatter
#: of its buffer before the FFN bundles run)
DISPATCH_CYC = 2.0


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25) -> int:
    """Expert capacity — must match ``models.moe.capacity_for`` exactly."""
    cap = int(capacity_factor * n_tokens * top_k / n_experts)
    return max(8, (cap + 7) // 8 * 8)


def router_loads(n_experts: int = 64, n_tokens: int = 4096, top_k: int = 2,
                 capacity_factor: float = 1.25, alpha: float = 1.0,
                 seed: int = 0) -> dict:
    """Numpy mirror of the router: per-expert kept/dropped token counts.

    Token ``t``'s score for expert ``e`` is ``-alpha*log(e+1) + Gumbel`` —
    top-k of those samples k distinct experts with probability ∝
    ``rank^-alpha`` (the Gumbel-max trick), reproducing the skewed expert
    popularity the dispatch kernel sees in serving traces.  Each expert
    ranks its assigned tokens by gate score and keeps the top
    ``capacity`` (the same keep-highest-priority rule as
    ``balance.route``); the rest drop.
    """
    assert 1 <= top_k <= n_experts
    rng = np.random.default_rng(seed)
    base = -alpha * np.log(np.arange(1, n_experts + 1, dtype=np.float64))
    scores = base + rng.gumbel(size=(n_tokens, n_experts))
    # top-k experts per token, then per-expert keep-by-score up to capacity
    picks = np.argsort(-scores, axis=1)[:, :top_k]
    cap = capacity(n_tokens, top_k, n_experts, capacity_factor)
    kept = np.zeros(n_experts, np.int64)
    dropped = 0
    for e in range(n_experts):
        routed = int((picks == e).sum())
        kept[e] = min(routed, cap)
        dropped += routed - kept[e]
    total = int(kept.sum()) + dropped
    mean = total / n_experts
    return dict(kept=kept, dropped=int(dropped), capacity=cap,
                routed_total=total,
                max_load=int(kept.max()),
                imbalance=float(kept.max() / mean) if mean else 0.0)


def moe(n_experts: int = 64, n_tokens: int = 4096, top_k: int = 2,
        capacity_factor: float = 1.25, alpha: float = 1.0,
        bundle: int | None = 16, seed: int = 0) -> TaskGraph:
    """Expert-dispatch graph: router root → per-expert dispatch heads →
    worksharing token bundles → combine join.  ``alpha`` is the Zipf
    load-skew knob (0 = uniform); ``bundle`` the worksharing granularity
    (``None`` = one task per expert)."""
    loads = router_loads(n_experts, n_tokens, top_k, capacity_factor,
                         alpha, seed)
    rng = np.random.default_rng(seed + 1)   # jitter stream ≠ routing stream
    root = _Node(n_tokens * ROUTE_CYC * CYCLE_NS)
    step = loads["capacity"] if bundle is None else int(bundle)
    assert step >= 1
    join = _Node(loads["routed_total"] * COMBINE_CYC * CYCLE_NS, dep=0)
    n_bundles = 0
    for k in loads["kept"]:
        k = int(k)
        if not k:
            continue
        head = _Node(max(1, k * DISPATCH_CYC * CYCLE_NS))
        root.children.append(head)
        while k > 0:
            m = min(step, k)
            k -= m
            t = _Node(m * TOKEN_CYC * CYCLE_NS
                      * float(rng.uniform(0.95, 1.05)))
            t.notify = join
            head.children.append(t)
            n_bundles += 1
    assert n_bundles > 0, "router kept no tokens"
    join.dep = n_bundles
    # alpha formatted %g so default knobs keep dot-free names (gate keys)
    return _linearize(
        f"moe(E{n_experts},T{n_tokens},k{top_k},a{alpha:g})", root)
