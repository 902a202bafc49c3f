"""Continuous-batching decode-step task graphs, from ``launch/serve.py``.

The serving loop decodes a batch of sequences one token per step: every
active sequence attends over its KV cache (cost grows with KV length),
then a batch-wide sample/scheduler tick runs — finished sequences evict,
waiting ones admit (prefill), and the next step begins.  As a task graph:

* step ``s`` is one *lane task per active sequence* (duration =
  ``STEP_CYC + KV_CYC * kv_len`` cycles — the KV-length-dependent decode
  ragged-batch cost), all notifying the step's *batch join*;
* the join is the sample + scheduler tick (its duration includes the
  prefill of sequences admitted for the next step — the admission stall
  naive continuous batching pays), and it *spawns the next step's lane
  tasks* when it executes;
* the chain ends when every sequence has generated its length.

``_linearize`` only walks spawn trees, so the arrays are built directly,
level by level: ``[root][step-0 lanes][join 0][step-1 lanes][join 1]...``
— the scheduler executes this because a join whose dependency count
reaches zero is claimed and stack-pushed like any task, and pushing it
releases its spawn range (see ``phases._finish``).  ``validate()`` holds
on the result, and the shape exercises the engine's join-with-children
path, which no BOTS generator does.

Open-system serving: compose with the ``arrivals=`` grid axis
(``run_grid(..., arrivals=("poisson:4",))``) — task ids are in step order,
so release stamps model request arrival pressure on the decode service and
the SLO reductions report p50/p90/p99 per-task latency under load.

Host-side numpy off one ``default_rng(seed)``; bit-stable across hosts.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.taskgraph import CYCLE_NS, MEM_BOUND, TaskGraph

#: fixed per-step decode cost in cycles (QKV projections, MLP, sampling
#: prep for one token)
STEP_CYC = 400.0

#: incremental attention cost per KV-cache token, in cycles
KV_CYC = 2.0

#: scheduler-tick cost: fixed + per-active-lane sampling in cycles
TICK_CYC = 50.0
SAMPLE_CYC = 20.0

#: prefill cost per prompt token for a newly admitted sequence, in cycles
PREFILL_CYC = 3.0


def decode(n_lanes: int = 8, n_seqs: int = 24, prompt_mean: int = 128,
           gen_mean: int = 32, seed: int = 0) -> TaskGraph:
    """Decode-service graph: ``n_seqs`` sequences through ``n_lanes``
    continuous-batching lanes, one lane task per (sequence, step)."""
    assert n_lanes >= 1 and n_seqs >= 1
    rng = np.random.default_rng(seed)
    prompt = np.maximum(
        1, rng.lognormal(np.log(prompt_mean), 0.4, n_seqs)).astype(np.int64)
    gen = np.maximum(1, rng.geometric(1.0 / gen_mean, n_seqs))

    dur, first_child, n_children, notify, join_dep = \
        [0], [0], [0], [-1], [0]

    def push(d, dep=0):
        dur.append(max(1, int(d)))
        first_child.append(0)
        n_children.append(0)
        notify.append(-1)
        join_dep.append(dep)
        return len(dur) - 1

    def jitter():
        return float(rng.uniform(0.95, 1.05))

    # admission in arrival order; kv[s] = prompt + tokens generated so far
    pending = list(range(n_seqs))
    active = pending[:n_lanes]
    del pending[:n_lanes]
    done_tok = np.zeros(n_seqs, np.int64)
    # root = the serve loop's setup + initial batch prefill
    dur[0] = max(1, int((TICK_CYC + PREFILL_CYC
                         * float(prompt[active].sum())) * CYCLE_NS))
    spawner = 0
    while active:
        first = len(dur)
        for s in active:
            kv = int(prompt[s] + done_tok[s])
            push((STEP_CYC + KV_CYC * kv) * CYCLE_NS * jitter())
        join = push(0, dep=len(active))
        first_child[spawner] = first
        n_children[spawner] = len(active)
        for t in range(first, join):
            notify[t] = join
        # advance: one token per active sequence, evict finished, admit
        done_tok[active] += 1
        survivors = [s for s in active if done_tok[s] < gen[s]]
        admitted = pending[:n_lanes - len(survivors)]
        del pending[:len(admitted)]
        tick = TICK_CYC + SAMPLE_CYC * len(active) \
            + PREFILL_CYC * float(prompt[admitted].sum())
        dur[join] = max(1, int(tick * CYCLE_NS * jitter()))
        active = survivors + admitted
        spawner = join

    arr = [np.asarray(a, np.int32)
           for a in (dur, first_child, n_children, notify, join_dep)]
    g = TaskGraph(f"decode(L{n_lanes},S{n_seqs},g{gen_mean})", *arr,
                  mem_bound=MEM_BOUND["decode"])
    g.validate()
    return g
