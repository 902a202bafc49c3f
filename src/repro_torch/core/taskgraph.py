"""BOTS-analogue task DAGs, built on the host with numpy.

The paper evaluates on the Barcelona OpenMP Task Suite.  We reproduce each
application's *task-graph shape and task-size distribution* (the properties
that drive scheduler behavior) rather than its numerics:

  fib       binary call tree + join continuations, 10-80 cycle tasks
  nqueens   prefix tree, small tasks, high fan-out near the root
  fft       recursive split with combine joins, 1e2-1e6 cycle tasks
  sort      merge-sort tree, most tasks ~1e5 cycles
  strassen  7-way recursion + quadratic combine, most tasks ~1e4 cycles
  uts       geometric random tree (unbalanced), small constant tasks
  health    irregular multi-level tree, lognormal sizes concentrated 1e3-1e4
  fp        pruned branch-and-bound tree, sizes 1e2-1e6 (floorplan)
  align     single-creator flat bag of ~1e6-cycle tasks (the OpenMP `single`
            construct: only worker 0 creates work)
  posp      proof-of-space hashing: single creator, 2^K puzzles in batches
            (batch size sweeps reproduce Fig. 8)

Graph encoding (all int32 numpy arrays, sized T = number of tasks):

  dur[t]          execution time of task t, in simulator ns
  first_child[t]  id of t's first *spawned* child; children of t occupy the
                  contiguous id range [first_child[t], first_child[t]+n_children[t])
  n_children[t]   number of spawned children
  notify[t]       join-task id whose dependency count t decrements on finish
                  (-1 if none)
  join_dep[t]     initial dependency count (0 for normal tasks; joins become
                  ready when their count reaches 0)

Task 0 is the root and is seeded into worker 0's spawn stack.  Contiguity of
spawn ranges lets the scheduler keep O(1) "range" entries on its spawn stacks
instead of materializing child lists (important for `align`, whose root spawns
thousands of tasks).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

CYCLE_NS = 0.5  # 2 GHz machine: 1 cycle = 0.5 ns. Paper sizes are rdtscp cycles.


class _Node:
    __slots__ = ("dur", "children", "notify", "dep", "tid")

    def __init__(self, dur: float, dep: int = 0):
        self.dur = max(1, int(dur))
        self.children: List["_Node"] = []  # spawned children (contiguous ids)
        self.notify: Optional["_Node"] = None
        self.dep = dep
        self.tid = -1


@dataclasses.dataclass
class TaskGraph:
    name: str
    dur: np.ndarray
    first_child: np.ndarray
    n_children: np.ndarray
    notify: np.ndarray
    join_dep: np.ndarray
    #: fraction of task runtime that is main-memory bound (drives the
    #: NUMA execution penalty; paper SVI-B: STRAS/Sort are memory-bound and
    #: gain ~4x from locality, align fits in cache and gains little)
    mem_bound: float = 0.0
    #: optional per-task payload in bytes (int32, shape (T,)): the data a
    #: task drags across a link when pushed/dequeued/stolen remotely.  Only
    #: cluster topologies price it (``L + payload/B``); ``None`` means
    #: zero payload everywhere and is bitwise-equivalent to the
    #: pre-cluster engine on every machine.
    payload: Optional[np.ndarray] = None

    @property
    def n_tasks(self) -> int:
        return int(self.dur.shape[0])

    @property
    def total_work_ns(self) -> int:
        return int(self.dur.sum())

    @property
    def mean_task_ns(self) -> float:
        return float(self.dur.mean())

    def with_payload(self, bytes_per_ns: float = 16.0) -> "TaskGraph":
        """This graph with per-task payloads derived from task sizes: a
        task's working set scales with its (mem_bound-weighted) runtime —
        long memory-bound tasks drag big buffers across links, short
        cache-resident tasks drag almost nothing.  Deterministic, so the
        payloaded graph keys the result cache stably."""
        scale = bytes_per_ns * max(float(self.mem_bound), 0.05)
        pay = np.minimum(self.dur.astype(np.int64) * scale,
                         np.int64(1) << 30).astype(np.int32)
        return dataclasses.replace(
            self, name=f"{self.name}+pl{bytes_per_ns:g}", payload=pay)

    def validate(self) -> None:
        T = self.n_tasks
        assert self.first_child.shape == (T,) and self.notify.shape == (T,)
        if self.payload is not None:
            assert self.payload.shape == (T,) and (self.payload >= 0).all()
        # spawn ranges in bounds and non-overlapping
        spawned = np.zeros(T, dtype=bool)
        for t in range(T):
            n = self.n_children[t]
            if n:
                lo, hi = self.first_child[t], self.first_child[t] + n
                assert 0 < lo and hi <= T
                assert not spawned[lo:hi].any(), "child spawned twice"
                spawned[lo:hi] = True
        # joins are exactly the tasks with join_dep > 0 and are never spawned
        joins = self.join_dep > 0
        assert not (spawned & joins).any()
        # every non-root task is either spawned or a join
        reachable = spawned | joins
        reachable[0] = True
        assert reachable.all(), "unreachable tasks"
        # notify targets are joins, and dep counts match notifier counts
        counts = np.zeros(T, dtype=np.int64)
        for t in range(T):
            j = self.notify[t]
            if j >= 0:
                assert self.join_dep[j] > 0
                counts[j] += 1
        assert (counts == self.join_dep).all(), "join dep mismatch"


MEM_BOUND = {
    "fib": 0.05, "nqueens": 0.1, "fft": 0.4, "sort": 0.7, "strassen": 0.7,
    "uts": 0.2, "health": 0.5, "fp": 0.3, "align": 0.1, "posp": 0.3,
    # workload apps (repro_torch.apps): expert FFNs stream dispatch buffers;
    # decode streams the KV cache
    "moe": 0.35, "decode": 0.5,
}


def _linearize(name: str, root: _Node) -> TaskGraph:
    """Assign contiguous-children ids (BFS over the spawn forest), joins last."""
    order: List[_Node] = [root]
    root.tid = 0
    next_id = 1
    qi = 0
    while qi < len(order):
        node = order[qi]
        qi += 1
        for ch in node.children:
            ch.tid = next_id
            next_id += 1
            order.append(ch)
    # joins (dep > 0) are reached only through notify pointers
    seen = {id(n) for n in order}
    joins: List[_Node] = []
    stack = list(order)
    while stack:
        n = stack.pop()
        j = n.notify
        if j is not None and id(j) not in seen:
            seen.add(id(j))
            j.tid = next_id
            next_id += 1
            joins.append(j)
            stack.append(j)
    allnodes = order + joins
    T = next_id
    dur = np.zeros(T, np.int32)
    first_child = np.zeros(T, np.int32)
    n_children = np.zeros(T, np.int32)
    notify = np.full(T, -1, np.int32)
    join_dep = np.zeros(T, np.int32)
    for n in allnodes:
        t = n.tid
        dur[t] = n.dur
        n_children[t] = len(n.children)
        first_child[t] = n.children[0].tid if n.children else 0
        notify[t] = n.notify.tid if n.notify is not None else -1
        join_dep[t] = n.dep
    mb = MEM_BOUND.get(name.split("(")[0], 0.0)
    return TaskGraph(name, dur, first_child, n_children, notify, join_dep,
                     mem_bound=mb)


def _cyc(rng: np.random.Generator, lo: float, hi: float) -> float:
    """Log-uniform draw in rdtscp cycles, returned in ns."""
    return float(np.exp(rng.uniform(np.log(lo), np.log(hi)))) * CYCLE_NS


# ---------------------------------------------------------------------------
# Generators. Each returns a TaskGraph; sizes follow §VI of the paper.
# ---------------------------------------------------------------------------

def fib(n: int = 18, seed: int = 0) -> TaskGraph:
    """Binary call tree; tasks are 10-80 cycles; long critical path of joins."""
    rng = np.random.default_rng(seed)

    def build(k: int):
        if k < 2:
            leaf = _Node(_cyc(rng, 10, 30))
            return leaf, leaf  # (entry, completion)
        call = _Node(_cyc(rng, 20, 80))
        join = _Node(_cyc(rng, 10, 40), dep=2)
        for kk in (k - 1, k - 2):
            entry, compl_ = build(kk)
            call.children.append(entry)
            compl_.notify = join
        return call, join

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        root, _ = build(n)
    finally:
        sys.setrecursionlimit(old)
    return _linearize(f"fib({n})", root)


def nqueens(n: int = 9, seed: int = 0) -> TaskGraph:
    """Prefix tree of valid partial placements; per-node work grows with depth."""
    rng = np.random.default_rng(seed)

    def ok(prefix, col):
        r = len(prefix)
        for rr, cc in enumerate(prefix):
            if cc == col or abs(cc - col) == r - rr:
                return False
        return True

    def build(prefix):
        depth = len(prefix)
        node = _Node((20 + 15 * depth + rng.integers(0, 20)) * CYCLE_NS)
        if depth == n:
            return node, node
        join = _Node(10 * CYCLE_NS, dep=0)
        kids = [c for c in range(n) if ok(prefix, c)]
        if not kids:
            return node, node
        join.dep = len(kids)
        for c in kids:
            entry, compl_ = build(prefix + [c])
            node.children.append(entry)
            compl_.notify = join
        return node, join

    root, _ = build([])
    return _linearize(f"nqueens({n})", root)


def _divide_conquer(name, levels, fanout, leaf_cyc, join_cyc_fn, spawn_cyc, rng):
    """Generic recursive split: `fanout` children per level, join on the way up."""

    def build(level):
        if level == 0:
            leaf = _Node(leaf_cyc(rng))
            return leaf, leaf
        call = _Node(spawn_cyc(rng))
        join = _Node(join_cyc_fn(level, rng), dep=fanout)
        for _ in range(fanout):
            entry, compl_ = build(level - 1)
            call.children.append(entry)
            compl_.notify = join
        return call, join

    root, _ = build(levels)
    return _linearize(name, root)


def sort(levels: int = 11, seed: int = 0) -> TaskGraph:
    """Merge sort: most work ~1e5 cycles (leaf sorts and big merges)."""
    rng = np.random.default_rng(seed)
    return _divide_conquer(
        f"sort(2^{levels})", levels, 2,
        leaf_cyc=lambda r: _cyc(r, 5e4, 2e5),
        join_cyc_fn=lambda lvl, r: (2 ** lvl) * 90 * CYCLE_NS,  # merge is linear
        spawn_cyc=lambda r: _cyc(r, 40, 120), rng=rng)


def fft(levels: int = 12, seed: int = 0) -> TaskGraph:
    """Recursive FFT: sizes 1e2-1e6 cycles, mode at 1e3-1e4 (paper §VI-A)."""
    rng = np.random.default_rng(seed)
    return _divide_conquer(
        f"fft(2^{levels})", levels, 2,
        leaf_cyc=lambda r: _cyc(r, 2e2, 2e3),
        join_cyc_fn=lambda lvl, r: (2 ** lvl) * 25 * CYCLE_NS,  # butterfly combine
        spawn_cyc=lambda r: _cyc(r, 40, 160), rng=rng)


def strassen(levels: int = 4, seed: int = 0) -> TaskGraph:
    """7-way recursion; combine is quadratic; mode ~1e4 cycles."""
    rng = np.random.default_rng(seed)
    return _divide_conquer(
        f"strassen(7^{levels})", levels, 7,
        leaf_cyc=lambda r: _cyc(r, 6e3, 3e4),
        join_cyc_fn=lambda lvl, r: (4 ** lvl) * 250 * CYCLE_NS,
        spawn_cyc=lambda r: _cyc(r, 100, 400), rng=rng)


def uts(n_target: int = 20000, b0: float = 2.0, seed: int = 0) -> TaskGraph:
    """Unbalanced Tree Search: geometric branching, small constant tasks."""
    rng = np.random.default_rng(seed)
    root = _Node(_cyc(rng, 2e2, 8e2))
    frontier = [root]
    total = 1
    first = True
    while frontier and total < n_target:
        node = frontier.pop(rng.integers(0, len(frontier)))
        nkids = rng.geometric(1.0 / b0) if rng.random() < 0.7 else 0
        if first:   # the root always branches (no early extinction)
            nkids = max(nkids, 4)
            first = False
        nkids = int(min(nkids, n_target - total))
        if nkids == 0:
            continue
        # OpenMP taskwait semantics: the join waits on the *direct* children's
        # execution (each child notifies it once, at creation time)
        join = _Node(20 * CYCLE_NS, dep=nkids)
        for _ in range(nkids):
            ch = _Node(_cyc(rng, 2e2, 8e2))
            ch.notify = join
            node.children.append(ch)
            frontier.append(ch)
            total += 1
    return _linearize(f"uts({n_target})", root)


def health(levels: int = 5, branch: int = 4, seed: int = 0) -> TaskGraph:
    """Hospital simulation: regular tree, lognormal sizes centered 1e3-1e4."""
    rng = np.random.default_rng(seed)

    def build(level):
        node = _Node(float(rng.lognormal(np.log(3e3), 0.9)) * CYCLE_NS)
        if level == 0:
            return node, node
        join = _Node(30 * CYCLE_NS, dep=branch)
        for _ in range(branch):
            entry, compl_ = build(level - 1)
            node.children.append(entry)
            compl_.notify = join
        return node, join

    root, _ = build(levels)
    return _linearize(f"health(l{levels})", root)


def floorplan(max_depth: int = 9, seed: int = 0, prune: float = 0.42) -> TaskGraph:
    """Branch-and-bound with pruning: heavily imbalanced, sizes 1e2-1e6."""
    rng = np.random.default_rng(seed)

    def build(depth):
        node = _Node(_cyc(rng, 1e2, 1e3 if depth > 3 else 1e6))
        if depth == max_depth:
            return node, node
        kids = [c for c in range(4) if rng.random() > prune]
        if not kids:
            return node, node
        join = _Node(15 * CYCLE_NS, dep=len(kids))
        for _ in kids:
            entry, compl_ = build(depth + 1)
            node.children.append(entry)
            compl_.notify = join
        return node, join

    root, _ = build(0)
    return _linearize(f"fp(d{max_depth})", root)


def align(n_seqs: int = 64, seed: int = 0) -> TaskGraph:
    """Protein alignment: the `single` construct — worker 0 creates all
    n*(n-1)/2 tasks; task sizes ~Normal around 1e6 cycles."""
    rng = np.random.default_rng(seed)
    ntasks = n_seqs * (n_seqs - 1) // 2
    root = _Node(50 * CYCLE_NS)
    join = _Node(20 * CYCLE_NS, dep=ntasks)
    root.notify = None
    for _ in range(ntasks):
        t = _Node(max(1e4, rng.normal(1e6, 2e5)) * CYCLE_NS)
        t.notify = join
        root.children.append(t)
    return _linearize(f"align({n_seqs})", root)


def posp(k: int = 16, batch: int = 64, hash_cyc: float = 600.0,
         seed: int = 0) -> TaskGraph:
    """Proof-of-Space puzzle generation (§VII): 2^k BLAKE3-style hashes in
    batches of `batch`; one task per batch, all created by one worker."""
    rng = np.random.default_rng(seed)
    total = 2 ** k
    ntasks = (total + batch - 1) // batch
    root = _Node(40 * CYCLE_NS)
    join = _Node(20 * CYCLE_NS, dep=ntasks)
    for i in range(ntasks):
        m = min(batch, total - i * batch)
        t = _Node(m * hash_cyc * CYCLE_NS * float(rng.uniform(0.95, 1.05)))
        t.notify = join
        root.children.append(t)
    return _linearize(f"posp(2^{k},b{batch})", root)


GENERATORS = {
    "fib": fib, "nqueens": nqueens, "fft": fft, "sort": sort,
    "strassen": strassen, "uts": uts, "health": health, "fp": floorplan,
    "align": align, "posp": posp,
}
#: the JAX package's name for the same table
BUILDERS = GENERATORS

#: Ordering used in the paper's figures (by mean task size, small -> large).
BOTS_APPS = ("fib", "nqueens", "fp", "health", "uts", "fft", "strassen",
             "sort", "align")


def build(name: str, **kw) -> TaskGraph:
    return GENERATORS[name](**kw)
