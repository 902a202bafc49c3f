"""Executor layer of the experiment service: how a planned chunk runs.

Every executor consumes one :class:`~repro_torch.core.plan.ChunkPlan`
against the shared :class:`ExecContext` (padded graphs + padded
``SimConfig`` on the run's device) and returns the same per-case raw
arrays — bitwise identical across executors, as in the JAX package's
``repro.core.executors``.  The run loop comes from the backend named by
``cfg.backend`` (see :mod:`repro_torch.core.backends`), orthogonal to the
executor and bitwise-neutral too:

* ``serial``  — one run per case.
* ``vmap`` (alias ``batched``) — the chunk stacked along a leading batch
  axis and padded with *inert* lanes (a zero-task graph, whose run gate is
  false from step 0).  On ``cuda_fused`` the whole chunk is one kernel
  launch, one thread block per simulation, with no per-step host round
  trip.  On ``reference``/``cuda`` each lane's loop runs in turn on views
  of the stacked tensors: ``torch.func.vmap`` cannot trace the phases'
  data-dependent loops, and these lane loops are the batched kernel's plain
  twin.
* ``sharded`` — the padded batch split over ``torch.cuda.device_count()``
  devices, one slice each (on one card, or on the CPU, ``vmap``).

Every executor splits into ``submit`` (stacking, state init and the
launch; no host sync on ``cuda_fused``) and ``collect`` (the device→host
copy, which syncs), so the sweep layer can overlap chunk *k+1*'s host work
with chunk *k*'s device work.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import arrivals as arrivals_mod
from repro_torch.core import backends as backends_mod
from repro_torch.core.plan import CaseSpec, ChunkPlan
from repro_torch.core.state import (GraphArrays, SimConfig, SweepCase,
                                    batch_of_one, init_batch, make_case,
                                    make_params, stack, to_device, tree_map)
from repro_torch.core.taskgraph import TaskGraph

#: process-wide engine counters: ``dispatches`` counts run-loop calls (one
#: per serial case / one per batched chunk), ``chunks`` the chunks
#: submitted, ``sim_steps`` the simulated steps (added by the sweep layer)
ENGINE_STATS = {"dispatches": 0, "chunks": 0, "sim_steps": 0}


def reset_engine_stats() -> dict:
    """Zero the engine counters; returns the dict for convenience."""
    for k in ENGINE_STATS:
        ENGINE_STATS[k] = 0
    return ENGINE_STATS


class ChunkRaw(NamedTuple):
    """Per-case raw outputs of one chunk, real cases only (padding dropped)."""
    clock: np.ndarray      # (n, W) int64
    ctr: np.ndarray        # (n, W, NC) int64
    n_done: np.ndarray     # (n,)
    overflow: np.ndarray   # (n,) bool
    step_i: np.ndarray     # (n,)
    done_ns: np.ndarray    # (n, T) int64 — per-task completion stamps


@dataclasses.dataclass(frozen=True)
class ExecContext:
    """Shared executor inputs fixed by the plan: padded config + graphs.

    ``release_len`` is the shared length of every case's release vector:
    the plan's ``t_pad`` when any case of the run is open-system, else the
    closed system's 1-length placeholder, so closed and open cases stack
    into one chunk.  ``garr`` lies on ``device``.
    """
    cfg: SimConfig                   # n_workers == the plan's w_pad
    gq_cap: int
    graphs: Sequence[TaskGraph]
    garr: Sequence[GraphArrays]      # padded to the plan's t_pad
    device: torch.device
    release_len: int = 1

    def case_for(self, s: CaseSpec) -> SweepCase:
        """The case of ``s``, built on the host (executors copy it)."""
        if s.arrivals is None and self.release_len == 1:
            release = None
        else:
            release = arrivals_mod.padded_release(
                s.arrivals, self.graphs[s.graph].n_tasks, s.seed,
                self.release_len)
        return make_case(
            s.spec, s.n_workers, s.zone_size, s.seed,
            round(float(self.graphs[s.graph].mem_bound), 3),
            make_params(s.n_victim, s.n_steal, s.t_interval, s.p_local,
                        s.p_local_node),
            topology=s.topology, release_ns=release,
            closed=s.arrivals is None)

    def run(self, st, gb, cb):
        """The backend's run loop over a batch, to the step horizon."""
        ENGINE_STATS["dispatches"] += 1
        return backends_mod.run_loop(self.cfg.backend)(
            st, gb, cb, costs=self.cfg.costs, max_steps=self.cfg.max_steps,
            max_iters=self.cfg.max_steps)


def _stack_chunk(ctx: ExecContext, specs_chunk: Sequence[CaseSpec],
                 padded: int):
    """Stack a chunk's graphs and cases, padding with inert lanes.  Cases
    are built on the host and copied in one transfer per leaf."""
    cases = [ctx.case_for(s) for s in specs_chunk]
    garrs = [ctx.garr[s.graph] for s in specs_chunk]
    if padded > len(specs_chunk):
        # zero-task graph: the lane's run gate is false from step 0
        inert = garrs[0]._replace(n_tasks=torch.zeros_like(garrs[0].n_tasks))
        garrs = garrs + [inert] * (padded - len(specs_chunk))
        cases = cases + [cases[0]] * (padded - len(cases))
    return stack(garrs), to_device(stack(cases), ctx.device)


def _raw(states: Sequence, n: int) -> ChunkRaw:
    """The host copy of the first ``n`` lanes of batched final states."""
    def cat(name):
        return np.concatenate(
            [getattr(st, name).cpu().numpy() for st in states])[:n]

    return ChunkRaw(cat("clock").astype(np.int64),
                    cat("ctr").astype(np.int64),
                    cat("n_done").astype(np.int64), cat("overflow"),
                    cat("step_i").astype(np.int64),
                    cat("done_ns").astype(np.int64))


class Executor(abc.ABC):
    """One way of running a planned chunk.  Stateless; see EXECUTORS."""

    name: str = "?"

    @abc.abstractmethod
    def submit(self, ctx: ExecContext, specs: Sequence[CaseSpec],
               chunk: ChunkPlan):
        """Start ``chunk.indices`` of ``specs``; returns a pending handle
        for ``collect``."""

    def collect(self, pending) -> ChunkRaw:
        """Copy a ``submit`` handle's results to the host; rows follow
        chunk order."""
        states, n = pending
        return _raw(states, n)

    def run_chunk(self, ctx: ExecContext, specs: Sequence[CaseSpec],
                  chunk: ChunkPlan) -> ChunkRaw:
        return self.collect(self.submit(ctx, specs, chunk))

    @staticmethod
    def _init(ctx, gb, cb):
        """Fresh batched states on the batch's device, built there."""
        cfg = ctx.cfg
        return init_batch(gb, cb.seed, cfg.n_workers, cfg.stack_cap,
                          cfg.queue_cap, ctx.gq_cap)


class SerialExecutor(Executor):
    name = "serial"

    def submit(self, ctx, specs, chunk):
        states = []
        for i in chunk.indices:
            s = specs[i]
            g = batch_of_one(ctx.garr[s.graph])
            case = to_device(batch_of_one(ctx.case_for(s)), ctx.device)
            states.append(ctx.run(self._init(ctx, g, case), g, case))
        ENGINE_STATS["chunks"] += 1
        return states, chunk.n_real


class VmapExecutor(Executor):
    name = "vmap"

    def padded_size(self, chunk: ChunkPlan) -> int:
        return chunk.padded_size

    def submit(self, ctx, specs, chunk):
        gb, cb = _stack_chunk(ctx, [specs[i] for i in chunk.indices],
                              self.padded_size(chunk))
        ENGINE_STATS["chunks"] += 1
        return self._dispatch(ctx, gb, cb), chunk.n_real

    def _dispatch(self, ctx, gb, cb):
        return [ctx.run(self._init(ctx, gb, cb), gb, cb)]


class ShardedExecutor(VmapExecutor):
    name = "sharded"

    @staticmethod
    def n_devices(ctx) -> int:
        return (torch.cuda.device_count() if ctx.device.type == "cuda"
                else 1)

    def padded_size(self, chunk: ChunkPlan) -> int:
        # a device multiple on top of the plan's power of two
        n_dev = max(torch.cuda.device_count(), 1)
        return -(-chunk.padded_size // n_dev) * n_dev

    def _dispatch(self, ctx, gb, cb):
        n_dev = self.n_devices(ctx)
        if n_dev <= 1:
            return super()._dispatch(ctx, gb, cb)
        # one contiguous slice of lanes per card; each card runs its own
        # launch on its own stream, and collect gathers them in order
        per = -(-gb.dur.shape[0] // n_dev)
        out = []
        for d in range(n_dev):
            dev = torch.device("cuda", d)
            sl = slice(d * per, (d + 1) * per)
            gd = tree_map(lambda x: x[sl].to(dev), gb)
            cd = tree_map(lambda x: x[sl].to(dev), cb)
            if gd.dur.shape[0] == 0:
                continue
            with torch.cuda.device(dev):
                out.append(ctx.run(self._init(ctx, gd, cd), gd, cd))
        return out


EXECUTORS = {e.name: e for e in
             (SerialExecutor(), VmapExecutor(), ShardedExecutor())}

#: accepted ``strategy=`` values; "batched" is the historical alias of vmap
STRATEGIES = ("auto",) + tuple(EXECUTORS) + ("batched",)


def select_executor(strategy: str, chunk: ChunkPlan,
                    backend: str = "reference",
                    device: torch.device | str = "cpu") -> Executor:
    """Resolve a strategy to an executor for one chunk.

    ``auto``: on ``cuda_fused`` the batched executor (``sharded`` when
    more than one card is visible), since one launch then runs the whole
    chunk; on the other backends ``serial``, because their batched path
    runs the lanes one after another anyway."""
    assert strategy in STRATEGIES, (strategy, STRATEGIES)
    if strategy == "batched":
        return EXECUTORS["vmap"]
    if strategy != "auto":
        return EXECUTORS[strategy]
    if backend != "cuda_fused":
        return EXECUTORS["serial"]
    if torch.device(device).type == "cuda" and torch.cuda.device_count() > 1:
        return EXECUTORS["sharded"]
    return EXECUTORS["vmap"]

