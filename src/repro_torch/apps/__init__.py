"""Workload apps: every schedulable task-graph family behind one registry.

The BOTS-analogue generators (``core/taskgraph.py``) and the graphs
extracted from the repo's model stack (``apps/moe.py`` expert dispatch,
``apps/decode.py`` continuous-batching decode) register here as
:class:`AppSpec` entries, so ``run_grid``, the result cache, the tuner,
and every benchmark sweep apps uniformly::

    from repro_torch import apps
    g = apps.build("moe", alpha=2.0)          # generator defaults + override
    g = apps.build("decode", scale="smoke")   # a registered size preset

An ``AppSpec`` carries the generator plus three kwargs presets — ``bench``
(full-scale benchmark instances, paper §VI-style scaling), ``smoke``
(CI-sized), ``tiny`` (test/property-sized) — so callers name a scale
instead of copy-pasting size tables.  ``build(name, scale=..., **kw)``
starts from the preset and overlays ``kw``; ``scale=None`` uses the
generator's own defaults.

The graph-extraction contract every app obeys (docs/ARCHITECTURE.md
"Workload apps"):

* pure host-side numpy off ``default_rng(seed)`` streams — bit-identical
  graphs across hosts and runs (golden digests in ``test_apps.py``);
* durations in simulator ns via ``CYCLE_NS`` and the cost constants of
  the source workload (tokens, KV lengths, hash batches — never wall
  time);
* ``TaskGraph.validate()`` holds, so any executor/backend may run it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

from repro_torch.apps import decode as decode_mod
from repro_torch.apps import moe as moe_mod
from repro_torch.core import taskgraph
from repro_torch.core.taskgraph import TaskGraph

SCALES = ("bench", "smoke", "tiny")


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """One registered workload family."""
    name: str
    family: str                      # "bots" | "model"
    make_graph: Callable[..., TaskGraph]
    desc: str
    bench: Mapping                   # full-scale kwargs (benchmarks)
    smoke: Mapping                   # CI-smoke kwargs (BENCH_SMOKE=1)
    tiny: Mapping                    # test/property kwargs

    def kwargs(self, scale: str | None) -> dict:
        if scale is None:
            return {}
        assert scale in SCALES, (scale, SCALES)
        return dict(getattr(self, scale))

    def build(self, scale: str | None = None, **kw) -> TaskGraph:
        return self.make_graph(**{**self.kwargs(scale), **kw})


#: size presets for the BOTS generators — ``bench`` matches the paper-style
#: scaled-down instances the benchmarks have always used, ``smoke`` its
#: BENCH_SMOKE=1 shrink (benchmarks/common.py derives its table from here)
_BOTS_SCALES = {
    "fib": (dict(n=16), dict(n=10), dict(n=8)),
    "nqueens": (dict(n=8), dict(n=6), dict(n=5)),
    "fp": (dict(max_depth=8), dict(max_depth=5), dict(max_depth=4)),
    "health": (dict(levels=4), dict(levels=3), dict(levels=2)),
    "uts": (dict(n_target=3000), dict(n_target=300), dict(n_target=120)),
    "fft": (dict(levels=10), dict(levels=6), dict(levels=4)),
    "strassen": (dict(levels=3), dict(levels=2), dict(levels=1)),
    "sort": (dict(levels=9), dict(levels=5), dict(levels=4)),
    "align": (dict(n_seqs=24), dict(n_seqs=8), dict(n_seqs=6)),
    "posp": (dict(k=13, batch=64), dict(k=9, batch=32),
             dict(k=8, batch=32)),
}

_BOTS_DESC = {
    "fib": "binary call tree, 10-80 cycle tasks",
    "nqueens": "prefix tree, high fan-out near the root",
    "fp": "pruned branch-and-bound tree (floorplan)",
    "health": "irregular multi-level tree, lognormal sizes",
    "uts": "unbalanced geometric random tree",
    "fft": "recursive split with combine joins",
    "strassen": "7-way recursion, quadratic combine",
    "sort": "merge-sort tree, ~1e5-cycle tasks",
    "align": "single-creator flat bag of ~1e6-cycle tasks",
    "posp": "proof-of-space hashing batches, single creator",
}

REGISTRY: dict[str, AppSpec] = {}


def _register(spec: AppSpec) -> None:
    assert spec.name not in REGISTRY, spec.name
    REGISTRY[spec.name] = spec


for _name, _make in taskgraph.GENERATORS.items():
    _b, _s, _t = _BOTS_SCALES[_name]
    _register(AppSpec(name=_name, family="bots", make_graph=_make,
                      desc=_BOTS_DESC[_name], bench=_b, smoke=_s, tiny=_t))

_register(AppSpec(
    name="moe", family="model", make_graph=moe_mod.moe,
    desc="MoE expert dispatch: router root -> per-expert token bundles "
         "-> combine join; Zipf-alpha load skew, capacity-constrained",
    bench=dict(n_experts=64, n_tokens=4096, top_k=2),
    smoke=dict(n_experts=32, n_tokens=512, top_k=2),
    tiny=dict(n_experts=8, n_tokens=96, top_k=2)))

_register(AppSpec(
    name="decode", family="model", make_graph=decode_mod.decode,
    desc="continuous-batching decode: per-sequence lane tasks with "
         "KV-length-dependent durations chained by batch joins",
    bench=dict(n_lanes=16, n_seqs=48, prompt_mean=128, gen_mean=32),
    smoke=dict(n_lanes=8, n_seqs=12, prompt_mean=64, gen_mean=8),
    tiny=dict(n_lanes=4, n_seqs=6, prompt_mean=32, gen_mean=4)))


def get(name: str) -> AppSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown app {name!r}; "
                       f"registered: {sorted(REGISTRY)}")
    return REGISTRY[name]


def names(family: str | None = None) -> tuple:
    return tuple(n for n, s in REGISTRY.items()
                 if family is None or s.family == family)


def build(name: str, scale: str | None = None, **kw) -> TaskGraph:
    """Build a registered app's graph: ``scale`` preset + ``kw`` overrides."""
    return get(name).build(scale=scale, **kw)


def app_label(graph_name: str) -> str:
    """Family label of a built graph (``"moe(E64,...)"`` → ``"moe"``) —
    the key the result cache stamps and splits stats on."""
    return graph_name.split("(")[0]


__all__ = ["AppSpec", "REGISTRY", "SCALES", "app_label", "build", "get",
           "names"]
