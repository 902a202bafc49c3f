"""The port's sweep planning and result cache against the JAX package's.

* ``build_plan`` cuts the same chunks (indices, spec, heterogeneity flag,
  padded size) with the same paddings and ``gq_cap``.
* ``case_key`` gives the same hex digest for flat, NUMA, cluster (native
  and starved) and open-system cases, so the two packages share one store.
* An entry written by the JAX package's ``ResultCache`` (through its
  ``run_cases``) is a hit in the port's ``run_cases``, bit for bit.

Inputs come from a numpy seed; the tolerance is zero differences.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import cache as j_cache  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core import topology as j_topo  # noqa: E402
from repro.core.scheduler import SimConfig as JConfig  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core import taskgraph as t_tg  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402
from repro_torch.core.spec import LATTICE  # noqa: E402
from repro_torch.core.state import SimConfig  # noqa: E402

TOPOLOGIES = (None, "quad_socket_48", "two_node_2x24", "rack_4x2x24")
ARRIVALS = (None, "poisson:2", "lognormal:2:1.5", "bursty:2:4:0.5")


def random_specs(seed: int, n: int, cls):
    """``n`` random case specs (a numpy seed picks every knob); ``cls`` is
    either package's ``CaseSpec``."""
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        topo = TOPOLOGIES[rs.integers(len(TOPOLOGIES))]
        out.append(cls(
            spec=LATTICE[rs.integers(len(LATTICE))].slug,
            n_workers=int(rs.choice([4, 8, 12, 16])),
            n_zones=int(rs.choice([1, 2, 4])), seed=int(rs.integers(0, 9)),
            n_victim=int(rs.integers(1, 5)), n_steal=int(rs.integers(1, 9)),
            t_interval=int(rs.choice([5, 10, 100])),
            p_local=float(rs.choice([0.5, 0.8, 1.0])),
            graph=int(rs.integers(0, 3)), topology=topo,
            arrivals=ARRIVALS[rs.integers(len(ARRIVALS))],
            p_local_node=float(rs.choice([0.25, 0.75]))))
    return out


def graphs(tg):
    return [tg.fib(5), tg.uts(60), tg.fib(7).with_payload(8.0)]


@pytest.mark.parametrize("seed,n,chunk", [(0, 40, 64), (1, 40, 4),
                                          (2, 17, 3), (3, 60, 8)])
def test_build_plan_matches_jax(seed, n, chunk):
    jp = j_plan.build_plan(graphs(j_tg), random_specs(seed, n,
                                                      j_plan.CaseSpec),
                           chunk_size=chunk)
    tp = t_plan.build_plan(graphs(t_tg), random_specs(seed, n,
                                                      t_plan.CaseSpec),
                           chunk_size=chunk)
    assert (tp.n_cases, tp.w_pad, tp.t_pad, tp.gq_cap) == \
        (jp.n_cases, jp.w_pad, jp.t_pad, jp.gq_cap)
    assert len(tp.chunks) == len(jp.chunks)
    for a, b in zip(tp.chunks, jp.chunks):
        assert a.indices == b.indices
        assert a.spec.slug == b.spec.slug and a.mode == b.mode
        assert a.hetero_dlb == b.hetero_dlb
        assert (a.n_real, a.padded_size) == (b.n_real, b.padded_size)


@pytest.mark.parametrize("seed", range(4))
def test_case_key_matches_jax(seed):
    """Flat, NUMA, cluster, starved-cluster and open-system specs, with a
    non-default cost model and SimConfig."""
    jg, tg = graphs(j_tg), graphs(t_tg)
    jd = [j_cache.graph_digest(g) for g in jg]
    td = [t_cache.graph_digest(g) for g in tg]
    assert jd == td
    jspecs = random_specs(seed, 24, j_plan.CaseSpec)
    tspecs = random_specs(seed, 24, t_plan.CaseSpec)
    # a starved cluster fabric (bw_scale < 1)
    jspecs.append(j_plan.CaseSpec(spec="na_ws", graph=2, topology=j_topo
                                  .PRESETS["two_node_2x24"].with_bandwidth(4)))
    tspecs.append(t_plan.CaseSpec(spec="na_ws", graph=2, topology=t_topo
                                  .PRESETS["two_node_2x24"].with_bandwidth(4)))
    kinds = set()
    for cfg_kw in ({}, dict(queue_cap=8, stack_cap=64, max_steps=999)):
        jcfg, tcfg = JConfig(**cfg_kw), SimConfig(**cfg_kw)
        jcfg = dataclasses.replace(jcfg, costs=dataclasses.replace(
            jcfg.costs, c_lock=1234, exec_zone_penalty=1.7))
        tcfg = dataclasses.replace(tcfg, costs=dataclasses.replace(
            tcfg.costs, c_lock=1234, exec_zone_penalty=1.7))
        for js, ts in zip(jspecs, tspecs):
            assert t_cache.case_key(td[ts.graph], ts, tcfg) == \
                j_cache.case_key(jd[js.graph], js, jcfg)
            kinds.add((ts.topology is None,
                       ts.topology is not None and ts.topology.is_cluster,
                       ts.arrivals is None))
    assert len(kinds) >= 4   # flat, numa/cluster, open and closed all met
    assert t_cache.CODE_VERSION == j_cache.CODE_VERSION
    assert t_cache.RECORD_FIELDS == j_cache.RECORD_FIELDS


def test_jax_written_entries_hit_in_the_port(tmp_path):
    """The JAX package fills a store; the port's run_cases serves every
    case from it, bit for bit, and executes nothing."""
    cfg_kw = dict(n_workers=8, n_zones=2, max_steps=60_000)
    jspecs = [j_plan.CaseSpec(spec=s, n_workers=8, n_zones=2, graph=0,
                              t_interval=10, p_local=0.8)
              for s in ("gomp", "na_ws")]
    jspecs.append(j_plan.CaseSpec(spec="na_rp", n_workers=8, graph=0,
                                  topology="quad_socket_48",
                                  arrivals="poisson:2"))
    tspecs = [t_plan.CaseSpec(spec=s, n_workers=8, n_zones=2, graph=0,
                              t_interval=10, p_local=0.8)
              for s in ("gomp", "na_ws")]
    tspecs.append(t_plan.CaseSpec(spec="na_rp", n_workers=8, graph=0,
                                  topology="quad_socket_48",
                                  arrivals="poisson:2"))
    cold = j_sweep.run_cases([j_tg.fib(7)], jspecs, cfg=JConfig(**cfg_kw),
                             cache=j_cache.ResultCache(str(tmp_path)))
    assert cold.cache_hits == 0
    warm = t_sweep.run_cases([t_tg.fib(7)], tspecs, cfg=SimConfig(**cfg_kw),
                             cache=t_cache.ResultCache(str(tmp_path)),
                             device="cpu")
    assert warm.cache_hits == len(tspecs)
    assert np.array_equal(warm.time_ns, cold.time_ns)
    assert np.array_equal(warm.steps, cold.steps)
    assert np.array_equal(warm.completed, cold.completed)
    for n in cold.counters:
        assert np.array_equal(warm.counters[n], cold.counters[n]), n
    for n in ("p50_ns", "p90_ns", "p99_ns", "throughput"):
        assert np.array_equal(getattr(warm, n), getattr(cold, n)), n


def test_port_written_entries_hit_in_jax(tmp_path):
    """And the other way: an entry the port executed and stored is a hit
    in the JAX package with the same record."""
    spec_kw = dict(spec="na_ws", n_workers=8, n_zones=2, t_interval=10,
                   p_local=0.8)
    cfg_kw = dict(n_workers=8, n_zones=2, max_steps=60_000)
    cold = t_sweep.run_cases(t_tg.fib(6), [t_plan.CaseSpec(**spec_kw)],
                             cfg=SimConfig(**cfg_kw),
                             cache=t_cache.ResultCache(str(tmp_path)),
                             device="cpu")
    warm = j_sweep.run_cases(j_tg.fib(6), [j_plan.CaseSpec(**spec_kw)],
                             cfg=JConfig(**cfg_kw),
                             cache=j_cache.ResultCache(str(tmp_path)))
    assert cold.cache_hits == 0 and warm.cache_hits == 1
    assert np.array_equal(warm.time_ns, cold.time_ns)
    for n in cold.counters:
        assert np.array_equal(warm.counters[n], cold.counters[n]), n


def test_cache_resolve_and_schema_misses(tmp_path):
    assert t_cache.resolve(None) is None and t_cache.resolve(False) is None
    store = t_cache.ResultCache(str(tmp_path))
    assert t_cache.resolve(store) is store
    assert isinstance(t_cache.resolve(True), t_cache.ResultCache)
    store.put("ab" * 32, dict(clock_max=1, counters={"exec": 1}, n_done=1,
                              overflow=False, step_i=1))
    assert store.get("ab" * 32, required_counters=("exec",)) is not None
    assert store.get("ab" * 32, required_counters=("stolen",)) is None
    assert store.get("cd" * 32) is None
    assert (store.hits, store.misses) == (1, 2)
