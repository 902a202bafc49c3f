"""The port's host-side layer against the JAX package's: task-graph
generators and app presets, topology presets, arrival schedules and SLO
records, barrier episodes, the spec lattice, and the initial tensors
(cases, graph arrays, fresh states) — all equal, bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.apps as j_apps  # noqa: E402
import repro_torch.apps as t_apps  # noqa: E402
from repro.core import arrivals as j_arr  # noqa: E402
from repro.core import barrier as j_bar  # noqa: E402
from repro.core import costs as j_costs  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import state as j_state  # noqa: E402
from repro.core import topology as j_topo  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import barrier as t_bar  # noqa: E402
from repro_torch.core import costs as t_costs  # noqa: E402
from repro_torch.core import spec as t_spec  # noqa: E402
from repro_torch.core import state as t_state  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402

GRAPH_FIELDS = ("dur", "first_child", "n_children", "notify", "join_dep")


def same_tree(a_tree, b_tree, label):
    a, b = t_state.to_numpy(a_tree), t_state.to_numpy(b_tree)
    assert a.keys() == b.keys(), label
    for k in b:
        assert a[k].dtype == b[k].dtype, (label, k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), (label, k)


def same_graph(t, j, label):
    assert t.name == j.name and t.mem_bound == j.mem_bound, label
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(t, f), getattr(j, f)), (label, f)
        assert getattr(t, f).dtype == getattr(j, f).dtype, (label, f)
    if j.payload is None:
        assert t.payload is None, label
    else:
        assert np.array_equal(t.payload, j.payload), label


@pytest.mark.parametrize("scale", ("tiny", "smoke"))
def test_app_registry_and_graphs_match(scale):
    assert t_apps.names() == j_apps.names()
    for name in j_apps.names():
        ts, js = t_apps.get(name), j_apps.get(name)
        assert (ts.family, ts.desc, dict(ts.bench), dict(ts.smoke),
                dict(ts.tiny)) == (js.family, js.desc, dict(js.bench),
                                   dict(js.smoke), dict(js.tiny)), name
        tg, jg = t_apps.build(name, scale=scale), j_apps.build(name,
                                                               scale=scale)
        same_graph(tg, jg, (name, scale))
        same_graph(tg.with_payload(8.0), jg.with_payload(8.0),
                   (name, scale, "payload"))
        assert t_apps.app_label(tg.name) == j_apps.app_label(jg.name)


def _topo_variants(mod):
    out = dict(mod.PRESETS)
    out["flat4"] = mod.MachineTopology.flat(4)
    for name in ("two_node_2x24", "rack_4x2x24", "dual_socket_24"):
        out[f"{name}@bw4"] = mod.PRESETS[name].with_bandwidth(4)
    out["two_node@bw4@bw2"] = mod.PRESETS["two_node_2x24"] \
        .with_bandwidth(4).with_bandwidth(2)
    return out


def test_topologies_match():
    assert tuple(t_topo.PRESETS) == tuple(j_topo.PRESETS)
    tv, jv = _topo_variants(t_topo), _topo_variants(j_topo)
    for name in jv:
        t, j = tv[name], jv[name]
        assert t.asdict() == j.asdict() and t.cache_key() == j.cache_key()
        assert (t.natural_workers, t.bw_scale, t.cross_node_bw,
                t.sort_key) == (j.natural_workers, j.bw_scale,
                                j.cross_node_bw, j.sort_key), name
        assert [t.zone_size_for(w) for w in (1, 5, 48, 64)] == \
            [j.zone_size_for(w) for w in (1, 5, 48, 64)]
        same_tree(t.arrays(), j.arrays(), name)
        assert t_topo.label(name if name in t_topo.PRESETS else t) == \
            j_topo.label(name if name in j_topo.PRESETS else j)
    same_tree(t_topo.degenerate_arrays(), j_topo.degenerate_arrays(), "deg")
    assert t_topo.label(None) == j_topo.label(None) == "flat"
    with pytest.raises(ValueError):
        t_topo.resolve("no_such_machine")
    w = torch.arange(12, dtype=torch.int32)
    assert np.array_equal(
        t_topo.domain_of(w, 5, 2).numpy(),
        np.asarray(j_topo.domain_of(jax.numpy.arange(12), 5, 2)))


ARRIVALS = ("poisson:2", "poisson:0.5", "lognormal:2:1.5", "lognormal:4",
            "bursty:2:4:0.5", "bursty:8")


@pytest.mark.parametrize("spec", ARRIVALS)
def test_release_times_and_slo_match(spec):
    tp, jp = t_arr.resolve(spec), j_arr.resolve(spec)
    assert tp.label() == jp.label() and tp.cache_key() == jp.cache_key()
    assert t_arr.label(spec) == j_arr.label(spec)
    for n, seed in ((1, 0), (163, 0), (250, 3), (4789, 11)):
        a = t_arr.release_times(tp, n, seed)
        b = j_arr.release_times(jp, n, seed)
        assert a.dtype == b.dtype and np.array_equal(a, b), (spec, n, seed)
        assert np.array_equal(t_arr.padded_release(tp, n, seed, n + 7),
                              j_arr.padded_release(jp, n, seed, n + 7))
        rs = np.random.default_rng(n)
        done = rs.integers(-1, 2 * int(b[-1]) + 50, n)
        assert t_arr.slo_metrics(done, a, n) == j_arr.slo_metrics(done, b, n)
    assert t_arr.slo_metrics(np.full(5, -1), np.zeros(5), 5) == \
        j_arr.slo_metrics(np.full(5, -1), np.zeros(5), 5)


def test_barrier_episodes_match():
    tv, jv = _topo_variants(t_topo), _topo_variants(j_topo)
    costs_t, costs_j = t_costs.DEFAULT_COSTS, j_costs.DEFAULT_COSTS
    assert dataclasses.asdict(costs_t) == dataclasses.asdict(costs_j)
    for barrier in j_spec.BARRIERS:
        for W in (1, 2, 5, 16, 48, 64, 100):
            for name in (None, *jv):
                t = t_bar.episode_for(barrier, W, costs_t,
                                      tv[name] if name else None)
                j = j_bar.episode_for(barrier, W, costs_j,
                                      jv[name] if name else None)
                assert (t.time_ns, t.atomic_ops) == \
                    (int(j.time_ns), int(j.atomic_ops)), (barrier, W, name)


def test_spec_lattice_matches():
    assert [s.slug for s in t_spec.LATTICE] == [s.slug for s in
                                                j_spec.LATTICE]
    assert {m: s.slug for m, s in t_spec.MODE_SPECS.items()} == \
        {m: s.slug for m, s in j_spec.MODE_SPECS.items()}
    for s in t_spec.LATTICE:
        assert s.axis_ids == j_spec.RuntimeSpec.from_slug(s.slug).axis_ids
        assert s.label == j_spec.RuntimeSpec.from_slug(s.slug).label


@pytest.mark.parametrize("mode,n_w,zone,topo,arrivals,seed", [
    ("gomp", 16, 4, None, None, 0),
    ("na_ws", 12, 3, "quad_socket_48", "poisson:2", 7),
    ("na_rp", 16, 4, "rack_4x2x24", "bursty:2:4:0.5", -3),
    ("xgomptb", 5, 2, "two_node_2x24", None, 2**31 - 1),
])
def test_initial_tensors_match(mode, n_w, zone, topo, arrivals, seed):
    tg = t_apps.build("fib", scale="tiny").with_payload(4.0)
    jg = j_apps.build("fib", scale="tiny").with_payload(4.0)
    rel = (None if arrivals is None
           else j_arr.release_times(j_arr.resolve(arrivals), tg.n_tasks, 1))
    kw = dict(seed=seed, mem_bound=0.05, topology=topo, release_ns=rel)
    tc = t_state.make_case(mode, n_w, zone,
                           params=t_state.make_params(p_local=0.8), **kw)
    jc = j_state.make_case(mode, n_w, zone,
                           params=j_state.make_params(p_local=0.8), **kw)
    same_tree(tc, jc, "case")
    for pad in (None, tg.n_tasks + 9):
        t_g = t_state.graph_arrays(tg, pad_to=pad)
        j_g = j_state.graph_arrays(jg, pad_to=pad)
        same_tree(t_g, j_g, ("graph", pad))
    gq = tg.n_tasks + 2 if mode == "gomp" else 4
    t_s = t_state.init_state(t_g, 16, 32, 4, gq, seed)
    j_s = j_state.init_state(j_g, 16, 32, 4, gq, jc.seed)
    same_tree(t_s, j_s, "init_state")
    # the converters round-trip and copy
    back = t_state.from_numpy(t_state.to_numpy(t_s), t_state.SimState)
    same_tree(back, j_s, "round trip")
    assert back.xq.buf.data_ptr() != t_s.xq.buf.data_ptr()
    assert back.rng.dtype == torch.int64
