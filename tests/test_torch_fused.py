"""The fused run-loop kernel's plain twin and the ``cuda_fused`` backend on
the CPU (the CUDA kernel itself runs only on the card: see
``tests/test_torch_gpu.py``).

* ``init_batch`` equals the JAX package's ``init_state`` lane by lane.
* The batched twin on a mixed chunk (graphs, worker counts, machines,
  arrival processes, inert padded lanes) equals lane-by-lane ``run``.
* The twin with ``max_iters=1`` equals the JAX package's ``pallas_fused``
  step (interpret mode, as ``tests/test_backends.py`` runs it) on small
  mid-run states carried across with ``state.from_numpy``.
* ``cuda_fused`` on CPU tensors takes the twin and never builds or
  launches anything.
* The wrapper's ``StepArgs`` marshalling follows the state's leaf order,
  and the scan-order waterfall the kernel walks inverts ``scan_pos``.

Inputs come from numpy seeds; the tolerance is zero differences.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import phases as j_ph  # noqa: E402
from repro.core import state as j_st  # noqa: E402
from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core.costs import DEFAULT_COSTS  # noqa: E402
from repro.kernels import sched_step as j_step  # noqa: E402
from repro_torch.core import executors, scheduler, xqueue  # noqa: E402
from repro_torch.core import taskgraph as t_tg  # noqa: E402
from repro_torch.core.plan import CaseSpec, build_plan  # noqa: E402
from repro_torch.core.spec import MODE_SPECS  # noqa: E402
from repro_torch.core.state import (GraphArrays, SimConfig,  # noqa: E402
                                    SimState, SweepCase, batch_of_one,
                                    from_numpy, graph_arrays, init_batch,
                                    init_state, lane, leaves, make_params,
                                    stack, to_numpy)
from repro_torch.kernels import registry as reg  # noqa: E402
from repro_torch.kernels import sched_step as ss  # noqa: E402

C = DEFAULT_COSTS
MAX_STEPS = 60_000


def assert_same(a, b, label):
    x, y = to_numpy(a), to_numpy(b)
    assert x.keys() == y.keys(), label
    for k in y:
        assert x[k].dtype == y[k].dtype, (label, k)
        assert np.array_equal(x[k], y[k]), (label, k)


@pytest.mark.parametrize("seed", range(3))
def test_init_batch_equals_jax_init_state(seed):
    rs = np.random.default_rng(seed)
    W, S, Q, gq = 8, 16, 4, 30
    sizes = rs.integers(3, 7, 4)
    seeds = rs.integers(-2**31, 2**31 - 1, 4).astype(np.int32)
    got = init_batch(stack([graph_arrays(t_tg.fib(int(n)), pad_to=60)
                            for n in sizes]),
                     torch.as_tensor(seeds), W, S, Q, gq)
    for b, (n, sd) in enumerate(zip(sizes, seeds)):
        jg = j_st.graph_arrays(j_tg.fib(int(n)), pad_to=60)
        assert_same(lane(got, b),
                    j_st.init_state(jg, W, S, Q, gq, jnp.int32(sd)),
                    (seed, b))


def _mixed_chunk():
    """A chunk mixing graphs, worker counts, machines and arrivals under
    one spec, as the batched executor would stack it (padded to 8 lanes,
    3 of them inert).  Flat worker counts are multiples of the zone size:
    otherwise the reference's flat victim draw can name lane
    ``n_workers``, which a padded run answers differently (ROADMAP §3)."""
    graphs = [t_tg.fib(7), t_tg.uts(120), t_tg.fib(6).with_payload(8.0)]
    specs = [CaseSpec(spec="na_ws", n_workers=8, n_zones=2, graph=0,
                      t_interval=5, p_local=0.7, seed=1),
             CaseSpec(spec="na_ws", n_workers=4, n_zones=2, graph=1,
                      t_interval=5, p_local=0.7, seed=2,
                      arrivals="poisson:2"),
             CaseSpec(spec="na_ws", n_workers=8, graph=2,
                      topology="two_node_2x24", seed=3),
             CaseSpec(spec="na_ws", n_workers=6, graph=0,
                      topology="quad_socket_48", n_victim=3, seed=4),
             CaseSpec(spec="na_ws", n_workers=8, n_zones=4, graph=1,
                      arrivals="bursty:2:4:0.5", seed=5)]
    plan = build_plan(graphs, specs)
    cfg = SimConfig(n_workers=plan.w_pad, queue_cap=8, stack_cap=64,
                    max_steps=MAX_STEPS)
    ctx = executors.ExecContext(
        cfg=dataclasses.replace(cfg, backend="reference"),
        gq_cap=plan.gq_cap, graphs=graphs,
        garr=[graph_arrays(g, plan.t_pad) for g in graphs],
        device=torch.device("cpu"), release_len=plan.t_pad)
    return graphs, specs, plan, cfg, ctx


def test_batched_twin_equals_lane_by_lane_run():
    graphs, specs, plan, cfg, ctx = _mixed_chunk()
    assert len(plan.chunks) == 1 and plan.chunks[0].padded_size == 8
    gb, cb = executors._stack_chunk(ctx, specs, 8)
    st0 = init_batch(gb, cb.seed, cfg.n_workers, cfg.stack_cap,
                     cfg.queue_cap, plan.gq_cap)
    out = ss.sched_step(st0, gb, cb, costs=C, max_steps=MAX_STEPS,
                        max_iters=MAX_STEPS)
    for b, s in enumerate(specs):
        r = scheduler.run(graphs[s.graph], spec=s.spec,
                          cfg=dataclasses.replace(cfg, n_workers=s.n_workers,
                                                  n_zones=s.n_zones),
                          seed=s.seed, topology=s.topology,
                          arrivals=s.arrivals,
                          params=make_params(s.n_victim, s.n_steal,
                                             s.t_interval, s.p_local,
                                             s.p_local_node),
                          device="cpu")
        got, want = lane(out, b), r.state
        T, W = graphs[s.graph].n_tasks, s.n_workers
        assert bool(r.state.n_done == T)
        for name in ("n_done", "step_i", "overflow", "g_head", "g_tail"):
            assert int(getattr(got, name)) == int(getattr(want, name)), \
                (b, name)
        for name in ("clock", "rr", "deq_rr", "idle", "rng", "s_top",
                     "nlink_bytes"):
            assert torch.equal(getattr(got, name)[:W],
                               getattr(want, name)), (b, name)
        assert torch.equal(got.ctr[:W], want.ctr), b
        assert not got.ctr[W:].any() and not got.clock[W:].any(), b
        for name in ("done", "done_ns", "creator", "join_cnt"):
            assert torch.equal(getattr(got, name)[:T],
                               getattr(want, name)), (b, name)
        assert torch.equal(got.xq.head[:W, :W], want.xq.head), b
        assert torch.equal(got.xq.tail[:W, :W], want.xq.tail), b
    # inert padding lanes never step
    for b in range(len(specs), 8):
        assert int(lane(out, b).step_i) == 0
        assert int(lane(out, b).n_done) == 0


@pytest.mark.parametrize("max_iters", (1, 7))
def test_max_iters_bounds_the_twin(max_iters):
    graphs, specs, plan, cfg, ctx = _mixed_chunk()
    gb, cb = executors._stack_chunk(ctx, specs, 8)
    st0 = init_batch(gb, cb.seed, cfg.n_workers, cfg.stack_cap,
                     cfg.queue_cap, plan.gq_cap)
    out = ss.run_lanes(st0, gb, cb, costs=C, max_steps=MAX_STEPS,
                       max_iters=max_iters)
    assert out.step_i.tolist() == [max_iters] * 5 + [0] * 3


# ---------------- against the JAX package's pallas_fused step ----------
W, S, Q = 8, 64, 4
T_PAD = 100


@jax.jit
def _j_advance(st, g, case, k):
    def body(c):
        return c[0] + 1, j_ph.step_pipeline(c[1], g=g, case=case, costs=C,
                                            max_steps=MAX_STEPS)
    return jax.lax.while_loop(lambda c: c[0] < k, body,
                              (jnp.int32(0), st))[1]


#: (mode, topology, active workers, payload, mid-run step)
FUSED_CASES = [("na_ws", "two_node_2x24", 8, True, 6),
               ("gomp", None, 5, False, 9),
               ("na_rp", "quad_socket_48", 8, False, 4)]


@pytest.mark.parametrize("mode,topology,n_w,payload,k", FUSED_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in FUSED_CASES])
def test_twin_step_equals_jax_pallas_fused(mode, topology, n_w, payload, k):
    g = j_tg.fib(8)
    g = g.with_payload(16.0) if payload else g
    g = j_st.graph_arrays(g, pad_to=T_PAD)
    zone = (j_st.topology_mod.resolve(topology).zone_size_for(n_w)
            if topology else max(n_w // 2, 1))
    case = j_st.make_case(mode, n_w, zone, seed=k, mem_bound=0.3,
                          params=j_st.make_params(n_victim=2, n_steal=4,
                                                  t_interval=3, p_local=0.7),
                          topology=topology)
    st = _j_advance(j_st.init_state(g, W, S, Q, T_PAD + 2, case.seed), g,
                    case, jnp.int32(k))
    t_st = from_numpy(to_numpy(st), SimState)
    t_g = from_numpy(to_numpy(g), GraphArrays)
    t_case = from_numpy(to_numpy(case), SweepCase)
    want = j_step.build_fused_step(C, g, case, MAX_STEPS)(st)
    got = ss.run_lanes(batch_of_one(t_st), batch_of_one(t_g),
                       batch_of_one(t_case), costs=C, max_steps=MAX_STEPS,
                       max_iters=1)
    assert int(want.step_i) == k + 1
    assert_same(lane(got, 0), want, (mode, topology))


# ---------------- the cuda_fused backend on the CPU ----------------
def test_cuda_fused_on_cpu_takes_the_twin(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(ss, "_library", no_build)
    reg.reset_launches()
    g = t_tg.uts(150)
    cfg = SimConfig(n_workers=8, n_zones=2, max_steps=MAX_STEPS)
    runs = {b: scheduler.run(g, spec=MODE_SPECS["na_ws"],
                             cfg=dataclasses.replace(cfg, backend=b),
                             device="cpu")
            for b in ("reference", "cuda_fused")}
    assert runs["cuda_fused"].cfg.backend == "cuda_fused"
    assert_same(runs["cuda_fused"].state, runs["reference"].state, "run")
    assert all(k.launches == 0 for k in reg.KERNELS.values())


def test_step_args_follow_the_state_layout():
    """``StepArgs`` holds one pointer per leaf, in leaf order, and the
    wrapper's shape table matches a real batch."""
    g = graph_arrays(t_tg.fib(5))
    st = init_state(g, 8, 16, 4, 6, 0)
    case = scheduler.make_case(MODE_SPECS["na_ws"], 8, 2,
                               topology="two_node_2x24")
    renamed = {"xq_buf": "xq.buf", "xq_ts": "xq.ts", "xq_head": "xq.head",
               "xq_tail": "xq.tail", "round": "cells.round",
               "req_round": "cells.req_round", "req_tid": "cells.req_tid",
               "rp_tgt": "rp.tgt", "rp_left": "rp.left",
               "nlink": "nlink_bytes"}
    assert [renamed.get(n, n) for n, _, _ in ss._STATE] == list(to_numpy(st))
    assert [n for n, _, _ in ss._GRAPH] == list(GraphArrays._fields)
    assert len(ss._CASE) == len(leaves(case))
    assert len(ss.StepArgs._fields_) == (
        len(ss._STATE) + len(ss._GRAPH) + len(ss._CASE) + len(ss._INTS)
        + len(ss._FLOATS))
    sizes = ss._sizes(*(batch_of_one(x) for x in (st, g, case)))
    dev = torch.device("cpu")
    for tree, spec in ((st, ss._STATE), (g, ss._GRAPH), (case, ss._CASE)):
        ss._check_leaves(batch_of_one(tree), spec, sizes, dev)
    bad = batch_of_one(st._replace(clock=st.clock.to(torch.int64)))
    with pytest.raises(TypeError):
        ss._check_leaves(bad, ss._STATE, sizes, dev)


@pytest.mark.parametrize("seed", range(4))
def test_scan_order_waterfall_inverts_scan_pos(seed):
    """The kernel walks the victim's queues in ``_scan_order`` and credits
    each position's producer; the plain version indexes by ``scan_pos``.
    Both agree when one inverts the other over the live producers."""
    rs = np.random.default_rng(seed)
    Wp = int(rs.integers(2, 40))
    n_act = int(rs.integers(1, Wp + 1))
    me = torch.arange(Wp, dtype=torch.int32)
    rot = torch.as_tensor(rs.integers(0, 10**6, Wp).astype(np.int32))
    na = torch.tensor(n_act, dtype=torch.int32)
    order, valid = xqueue._scan_order(Wp, me, rot, na)
    pos = xqueue.scan_pos(Wp, me, rot, na)
    for m in range(n_act):
        live = order[m][valid[m]]
        assert sorted(live.tolist()) == list(range(n_act))
        for i, p in enumerate(live.tolist()):
            assert int(pos[m, p]) == i


def test_backend_follows_the_device():
    from repro_torch.core import backends
    assert backends.resolve_name(None, torch.device("cuda")) == "cuda_fused"
    assert backends.resolve_name(None, torch.device("cpu")) == "reference"
    assert backends.resolve_name("cuda", torch.device("cpu")) == "cuda"
    with pytest.raises(ValueError):
        backends.resolve_name("pallas_fused", torch.device("cpu"))
    with pytest.raises(ValueError):
        backends.step_ops("cuda_fused")
    assert backends.run_loop("cuda_fused") is ss.sched_step


def _domain_rows(W, n_w, zsz, topo):
    """The kernel's ``wt_build``, in Python: one cumulative weight row per
    (domain, table), built once per run from the thief's domain alone."""
    nd = int(topo.n_domains)
    dist, node = topo.dist.tolist(), topo.node.tolist()
    rows = {}
    for d in range(nd):
        for t in range(3):
            doms = [min(j // zsz, nd - 1) for j in range(W)]
            cand = [j < n_w and doms[j] != d for j in range(W)]
            if t == 1:
                cand = [c and node[d] == node[dj] for c, dj in zip(cand, doms)]
            if t == 2:
                cand = [c and node[d] != node[dj] for c, dj in zip(cand, doms)]
            dmax = max([dist[d][dj] for c, dj in zip(cand, doms) if c],
                       default=0)
            cum, row = 0, []
            for c, dj in zip(cand, doms):
                cum += dmax - dist[d][dj] + 1 if c else 0
                row.append(cum)
            rows[d, t] = row
    return rows


def _row_pick(row, draw):
    """The kernel's ``wt_pick``, in Python: a binary search of the row."""
    import bisect
    total = row[-1]
    lane = bisect.bisect_right(row, draw % max(total, 1))
    return min(lane, len(row) - 1), total > 0


@pytest.mark.parametrize("topology,n_w,W", (("quad_socket_48", 48, 48),
                                            ("quad_socket_48", 48, 53),
                                            ("two_node_2x24", 96, 96),
                                            ("two_node_2x24", 80, 96)))
def test_domain_weight_rows_pick_as_remote_weighted(topology, n_w, W):
    """The fused kernel's per-domain victim-weight rows and binary search
    give exactly ``dlb._remote_weighted``'s lane and ``has_remote`` for
    every lane and every draw: all remainders of each row's total, and
    large draws (the clip to W - 1 included)."""
    from repro_torch.core import dlb, topology as topology_mod
    zsz = topology_mod.resolve(topology).zone_size_for(n_w)
    case = scheduler.make_case(MODE_SPECS["na_ws"], n_w, zsz,
                               topology=topology)
    topo = case.topo
    me = torch.arange(W, dtype=torch.int32)
    rows = _domain_rows(W, n_w, zsz, topo)
    nd = int(topo.n_domains)
    rs = np.random.default_rng(W)
    for t, restrict in enumerate((None, "node_local", "node_remote")):
        cum, total = dlb.remote_weight_table(me, n_w, zsz, topo,
                                             restrict=restrict)
        span = int(total.max()) + 2
        draws = list(range(span)) + rs.integers(0, 2**31, 32).tolist()
        for draw in draws:
            want, has = dlb._remote_weighted(
                torch.full((W,), draw, dtype=torch.int32), cum, total)
            for m in range(W):
                got = _row_pick(rows[min(m // zsz, nd - 1), t], draw)
                assert got == (int(want[m]), bool(has[m])), \
                    (topology, restrict, m, draw)


def test_step_args_pack_as_the_ctypes_record():
    """The wrapper packs ``StepArgs`` in one ``struct.pack``; the bytes are
    those of the ctypes record built field by field."""
    n_ptr = len(ss._STATE) + len(ss._GRAPH) + len(ss._CASE)
    vals = ([0x7F0000000000 + 64 * i for i in range(n_ptr)]
            + [-3 + 7 * i for i in range(len(ss._INTS))]
            + [0.1 * (i + 1) for i in range(len(ss._FLOATS))])
    packed = ss.StepArgs.from_buffer_copy(ss._ARGS.pack(*vals)
                                          + ss._ARGS_PAD)
    assert bytes(packed) == bytes(ss.StepArgs(*vals))


def test_step_split_instruments_the_kernel_source():
    """``repro_torch.step_split`` finds every phase of the fused kernel's
    step loop and the victim phase's two barriers in the source."""
    from repro_torch import step_split
    src = step_split.instrument(ss.SOURCE.read_text())
    assert src.count("PSTAMP(") == 9           # the macro and 8 stamps
    assert "g_prof[9]" in src and "g_prof[10]" in src
    assert 'int ss_prof(' in src
