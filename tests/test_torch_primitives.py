"""Parity of the port's queue, messaging and DLB primitives with the JAX
package, bitwise, on random inputs made from a numpy seed.

The inputs cover the corners the phases reach: duplicate victims (racy
request overwrites), full and empty queues, padded lanes (``n_active <
W``), victims past the last lane, and flat, NUMA and cluster topologies
(native and bandwidth-starved fabrics).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import dlb as j_dlb  # noqa: E402
from repro.core import messaging as j_msg  # noqa: E402
from repro.core import topology as j_topo  # noqa: E402
from repro.core import xqueue as j_xq  # noqa: E402
from repro_torch.core import dlb as t_dlb  # noqa: E402
from repro_torch.core import messaging as t_msg  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402
from repro_torch.core import xqueue as t_xq  # noqa: E402
from repro_torch.core.state import WS_CAP, to_numpy  # noqa: E402

W, Q = 8, 4
#: the JAX transfer compiled once per variant (eager dispatch of its ~100
#: ops is what would dominate this file's time otherwise)
J_WS_TRANSFER = jax.jit(j_dlb.ws_transfer, static_argnums=(7,))


def T(x, dtype=None):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy(), dtype=dtype)


def J(x):
    return jnp.asarray(np.asarray(x))


def same(a, b, label):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    assert a.shape == b.shape, (label, a.shape, b.shape)
    assert np.array_equal(a.astype(b.dtype), b), (label, a, b)


def same_tree(t_tree, j_tree, label):
    t_np, j_np = to_numpy(t_tree), to_numpy(j_tree)
    assert t_np.keys() == j_np.keys(), label
    for k in j_np:
        same(t_np[k], j_np[k], (label, k))


def random_xq(rs, full_bias=0.3):
    head = rs.integers(0, 40, (W, W)).astype(np.int32)
    size = rs.integers(0, Q + 1, (W, W)).astype(np.int32)
    size = np.where(rs.random((W, W)) < full_bias, Q, size).astype(np.int32)
    buf = rs.integers(-1, 60, (W, W, Q)).astype(np.int32)
    ts = rs.integers(0, 10_000, (W, W, Q)).astype(np.int32)
    arrs = dict(buf=buf, ts=ts, head=head, tail=head + size)
    return (t_xq.XQ(**{k: T(v) for k, v in arrs.items()}),
            j_xq.XQ(**{k: J(v) for k, v in arrs.items()}))


TOPOLOGIES = [None, "flat", "quad_socket_48", "two_node_2x24",
              "two_node_2x24@bw4", "rack_4x2x24"]


def topo_pair(name):
    """(port TopoArrays, JAX TopoArrays, zone-size rule) for a topology
    label; ``None`` is the degenerate flat machine."""
    if name is None:
        return (t_topo.degenerate_arrays(), j_topo.degenerate_arrays(),
                lambda n: max(n // 2, 1))
    if name == "flat":
        t = t_topo.MachineTopology.flat(4)
        j = j_topo.MachineTopology.flat(4)
    elif name.endswith("@bw4"):
        base = name.split("@")[0]
        t = t_topo.PRESETS[base].with_bandwidth(4)
        j = j_topo.PRESETS[base].with_bandwidth(4)
    else:
        t, j = t_topo.PRESETS[name], j_topo.PRESETS[name]
    return t.arrays(), j.arrays(), t.zone_size_for


@pytest.mark.parametrize("seed", range(6))
def test_push_matches_jax(seed):
    rs = np.random.default_rng(seed)
    t_q, j_q = random_xq(rs)
    n_active = int(rs.integers(1, W + 1))
    producer = np.arange(W, dtype=np.int32)
    consumer = rs.integers(0, n_active, W).astype(np.int32)
    task = rs.integers(0, 60, W).astype(np.int32)
    ts = rs.integers(0, 10_000, W).astype(np.int32)
    mask = (rs.random(W) < 0.7) & (producer < n_active)
    t_out, t_ok = t_xq.push(t_q, T(producer), T(consumer), T(task), T(ts),
                            T(mask))
    j_out, j_ok = j_xq.push(j_q, J(producer), J(consumer), J(task), J(ts),
                            J(mask))
    same_tree(t_out, j_out, ("push", seed))
    same(t_ok, j_ok, ("push ok", seed))
    # the inputs were not written (the plain versions are functional)
    same(t_q.tail, np.asarray(j_q.tail), "push input")


#: ids outside [0, W) that a push lane may carry: (which id, value)
BAD_IDS = [("consumer", -1), ("consumer", W), ("consumer", -W - 1),
           ("consumer", 2 * W), ("producer", -1), ("producer", W)]


def bad_push(rs, which, value, fill, owner_active=True):
    """A push whose lane 1 (consumer case) or lane 0 (producer case)
    carries an id outside [0, W), on random queues whose row that lane's
    ``ok`` reads is all full or all empty.  In the producer case every
    lane pushes to consumer 1, and lane W - 1 (the owner of the column a
    producer of -1 wraps to) is active or not."""
    q = {k: v.numpy().copy() for k, v in random_xq(rs)[0]._asdict().items()}
    producer = np.arange(W, dtype=np.int32)
    consumer = rs.integers(0, W, W).astype(np.int32)
    mask = np.ones(W, bool)
    if which == "consumer":
        consumer[1] = value
        row = min(max(value + W if value < 0 else value, 0), W - 1)
    else:
        producer[0] = value
        consumer[:] = 1
        mask[W - 1] = owner_active
        row = 1
    q["tail"][row] = q["head"][row] + (Q if fill == "full" else 0)
    lanes = (producer, consumer, rs.integers(0, 60, W).astype(np.int32),
             rs.integers(0, 10_000, W).astype(np.int32), mask)
    return q, lanes


@pytest.mark.parametrize("fill", ("full", "empty"))
@pytest.mark.parametrize("which,value", BAD_IDS)
def test_push_with_ids_outside_the_width_matches_jax(which, value, fill):
    """A lane whose consumer or producer lies outside [0, W): the port's
    push equals the reference's bitwise, ``ok`` and the queues (the
    reference wraps a negative id once and clamps its gathers, drops its
    scatter's ids outside [-W, W), and writes no consumer outside [0,
    W))."""
    rs = np.random.default_rng(700 + W + value)
    for owner_active in ((True, False) if which == "producer" else (True,)):
        q, lanes = bad_push(rs, which, value, fill, owner_active)
        t_out, t_ok = t_xq.push(t_xq.XQ(**{k: T(v) for k, v in q.items()}),
                                *map(T, lanes))
        j_out, j_ok = j_xq.push(j_xq.XQ(**{k: J(v) for k, v in q.items()}),
                                *map(J, lanes))
        label = (which, value, fill, owner_active)
        same_tree(t_out, j_out, label)
        same(t_ok, j_ok, ("ok", *label))


@pytest.mark.parametrize("seed", range(6))
def test_pop_scan_matches_jax(seed):
    rs = np.random.default_rng(100 + seed)
    t_q, j_q = random_xq(rs, full_bias=0.0)
    # empty about half the queues so the scan has to walk
    empty = rs.random((W, W)) < 0.6
    tail = np.where(empty, np.asarray(j_q.head), np.asarray(j_q.tail))
    t_q = t_q._replace(tail=T(tail))
    j_q = j_q._replace(tail=J(tail))
    n_active = int(rs.integers(1, W + 1))
    rot = rs.integers(0, 50, W).astype(np.int32)
    mask = (rs.random(W) < 0.8) & (np.arange(W) < n_active)
    t_out = t_xq.pop_first(t_q, T(rot), T(mask), T(np.int32(n_active)))
    j_out = j_xq.pop_first(j_q, J(rot), J(mask), jnp.int32(n_active))
    same_tree(t_out[0], j_out[0], ("pop xq", seed))
    for k, (a, b) in enumerate(zip(t_out[1:], j_out[1:])):
        same(a, b, ("pop", seed, k))
    me = np.arange(W, dtype=np.int32)
    for n in (1, 2, n_active, W):
        na = T(np.int32(n))
        same(t_xq.scan_pos(W, T(me), T(rot), na),
             j_xq.scan_pos(W, J(me), J(rot), jnp.int32(n)), ("scan_pos", n))
        to, tv = t_xq._scan_order(W, T(me), T(rot), na)
        jo, jv = j_xq._scan_order(W, J(me), J(rot), jnp.int32(n))
        same(to, jo, ("scan_order", n))
        same(tv, jv, ("scan_valid", n))


@pytest.mark.parametrize("seed", range(6))
def test_thief_send_duplicate_victims(seed):
    rs = np.random.default_rng(200 + seed)
    rounds = rs.integers(1, 6, W).astype(np.int32)
    req_round = rs.integers(0, 6, W).astype(np.int32)
    req_tid = rs.integers(-1, W, W).astype(np.int32)
    # few distinct victims -> many duplicate writes; W is past the end
    victim = rs.choice(np.array([1, 3, W], np.int32), W)
    mask = rs.random(W) < 0.8
    thief = np.arange(W, dtype=np.int32)
    t_c, t_sent = t_msg.thief_send(
        t_msg.Cells(T(rounds), T(req_round), T(req_tid)), T(thief),
        T(victim), T(mask))
    j_c, j_sent = j_msg.thief_send(
        j_msg.Cells(J(rounds), J(req_round), J(req_tid)), J(thief),
        J(victim), J(mask))
    same_tree(t_c, j_c, ("thief_send", seed))
    same(t_sent, j_sent, ("sent", seed))
    same(t_msg.victim_valid(t_c), j_msg.victim_valid(j_c), "valid")
    h = rs.random(W) < 0.5
    same_tree(t_msg.victim_advance(t_c, T(h)),
              j_msg.victim_advance(j_c, J(h)), "advance")


def test_xorshift_uniform_match_jax():
    rs = np.random.default_rng(7)
    s = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    s[:3] = (1, 0xFFFFFFFF, 0x80000000)
    t_s, j_s = T(s), J(s)
    for _ in range(3):
        t_s, j_s = t_dlb.xorshift(t_s), j_dlb.xorshift(j_s)
        same(t_s, j_s, "xorshift")
        same(t_dlb.uniform(t_s), j_dlb.uniform(j_s), "uniform")


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("n_workers", (3, 5, 8))
def test_pick_victim_matches_jax(topo, n_workers):
    t_t, j_t, zone_for = topo_pair(topo)
    zone = zone_for(n_workers)
    rs = np.random.default_rng(n_workers)
    me = np.arange(W, dtype=np.int32)
    rng = rs.integers(1, 2**32, W, dtype=np.uint64).astype(np.uint32)
    t_rng, j_rng = T(rng), J(rng)
    for restrict in (None, "node_local", "node_remote"):
        tables = (
            t_dlb.remote_weight_table(T(me), T(np.int32(n_workers)),
                                      T(np.int32(zone)), t_t, restrict),
            j_dlb.remote_weight_table(J(me), jnp.int32(n_workers),
                                      jnp.int32(zone), j_t, restrict))
        for a, b in zip(*tables):
            same(a, b, ("weights", topo, restrict))
    for p_local in (0.0, 0.7, 1.0):
        pl = np.float32(p_local)
        for _ in range(4):
            t_rng, t_v = t_dlb.pick_victim(
                t_rng, T(me), T(np.int32(n_workers)), T(np.int32(zone)),
                T(pl), t_t, p_local_node=T(np.float32(0.75)))
            j_rng, j_v = j_dlb.pick_victim(
                j_rng, J(me), jnp.int32(n_workers), jnp.int32(zone),
                jnp.float32(pl), j_t, p_local_node=jnp.float32(0.75))
            same(t_rng, j_rng, ("rng", topo, p_local))
            same(t_v, j_v, ("victim", topo, p_local))
        # the topology-free (legacy) path
        t_rng, t_v = t_dlb.pick_victim(t_rng, T(me), n_workers, zone, T(pl))
        j_rng, j_v = j_dlb.pick_victim(j_rng, J(me), n_workers, zone,
                                       jnp.float32(pl))
        same(t_v, j_v, ("victim no topo", topo, p_local))


def test_rp_adopt_matches_jax():
    rs = np.random.default_rng(11)
    tgt = rs.integers(-1, W, W).astype(np.int32)
    left = rs.integers(0, 9, W).astype(np.int32)
    thief = rs.integers(0, W, W).astype(np.int32)
    valid = rs.random(W) < 0.6
    t_rp, t_a = t_dlb.rp_adopt(t_dlb.RPState(T(tgt), T(left)), T(thief),
                               T(np.int32(8)), T(valid))
    j_rp, j_a = j_dlb.rp_adopt(j_dlb.RPState(J(tgt), J(left)), J(thief),
                               jnp.int32(8), J(valid))
    same_tree(t_rp, j_rp, "rp_adopt")
    same(t_a, j_a, "adopted")
    same_tree(t_dlb.rp_make(W), j_dlb.rp_make(W), "rp_make")


@pytest.mark.parametrize("seed", range(8))
def test_ws_transfer_matches_jax(seed):
    rs = np.random.default_rng(300 + seed)
    t_q, j_q = random_xq(rs)
    n_active = int(rs.integers(2, W + 1))
    me = np.arange(W)
    thief = ((me + rs.integers(1, n_active, W)) % n_active).astype(np.int32)
    victim_mask = (rs.random(W) < 0.6) & (me < n_active)
    # one victim per thief at most (the messaging cells guarantee it)
    _, first = np.unique(np.where(victim_mask, thief, -1 - me),
                         return_index=True)
    keep = np.zeros(W, bool)
    keep[first] = True
    victim_mask &= keep
    clock = rs.integers(0, 5000, W).astype(np.int32)
    comm = rs.integers(2, 200, W).astype(np.int32)
    deq_rr = rs.integers(0, 30, W).astype(np.int32)
    payload = rs.integers(0, 4000, 60).astype(np.int32)
    xfer_bw = np.where(rs.random(W) < 0.5, 0,
                       rs.integers(1, 64, W)).astype(np.int32)
    n_steal = int(rs.integers(1, 10))
    args_t = (T(victim_mask), T(thief), T(np.int32(n_steal)), T(clock),
              T(comm), T(deq_rr), WS_CAP, T(np.int32(n_active)))
    args_j = (J(victim_mask), J(thief), jnp.int32(n_steal), J(clock),
              J(comm), J(deq_rr), WS_CAP, jnp.int32(n_active))
    for priced in (False, True):
        kw_t = dict(payload=T(payload), xfer_bw=T(xfer_bw)) if priced else {}
        kw_j = dict(payload=J(payload), xfer_bw=J(xfer_bw)) if priced else {}
        t_out = t_dlb.ws_transfer(t_q, *args_t, **kw_t)
        j_out = J_WS_TRANSFER(j_q, *args_j, **kw_j)
        same_tree(t_out[0], j_out[0], ("ws xq", seed, priced))
        for k, (a, b) in enumerate(zip(t_out[1:], j_out[1:])):
            same(a, b, ("ws", seed, priced, k))
    # no victim at all: the one-shot transfer is skipped, state unchanged
    none_t = t_dlb.ws_transfer(t_q, T(np.zeros(W, bool)), *args_t[1:])
    none_j = j_dlb.ws_transfer(j_q, J(np.zeros(W, bool)), *args_j[1:])
    same_tree(none_t[0], none_j[0], "ws idle")
    for a, b in zip(none_t[1:], none_j[1:]):
        same(a, b, "ws idle")


# ---------------- the rest of the core's public names ----------------
#: (thief id, round) at the edges of the 24-bit id and the 40-bit round,
#: and rounds past 40 bits (masked on packing)
PACK_CASES = [(0, 0), (0, 1), (1, 0), (23, 5), (2 ** 24 - 1, 2 ** 40 - 1),
              (2 ** 24 - 1, 0), (0, 2 ** 40 - 1), (5, 2 ** 40),
              (7, 2 ** 40 + 3), (2 ** 23, 2 ** 39)]


@pytest.mark.parametrize("tid, rnd", PACK_CASES)
def test_pack_and_unpack_match_jax(tid, rnd):
    assert t_msg.ROUND_BITS == j_msg.ROUND_BITS == 40
    req = t_msg.pack(tid, rnd)
    assert type(req) is int and req == j_msg.pack(tid, rnd)
    assert t_msg.unpack(req) == j_msg.unpack(req)
    assert t_msg.unpack(req) == (tid, rnd & (2 ** 40 - 1))


@pytest.mark.parametrize("seed", range(3))
def test_sizes_and_zone_of_match_jax(seed):
    rs = np.random.default_rng(700 + seed)
    t_q, j_q = random_xq(rs)
    same(t_xq.sizes(t_q), j_xq.sizes(j_q), ("sizes", seed))
    # the roundtrip of tests/test_xqueue.py: one push to every master queue
    me = np.arange(W, dtype=np.int32)
    t_q, _ = t_xq.push(t_xq.make(W, Q), T(me), T(me), T(me * 10), T(me * 0),
                       T(np.ones(W, bool)))
    assert np.array_equal(t_xq.sizes(t_q).numpy().diagonal(), np.ones(W))
    ids = rs.integers(0, 200, 64).astype(np.int32)
    for zs in (1, 2, 3, 6, 8, 24):
        same(t_dlb.zone_of(T(ids), zs), j_dlb.zone_of(J(ids), zs),
             ("zone_of", zs))


def test_episode_arrays_and_tree_gathered_match_jax():
    from repro.core import barrier as j_bar
    from repro.core.spec import LATTICE
    from repro_torch.core import barrier as t_bar
    from repro_torch.core.state import SimConfig

    costs = SimConfig().costs
    # tests/test_sweep.py's parity grid, against the JAX selector and the
    # port's own host-side episodes
    for spec in LATTICE:
        for w in (1, 8, 16, 48, 64):
            got = t_bar.episode_arrays(torch.tensor(spec.barrier_id,
                                                    dtype=torch.int32),
                                       torch.tensor(w, dtype=torch.int32),
                                       costs)
            want = j_bar.episode_arrays(jnp.int32(spec.barrier_id),
                                        jnp.int32(w), costs)
            host = (t_bar.centralized_episode(w, costs)
                    if spec.barrier == "centralized_count"
                    else t_bar.tree_episode(w, costs))
            for k in ("time_ns", "atomic_ops"):
                assert getattr(got, k).dtype == torch.int32
                same(getattr(got, k), getattr(want, k), (spec, w, k))
                assert int(getattr(got, k)) == int(getattr(host, k))
    # vectors of ids and widths, as an in-graph consumer would pass them
    bid = np.array([0, 1, 1, 0, 1], np.int32)
    nw = np.array([2, 3, 5, 17, 200], np.int32)
    got = t_bar.episode_arrays(T(bid), T(nw), costs)
    want = j_bar.episode_arrays(J(bid), J(nw), costs)
    same(got.time_ns, want.time_ns, "episode vectors")
    same(got.atomic_ops, want.atomic_ops, "episode vectors")
    # tests/test_barrier.py's gather cases, then random idle sets
    cases = [(8, np.ones(8, bool)), (8, np.arange(8) != 7),
             (8, np.arange(8) != 5)]
    rs = np.random.default_rng(11)
    cases += [(w, rs.random(w) < 0.85) for w in (1, 2, 3, 7, 16, 33)]
    for w, idle in cases:
        same(t_bar.tree_gathered(T(idle), w),
             j_bar.tree_gathered(J(idle), w), ("gathered", w))
    g = t_bar.tree_gathered(T(np.arange(8) != 5), 8)
    assert not bool(g[2]) and not bool(g[0]) and bool(g[1])


def test_spec_plan_scheduler_phase_and_registry_names_match_jax():
    from repro.core import phases as j_ph
    from repro.core import plan as j_plan
    from repro.core import scheduler as j_sch
    from repro.core import spec as j_spec
    from repro.core import taskgraph as j_tg
    from repro_torch.core import phases as t_ph
    from repro_torch.core import plan as t_plan
    from repro_torch.core import scheduler as t_sch
    from repro_torch.core import spec as t_spec
    from repro_torch.core import taskgraph as t_tg

    assert t_spec.SLB_SPEC.asdict() == j_spec.SLB_SPEC.asdict()
    assert t_spec.SLB_SPEC.slug == j_spec.SLB_SPEC.slug == "xqueue-tree-static_rr"
    for bal in t_spec.DLB_BALANCERS:
        assert t_spec.dlb_spec(bal).asdict() == j_spec.dlb_spec(bal).asdict()
    for bad in ("static_rr", "na_xx"):
        with pytest.raises(AssertionError):
            t_spec.dlb_spec(bad)
    assert t_sch.MODES == j_sch.MODES
    assert t_sch.MODE_ID == j_sch.MODE_ID
    assert t_plan.DLB_MODES == j_plan.DLB_MODES
    assert t_ph.PHASES == j_ph.PHASES
    assert all(callable(getattr(t_ph, name)) for name in t_ph.PHASES)
    assert t_tg.BOTS_APPS == j_tg.BOTS_APPS
    assert list(t_tg.BUILDERS) == list(j_tg.BUILDERS)
    assert t_tg.BUILDERS is t_tg.GENERATORS
    # the same graphs at a tiny size (the apps registry's tiny presets)
    from repro import apps as j_apps
    for name in t_tg.BUILDERS:
        kw = j_apps.get(name).kwargs("tiny")
        a, b = t_tg.BUILDERS[name](**kw), j_tg.BUILDERS[name](**kw)
        assert a.name == b.name, name
        for f in ("dur", "first_child", "n_children", "notify", "join_dep"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), (name, f)
