"""Every phase of the port's step against the JAX package's, bitwise, on
all 12 lattice points and three machines (the flat machine with padded
lanes, ``quad_socket_48``, and the ``two_node_2x24`` cluster with task
payloads).

Mid-run states come from the JAX package (a few composed reference steps
from a fresh state), are carried across with
:func:`repro_torch.core.state.from_numpy`, and each phase then runs on
both sides from the same input.  The port runs under both step backends:
``reference`` and ``cuda`` (whose wrappers take the plain path on CPU
tensors after the CUDA path's argument checks).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import phases as j_ph  # noqa: E402
from repro.core import state as j_st  # noqa: E402
from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core.costs import DEFAULT_COSTS  # noqa: E402
from repro.core.spec import LATTICE  # noqa: E402
from repro.core.spec import MODE_SPECS as J_MODES  # noqa: E402
from repro_torch.core import backends as t_be  # noqa: E402
from repro_torch.core import phases as t_ph  # noqa: E402
from repro_torch.core.state import (GraphArrays, SimState,  # noqa: E402
                                    SweepCase, from_numpy, to_numpy)

W, S, Q = 8, 64, 4
MAX_STEPS = 60_000
C = DEFAULT_COSTS
#: machine -> (topology, active workers, graph).  The flat machine runs a
#: single-creator bag (``align``) whose creator's own master queue fills,
#: so the execute-immediately rule and NA-RP's target-full stop fire.
MACHINES = {"flat": (None, 5, "align"),
            "quad_socket_48": ("quad_socket_48", 8, "fib"),
            "two_node_2x24": ("two_node_2x24", 8, "fib+payload")}


#: every graph pads to one length and every case gets the same global-queue
#: capacity, so each JAX phase compiles once for all cases
T_PAD = 100   # fib(8) has 100 tasks, align(12) 68


@functools.lru_cache(maxsize=None)
def j_graph(kind: str):
    if kind == "align":
        g = j_tg.align(12)
    else:
        g = j_tg.fib(8)
        g = g.with_payload(16.0) if kind != "fib" else g
    return j_st.graph_arrays(g, pad_to=T_PAD)


@jax.jit
def j_advance(st, g, case, k):
    def body(c):
        return c[0] + 1, j_ph.step_pipeline(c[1], g=g, case=case, costs=C,
                                            max_steps=MAX_STEPS)
    return jax.lax.while_loop(lambda c: c[0] < k, body, (jnp.int32(0), st))[1]


J = {
    "gate": jax.jit(lambda st, g: j_ph.run_gate(st, g, MAX_STEPS)),
    "adopt": jax.jit(lambda st, r, g, case: j_ph.adopt_phase(
        st, r, case=case, costs=C)),
    "spawn": jax.jit(lambda st, r, g, case: j_ph.spawn_phase(
        st, r, g=g, case=case, costs=C)),
    "dequeue": jax.jit(lambda st, r, g, case: j_ph.dequeue_phase(
        st, r, g=g, case=case, costs=C)),
    "thief": jax.jit(lambda st, found, r, case: j_ph.thief_phase(
        st, found, r, case=case, costs=C)),
    "victim": jax.jit(lambda st, found, g, case: j_ph.victim_phase(
        st, found, g=g, case=case, costs=C)),
    "exec": jax.jit(lambda st, task, ts, found, g, case: j_ph.exec_phase(
        st, task, ts, found, g=g, case=case, costs=C)),
    "step": jax.jit(lambda st, g, case: j_ph.step_pipeline(
        st, g=g, case=case, costs=C, max_steps=MAX_STEPS)),
}


@functools.lru_cache(maxsize=None)
def mid_run(spec, machine, seed, k):
    topology, n_workers, kind = MACHINES[machine]
    g = j_graph(kind)
    zone = (j_st.topology_mod.resolve(topology).zone_size_for(n_workers)
            if topology else max(n_workers // 2, 1))
    case = j_st.make_case(spec, n_workers, zone, seed=seed, mem_bound=0.3,
                          params=j_st.make_params(n_victim=2, n_steal=4,
                                                  t_interval=5,
                                                  p_local=0.7),
                          topology=topology)
    st = j_st.init_state(g, W, S, Q, T_PAD + 2, case.seed)
    return j_advance(st, g, case, jnp.int32(k)), g, case


def to_port(tree, cls):
    return from_numpy(to_numpy(tree), cls)


def assert_same(t_tree, j_tree, label):
    a, b = to_numpy(t_tree), to_numpy(j_tree)
    assert a.keys() == b.keys(), label
    for k in b:
        assert a[k].dtype == b[k].dtype, (label, k, a[k].dtype, b[k].dtype)
        assert np.array_equal(a[k], b[k]), (label, k)


def t_vec(x):
    return torch.as_tensor(np.asarray(x).copy())


CASES = [(spec, machine, seed,
          13 + i % 6 if machine == "flat" else 3 + (3 * i + seed) % 10)
         for i, spec in enumerate(LATTICE)
         for seed, machine in enumerate(MACHINES)]


@pytest.mark.parametrize("backend", ("reference", "cuda"))
@pytest.mark.parametrize(
    "spec,machine,seed,k", CASES,
    ids=[f"{s.slug}-{m}-k{k}" for s, m, _, k in CASES])
def test_every_phase_matches_jax(spec, machine, seed, k, backend):
    ops = t_be.step_ops(backend)
    st, g, case = mid_run(spec, machine, seed, k)
    tg, tcase = to_port(g, GraphArrays), to_port(case, SweepCase)
    running = J["gate"](st, g)
    t_run = t_ph.run_gate(to_port(st, SimState), tg, MAX_STEPS)
    assert bool(t_run) == bool(running)
    tr = torch.tensor(bool(running))
    kw = dict(case=tcase, costs=C, ops=ops)
    label = (spec.slug, machine, k, backend)

    out = J["adopt"](st, running, g, case)
    assert_same(t_ph.adopt_phase(to_port(st, SimState), tr, **kw), out,
                (*label, "adopt"))
    st = out
    out = J["spawn"](st, running, g, case)
    assert_same(t_ph.spawn_phase(to_port(st, SimState), tr, g=tg, **kw),
                out, (*label, "spawn"))
    st = out
    j_st_, task, ts, found = J["dequeue"](st, running, g, case)
    t_st_, t_task, t_ts, t_found = t_ph.dequeue_phase(
        to_port(st, SimState), tr, g=tg, **kw)
    assert_same(t_st_, j_st_, (*label, "dequeue"))
    for a, b in ((t_task, task), (t_ts, ts), (t_found, found)):
        assert np.array_equal(a.numpy(), np.asarray(b)), (*label, "deq out")
    st = j_st_
    out = J["thief"](st, found, running, case)
    assert_same(t_ph.thief_phase(to_port(st, SimState), t_vec(found), tr,
                                 **kw), out, (*label, "thief"))
    st = out
    out = J["victim"](st, found, g, case)
    assert_same(t_ph.victim_phase(to_port(st, SimState), t_vec(found), g=tg,
                                  **kw), out, (*label, "victim"))
    st = out
    out = J["exec"](st, task, ts, found, g, case)
    assert_same(t_ph.exec_phase(to_port(st, SimState), t_vec(task),
                                t_vec(ts), t_vec(found), g=tg, **kw),
                out, (*label, "exec"))
    # and one whole composed step from the same starting point (the JAX
    # arrays are immutable, so the cached state is still the start)
    st0, _, _ = mid_run(spec, machine, seed, k)
    assert_same(t_ph.step_pipeline(to_port(st0, SimState), g=tg, case=tcase,
                                   costs=C, ops=ops, max_steps=MAX_STEPS),
                J["step"](st0, g, case), (*label, "step"))


@pytest.mark.parametrize("mode", ("na_ws", "na_rp"))
def test_batched_bumps_step_equals_jax_on_numa(mode):
    """Steps of the port's phases on ``quad_socket_48`` through the
    ``cuda`` ops (their CPU path), every ``ctr_add`` call counted: each run
    of bumps is one call (at most 8 a step, 10 with the
    execute-immediately rule), the 36 bumps of a step are all there, and
    the state equals the JAX package's ``step_pipeline`` (one bump a
    call), bitwise."""
    base = t_be.step_ops("cuda")
    calls = []

    def counted(ctr, col_or_pairs, val=None):
        calls.append(len(t_ph.ctr_pairs(col_or_pairs, val)))
        return base.ctr_add(ctr, col_or_pairs, val)

    ops = base._replace(ctr_add=counted)
    for k in (3, 6, 9):
        st, g, case = mid_run(J_MODES[mode], "quad_socket_48", 1, k)
        calls.clear()
        got = t_ph.step_pipeline(to_port(st, SimState),
                                 g=to_port(g, GraphArrays),
                                 case=to_port(case, SweepCase), costs=C,
                                 ops=ops, max_steps=MAX_STEPS)
        assert_same(got, J["step"](st, g, case), (mode, k))
        assert len(calls) <= 10 and sum(calls) >= 36, (mode, k, calls)
