"""The port's ``run_grid`` against the JAX package's, bitwise: the whole
12-point lattice × flat / ``quad_socket_48`` / ``two_node_2x24`` (with task
payloads, so the cluster tier's link pricing and bottleneck run) at smoke
scale (``fib(7)``, 8 workers), 36 cases, with the same axis labels.  The
tolerance is zero differences."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import sweep as j_sweep  # noqa: E402
from repro.core import taskgraph as j_tg  # noqa: E402
from repro.core.scheduler import SimConfig as JConfig  # noqa: E402
from repro_torch.core import sweep  # noqa: E402
from repro_torch.core import taskgraph as t_tg  # noqa: E402
from repro_torch.core.spec import BALANCERS, BARRIERS, QUEUES  # noqa: E402
from repro_torch.core.state import CTR_NAMES, SimConfig  # noqa: E402

SLO = ("p50_ns", "p90_ns", "p99_ns", "throughput")


GRID = dict(queues=QUEUES, barriers=BARRIERS, balancers=BALANCERS,
            topologies=(None, "quad_socket_48", "two_node_2x24"),
            n_workers=(8,), t_interval=(10,), p_local=(0.8,))


def test_run_grid_matches_jax_on_lattice_and_machines():
    """All 12 lattice points × 3 machines (36 cases) at smoke scale."""
    cfg_kw = dict(n_workers=8, n_zones=2, max_steps=60_000)
    j_res = j_sweep.run_grid([j_tg.fib(7).with_payload(8.0)],
                             cfg=JConfig(**cfg_kw), strategy="batched",
                             **GRID)
    t_res = sweep.run_grid([t_tg.fib(7).with_payload(8.0)],
                           cfg=SimConfig(**cfg_kw), strategy="batched",
                           device="cpu", **GRID)
    assert t_res.grid_axes == j_res.grid_axes
    assert t_res.makespans.shape == j_res.makespans.shape
    assert t_res.completed.all()
    for a, b in ((t_res.time_ns, j_res.time_ns), (t_res.steps, j_res.steps),
                 (t_res.completed, j_res.completed)):
        assert np.array_equal(a, b)
    for n in SLO:
        assert np.array_equal(getattr(t_res, n), getattr(j_res, n)), n
    for name in CTR_NAMES:
        assert np.array_equal(t_res.counter(name), j_res.counter(name))
    # the cluster machine really moved bytes over the bottleneck
    assert t_res.counters["xnode_bytes"].sum() > 0
