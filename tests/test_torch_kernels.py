"""The port's queue kernels (``repro_torch.kernels.sched_queue``) against
the JAX package's Pallas kernels (``repro.kernels.sched_queue``, run in
interpret mode on the CPU), bitwise.

On CPU tensors each wrapper runs its plain PyTorch twin after the same
argument checks the CUDA path makes; ``tests/test_torch_gpu.py`` holds the
CUDA kernels against the twins on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import xqueue as j_xq  # noqa: E402
from repro.kernels import sched_queue as j_sq  # noqa: E402
from repro_torch.core import phases as t_ph  # noqa: E402
from repro_torch.core import xqueue as t_xq  # noqa: E402
from repro_torch.core.state import to_numpy  # noqa: E402
from repro_torch.kernels import registry as t_reg  # noqa: E402
from repro_torch.kernels import sched_queue as t_sq  # noqa: E402

W, Q, NC = 8, 4, 18


def queues(rs):
    head = rs.integers(0, 40, (W, W)).astype(np.int32)
    size = rs.integers(0, Q + 1, (W, W)).astype(np.int32)
    size = np.where(rs.random((W, W)) < 0.5, 0, size).astype(np.int32)
    return dict(buf=rs.integers(-1, 99, (W, W, Q)).astype(np.int32),
                ts=rs.integers(0, 9999, (W, W, Q)).astype(np.int32),
                head=head, tail=(head + size).astype(np.int32))


def tq(d):
    return t_xq.XQ(**{k: torch.as_tensor(v.copy()) for k, v in d.items()})


def jq(d):
    return j_xq.XQ(**{k: jnp.asarray(v) for k, v in d.items()})


def eq(a, b, label):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert np.array_equal(a, np.asarray(b)), label


@pytest.mark.parametrize("seed", range(4))
def test_ctr_add_matches_pallas(seed):
    rs = np.random.default_rng(seed)
    ctr = rs.integers(-50, 50, (W, NC)).astype(np.int32)
    val = rs.integers(-9, 9, W).astype(np.int32)
    for col in (0, 7, NC - 1):
        out = t_sq.ctr_add(torch.as_tensor(ctr), col, torch.as_tensor(val))
        eq(out, j_sq.ctr_add(jnp.asarray(ctr), col, jnp.asarray(val)),
           ("ctr_add", seed, col))


@pytest.mark.parametrize("seed", range(4))
def test_push_matches_pallas(seed):
    rs = np.random.default_rng(10 + seed)
    d = queues(rs)
    n_active = int(rs.integers(1, W + 1))
    producer = np.arange(W, dtype=np.int32)
    consumer = rs.integers(0, n_active, W).astype(np.int32)
    task = rs.integers(0, 99, W).astype(np.int32)
    ts = rs.integers(0, 9999, W).astype(np.int32)
    mask = (rs.random(W) < 0.8) & (producer < n_active)
    lanes = [producer, consumer, task, ts, mask]
    t_out, t_ok = t_sq.push(tq(d), *map(torch.as_tensor, lanes))
    j_out, j_ok = j_sq.push(jq(d), *map(jnp.asarray, lanes))
    for k, v in to_numpy(j_out).items():
        eq(to_numpy(t_out)[k], v, ("push", seed, k))
    eq(t_ok, j_ok, ("push ok", seed))


@pytest.mark.parametrize("seed", range(4))
def test_pop_first_matches_pallas(seed):
    rs = np.random.default_rng(20 + seed)
    d = queues(rs)
    n_active = int(rs.integers(1, W + 1))
    rot = rs.integers(0, 40, W).astype(np.int32)
    mask = (rs.random(W) < 0.8) & (np.arange(W) < n_active)
    t_out = t_sq.pop_first(tq(d), torch.as_tensor(rot),
                           torch.as_tensor(mask),
                           torch.tensor(n_active, dtype=torch.int32))
    j_out = j_sq.pop_first(jq(d), jnp.asarray(rot), jnp.asarray(mask),
                           jnp.int32(n_active))
    for k, v in to_numpy(j_out[0]).items():
        eq(to_numpy(t_out[0])[k], v, ("pop xq", seed, k))
    for i, (a, b) in enumerate(zip(t_out[1:], j_out[1:])):
        eq(a, b, ("pop", seed, i))


def test_cpu_wrappers_check_arguments_and_never_count():
    t_reg.reset_launches()
    rs = np.random.default_rng(0)
    ctr = torch.zeros((W, NC), dtype=torch.int32)
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, 0, torch.zeros(W, dtype=torch.int64))
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr, 0, torch.zeros(W + 1, dtype=torch.int32))
    with pytest.raises(IndexError):
        t_sq.ctr_add(ctr, NC, torch.zeros(W, dtype=torch.int32))
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr.t().contiguous().t(), 0,
                     torch.zeros(W, dtype=torch.int32))
    q = tq(queues(rs))
    lane = torch.zeros(W, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_sq.push(q, lane, lane, lane, lane, lane)        # int mask
    with pytest.raises(ValueError):
        t_sq.pop_first(q, lane, lane.bool(), torch.tensor([W]).int())
    t_sq.ctr_add(ctr, 0, torch.ones(W, dtype=torch.int32))
    t_sq.pop_first(q, lane, lane.bool())
    assert all(k.launches == 0 for k in t_reg.KERNELS.values())


def _pairs(rs):
    """A run of bumps as the phases issue them: bool and int32 values, a
    repeated column, and an int32 sum that wraps past 2**31."""
    cols = [int(c) for c in rs.integers(0, NC, int(rs.integers(2, 14)))]
    cols += [cols[0], NC - 1]
    pairs = []
    for i, col in enumerate(cols):
        if i % 3 == 0:
            pairs.append((col, rs.random(W) < 0.5))
        else:
            pairs.append((col, rs.integers(-9, 9, W).astype(np.int32)))
    pairs.append((NC - 1, np.full(W, 2**31 - 1, np.int32)))
    return pairs


@pytest.mark.parametrize("seed", range(4))
def test_multi_pair_ctr_add_matches_a_sequence_of_pallas_calls(seed):
    """One ``ctr_add`` call with many ``(col, val)`` pairs equals the JAX
    package's one-column ``ctr_add`` called once per pair in order (bools
    cast to int32 as its ``_bump`` does), bitwise, wraps included."""
    rs = np.random.default_rng(30 + seed)
    ctr = rs.integers(-50, 50, (W, NC)).astype(np.int32)
    ctr[:, NC - 1] = 2**31 - 5
    pairs = _pairs(rs)
    want = jnp.asarray(ctr)
    for col, v in pairs:
        want = j_sq.ctr_add(want, col, jnp.asarray(v).astype(jnp.int32))
    t_pairs = [(col, torch.as_tensor(v)) for col, v in pairs]
    eq(t_sq.ctr_add(torch.as_tensor(ctr), t_pairs), want, ("pairs", seed))
    eq(t_ph.ctr_add_ref(torch.as_tensor(ctr), t_pairs), want,
       ("plain pairs", seed))
    # the one-pair form, bool value
    col, v = pairs[0]
    eq(t_sq.ctr_add(torch.as_tensor(ctr), col, torch.as_tensor(v)),
       j_sq.ctr_add(jnp.asarray(ctr), col, jnp.asarray(v).astype(jnp.int32)),
       ("one bool pair", seed))


def test_multi_pair_ctr_add_checks_every_pair():
    t_reg.reset_launches()
    ctr = torch.zeros((W, NC), dtype=torch.int32)
    ok = torch.ones(W, dtype=torch.int32)
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, [(c % NC, ok) for c in range(17)])
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, [])
    with pytest.raises(TypeError):
        t_sq.ctr_add(ctr, [(0, ok), (1, torch.zeros(W, dtype=torch.int64))])
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr, [(0, ok), (1, torch.zeros(W + 1, dtype=torch.bool))])
    with pytest.raises(ValueError):
        t_sq.ctr_add(ctr, [(0, torch.zeros((W, 2), dtype=torch.int32)[:, 0])])
    with pytest.raises(IndexError):
        t_sq.ctr_add(ctr, [(0, ok), (NC, ok)])
    with pytest.raises(IndexError):
        t_sq.ctr_add(ctr, [(-1, ok)])
    out = t_sq.ctr_add(ctr, [(c % NC, ok) for c in range(16)])
    assert int(out.sum()) == 16 * W and int(ctr.sum()) == 0
    assert all(k.launches == 0 for k in t_reg.KERNELS.values())
