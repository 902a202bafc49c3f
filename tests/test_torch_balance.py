"""The port's MoE routing (``repro_torch.core.balance``) against the JAX
package's ``core/balance.py``: the same logits (made with numpy) and the
same key give equal ``expert``, ``pos`` and counters, and ``weight`` and
``probs`` within 1e-6, for every strategy, with one token group and more;
the parity traps (the top-k tie order, stable sorts) each get a case."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import balance as j_bal  # noqa: E402
from repro_torch.core import balance as t_bal  # noqa: E402
from repro_torch.core import prng  # noqa: E402

STRATEGIES = ("drop", "na_rp", "na_ws")
TOL = dict(rtol=1e-6, atol=1e-6)


def both_route(logits, k, cap, E, n_groups, *, strategy, seed=0, G=1,
               p_local=0.9):
    """Route ``logits`` in both packages with one key and the token groups
    ``arange(T) // (T // G)``; returns (port result, JAX result)."""
    T = logits.shape[0]
    tg = (np.arange(T) // (T // G)).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = j_bal.route(jnp.asarray(logits), k, cap,
                       j_bal.default_expert_groups(E, n_groups),
                       strategy=strategy, p_local=p_local, key=key,
                       token_group=jnp.asarray(tg), n_token_groups=G)
    got = t_bal.route(torch.as_tensor(logits), k, cap,
                      t_bal.default_expert_groups(E, n_groups),
                      strategy=strategy, p_local=p_local,
                      key=np.asarray(key), token_group=torch.as_tensor(tg),
                      n_token_groups=G)
    return got, want


def assert_same_route(got, want, label=""):
    assert got.expert.dtype == torch.int32 and got.pos.dtype == torch.int32
    assert np.array_equal(got.expert.numpy(), np.asarray(want.expert)), label
    assert np.array_equal(got.pos.numpy(), np.asarray(want.pos)), label
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               err_msg=str(label), **TOL)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs),
                               err_msg=str(label), **TOL)
    assert sorted(got.stats) == sorted(want.stats) == sorted(
        t_bal.STAT_KEYS)
    for name, v in got.stats.items():
        assert v.dtype == torch.int32, name
        assert int(v) == int(want.stats[name]), (label, name)


@pytest.mark.parametrize("G", (1, 2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", (0, 7))
def test_route_matches_jax(seed, strategy, G):
    """The invariants case of the JAX tests: T = 64 G, E = 8, k = 2,
    capacity 24, logits N(0, 4)."""
    T, E, k, cap = 64 * G, 8, 2, 24
    logits = (np.random.default_rng(seed).standard_normal((T, E)) * 2.0
              ).astype(np.float32)
    got, want = both_route(logits, k, cap, E, 4, strategy=strategy,
                           seed=seed, G=G)
    assert_same_route(got, want, (seed, strategy, G))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_redirects_recover_drops_as_in_jax(strategy):
    """Four hot experts of 16, capacity 96: the static router drops and the
    redirecting ones place everything."""
    T, E, k, cap = 512, 16, 2, 96
    logits = (np.random.default_rng(1).standard_normal((T, E))
              + np.array([3.0] * 4 + [0.0] * 12)).astype(np.float32)
    got, want = both_route(logits, k, cap, E, 4, strategy=strategy, seed=0)
    assert_same_route(got, want, strategy)
    dropped = int(got.stats["ntasks_dropped"])
    assert (dropped > 0) if strategy == "drop" else (dropped == 0)


@pytest.mark.parametrize("G", (1, 2))
def test_local_preference_as_in_jax(G):
    """One hot expert, p_local 0.95, k = 1: NA-RP fills the hot expert's
    own group before it spills to other groups."""
    T, E, k, cap = 256 * G, 16, 1, 32
    logits = np.random.default_rng(2).standard_normal((T, E)) * 0.1
    logits[:, 0] += 4.0
    got, want = both_route(logits.astype(np.float32), k, cap, E, 4,
                           strategy="na_rp", seed=1, G=G, p_local=0.95)
    assert_same_route(got, want, G)
    assert int(got.stats["ntasks_stolen_local"]) >= 90 * G


@pytest.mark.parametrize("strategy", ("na_rp", "na_ws"))
def test_token_groups_confine_redirects_as_in_jax(strategy):
    T, E, k, cap, G = 128, 8, 2, 8, 4
    logits = np.random.default_rng(3).standard_normal((T, E))
    logits[:, 0] += 5.0                   # heavy overflow
    got, want = both_route(logits.astype(np.float32), k, cap, E, 2,
                           strategy=strategy, seed=3, G=G)
    assert_same_route(got, want, strategy)
    tg = np.arange(T) // (T // G)
    e = got.expert.numpy()
    for g in range(G):
        rows = e[tg == g]
        # each group's tokens fill at most its own E x capacity slots
        assert (rows >= 0).sum() <= E * cap


def test_top_k_breaks_ties_toward_the_lower_index():
    """Equal probabilities: ``lax.top_k`` (and the port) take the lower
    expert first; the same equal gate weights rank by position."""
    T, E, k = 16, 8, 3
    logits = np.zeros((T, E), np.float32)
    logits[::2, 5] = 1.0                  # every other token prefers 5
    got, want = both_route(logits, k, T, E, 2, strategy="na_rp")
    assert_same_route(got, want)
    assert got.expert[1].tolist() == [0, 1, 2]
    assert got.expert[0].tolist() == [5, 0, 1]
    # equal gate weights rank by token: expert 1 takes the odd tokens
    # (weight 1/8) in order, then the even ones (1/(7 + e)) in order
    assert got.pos[1::2, 1].tolist() == list(range(T // 2))
    assert got.pos[0::2, 2].tolist() == list(range(T // 2, T))


def test_rank_in_expert_matches_jax():
    rs = np.random.default_rng(4)
    N, E = 200, 6
    e = rs.integers(0, E, N).astype(np.int32)
    prio = rs.random(N).astype(np.float32)
    prio[::7] = 0.5                       # ties in priority
    active = rs.random(N) < 0.8
    got = t_bal._rank_in_expert(torch.as_tensor(e), torch.as_tensor(prio),
                                E, torch.as_tensor(active))
    want = j_bal._rank_in_expert(jnp.asarray(e), jnp.asarray(prio), E,
                                 jnp.asarray(active))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_load_balance_loss_and_groups_match_jax():
    rs = np.random.default_rng(5)
    T, E, k = 40, 8, 2
    probs = rs.dirichlet(np.ones(E), T).astype(np.float32)
    expert = rs.integers(-1, E, (T, k)).astype(np.int32)
    got = t_bal.load_balance_loss(torch.as_tensor(probs),
                                  torch.as_tensor(expert), k)
    want = j_bal.load_balance_loss(jnp.asarray(probs), jnp.asarray(expert),
                                   k)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for n_experts, n_groups in ((8, 2), (64, 16), (16, 1)):
        assert np.array_equal(
            t_bal.default_expert_groups(n_experts, n_groups).numpy(),
            np.asarray(j_bal.default_expert_groups(n_experts, n_groups)))
    with pytest.raises(ValueError):
        t_bal.default_expert_groups(8, 3)


def test_default_key_is_prngkey_zero():
    logits = np.random.default_rng(6).standard_normal((64, 8)).astype(
        np.float32) * 2.0
    groups = t_bal.default_expert_groups(8, 4)
    a = t_bal.route(torch.as_tensor(logits), 2, 8, groups)
    b = t_bal.route(torch.as_tensor(logits), 2, 8, groups,
                    key=prng.PRNGKey(0))
    assert torch.equal(a.expert, b.expert) and torch.equal(a.pos, b.pos)
    with pytest.raises(ValueError):
        t_bal.route(torch.as_tensor(logits), 2, 8, groups, strategy="x")
