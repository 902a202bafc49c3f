"""The port's threefry pieces (``repro_torch.core.prng``) against
``jax.random``: keys, ``fold_in`` and the 32-bit draws bitwise, the
uniform floats bitwise, the Gumbel floats within 1e-6 relative (PyTorch's
``log`` and XLA's may differ in the last place)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 1, 42, 12345, 2**31 - 1)
SHAPES = ((1,), (5,), (24, 8), (3, 7, 5), (96, 64))


def jkey(seed, *data):
    k = jax.random.PRNGKey(seed)
    for d in data:
        k = jax.random.fold_in(k, d)
    return k


def tkey(seed, *data):
    k = prng.PRNGKey(seed)
    for d in data:
        k = prng.fold_in(k, d)
    return k


def as_pair(jk):
    return tuple(int(x) for x in np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_are_bitwise(seed):
    assert prng.PRNGKey(seed) == as_pair(jax.random.PRNGKey(seed))
    rs = np.random.default_rng(seed)
    datas = [0, 1, 95, 2**31 + 3, 2**32 - 1] + rs.integers(
        0, 2**32, 5).tolist()
    for d in datas:
        assert tkey(seed, d) == as_pair(jkey(seed, d)), (seed, d)
    # the per-layer, per-round derivation of the routing keys
    for layer in (0, 7, 47):
        for r in (0, 1):
            assert tkey(seed, layer, r) == as_pair(jkey(seed, layer, r))


def test_threefry_on_ints_and_tensors_agree():
    rs = np.random.default_rng(3)
    key = tuple(int(x) for x in rs.integers(0, 2**32, 2))
    x0 = rs.integers(0, 2**32, 50)
    x1 = rs.integers(0, 2**32, 50)
    t0, t1 = prng.threefry2x32(key, torch.as_tensor(x0),
                               torch.as_tensor(x1))
    for i in range(50):
        assert prng.threefry2x32(key, int(x0[i]), int(x1[i])) == (
            int(t0[i]), int(t1[i]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", (0, 42))
def test_bits_and_uniform_are_bitwise(seed, shape):
    jk = jkey(seed, 3, 1)
    want = np.asarray(jax.random.bits(jk, shape, dtype=np.uint32))
    got = prng.random_bits(np.asarray(jk), shape, "cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    assert tiny == prng.TINY
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(tkey(seed, 3, 1), shape, "cpu", lo, hi)
        assert got.dtype == torch.float32
        if hi - lo == 1.0:
            # the routing's ranges: the scale is exact, so bit for bit
            assert np.array_equal(got.numpy(), want), (lo, hi)
        else:
            # XLA may fuse the scale and the shift into one FMA
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_a_last_place(seed, shape):
    jk = jkey(seed, 11)
    want = np.asarray(jax.random.gumbel(jk, shape))
    got = prng.gumbel(tkey(seed, 11), shape, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_key_checks():
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)
    assert prng.as_key(np.asarray(jax.random.PRNGKey(9))) == prng.PRNGKey(9)
