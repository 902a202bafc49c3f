"""The port's int8 gradient compression (``repro_torch.optim.grad_compress``)
bitwise against the JAX package's on the CPU: the int8 codes and scales,
the round trip and error feedback on float32 and bfloat16 leaves whose
sizes are and are not multiples of the 256-element block (all-zero blocks
included, where the 1e-12 floor sets the scale), and three error-feedback
steps over the smoke gemma2 gradient tree."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.optim import grad_compress as J  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.data.pipeline import batch_for  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import grad_compress as T  # noqa: E402

DTYPES = ("float32", "bfloat16")
#: element counts: whole blocks, ragged tails, a single element
SIZES = (256, 9472, 1000, 12293, 1)


def to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def same(t: torch.Tensor, a) -> bool:
    """Equal bit for bit, dtype and shape included."""
    b = to_torch(a)
    return t.dtype == b.dtype and t.shape == b.shape and torch.equal(
        t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def _input(n: int, dtype: str, seed: int, shape=None) -> np.ndarray:
    """Normal values at a spread of scales, one all-zero block when there
    is room for one, one block of tiny values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 3, n)).astype(
        np.float32)
    if n >= 3 * T.BLOCK:
        x[T.BLOCK:2 * T.BLOCK] = 0.0
        x[2 * T.BLOCK:3 * T.BLOCK] *= 1e-30
    x = x.reshape(shape or (n,))
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_codes_and_scales_match_jax(n, dtype):
    x = _input(n, dtype, n)
    q, scale, pad = T._quant(to_torch(x).float())
    jq, jscale, jpad = J._quant(jnp.asarray(x).astype(jnp.float32))
    assert pad == jpad == (-n) % T.BLOCK
    assert q.dtype == torch.int8 and same(q, jq)
    assert same(scale, jscale)
    if n >= 3 * T.BLOCK:
        assert float(scale[1, 0]) == np.float32(1e-12)   # the zero block


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(9472,), (1000,), (37, 41), (4, 8, 32),
                                   (3, 1)])
def test_round_trip_matches_jax(shape, dtype):
    n = int(np.prod(shape))
    x = _input(n, dtype, 7 + n, shape)
    x_hat, resid = T.compress_decompress(to_torch(x))
    jx, jr = J.compress_decompress(jnp.asarray(x))
    assert same(x_hat, jx) and same(resid, jr)


def test_an_all_zero_tensor_round_trips_to_zeros():
    for dtype in (torch.float32, torch.bfloat16):
        x_hat, resid = T.compress_decompress(torch.zeros(700, dtype=dtype))
        assert not x_hat.any() and not resid.any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_ef_compress_grads_matches_jax_from_a_nonzero_residual(dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (1000,), "b": (16, 64), "c": (5, 7, 3), "d": (256,)}
    grads = {k: _input(int(np.prod(s)), dtype, i, s)
             for i, (k, s) in enumerate(sorted(shapes.items()))}
    ef = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
          for k, s in shapes.items()}
    g_hat, e1 = T.ef_compress_grads({k: to_torch(v) for k, v in grads.items()},
                                    {k: to_torch(v) for k, v in ef.items()})
    jg, je = J.ef_compress_grads({k: jnp.asarray(v) for k, v in grads.items()},
                                 {k: jnp.asarray(v) for k, v in ef.items()})
    assert set(g_hat) == set(e1) == set(shapes)
    for k in shapes:
        assert g_hat[k].dtype == getattr(torch, dtype)
        assert e1[k].dtype == torch.float32
        assert same(g_hat[k], jg[k]) and same(e1[k], je[k]), k


def _smoke_gemma2(dtype: str):
    """Smoke gemma2 in ``dtype`` with weights from a numpy seed."""
    cfg = dataclasses.replace(tcb.smoke_config("gemma2_2b"),
                              param_dtype=dtype, compute_dtype=dtype)
    shapes, _ = tsteps.init_shapes(cfg)
    rng = np.random.default_rng(11)
    leaves = [torch.from_numpy((rng.standard_normal(tuple(p.shape)) * 0.1)
                               .astype(np.float32)).to(p.dtype)
              for p in tfm.tree_leaves(shapes)]
    return cfg, tfm.tree_unflatten(shapes, leaves).requires_grad_(True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_three_error_feedback_steps_over_smoke_gemma2_gradients(dtype):
    """The port's ``ParamTree`` path (``ef_init`` beside the parameters,
    gradients as the tree) against the JAX function on the same leaves in
    leaf order, three steps, each on the gradient of another batch."""
    cfg, params = _smoke_gemma2(dtype)
    leaves = tfm.tree_leaves(params)
    ef = T.ef_init(params)
    assert isinstance(ef, tfm.ParamTree)
    assert [e.dtype for e in tfm.tree_leaves(ef)] == [torch.float32] * len(
        leaves)
    j_ef = [jnp.zeros(tuple(p.shape), jnp.float32) for p in leaves]
    for step in range(3):
        batch = {k: torch.as_tensor(v)
                 for k, v in batch_for(cfg, step, 2, 16).items()}
        loss, _ = tfm.loss_fn(params, cfg, batch)
        grads = tfm.tree_unflatten(params, torch.autograd.grad(loss, leaves))
        g_hat, ef = T.ef_compress_grads(grads, ef)
        jg, j_ef = J.ef_compress_grads(
            [jnp.asarray(to_np(g)) for g in tfm.tree_leaves(grads)], j_ef)
        assert isinstance(g_hat, tfm.ParamTree)
        names = [p for p, _ in tfm.tree_items(params)]
        assert [p for p, _ in tfm.tree_items(g_hat)] == names
        for name, g, e, a, b in zip(names, tfm.tree_leaves(g_hat),
                                    tfm.tree_leaves(ef), jg, j_ef):
            assert g.dtype == getattr(torch, dtype), name
            assert same(g, a) and same(e, b), (step, name)
        # the residual carries what the codes missed: it is never all zero
        assert any(e.any() for e in tfm.tree_leaves(ef))


def test_trees_keep_their_structure():
    p = {"x": torch.ones(3), "y": [torch.ones(2, 2), torch.ones(5)],
         "z": (torch.ones(1),)}
    ef = T.ef_init(p)
    assert type(ef["y"]) is list and type(ef["z"]) is tuple
    g_hat, e1 = T.ef_compress_grads(p, ef)
    assert type(g_hat["y"]) is list and type(e1["z"]) is tuple
    flat_hat, flat_e = T.ef_compress_grads(tfm.tree_leaves(p),
                                           tfm.tree_leaves(ef))
    assert isinstance(flat_hat, list) and len(flat_e) == 4
    with pytest.raises(ValueError, match="4 gradients, 3 residuals"):
        T.ef_compress_grads(tfm.tree_leaves(p), tfm.tree_leaves(ef)[:3])
