"""The port's selective SSM (``repro_torch.kernels.ref.ssm_*``, ``ops``,
``models.ssm``) against the JAX package's, with inputs drawn from a seed
with numpy and the JAX package's own SSM weights carried across.

float32 results are held to 2e-4 (atol and rtol), the JAX package's own
tolerance between its forward and its decode (``tests/test_models.py``);
a bf16 output to 1e-2, one bf16 rounding step (2^-8) of a float32 value
that the two packages sum in another order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def npy(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def close(a, b, label="", tol=TOL):
    np.testing.assert_allclose(npy(a), npy(b), **tol, err_msg=str(label))


def scan_inputs(B, T, Di, N, seed=0, nonzero_state=True):
    """x, dt, A, Bm, Cm, D, state as numpy float32, drawn the way
    ``tests/test_kernels.py`` draws them: softplus dt, ``A = -exp(z)``."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, T, Di)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((B, T, Di)))).astype(np.float32)
    A = -np.exp(rs.standard_normal((Di, N))).astype(np.float32)
    Bm = rs.standard_normal((B, T, N)).astype(np.float32)
    Cm = rs.standard_normal((B, T, N)).astype(np.float32)
    D = (1.0 + 0.1 * rs.standard_normal(Di)).astype(np.float32)
    state = (rs.standard_normal((B, Di, N)) * 0.5 if nonzero_state
             else np.zeros((B, Di, N))).astype(np.float32)
    return x, dt, A, Bm, Cm, D, state


def as_torch(arrs, dtype=None):
    out = [torch.as_tensor(a) for a in arrs]
    if dtype is not None:   # x, Bm and Cm in the compute dtype
        for i in (0, 3, 4):
            out[i] = out[i].to(dtype)
    return out


def as_jax(arrs, dtype=None):
    out = [jnp.asarray(a) for a in arrs]
    if dtype is not None:
        for i in (0, 3, 4):
            out[i] = out[i].astype(dtype)
    return out


@pytest.mark.parametrize("T", (7, 64, 256, 768))
def test_scan_matches_jax_from_a_nonzero_state(T):
    """Below one 256-step chunk, one chunk, and three; and the port's
    step block (64) exactly."""
    arrs = scan_inputs(2, T, 24, 16, seed=T)
    want_y, want_s = j_ref.ssm_scan(*as_jax(arrs), chunk=256)
    for fn in (t_ref.ssm_scan, t_ops.ssm_scan):
        y, s = fn(*as_torch(arrs))
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        close(y, want_y, (fn, T, "y"))
        close(s, want_s, (fn, T, "state"))
    y, s = t_ref.ssm_chunked(*as_torch(arrs), chunk=256)
    close(y, want_y, (T, "chunked y"))
    close(s, want_s, (T, "chunked state"))


def test_scan_in_bfloat16_casts_to_float32_and_back():
    arrs = scan_inputs(2, 100, 16, 8, seed=3)
    want_y, want_s = j_ref.ssm_scan(*as_jax(arrs, jnp.bfloat16), chunk=256)
    y, s = t_ops.ssm_scan(*as_torch(arrs, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    close(y, want_y, "y", BF16_TOL)
    close(s, want_s, "state")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_decode_matches_jax(dtype):
    """One step from a nonzero state; x, Bm and Cm in ``dtype``, dt and
    the state float32, as the model hands them over."""
    x, dt, A, Bm, Cm, D, state = scan_inputs(3, 1, 16, 8, seed=5)
    arrs = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, state)
    jd = None if dtype == "float32" else jnp.bfloat16
    td = None if dtype == "float32" else torch.bfloat16
    want_y, want_h = j_ref.ssm_decode(*as_jax(arrs, jd))
    y, h = t_ops.ssm_decode(*as_torch(arrs, td))
    assert str(y.dtype).split(".")[-1] == want_y.dtype.name
    assert str(h.dtype).split(".")[-1] == want_h.dtype.name == "float32"
    close(y, want_y, "y", TOL if dtype == "float32" else BF16_TOL)
    close(h, want_h, "h")


def test_decode_steps_reproduce_the_scan():
    """The port of ``tests/test_kernels.py::test_ssm_scan_vs_decode``:
    replaying the decode step gives the scan's outputs and state."""
    arrs = as_torch(scan_inputs(2, 32, 16, 4, seed=7, nonzero_state=False))
    x, dt, A, Bm, Cm, D, s0 = arrs
    y, sT = t_ref.ssm_chunked(x, dt, A, Bm, Cm, D, s0, chunk=8)
    s = s0
    outs = []
    for t in range(x.shape[1]):
        o, s = t_ref.ssm_decode(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D,
                                s)
        outs.append(o)
    close(y, torch.stack(outs, dim=1), "y", dict(atol=1e-4, rtol=0))
    close(sT, s, "state", dict(atol=1e-4, rtol=0))


def test_chunked_raises_where_jax_fails_and_the_scan_takes_any_T():
    """T = 300 over a chunk of 256: the JAX scan fails on its reshape, the
    chunked ref raises ``ValueError``, and the scan (no chunk) gives what
    the JAX scan gives with one chunk of 300."""
    arrs = scan_inputs(1, 300, 8, 4, seed=9)
    with pytest.raises(Exception):
        j_ref.ssm_scan(*as_jax(arrs), chunk=256)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ref.ssm_chunked(*as_torch(arrs), chunk=256)
    want_y, want_s = j_ref.ssm_scan(*as_jax(arrs), chunk=300)
    y, s = t_ops.ssm_scan(*as_torch(arrs))
    close(y, want_y, "y")
    close(s, want_s, "state")


# ---------------------------------------------------------------------------
# models/ssm.py
# ---------------------------------------------------------------------------

def ssm_models(perturb=True):
    """hymba's smoke config in each package, the JAX SSM weights and the
    same weights as the port's tensors.  ``dt_bias``, ``D`` and ``A_log``
    are perturbed away from their constant init so that a wrong index
    shows."""
    jcfg, tcfg = j_cb.smoke_config("hymba_1_5b"), t_cb.smoke_config(
        "hymba_1_5b")
    jp = j_ssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    if perturb:
        rs = np.random.default_rng(11)
        for k in ("dt_bias", "D", "A_log"):
            jp[k] = (jp[k] + 0.3 * rs.standard_normal(jp[k].shape)
                     ).astype(np.float32)
    tp = {k: torch.as_tensor(v.copy()) for k, v in jp.items()}
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in jp.items()}, tp


def test_ssm_init_leaves_match_jax():
    jcfg, tcfg, jp, _ = ssm_models(perturb=False)
    tp = t_ssm.ssm_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == jp[k].dtype.name, k
    for k in ("dt_bias", "D"):               # the constant leaves, exactly
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    # log(1..N): torch's and XLA's float32 log differ by one ulp at log 7
    a, b = tp["A_log"].numpy(), np.asarray(jp["A_log"])
    assert (np.abs(a - b) <= np.spacing(b)).all()
    assert np.array_equal(a[0], a[-1])
    # stacked: a leading layer dim on every leaf
    st = t_ssm.ssm_init(tcfg, torch.Generator().manual_seed(0), "cpu",
                        lead=(3,))
    for k in jp:
        assert tuple(st[k].shape) == (3,) + jp[k].shape, k
    assert np.array_equal(st["A_log"][2].numpy(), a)


@pytest.mark.parametrize("with_carry", (False, True))
def test_conv_sums_the_taps_left_to_right_with_its_carry(with_carry):
    """The depthwise causal conv and its carry (the last K - 1 rows of the
    padded input) against the JAX ``_conv``, bitwise in float32."""
    rs = np.random.default_rng(13)
    x = rs.standard_normal((2, 9, 12)).astype(np.float32)
    w = rs.standard_normal((4, 12)).astype(np.float32)
    carry = rs.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_carry else None
    got, got_c = t_ssm._conv(torch.as_tensor(x), torch.as_tensor(w),
                             None if carry is None else torch.as_tensor(carry))
    want, want_c = j_ssm._conv(jnp.asarray(x), jnp.asarray(w),
                               None if carry is None else jnp.asarray(carry))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # one token at a time, carrying the tail, gives the whole sequence
    c = None if carry is None else torch.as_tensor(carry)
    steps = []
    for t in range(x.shape[1]):
        o, c = t_ssm._conv(torch.as_tensor(x[:, t:t + 1]),
                           torch.as_tensor(w), c)
        steps.append(o)
    np.testing.assert_array_equal(torch.cat(steps, 1).numpy(), got.numpy())


def test_softplus_is_jaxs():
    v = np.linspace(-40, 40, 801).astype(np.float32)
    got = t_ssm._softplus(torch.as_tensor(v)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


def test_ssm_apply_and_decode_steps_match_jax_with_the_conv_carry():
    """``ssm_apply`` over 20 tokens, then 4 ``ssm_decode_step``s from its
    state and conv carry: outputs, states and carries against JAX."""
    jcfg, tcfg, jp, tp = ssm_models()
    rs = np.random.default_rng(17)
    x = rs.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    out, st, cv = t_ssm.ssm_apply(tp, torch.as_tensor(x[:, :20]), tcfg)
    j_out, j_st, j_cv = j_ssm.ssm_apply(jp, jnp.asarray(x[:, :20]), jcfg)
    close(out, j_out, "apply out")
    close(st, j_st, "apply state")
    close(cv, j_cv, "apply carry")
    assert tuple(cv.shape) == (2, tcfg.ssm.d_conv - 1,
                               tcfg.ssm.expand * tcfg.d_model)
    for t in range(20, 24):
        out, st, cv = t_ssm.ssm_decode_step(tp, torch.as_tensor(x[:, t]),
                                            tcfg, st, cv)
        j_out, j_st, j_cv = j_ssm.ssm_decode_step(jp, jnp.asarray(x[:, t]),
                                                  jcfg, j_st, j_cv)
        close(out, j_out, ("decode out", t))
        close(st, j_st, ("decode state", t))
        close(cv, j_cv, ("decode carry", t))
    # and the decode steps continue the sequence: apply over all 24 tokens
    full, f_st, f_cv = t_ssm.ssm_apply(tp, torch.as_tensor(x), tcfg)
    close(out, full[:, -1], "decode against apply")
    close(st, f_st, "state against apply")
    close(cv, f_cv, "carry against apply")


def test_ssm_state_init_matches_jax():
    jcfg, tcfg = j_cb.smoke_config("hymba_1_5b"), t_cb.smoke_config(
        "hymba_1_5b")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    got = t_ssm.ssm_state_init(tcfg, 3)
    want = j_ssm.ssm_state_init(jcfg, 3)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        assert not a.any()
