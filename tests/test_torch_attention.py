"""The port's attention (``repro_torch.kernels.ref`` / ``flash_attention`` /
``ops``) against the JAX package's: the plain chunked forward against JAX
``ref.flash_attention`` and against the Pallas kernel run in interpret mode
(``flash_attention_pallas(..., interpret=True)``), ``attention_naive`` and
``decode_attention`` against theirs, on the same inputs made with numpy.

On CPU tensors the wrapper runs the plain twin after the checks the CUDA
path makes; ``tests/test_torch_gpu.py`` holds the CUDA kernel against the
twin on the card.  Tolerances: 1e-5 (atol and rtol) in float32, where the
two packages only sum in other orders; 2e-2 in bfloat16, whose outputs
round at 2^-8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import registry as t_reg  # noqa: E402

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
VARIANTS = [(True, 0, None), (True, 16, None), (False, 0, None),
            (True, 0, 30.0), (True, 16, 50.0)]


def qkv(seed, B, H, KV, S, Dh, dtype=np.float32):
    rs = np.random.default_rng(seed)
    return tuple(rs.standard_normal(shape).astype(dtype)
                 for shape in ((B, H, S, Dh), (B, KV, S, Dh), (B, KV, S, Dh)))


def both(arrs, torch_dtype=torch.float32, jax_dtype=jnp.float32):
    return ([torch.as_tensor(a).to(torch_dtype) for a in arrs],
            [jnp.asarray(a, jax_dtype) for a in arrs])


def close(got, want, tol, label=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol,
                               err_msg=str(label))


@pytest.mark.parametrize("S", (48, 128))
@pytest.mark.parametrize("KV", (4, 2))
@pytest.mark.parametrize("causal,window,softcap", VARIANTS)
def test_plain_flash_matches_jax_ref_and_pallas(causal, window, softcap, KV,
                                                S):
    (tq, tk, tv), (jq, jk, jv) = both(qkv(S + KV, 2, 4, KV, S, 32))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = t_fa.flash_attention(tq, tk, tv, **kw)
    label = (causal, window, softcap, KV, S)
    close(got, j_ref.flash_attention(jq, jk, jv, causal, window, softcap),
          F32_TOL, label)
    close(got, flash_attention_pallas(jq, jk, jv, **kw, interpret=True),
          F32_TOL, label)
    # the reference's chunking, with several chunks each way
    got_c = t_ref.flash_attention(tq, tk, tv, causal, window, softcap, 16, 16)
    close(got_c, j_ref.flash_attention(jq, jk, jv, causal, window, softcap,
                                       16, 16), F32_TOL, label)


@pytest.mark.parametrize("causal,window,softcap", VARIANTS)
def test_attention_naive_matches_jax(causal, window, softcap):
    (tq, tk, tv), (jq, jk, jv) = both(qkv(7, 1, 4, 2, 40, 16))
    close(t_ref.attention_naive(tq, tk, tv, causal, window, softcap),
          j_ref.attention_naive(jq, jk, jv, causal, window, softcap),
          F32_TOL)


@pytest.mark.parametrize("window,softcap", [(0, None), (5, None),
                                            (0, 50.0), (5, 30.0)])
def test_decode_attention_matches_jax(window, softcap):
    rs = np.random.default_rng(3)
    B, H, KV, S, Dh = 3, 4, 2, 24, 16
    q = rs.standard_normal((B, H, Dh)).astype(np.float32)
    kc = rs.standard_normal((B, KV, S, Dh)).astype(np.float32)
    vc = rs.standard_normal((B, KV, S, Dh)).astype(np.float32)
    lens = np.array([1, 13, 24], np.int32)
    got = t_ref.decode_attention(*(torch.as_tensor(a) for a in (q, kc, vc,
                                                                lens)),
                                 window=window, softcap=softcap)
    want = j_ref.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc,
                                                             lens)),
                                  window=window, softcap=softcap)
    close(got, want, F32_TOL)
    close(t_ops.decode_attention(*(torch.as_tensor(a) for a in (q, kc, vc,
                                                                lens)),
                                 window=window, softcap=softcap), want,
          F32_TOL)


def test_bf16_plain_flash_matches_jax():
    (tq, tk, tv), (jq, jk, jv) = both(qkv(11, 1, 4, 2, 128, 64),
                                      torch.bfloat16, jnp.bfloat16)
    got = t_fa.flash_attention(tq, tk, tv, window=32, softcap=50.0)
    assert got.dtype == torch.bfloat16
    close(got, j_ref.flash_attention(jq, jk, jv, True, 32, 50.0), BF16_TOL)
    close(got, flash_attention_pallas(jq, jk, jv, window=32, softcap=50.0,
                                      interpret=True), BF16_TOL)


def test_plain_twin_takes_a_ragged_sequence():
    """S = 100 is no multiple of the TPU kernel's 128-row block; the twin
    (one chunk) and the naive oracle agree on every row."""
    (tq, tk, tv), _ = both(qkv(5, 1, 2, 1, 100, 16))
    close(t_fa.flash_attention(tq, tk, tv, window=30),
          t_ref.attention_naive(tq, tk, tv, True, 30).numpy(), F32_TOL)


def test_ops_dispatch_on_the_cpu():
    (tq, tk, tv), (jq, jk, jv) = both(qkv(2, 1, 2, 2, 32, 16))
    want = j_ref.flash_attention(jq, jk, jv, True, 0, 20.0)
    t_reg.reset_launches()
    try:
        for impl in (None, "ref"):
            t_ops.set_impl(impl)
            close(t_ops.flash_attention(tq, tk, tv, softcap=20.0), want,
                  F32_TOL, impl)
        t_ops.set_impl("cuda")
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            t_ops.flash_attention(tq, tk, tv)
        with pytest.raises(ValueError):
            t_ops.set_impl("pallas")
    finally:
        t_ops.set_impl(None)
    assert t_reg.KERNELS["flash_attention"].launches == 0


def test_wrapper_checks_its_inputs():
    (tq, tk, tv), _ = both(qkv(1, 1, 4, 2, 16, 16))
    with pytest.raises(ValueError, match="contiguous"):
        t_fa.flash_attention(tq.transpose(2, 3).contiguous().transpose(2, 3),
                             tk, tv)
    with pytest.raises(ValueError, match="multiple"):
        t_fa.flash_attention(tq[:, :3].contiguous(), tk, tv)
    with pytest.raises(TypeError):
        t_fa.flash_attention(tq, tk.double(), tv)
    with pytest.raises(TypeError):
        t_fa.flash_attention(tq.double(), tk.double(), tv.double())
    with pytest.raises(ValueError):
        t_fa.flash_attention(tq, tk[:, :, :8].contiguous(), tv)
    assert t_reg.KERNELS["flash_attention"].replaces == \
        "src/repro/kernels/flash_attention.py:105"
