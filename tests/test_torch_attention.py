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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 64, 256])
def test_plain_twin_never_reads_the_next_head(Dh, dtype):
    """KV head 1's V all inf: the query heads of KV head 0 stay finite and
    equal what they give alone, at a ragged S.  The CUDA kernels are held
    to the same rule on the card, bit for bit (``tests/test_torch_gpu.py``);
    this is its oracle.  The CPU's matrix product may sum in another order
    for another number of heads, so here "equal" is within 1e-5."""
    B, H, KV, S = 1, 4, 2, 100
    (tq, tk, tv), _ = both(qkv(Dh + S, B, H, KV, S, Dh), dtype, jnp.float32)
    tv[:, 1] = float("inf")
    rep = H // KV
    got = t_fa.flash_attention(tq, tk, tv, softcap=50.0)
    alone = t_fa.flash_attention(tq[:, :rep].contiguous(),
                                 tk[:, :1].contiguous(),
                                 tv[:, :1].contiguous(), softcap=50.0)
    assert torch.isfinite(got[:, :rep]).all()
    close(got[:, :rep], alone.float().numpy(), F32_TOL)
    assert not torch.isfinite(got[:, rep:]).all()


def test_each_dtype_names_its_kernel():
    """The wrapper runs one CUDA kernel per I/O type; ``chip_smoke.py``
    reads both from the profiler by these names."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert set(t_fa.KERNEL_NAMES) == set(t_fa.DTYPES)
    assert t_fa.KERNEL_NAMES[torch.bfloat16] == "flash_fwd_wgmma_kernel"
    assert t_fa.KERNEL_NAMES[torch.float32] == "flash_fwd_kernel"
    assert set(chip_smoke.FLASH_KERNEL_KEYS) == \
        set(t_fa.KERNEL_NAMES.values())


def test_wgmma_kernel_softcap_arithmetic():
    """The bf16 kernel's branch-free softcap, emulated in float32 numpy
    (``csrc/flash_attention.cu``: ``div_rn``, ``tanh_f32``).  x / cap as
    ``q = x * r; q + (x - q * cap) * r`` with r the rounded 1 / cap and
    FMAs (exact in float64 here) equals IEEE division bit for bit; tanh as
    ``1 - 2 / (e^(2|y|) + 1)`` with each step rounded to float32 is within
    2e-7 of tanh.  The card's ex2 / rcp add up to 2 ulp each."""
    rs = np.random.default_rng(0)
    f32 = np.float32

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(f32)

    for cap in (50.0, 30.0, 20.0, 7.0):
        d = f32(cap)
        r = f32(1) / d
        x = np.concatenate([rs.standard_normal(200_000) * sc for sc in
                            (1e-3, 1.0, 30.0, 1e4)]).astype(f32)
        q = x * r
        got = fma(fma(-q, d, x), r, q)
        np.testing.assert_array_equal(got, x / d)
    y = np.concatenate([np.linspace(-20, 20, 400_001),
                        np.linspace(-1e-3, 1e-3, 20_001)]).astype(f32)
    e = np.exp2((f32(2 * 1.4426950408889634) * np.abs(y)).astype(f32)
                .astype(np.float64)).astype(f32)
    rcp = (1.0 / (e.astype(np.float64) + 1.0)).astype(f32)
    t = np.copysign(fma(np.full_like(rcp, -2), rcp, np.ones_like(rcp)), y)
    assert np.abs(t - np.tanh(y.astype(np.float64))).max() < 2e-7
