"""The port's RWKV6 path (``repro_torch.kernels.ref`` / ``rwkv6_scan`` /
``ops``, ``models.rwkv``, the RWKV block of ``models.transformer`` and
serving) against the JAX package's, on the same inputs made with numpy and
with the JAX package's weights carried across (``params_from_numpy``).

On CPU tensors the kernel's wrapper runs its plain twin after the checks
the CUDA path makes; ``tests/test_torch_gpu.py`` holds the CUDA kernel
against the twin on the card.  Tolerances: the recurrence refs 1e-5 (atol
and rtol) in float32, where the two packages only sum in other orders, and
2e-2 in bfloat16, whose outputs round at 2^-8; the plain path against the
Pallas kernel 1e-4, the JAX package's own tolerance for it
(``tests/test_kernels.py``); the blocks 1e-4; the whole smoke model 2e-4,
the JAX package's tolerance between its forward and its decode
(``tests/test_models.py``).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_pallas  # noqa: E402
from repro.models import rwkv as j_rwkv  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as t_rk  # noqa: E402
from repro_torch.kernels import registry as t_reg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import rwkv as t_rwkv  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

ARCH = "rwkv6_1_6b"
REF_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
PALLAS_TOL = dict(atol=1e-4, rtol=1e-4)
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(a, b, tol, label=""):
    np.testing.assert_allclose(npy(a), npy(b), **tol, err_msg=str(label))


def recurrence_inputs(seed, B, H, T, Dh, nonzero_state=True):
    """r, k, v, w, u, state as numpy float32, drawn as the JAX package's
    kernel test draws them (k, v by 0.3; sigmoid decays; u, state by
    0.1)."""
    rs = np.random.default_rng(seed)

    def n(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    w = 1.0 / (1.0 + np.exp(-n(B, H, T, Dh)))
    state = n(B, H, Dh, Dh) * 0.1 if nonzero_state else \
        np.zeros((B, H, Dh, Dh), np.float32)
    return (n(B, H, T, Dh), n(B, H, T, Dh) * 0.3, n(B, H, T, Dh) * 0.3,
            w.astype(np.float32), n(H, Dh) * 0.1, state)


def both(arrs, dtype="float32"):
    """The four (B, H, T, Dh) inputs in ``dtype`` and u, state in float32,
    for each package (the same bits: both round float32 to bf16 to
    nearest even)."""
    tt = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs[:4]]
    jj = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs[:4]]
    return (tt + [torch.as_tensor(a) for a in arrs[4:]],
            jj + [jnp.asarray(a) for a in arrs[4:]])


# ---------------------------------------------------------------------------
# the recurrence: refs, the plain path, the Pallas kernel, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("form", ("naive", "chunked", "decode"))
def test_refs_match_jax(form, dtype):
    arrs = recurrence_inputs(1, 2, 3, 64, 16)
    if form == "decode":
        arrs = tuple(a[:, :, 5] for a in arrs[:4]) + arrs[4:]
    (tr, tk, tv, tw, tu, ts), (jr, jk, jv, jw, ju, js) = both(arrs, dtype)
    kw = {"chunk": 16} if form == "chunked" else {}
    name = "rwkv6_" + form
    out, state = getattr(t_ref, name)(tr, tk, tv, tw, tu, ts, **kw)
    j_out, j_state = getattr(j_ref, name)(jr, jk, jv, jw, ju, js, **kw)
    assert out.dtype == tr.dtype and state.dtype == torch.float32
    assert tuple(out.shape) == j_out.shape
    close(out, j_out, REF_TOL[dtype], (form, dtype, "out"))
    # the state is float32 either way; from bf16 inputs it sums the same
    # rounded values, so it keeps float32's tolerance
    close(state, j_state, REF_TOL["float32"], (form, dtype, "state"))


@pytest.mark.parametrize("B,H,T,dh,bt", [
    (2, 2, 128, 32, 32), (1, 4, 64, 64, 64), (1, 1, 96, 16, 16),
])
def test_plain_path_matches_the_pallas_kernel(B, H, T, dh, bt):
    """The wrapper on CPU tensors (its plain twin) against the Pallas
    kernel in interpret mode, on the JAX package's kernel-test shapes."""
    (tr, tk, tv, tw, tu, ts), (jr, jk, jv, jw, ju, js) = both(
        recurrence_inputs(T + dh, B, H, T, dh))
    t_reg.reset_launches()
    out, state = t_rk.rwkv6(tr, tk, tv, tw, tu, ts)
    j_out, j_state = rwkv6_pallas(jr, jk, jv, jw, ju, js, block_t=bt,
                                  interpret=True)
    close(out, j_out, PALLAS_TOL, "out")
    close(state, j_state, PALLAS_TOL, "state")
    assert t_reg.KERNELS["rwkv6_scan"].launches == 0     # CPU: the twin


def test_chunked_refuses_a_ragged_T_and_naive_takes_any():
    arrs = recurrence_inputs(2, 1, 2, 100, 16)
    (tr, tk, tv, tw, tu, ts), (jr, jk, jv, jw, ju, js) = both(arrs)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        t_ref.rwkv6_chunked(tr, tk, tv, tw, tu, ts, chunk=64)
    want = j_ref.rwkv6_naive(jr, jk, jv, jw, ju, js)
    for got in (t_ref.rwkv6_naive(tr, tk, tv, tw, tu, ts),
                t_rk.rwkv6(tr, tk, tv, tw, tu, ts),      # the twin: naive
                t_rk.plain(tr, tk, tv, tw, tu, ts)):
        close(got[0], want[0], REF_TOL["float32"], "out")
        close(got[1], want[1], REF_TOL["float32"], "state")
    # where the chunked form runs (a T shorter than the chunk is one chunk,
    # as in the reference; or a multiple of it) it takes the same steps in
    # the same order as the twin: equal bitwise
    for T, chunk in ((40, 64), (96, 32), (100, 25)):
        part = [x[:, :, :T] if x.dim() == 4 and x.shape[2] == 100 else x
                for x in (tr, tk, tv, tw)] + [tu, ts]
        got = t_ref.rwkv6_chunked(*part, chunk=chunk)
        twin = t_rk.plain(*part)
        assert torch.equal(got[0], twin[0]), (T, chunk)
        assert torch.equal(got[1], twin[1]), (T, chunk)


def test_the_pallas_wrapper_drops_the_tail_and_the_port_does_not():
    """A reference behaviour, not a port fault: ``rwkv6_pallas`` walks
    ``T // 128`` blocks of 128 steps, so for T = 160 its final state
    misses the last 32 tokens.  The port takes every step."""
    arrs = recurrence_inputs(3, 1, 2, 160, 16)
    (tr, tk, tv, tw, tu, ts), (jr, jk, jv, jw, ju, js) = both(arrs)
    j_out, j_state = rwkv6_pallas(jr, jk, jv, jw, ju, js, interpret=True)
    head = j_ref.rwkv6_naive(jr[:, :, :128], jk[:, :, :128], jv[:, :, :128],
                             jw[:, :, :128], ju, js)
    whole = j_ref.rwkv6_naive(jr, jk, jv, jw, ju, js)
    close(j_state, head[1], PALLAS_TOL, "pallas state = 128 steps")
    close(j_out[:, :, :128], head[0], PALLAS_TOL, "pallas rows < 128")
    assert np.abs(npy(j_state) - npy(whole[1])).max() > 1e-2
    out, state = t_rk.rwkv6(tr, tk, tv, tw, tu, ts)
    close(out, whole[0], REF_TOL["float32"], "port out")
    close(state, whole[1], REF_TOL["float32"], "port state")


def test_ops_dispatch_and_the_kernel_row():
    (tr, tk, tv, tw, tu, ts), (jr, jk, jv, jw, ju, js) = both(
        recurrence_inputs(4, 1, 2, 32, 16))
    want = j_ref.rwkv6_naive(jr, jk, jv, jw, ju, js)
    t_reg.reset_launches()
    try:
        for impl in (None, "ref"):
            t_ops.set_impl(impl)
            got = t_ops.rwkv6(tr, tk, tv, tw, tu, ts)
            close(got[0], want[0], REF_TOL["float32"], impl)
            close(got[1], want[1], REF_TOL["float32"], impl)
        t_ops.set_impl("cuda")
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            t_ops.rwkv6(tr, tk, tv, tw, tu, ts)
    finally:
        t_ops.set_impl(None)
    # the decode step is the plain op in both packages
    step = [x[:, :, 0] for x in (tr, tk, tv, tw)]
    got = t_ops.rwkv6_decode(*step, tu, ts)
    j_got = j_ops.rwkv6_decode(*(x[:, :, 0] for x in (jr, jk, jv, jw)),
                               ju, js)
    close(got[0], j_got[0], REF_TOL["float32"])
    close(got[1], j_got[1], REF_TOL["float32"])
    assert t_reg.KERNELS["rwkv6_scan"].launches == 0
    row = t_reg.KERNELS["rwkv6_scan"].replaces
    assert row == "src/repro/kernels/rwkv6_scan.py:67"
    path, line = row.rsplit(":", 1)
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, path)) as f:
        assert "pl.pallas_call(" in f.read().splitlines()[int(line) - 1]


def test_wrapper_checks_its_inputs():
    tr, tk, tv, tw, tu, ts = both(recurrence_inputs(5, 1, 2, 16, 16))[0]
    with pytest.raises(ValueError, match="does not match"):
        t_rk.rwkv6(tr, tk[:, :, :8], tv, tw, tu, ts)
    with pytest.raises(TypeError):
        t_rk.rwkv6(tr, tk.double(), tv, tw, tu, ts)
    with pytest.raises(TypeError):
        t_rk.rwkv6(*(x.double() for x in (tr, tk, tv, tw)), tu, ts)
    with pytest.raises(TypeError, match="float32"):
        t_rk.rwkv6(tr, tk, tv, tw, tu.bfloat16(), ts)
    with pytest.raises(ValueError, match="state"):
        t_rk.rwkv6(tr, tk, tv, tw, tu, ts[:, :, :8])
    with pytest.raises(ValueError, match="empty"):
        t_rk.rwkv6(*(x[:, :, :0] for x in (tr, tk, tv, tw)), tu, ts)
    with pytest.raises(ValueError, match=r"\(B, H, T, Dh\)"):
        t_rk.rwkv6(tr[0], tk[0], tv[0], tw[0], tu, ts)


# ---------------------------------------------------------------------------
# the block and the model
# ---------------------------------------------------------------------------

def perturbed(tree, seed=7):
    """A JAX rwkv parameter tree with the token-shift mixes, the norms and
    the decay base drawn away from their zero / constant init (at init the
    mixes are 0, which would leave the shift untested)."""
    rs = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, name) for v in node)
        a = np.asarray(node)
        if name.startswith("mu_") or name in ("cm_mu", "ln_x", "ln1", "ln2"):
            noise = rs.random(a.shape).astype(np.float32)
        elif name == "w_base":
            noise = a.astype(np.float32) + rs.standard_normal(a.shape
                                                              ).astype(
                                                                  np.float32)
        else:
            return a
        return np.asarray(jnp.asarray(noise, a.dtype))

    return walk(tree)


def models(**changes):
    """(config for each package, JAX params, the port's params), with the
    perturbed JAX weights carried across."""
    jcfg = dataclasses.replace(j_cb.smoke_config(ARCH), **changes)
    tcfg = dataclasses.replace(t_cb.smoke_config(ARCH), **changes)
    tree = perturbed(jax.tree.map(np.asarray,
                                  j_tfm.init_params(jcfg,
                                                    jax.random.PRNGKey(0))))
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, t_tfm.params_from_numpy(tree, tcfg)


def block_params(seed, dtype="float32"):
    """One layer's rwkv parameters for each package, from the JAX init,
    perturbed."""
    jcfg = dataclasses.replace(j_cb.smoke_config(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(t_cb.smoke_config(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    tree = perturbed({k: np.asarray(v) for k, v in j_rwkv.rwkv_init(
        jax.random.PRNGKey(seed), jcfg).items()}, seed)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in tree.items()},
            {k: t_tfm._tensor_from_numpy(v) for k, v in tree.items()})


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def test_rwkv_init_leaves_match_jax():
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(j_cb.smoke_config(ARCH),
                                   param_dtype=dtype)
        tcfg = dataclasses.replace(t_cb.smoke_config(ARCH),
                                   param_dtype=dtype)
        want = j_rwkv.rwkv_init(jax.random.PRNGKey(0), jcfg)
        got = t_rwkv.rwkv_init(tcfg, torch.Generator().manual_seed(0), "cpu",
                               lead=(3,))
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == (3,) + want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
        assert got["w_base"].dtype == got["u"].dtype == torch.float32
        assert torch.equal(got["w_base"], torch.full_like(got["w_base"], -2))
        assert want["w_a"].shape == (tcfg.d_model, t_rwkv.LORA) == (64, 64)


@pytest.mark.parametrize("shifted", (False, True))
def test_time_mix_and_channel_mix_match_jax(shifted):
    """Prefill forms, from a zero pad (prefill) or from given tails, with
    a nonzero state."""
    jcfg, tcfg, jp, tp = block_params(1)
    rs = np.random.default_rng(2)
    B, S, D = 2, 24, tcfg.d_model
    H, dh = tcfg.n_heads, tcfg.head_dim
    x = rs.standard_normal((B, S, D)).astype(np.float32)
    st = rs.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.1
    last = rs.standard_normal((B, D)).astype(np.float32) if shifted else None
    t_last = None if last is None else torch.as_tensor(last)
    j_last = None if last is None else jnp.asarray(last)
    got = t_rwkv.time_mix(tp, torch.as_tensor(x), tcfg, torch.as_tensor(st),
                          t_last)
    want = j_rwkv.time_mix(jp, jnp.asarray(x), jcfg, jnp.asarray(st), j_last)
    for name, a, b in zip(("out", "state", "tail"), got, want):
        close(a, b, BLOCK_TOL, ("time_mix", name))
    got = t_rwkv.channel_mix(tp, torch.as_tensor(x), t_last)
    want = j_rwkv.channel_mix(jp, jnp.asarray(x), j_last)
    for name, a, b in zip(("out", "tail"), got, want):
        close(a, b, BLOCK_TOL, ("channel_mix", name))


def test_decode_forms_match_jax():
    jcfg, tcfg, jp, tp = block_params(3)
    rs = np.random.default_rng(4)
    B, D = 3, tcfg.d_model
    H, dh = tcfg.n_heads, tcfg.head_dim
    x, last = (rs.standard_normal((B, D)).astype(np.float32)
               for _ in range(2))
    st = rs.standard_normal((B, H, dh, dh)).astype(np.float32) * 0.1
    got = t_rwkv.time_mix_decode(tp, torch.as_tensor(x), tcfg,
                                 torch.as_tensor(st), torch.as_tensor(last))
    want = j_rwkv.time_mix_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(st),
                                  jnp.asarray(last))
    for name, a, b in zip(("out", "state", "tail"), got, want):
        close(a, b, BLOCK_TOL, ("time_mix_decode", name))
    got = t_rwkv.channel_mix_decode(tp, torch.as_tensor(x),
                                    torch.as_tensor(last))
    want = j_rwkv.channel_mix_decode(jp, jnp.asarray(x), jnp.asarray(last))
    for name, a, b in zip(("out", "tail"), got, want):
        close(a, b, BLOCK_TOL, ("channel_mix_decode", name))


def test_channel_mix_receptance_reads_the_shifted_input():
    """``sigmoid(xs @ cm_r)``, not the mixed input: with cm_mu = 0 the mix
    is x itself, and reading it would change the output."""
    _, tcfg, _, tp = block_params(5)
    tp = dict(tp, cm_mu=torch.zeros_like(tp["cm_mu"]))
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32))
    got, _ = t_rwkv.channel_mix(tp, x)
    xs = t_rwkv._shift(x)
    h = torch.square(torch.relu(x @ tp["cm_k"])) @ tp["cm_v"]
    close(got, torch.sigmoid(xs @ tp["cm_r"]) * h, BLOCK_TOL)
    assert float((got - torch.sigmoid(x @ tp["cm_r"]) * h).abs().max()) > 1e-3


def test_ln_x_is_one_rmsnorm_over_the_heads_width():
    """ln_x normalises all H * Dh channels together, not per head; the
    per-head group norm would give another output."""
    _, tcfg, _, tp = block_params(8)
    rs = np.random.default_rng(9)
    B, S, H, dh = 1, 5, tcfg.n_heads, tcfg.head_dim
    out = torch.as_tensor(rs.standard_normal((B, S, H * dh)).astype(
        np.float32)) * torch.linspace(0.1, 4.0, H * dh)
    g = torch.as_tensor(rs.standard_normal((B, S, H * dh)).astype(
        np.float32))
    got = t_rwkv._gate_out(tp, out, g)
    per_head = t_rwkv.layers.rmsnorm(
        tp["ln_x"].view(H, dh), out.view(B, S, H, dh)).view(B, S, H * dh)
    other = (per_head * torch.nn.functional.silu(g)) @ tp["wo"]
    assert float((got - other).abs().max()) > 1e-2


def test_decay_is_rounded_to_the_compute_dtype(monkeypatch):
    """In bf16 the decay ``w`` reaches the recurrence rounded to bf16, as
    ``heads(w.astype(x.dtype))`` does in the JAX package; r, k, v too.
    The rounding is visible: the recurrence on the float32 decay differs
    from the one on the rounded decay by far more than the two packages
    differ from each other."""
    jcfg, tcfg, jp, tp = block_params(10, "bfloat16")
    seen = {}

    def spy(pkg, fn):
        def wrapped(*args, **kw):
            seen[pkg] = args
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(t_ops, "rwkv6", spy("torch", t_ops.rwkv6))
    monkeypatch.setattr(j_ops, "rwkv6", spy("jax", j_ops.rwkv6))
    x = np.random.default_rng(11).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    B, S, H, dh = 2, 32, tcfg.n_heads, tcfg.head_dim
    st = np.zeros((B, H, dh, dh), np.float32)
    got = t_rwkv.time_mix(tp, torch.as_tensor(x).bfloat16(), tcfg,
                          torch.as_tensor(st))
    want = j_rwkv.time_mix(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                           jnp.asarray(st))
    close(got[0], want[0], REF_TOL["bfloat16"], "time_mix out")
    t_args, j_args = seen["torch"], seen["jax"]
    assert all(a.dtype == torch.bfloat16 for a in t_args[:4])
    # the decay of each package, as bf16 bits: at most one ulp apart
    # (their float32 products may sum in other orders), mostly equal
    tw = t_args[3].contiguous().view(torch.int16).numpy().astype(int)
    jw = np.asarray(j_args[3]).view(np.int16).astype(int)
    assert np.abs(tw - jw).max() <= 1 and (tw != jw).mean() < 0.01
    for a, b in zip(t_args[:3], j_args[:3]):
        close(a, b, REF_TOL["bfloat16"])
    # the float32 decay the port rounded, and the recurrence on each
    mixed = t_rwkv._mix(torch.as_tensor(x).bfloat16(), t_rwkv._shift(
        torch.as_tensor(x).bfloat16()), tp["mu_w"])
    w32 = t_rwkv._decay(tp, mixed).view(B, S, H, dh).transpose(1, 2)
    assert torch.equal(w32.to(torch.bfloat16), t_args[3])
    r, k, v = t_args[:3]
    rounded = t_ref.rwkv6_naive(r, k, v, t_args[3], *t_args[4:])[0]
    unrounded = t_ref.rwkv6_naive(r.float(), k.float(), v.float(), w32,
                                  *t_args[4:])[0]
    j_out = j_ref.rwkv6_naive(*j_args)[0]
    gap = float((unrounded - rounded.float()).abs().max())
    agree = np.abs(npy(rounded) - npy(j_out)).max()
    assert gap > 4 * max(agree, 1e-3), (gap, agree)


@pytest.mark.parametrize("shifted", (False, True))
def test_forward_prefill_and_decode_match_jax(shifted):
    """Smoke rwkv6: forward logits, prefill logits and decode state leaf
    for leaf, then 4 decode steps and the state after them.  ``shifted``
    carries the JAX weights as perturbed (mixes, norms and decay base
    away from their init); otherwise as initialised."""
    jcfg = j_cb.smoke_config(ARCH)
    tcfg = t_cb.smoke_config(ARCH)
    if shifted:
        jcfg, tcfg, jp, tp = models()
    else:
        jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    B, S, EXTRA = 2, 30, 4
    tok = tokens(tcfg, B, S + EXTRA, seed=1)
    got, _ = t_tfm.forward(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    want, _ = j_tfm.forward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    close(got, want, MODEL_TOL, "forward")
    t_last, t_state = t_tfm.prefill(
        tp, tcfg, {"tokens": torch.as_tensor(tok[:, :S])}, S + EXTRA)
    j_last, j_state = j_tfm.prefill(
        jp, jcfg, {"tokens": jnp.asarray(tok[:, :S])}, S + EXTRA)
    close(t_last, j_last, MODEL_TOL, "prefill")
    state_close(t_state, j_state, "prefill")
    for t in range(EXTRA):
        t_log, t_state = t_tfm.decode_step(tp, tcfg, t_state,
                                           torch.as_tensor(tok[:, S + t]))
        j_log, j_state = j_tfm.decode_step(jp, jcfg, j_state,
                                           jnp.asarray(tok[:, S + t]))
        close(t_log, j_log, MODEL_TOL, ("decode", t))
    state_close(t_state, j_state, "decode")


def state_close(t_state, j_state, label):
    assert np.array_equal(t_state.length.numpy(), np.asarray(j_state.length))
    assert len(t_state.caches) == len(j_state.caches) == 1
    for tc, jc in zip(t_state.caches, j_state.caches):
        assert sorted(tc) == sorted(jc) == ["cm_last", "rwkv_state",
                                             "tm_last"]
        for key in tc:
            assert tuple(tc[key].shape) == jc[key].shape, (label, key)
            assert str(tc[key].dtype).split(".")[-1] == jc[key].dtype.name
            close(tc[key], jc[key], MODEL_TOL, (label, key))


def test_decode_matches_the_full_forward():
    """Teacher-forced decode reproduces the port's own full forward, as
    the JAX package checks for itself (``tests/test_models.py``)."""
    _, tcfg, _, tp = models()
    B, S, EXTRA = 2, 48, 4
    tok = torch.as_tensor(tokens(tcfg, B, S + EXTRA, seed=2))
    full, _ = t_tfm.forward(tp, tcfg, {"tokens": tok})
    last, state = t_tfm.prefill(tp, tcfg, {"tokens": tok[:, :S]}, S + EXTRA)
    close(last, full[:, S - 1], MODEL_TOL)
    for t in range(EXTRA):
        logits, state = t_tfm.decode_step(tp, tcfg, state, tok[:, S + t])
        close(logits, full[:, S + t], dict(atol=3e-4, rtol=3e-4), t)


def test_decode_updates_the_state_in_place():
    _, tcfg, _, tp = models()
    tok = torch.as_tensor(tokens(tcfg, 2, 10, seed=3))
    _, state = t_tfm.prefill(tp, tcfg, {"tokens": tok[:, :8]}, 10)
    leaves = {k: v for k, v in state.caches[0].items()}
    before = {k: v.clone() for k, v in leaves.items()}
    _, after = t_tfm.decode_step(tp, tcfg, state, tok[:, 8])
    for k, v in after.caches[0].items():
        assert v is leaves[k], k
        assert not torch.equal(v, before[k]), k
    assert after.length.tolist() == [9, 9]


def test_init_decode_state_matches_jax():
    jcfg, tcfg = j_cb.smoke_config(ARCH), t_cb.smoke_config(ARCH)
    state_close(t_tfm.init_decode_state(tcfg, 3, 20),
                j_tfm.init_decode_state(jcfg, 3, 20), "init")


def test_params_map_one_to_one_onto_the_jax_tree():
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(j_cb.smoke_config(ARCH), param_dtype=dtype)
        tcfg = dataclasses.replace(t_cb.smoke_config(ARCH), param_dtype=dtype)
        jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
        flat, _ = jax.tree_util.tree_flatten_with_path(jp)
        jpaths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): np.asarray(leaf)
                  for path, leaf in flat}
        tparams = dict(tp.named_parameters())
        assert sorted(tparams) == sorted(jpaths)
        for name, leaf in jpaths.items():
            a = tparams[name]
            assert str(a.dtype).split(".")[-1] == leaf.dtype.name, name
            assert np.array_equal(npy(a), leaf.astype(np.float32)), name
        drawn = t_tfm.init_params(tcfg, torch.Generator().manual_seed(0),
                                  "cpu")
        assert {n: (tuple(p.shape), p.dtype)
                for n, p in drawn.named_parameters()} == \
            {n: (tuple(p.shape), p.dtype) for n, p in tparams.items()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _jax_serve_loop(params, cfg, batch, gen):
    """The loop of the JAX ``serve.main``, without its mesh."""
    max_len = batch["tokens"].shape[1] + gen
    logits, state = jax.jit(
        lambda p, b: j_tfm.prefill(p, cfg, b, max_len))(params, batch)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    step = jax.jit(lambda p, s, t: j_tfm.decode_step(p, cfg, s, t))
    outs = [np.asarray(tok)]
    for _ in range(gen - 1):
        logits, state = step(params, state, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        outs.append(np.asarray(tok))
    return np.stack(outs, axis=1)


def _as_jax_tree(node):
    """The port's parameters as the JAX parameter tree."""
    if isinstance(node, torch.nn.ModuleList):
        return tuple(_as_jax_tree(x) for x in node)
    if isinstance(node, t_tfm.ParamTree):
        return {k: _as_jax_tree(node[k]) for k in node.keys()}
    return jnp.asarray(node.detach().numpy())


def test_serve_main_gives_the_jax_greedy_ids():
    """``serve.main --arch rwkv6_1_6b --smoke --device cpu`` (its default
    batch 4, prompt 48, 16 tokens) against the JAX serving loop on the
    same weights and prompts, id for id."""
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    tcfg, jcfg = t_cb.smoke_config(ARCH), j_cb.smoke_config(ARCH)
    tp = t_tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tok = t_pipe.batch_for(tcfg, 0, 4, 48)["tokens"]
    want = _jax_serve_loop(_as_jax_tree(tp), jcfg,
                           {"tokens": jnp.asarray(tok)}, 16)
    assert out.ids.dtype == torch.int32 and tuple(out.ids.shape) == (4, 16)
    assert len(np.unique(want)) > 10
    assert np.array_equal(out.ids.numpy(), want), (out.ids, want)
    assert tuple(out.prefill_logits.shape) == (4, tcfg.vocab)
    zero = dict.fromkeys(t_reg.KERNELS, 0)
    assert out.launches == {"prefill": zero, "decode": zero}   # CPU: twins


def test_generate_gives_the_jax_greedy_ids_with_jax_weights():
    jcfg, tcfg, jp, tp = models()
    tok = t_pipe.batch_for(tcfg, 5, 3, 40)["tokens"]
    want = _jax_serve_loop(jp, jcfg, {"tokens": jnp.asarray(tok)}, 12)
    got = serve.generate(tp, tcfg, {"tokens": torch.as_tensor(tok)}, 12)
    assert np.array_equal(got.ids.numpy(), want), (got.ids, want)
