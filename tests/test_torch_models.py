"""The port's dense model stack (``repro_torch.configs``, ``models.layers``,
``models.transformer``) against the JAX package's, with the JAX package's
own weights carried across by ``params_from_numpy``.

Forward logits, prefill logits and decode state, and decode steps past the
local layers' ring are held to 2e-4 (atol and rtol), the JAX package's own
tolerance between its forward and its decode (``tests/test_models.py``);
the parity traps of the reference each get a test of their own.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ("gemma2_2b", "yi_9b")
ALL = j_cb.ARCH_IDS + ("repro_100m",)


def npy(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def close(a, b, label="", tol=TOL):
    np.testing.assert_allclose(npy(a), npy(b), **tol, err_msg=str(label))


def models(arch, **changes):
    """(config for each package, JAX params, the port's params)."""
    jcfg = dataclasses.replace(j_cb.smoke_config(arch), **changes)
    tcfg = dataclasses.replace(t_cb.smoke_config(arch), **changes)
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def state_close(t_state, j_state, label):
    assert np.array_equal(t_state.length.numpy(), np.asarray(j_state.length))
    assert len(t_state.caches) == len(j_state.caches)
    for p, (tc, jc) in enumerate(zip(t_state.caches, j_state.caches)):
        assert sorted(tc) == sorted(jc), (label, p)
        for key in tc:
            a, b = tc[key], jc[key]
            assert tuple(a.shape) == b.shape, (label, p, key)
            if a.dtype == torch.int8:
                # int8 codes of the same float32 k/v: a value within an
                # ulp of a rounding boundary may land one code away
                assert str(b.dtype) == "int8", (label, p, key)
                diff = np.abs(a.numpy().astype(int) - np.asarray(b, int))
                assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, \
                    (label, p, key)
            else:
                close(a, b, (label, p, key))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_map_one_to_one_onto_the_jax_tree(arch):
    jcfg, tcfg, jp, tp = models(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    jpaths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): np.asarray(leaf)
              for path, leaf in flat}
    tparams = dict(tp.named_parameters())
    assert sorted(tparams) == sorted(jpaths)
    for name, leaf in jpaths.items():
        assert np.array_equal(tparams[name].numpy(), leaf), name
    # weights stay (in, out): no leaf is transposed
    assert tuple(tp["streams"][0]["attn"]["wq"].shape[1:]) == (
        tcfg.d_model, tcfg.n_heads * tcfg.head_dim)


def test_params_from_numpy_keeps_bfloat16_bits_and_checks_shapes():
    jcfg, tcfg, jp, tp = models("gemma2_2b", param_dtype="bfloat16")
    a = tp["embed"]
    assert a.dtype == torch.bfloat16
    want = np.asarray(jp["embed"]).view(np.int16)
    assert np.array_equal(a.view(torch.int16).numpy(), want)
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        t_tfm.params_from_numpy(tree, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp = models(arch)
    tok = tokens(tcfg, 2, 40)
    got, aux = t_tfm.forward(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    want, _ = j_tfm.forward(jp, jcfg, {"tokens": jnp.asarray(tok)})
    assert tuple(got.shape) == (2, 40, tcfg.vocab)
    close(got, want, arch)
    assert sorted(aux) == sorted(j_tfm.AUX_KEYS)


@pytest.mark.parametrize("kv_cache_dtype", ("bfloat16", "int8"))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_past_the_ring_match_jax(arch, kv_cache_dtype):
    """Prefill 30 tokens, then 4 decode steps: the local layers' 32-slot
    ring wraps at step 3.  Logits of every step and the decode state
    after prefill and after the last step, leaf for leaf."""
    jcfg, tcfg, jp, tp = models(arch, kv_cache_dtype=kv_cache_dtype)
    B, S, EXTRA = 2, 30, 4
    tok = tokens(tcfg, B, S + EXTRA, seed=1)
    t_last, t_state = t_tfm.prefill(tp, tcfg,
                                    {"tokens": torch.as_tensor(tok[:, :S])},
                                    S + EXTRA)
    j_last, j_state = j_tfm.prefill(jp, jcfg, {"tokens": jnp.asarray(
        tok[:, :S])}, S + EXTRA)
    close(t_last, j_last, "prefill")
    state_close(t_state, j_state, "prefill")
    if kv_cache_dtype == "int8":
        # decode from the JAX package's int8 codes: a code one step away
        # (above) moves a logit by ~1e-3, which is the quantisation, not
        # the port; from the same codes the steps agree to 2e-4
        t_state = t_tfm.DecodeState(
            caches=tuple({k: torch.as_tensor(np.asarray(v).copy())
                          for k, v in c.items()} for c in j_state.caches),
            length=torch.as_tensor(np.asarray(j_state.length).copy()))
    if "local" in tcfg.attn_pattern:
        assert t_state.caches[0]["k"].shape[3] == tcfg.window == 32
    for t in range(EXTRA):
        t_log, t_state = t_tfm.decode_step(tp, tcfg, t_state,
                                           torch.as_tensor(tok[:, S + t]))
        j_log, j_state = j_tfm.decode_step(jp, jcfg, j_state,
                                           jnp.asarray(tok[:, S + t]))
        close(t_log, j_log, ("decode", t))
    state_close(t_state, j_state, "decode")


def test_decode_matches_the_full_forward():
    """Teacher-forced decode reproduces the port's own full forward, as
    the JAX package checks for itself (``tests/test_models.py``)."""
    _, tcfg, _, tp = models("gemma2_2b")
    B, S, EXTRA = 1, 40, 6
    tok = torch.as_tensor(tokens(tcfg, B, S + EXTRA, seed=2))
    full, _ = t_tfm.forward(tp, tcfg, {"tokens": tok})
    _, state = t_tfm.prefill(tp, tcfg, {"tokens": tok[:, :S]}, S + EXTRA)
    for t in range(EXTRA):
        logits, state = t_tfm.decode_step(tp, tcfg, state, tok[:, S + t])
        close(logits, full[:, S + t], t, tol=dict(atol=3e-4, rtol=3e-4))


def test_init_decode_state_matches_jax():
    for arch in ARCHS:
        jcfg, tcfg = j_cb.smoke_config(arch), t_cb.smoke_config(arch)
        state_close(t_tfm.init_decode_state(tcfg, 3, 20),
                    j_tfm.init_decode_state(jcfg, 3, 20), arch)


def test_init_params_draws_the_jax_shapes_from_a_generator():
    tcfg = t_cb.smoke_config("gemma2_2b")
    jp = j_tfm.init_params(j_cb.smoke_config("gemma2_2b"),
                           jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tp = t_tfm.init_params(tcfg, gen, "cpu")
    again = t_tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    shapes = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): leaf.shape for path, leaf in flat}
    got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    assert got == shapes
    for (n, a), (_, b) in zip(tp.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    # the JAX package's scales: N(0, 1) embeddings, N(0, 1/fan_in) weights
    assert 0.9 < float(tp["embed"].std()) < 1.1
    wq = tp["streams"][0]["attn"]["wq"]
    assert 0.9 < float(wq.std()) * tcfg.d_model ** 0.5 < 1.1


# ---------------------------------------------------------------------------
# the parity traps, one by one
# ---------------------------------------------------------------------------

def test_gelu_is_the_tanh_approximation():
    cfg = t_cb.smoke_config("gemma2_2b")
    assert cfg.mlp_act == "gelu_glu"
    rs = np.random.default_rng(4)
    x = rs.standard_normal((3, cfg.d_model)).astype(np.float32) * 3
    p = {k: rs.standard_normal(s).astype(np.float32) * 0.2 for k, s in (
        ("wg", (cfg.d_model, cfg.d_ff)), ("wu", (cfg.d_model, cfg.d_ff)),
        ("wd", (cfg.d_ff, cfg.d_model)))}
    got = t_layers.mlp_apply({k: torch.as_tensor(v) for k, v in p.items()},
                             torch.as_tensor(x), cfg)
    want = j_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), j_cb.smoke_config("gemma2_2b"))
    close(got, want, tol=dict(atol=1e-5, rtol=1e-5))
    h = torch.as_tensor(x @ p["wg"])
    erf = (torch.nn.functional.gelu(h) * torch.as_tensor(x @ p["wu"])) \
        @ torch.as_tensor(p["wd"])
    assert float((erf - got).abs().max()) > 1e-3   # the exact gelu differs


def test_rope_rotates_the_two_halves():
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32) * 9, (2, 1))
    got = t_layers.rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    want = j_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    close(got, want, tol=dict(atol=1e-5, rtol=1e-5))
    # pairs (even, odd) would be another rotation
    half = 8
    freqs = 10000.0 ** (-np.arange(half, dtype=np.float32) / half)
    ang = pos[..., None].astype(np.float32) * freqs
    c, s = np.cos(ang)[..., None, :], np.sin(ang)[..., None, :]
    ev, od = x[..., 0::2], x[..., 1::2]
    pairs = np.stack([ev * c - od * s, ev * s + od * c], -1).reshape(x.shape)
    assert np.abs(pairs - got.numpy()).max() > 0.1
    # decode form: (B, H, Dh) at per-lane positions
    got1 = t_layers.rope(torch.as_tensor(x[:, 0]), torch.as_tensor(pos[:, 3]),
                         500.0)
    close(got1, j_layers.rope(jnp.asarray(x[:, 0]), jnp.asarray(pos[:, 3]),
                              500.0), tol=dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rmsnorm_scales_by_one_plus_scale_in_float32(dtype):
    rs = np.random.default_rng(6)
    x = rs.standard_normal((4, 64)).astype(np.float32) * 5
    sc = rs.standard_normal(64).astype(np.float32) * 0.5
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = t_layers.rmsnorm(torch.as_tensor(sc), tx)
    want = j_layers.rmsnorm(jnp.asarray(sc), jnp.asarray(x, dtype))
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 1e-2
    close(got, want, tol=dict(atol=tol, rtol=tol))
    # zeros as scale: plain normalisation (the "1 +" keeps it)
    unit = t_layers.rmsnorm(torch.zeros(64), torch.as_tensor(x))
    close(unit.pow(2).mean(-1), np.ones(4), tol=dict(atol=1e-4, rtol=1e-4))


def test_tied_embeddings_scale_in_the_compute_dtype():
    """gemma2 multiplies its embeddings by sqrt(d_model) rounded to the
    compute dtype first: at d_model 72, sqrt is 8.485..., 8.5 in bf16."""
    changes = dict(d_model=72, param_dtype="bfloat16",
                   compute_dtype="bfloat16")
    jcfg, tcfg, jp, tp = models("gemma2_2b", **changes)
    tok = tokens(tcfg, 2, 9)
    got = t_tfm._embed_inputs(tp, tcfg, {"tokens": torch.as_tensor(tok)})
    want = j_tfm._embed_inputs(jp, jcfg, {"tokens": jnp.asarray(tok)})
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    f32 = tp["embed"][torch.as_tensor(tok).long()].float() * 72 ** 0.5
    assert not torch.equal(got, f32.to(torch.bfloat16))


def test_final_logit_softcap_is_30():
    jcfg, tcfg, jp, tp = models("gemma2_2b")
    assert tcfg.logit_softcap == 30.0 and tcfg.attn_softcap == 50.0
    x = np.random.default_rng(8).standard_normal((2, 3, tcfg.d_model)
                                                 ).astype(np.float32) * 50
    tp["embed"].mul_(20.0)   # logits far beyond the cap
    jp = dict(jp, embed=jp["embed"] * 20.0)
    got = t_tfm._logits(tp, tcfg, torch.as_tensor(x))
    want = j_tfm._logits(jp, jcfg, jnp.asarray(x))
    close(got, want)
    assert float(got.abs().max()) <= 30.0 < float(
        (t_layers.rmsnorm(tp["final_norm"], torch.as_tensor(x))
         @ tp["embed"].T).abs().max())


def test_local_decode_cache_is_a_ring_of_the_window():
    """Local layers keep min(window, max_len) slots, written at pos % C;
    at decode only "slot filled" is masked."""
    jcfg, tcfg, jp, tp = models("gemma2_2b")
    for max_len, C in ((20, 20), (50, 32)):
        c = t_layers.attn_cache_init(tcfg, "local", 1, max_len)
        assert c.k.shape[2] == C
        assert t_layers.attn_cache_init(tcfg, "full", 1, max_len
                                        ).k.shape[2] == max_len
    rs = np.random.default_rng(9)
    kt = rs.standard_normal((1, 2, 40, 16)).astype(np.float32)
    vt = rs.standard_normal((1, 2, 40, 16)).astype(np.float32)
    got = t_layers.attn_cache_from_prefill(tcfg, "local", torch.as_tensor(kt),
                                           torch.as_tensor(vt), 50)
    want = j_layers.attn_cache_from_prefill(jcfg, "local", jnp.asarray(kt),
                                            jnp.asarray(vt), 50)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # slot p % 32 holds position p for the last 32 positions
    assert np.array_equal(got.k[0, :, 40 % 32].numpy(), kt[0, :, 40 - 32])


@pytest.mark.parametrize("name", ALL)
def test_registry_and_smoke_config_equal_jax(name):
    for fn in ("get", "smoke_config"):
        a = getattr(t_cb, fn)(name)
        b = getattr(j_cb, fn)(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), (fn, name)
        assert str(a.pdtype).split(".")[-1] == b.pdtype.name
        assert str(a.cdtype).split(".")[-1] == b.cdtype.name
        assert a.n_params() == b.n_params()
        assert a.head_dim == b.head_dim
    assert t_cb.ARCH_IDS == j_cb.ARCH_IDS
    assert name in t_cb.REGISTRY and len(t_cb.REGISTRY) == 11
    assert set(t_cb.all_configs()) == set(ALL)
    with pytest.raises(KeyError):
        t_cb.get("no_such_arch")
