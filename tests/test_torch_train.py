"""The port's training path against the JAX package's, on the CPU: the
attention backward (``ref._attn_bwd`` and the twin's ``autograd.Function``
against ``jax.vjp`` of the reference's custom VJP), the cross-entropy's
custom VJP, ``loss_fn`` and every leaf's gradient with the JAX weights
carried across (``params_from_numpy``), rematerialisation, AdamW and its
schedule, the train step (with and without microbatches) and the
synthetic pipeline.

Tolerances: 1e-5 (atol and rtol, or of each gradient's largest magnitude)
for float32 sums taken in another order; 1e-6 for AdamW and the schedule,
whose scalars are float32 in both packages; batches bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402

TOL = 1e-5
#: the configs whose loss and gradients are held leaf for leaf: every
#: family (dense, MoE, RWKV6, hybrid, the two frontends) and repro_100m
GRAD_ARCHS = j_cb.ARCH_IDS + ("repro_100m",)


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them many
    times faster than a pool of them, which contends with the other test
    processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def npy(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def rel(got, want):
    """Largest absolute difference over ``want``'s largest magnitude."""
    got, want = npy(got), npy(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def models(arch, **changes):
    jcfg = dataclasses.replace(j_cb.smoke_config(arch), **changes)
    tcfg = dataclasses.replace(t_cb.smoke_config(arch), **changes)
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

#: (label, B, H, KV, S, Dh, causal, window, softcap, chunk)
ATTN_CASES = (
    ("causal_softcap", 2, 4, 2, 64, 16, True, 0, 50.0, 1024),
    ("causal_plain", 2, 4, 4, 48, 16, True, 0, None, 1024),
    ("window", 1, 4, 2, 64, 16, True, 16, 20.0, 1024),
    ("gqa_4_to_1", 1, 4, 1, 40, 32, True, 0, None, 1024),
    ("bidirectional", 2, 2, 2, 40, 16, False, 0, None, 1024),
    ("bidir_window", 1, 2, 1, 40, 16, False, 8, 30.0, 1024),
    ("chunked_2048", 1, 2, 1, 2048, 16, True, 0, 50.0, 1024),
    ("chunked_window", 1, 2, 2, 256, 16, True, 100, None, 64),
)


def attn_inputs(B, H, KV, S, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, H, S, Dh), (B, KV, S, Dh), (B, KV, S, Dh), (B, H, S, Dh)))


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attn_bwd_matches_the_reference(case):
    """The same (q, k, v, out, lse, dout) through both ``_attn_bwd``s."""
    _, B, H, KV, S, Dh, causal, window, softcap, chunk = case
    q, k, v, dout = attn_inputs(B, H, KV, S, Dh)
    out, lse = j_ref._attn_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal, window, softcap,
                               chunk, chunk)
    want = j_ref._attn_bwd(q, k, v, out, lse, dout, causal, window, softcap,
                           chunk, chunk)
    t = [torch.as_tensor(np.asarray(a)) for a in (q, k, v, out, lse, dout)]
    got = t_ref._attn_bwd(*t, causal, window, softcap, chunk, chunk)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(npy(g), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_autograd_matches_jax_vjp(case):
    """The twin's ``autograd.Function`` against ``jax.vjp`` of the
    reference's ``custom_vjp``: out, then dq, dk, dv for one cotangent."""
    _, B, H, KV, S, Dh, causal, window, softcap, chunk = case
    q, k, v, dout = attn_inputs(B, H, KV, S, Dh, seed=1)
    jout, vjp = jax.vjp(lambda a, b, c: j_ref.flash_attention(
        a, b, c, causal, window, softcap, chunk, chunk), q, k, v)
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.as_tensor(a).requires_grad_(True) for a in (q, k, v))
    tout = t_ref.flash_attention(tq, tk, tv, causal, window, softcap, chunk,
                                 chunk)
    assert tout.grad_fn is not None
    got = torch.autograd.grad(tout, (tq, tk, tv), torch.as_tensor(dout))
    np.testing.assert_allclose(npy(tout), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(npy(g), np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_flash_without_grad_builds_no_graph():
    q, k, v, _ = (torch.as_tensor(a) for a in attn_inputs(1, 2, 1, 16, 16))
    assert t_ref.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert t_ref.flash_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_ce_mean_value_and_gradient(dtype):
    """The custom VJP's value and its gradient, rebuilt in the logits'
    dtype (bf16: within its rounding step of 2^-8)."""
    rng = np.random.default_rng(0)
    N, V = 37, 301
    flat = (rng.standard_normal((N, V)) * 4).astype(np.float32)
    idx = rng.integers(0, V, N).astype(np.int32)
    jflat = jnp.asarray(flat).astype(dtype)
    jl, jg = jax.value_and_grad(lambda f: j_tfm._ce_mean(f, idx))(jflat)
    tflat = torch.as_tensor(flat).to(getattr(torch, dtype)
                                     ).requires_grad_(True)
    tl = t_tfm._ce_mean.apply(tflat, torch.as_tensor(idx))
    (tg,) = torch.autograd.grad(tl, tflat)
    assert tl.dtype == torch.float32 and tg.dtype == tflat.dtype
    tol = TOL if dtype == "float32" else 2 ** -8
    assert float(tl) == pytest.approx(float(jl), rel=tol)
    assert rel(tg, np.asarray(jg, np.float32)) <= tol


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    """``loss_fn``'s value, its metrics and every leaf's gradient (within
    1e-5 of the leaf's largest magnitude) against ``jax.value_and_grad``;
    a leaf the loss does not read (hubert's token embedding) has no
    gradient in the port and a zero one in JAX."""
    jcfg, tcfg, jp, tp = models(arch)
    batch = t_pipe.batch_for(tcfg, 0, 2, 40)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_tfm.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}),
        has_aux=True)(jp)
    tp.requires_grad_(True)
    tl, tm = t_tfm.loss_fn(tp, tcfg, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(tl, list(tp.parameters()), allow_unused=True)
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert sorted(tm) == sorted(jm)
    for key in tm:
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TOL,
                                               abs=TOL), key
    want = jax_paths(jg)
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        if g is None:
            assert not want[name].any(), name
            continue
        assert rel(g, want[name]) <= TOL, (name, rel(g, want[name]))


@pytest.mark.parametrize("arch,n_layers", (("gemma2_2b", 4),
                                           ("repro_100m", 4)))
def test_remat_gives_the_same_loss_and_gradients(arch, n_layers, monkeypatch):
    """Checkpointed groups (gemma2: 2 pattern steps of 2 layers, groups of
    one; repro_100m at 4 layers: groups of 2) recompute each attention
    forward once in the backward and change no value."""
    calls = []
    real = t_ref.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(t_ref, "flash_attention", counted)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(t_cb.smoke_config(arch), n_layers=n_layers,
                                  remat=remat)
        params = t_tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu").requires_grad_(True)
        batch = {k: torch.as_tensor(v)
                 for k, v in t_pipe.batch_for(cfg, 0, 2, 24).items()}
        calls.clear()
        loss, _ = t_tfm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        out[remat] = (loss, grads, len(calls))
    n = t_tfm._remat_group(cfg, n_layers // len(t_tfm.pattern(cfg)))
    assert n == (1 if arch == "gemma2_2b" else 2)
    assert out[False][2] == n_layers and out[True][2] == 2 * n_layers
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_serving_keeps_parameters_frozen():
    cfg = t_cb.smoke_config("gemma2_2b")
    params = t_tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    assert all(p.requires_grad for p in
               params.requires_grad_(True).parameters())


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------

def opt_trees(seed=0):
    """A small parameter tree (float32 and bf16 leaves, a stacked tuple) in
    both packages, and three steps of gradients large enough that the
    clipping bites."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"s": rng.standard_normal(7).astype(np.float32),
                  "h": rng.standard_normal((3, 4)).astype(np.float32)},
            "streams": ({"x": rng.standard_normal((2, 3)).astype(np.float32)},
                        {"x": rng.standard_normal((2, 3)).astype(np.float32)})}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3
                                     ).astype(np.float32), tree)
             for _ in range(3)]
    return tree, grads


@pytest.mark.parametrize("state_dtype", ("float32", "bfloat16"))
def test_adamw_matches_jax_for_three_clipped_steps(state_dtype):
    tree, grads = opt_trees()
    jp = jax.tree.map(jnp.asarray, tree)
    jp["b"]["h"] = jp["b"]["h"].astype(jnp.bfloat16)
    tp = t_tfm.ParamTree(jax.tree.map(t_tfm._tensor_from_numpy,
                                      jax.tree.map(np.asarray, jp)))
    jo = j_adamw.adamw_init(jp, jnp.dtype(state_dtype))
    to = t_adamw.adamw_init(tp, getattr(torch, state_dtype))
    for i, g in enumerate(grads):
        lr = j_adamw.cosine_schedule(jnp.int32(i), peak_lr=1e-2, warmup=1,
                                     total=3)
        jg = jax.tree.map(jnp.asarray, g)
        jg["b"]["h"] = jg["b"]["h"].astype(jnp.bfloat16)
        jp, jo, jm = j_adamw.adamw_update(jg, jo, jp, lr=lr)
        tg = t_tfm.ParamTree(jax.tree.map(t_tfm._tensor_from_numpy,
                                          jax.tree.map(np.asarray, jg)))
        tlr = t_adamw.cosine_schedule(i, peak_lr=1e-2, warmup=1, total=3)
        tp, to, tm = t_adamw.adamw_update(tg, to, tp, lr=tlr)
        assert float(jm["grad_norm"]) > 1.0     # the clipping bites
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert int(to.step) == int(jo.step) == i + 1
        for name, (got, want) in {
                "params": (tp, jp), "m": (to.m, jo.m),
                "v": (to.v, jo.v)}.items():
            w = jax_paths(want)
            for path, t in t_tfm.tree_items(got):
                key = ".".join(path)
                assert t.dtype == getattr(torch, str(w[key].dtype)), key
                tol = 1e-6 if t.dtype == torch.float32 else 2 ** -8
                np.testing.assert_allclose(npy(t), w[key].astype(np.float32),
                                           rtol=tol, atol=tol,
                                           err_msg=f"{name} {key} step {i}")


def test_global_norm_matches_jax():
    tree, grads = opt_trees(1)
    got = t_adamw.global_norm(jax.tree.map(torch.as_tensor, grads[0]))
    want = j_adamw.global_norm(jax.tree.map(jnp.asarray, grads[0]))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_adamw_updates_in_place_and_keeps_the_trees():
    tree, grads = opt_trees()
    tp = t_tfm.ParamTree(jax.tree.map(torch.tensor, tree))
    to = t_adamw.adamw_init(tp)
    w = tp["w"]
    tp2, to2, _ = t_adamw.adamw_update(
        t_tfm.tree_leaves(jax.tree.map(torch.as_tensor, grads[0])), to, tp,
        lr=torch.tensor(1e-3))
    assert tp2 is tp and to2.m is to.m and tp2["w"] is w
    assert not torch.equal(w, torch.as_tensor(tree["w"]))
    with pytest.raises(ValueError, match="gradients"):
        t_adamw.adamw_update([grads[0]["w"]], to, tp, lr=1e-3)


@pytest.mark.parametrize("step", (0, 1, 5, 10, 11, 50, 99, 100, 150))
def test_cosine_schedule_matches_jax(step):
    """Warmup (0-9), the middle, the end and past it."""
    kw = dict(peak_lr=3e-4, warmup=10, total=100, min_frac=0.1)
    got = t_adamw.cosine_schedule(step, **kw)
    want = j_adamw.cosine_schedule(jnp.int32(step), **kw)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# the train step and the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", (1, 2))
def test_train_step_matches_jax_for_three_steps(microbatches):
    """``make_train_step`` against the JAX package's step on a one-device
    mesh: the losses, the learning rates, the gradient norms and every
    parameter after three steps (the warmup of ``total // 10`` steps
    included)."""
    jcfg, tcfg, jp, tp = models("gemma2_2b")
    # automatic axes: with explicit ones (this jax's default) the step's
    # sharding constraints are asserts its unsharded inputs fail
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    try:
        with jax.set_mesh(mesh):
            _, jit_for, _ = j_steps.make_train_step(
                jcfg, mesh, microbatches=microbatches, total_steps=20,
                donate=False)
            batches = [t_pipe.batch_for(tcfg, i, 4, 24) for i in range(3)]
            jstep = jit_for(jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                batches[0]))
            jo = j_adamw.adamw_init(jp)
            jmetrics = []
            for i, b in enumerate(batches):
                jp, jo, m = jstep(jp, jo, b, jnp.int32(i))
                jmetrics.append(jax.tree.map(float, m))
    finally:
        j_layers.clear_axis_hints()
    tstep = t_steps.make_train_step(tcfg, "cpu", microbatches=microbatches,
                                    total_steps=20)
    to = t_adamw.adamw_init(tp)
    for i, b in enumerate(batches):
        tp, to, m = tstep(tp, to, b, i)
        for key in ("loss", "lr", "grad_norm", "ce", "lb_loss"):
            assert float(m[key]) == pytest.approx(jmetrics[i][key], rel=TOL,
                                                  abs=1e-12), (i, key)
    want = jax_paths(jp)
    for name, t in tp.named_parameters():
        assert rel(t, want[name]) <= TOL, name


def test_train_step_init_shapes_are_meta():
    cfg = t_cb.get("gemma2_2b")
    p, o = t_steps.init_shapes(cfg)
    leaves = t_tfm.tree_leaves(p)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == sum(
        t.numel() for t in t_tfm.tree_leaves(o.m))
    assert o.m["embed"].dtype == torch.float32
    assert p["embed"].shape == (cfg.vocab, cfg.d_model)


@pytest.mark.parametrize("arch", ("yi_9b", "pixtral_12b", "hubert_xlarge"))
def test_pipeline_batches_equal_jax_on_two_processes(arch):
    """Steps 0-3 of each of two processes' prefetching pipelines, bitwise."""
    tcfg, jcfg = t_cb.smoke_config(arch), j_cb.smoke_config(arch)
    for index in (0, 1):
        tp = t_pipe.SyntheticPipeline(tcfg, 8, 24, process_index=index,
                                      process_count=2)
        jpipe = j_pipe.SyntheticPipeline(jcfg, 8, 24, process_index=index,
                                         process_count=2)
        try:
            assert (tp.lo, tp.hi) == (jpipe.lo, jpipe.hi) == (4 * index,
                                                              4 * index + 4)
            for want_step in range(4):
                (ts, tb), (js, jb) = next(tp), next(jpipe)
                assert ts == js == want_step
                assert sorted(tb) == sorted(jb)
                for k in tb:
                    assert tb[k].dtype == jb[k].dtype
                    assert np.array_equal(tb[k], jb[k]), (arch, index, k)
        finally:
            tp.close()
            jpipe.close()
    specs = t_pipe.batch_specs(tcfg, 8, 24)
    jspecs = j_pipe.batch_specs(jcfg, 8, 24)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in specs.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}


def test_pipeline_defaults_to_one_process():
    cfg = t_cb.smoke_config("yi_9b")
    pipe = t_pipe.SyntheticPipeline(cfg, 4, 16, start_step=5)
    try:
        assert (pipe.lo, pipe.hi) == (0, 4)
        assert [next(pipe)[0] for _ in range(3)] == [5, 6, 7]
    finally:
        pipe.close()
