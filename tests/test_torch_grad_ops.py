"""The gradients of the port's RWKV6, SSM-scan and MoE-dispatch ops against
the JAX package's (``jax.vjp`` of its refs), on the CPU, with inputs drawn
from a seed with numpy: ``ref.rwkv6_backward`` (the backward of the RWKV6
kernel's ``autograd.Function``), the differentiable SSM scan (fault F4),
``ref.moe_dispatch_backward`` (the dispatch kernel's backward), and the
routing's stop-gradient points.  Each ``autograd.Function`` runs its
backward here with the plain twin standing in for the launch.

Tolerances: float32 gradients within 1e-5 of each one's largest magnitude
(float32 sums taken in another order); a bf16 gradient within 2^-7 of
it (the two packages round the same float32 value to bf16, one step of
2^-8 apart at most); the dispatch's gradient, which only moves and adds
the same values in the same order, bitwise against the twin's autograd.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import balance as j_bal  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.core import balance as t_bal  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels import moe_dispatch as md  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def npy(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def rel(got, want):
    """Largest absolute difference over ``want``'s largest magnitude."""
    got, want = npy(got), npy(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_in(a, dtype):
    return jnp.asarray(a).astype(dtype)


def torch_in(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def rwkv_inputs(B, H, T, Dh, seed=0):
    """r, k, v, w (decays in (0.45, 0.95)), u, a nonzero initial state and
    the cotangents of out and of the final state, float32 numpy."""
    rs = np.random.default_rng(seed)
    r, k, v, dout = (rs.standard_normal((B, H, T, Dh)).astype(np.float32)
                     for _ in range(4))
    w = rs.uniform(0.45, 0.95, (B, H, T, Dh)).astype(np.float32)
    u = (rs.standard_normal((H, Dh)) * 0.3).astype(np.float32)
    state = (rs.standard_normal((B, H, Dh, Dh)) * 0.3).astype(np.float32)
    dstate = rs.standard_normal((B, H, Dh, Dh)).astype(np.float32)
    return (r, k, v, w, u, state), dout, dstate


#: (label, B, H, T, Dh, the reference's chunk, dtype, backward block)
RWKV_CASES = (
    ("one_chunk", 2, 2, 40, 16, 64, "float32", None),
    ("three_chunks", 1, 2, 192, 16, 64, "float32", None),
    ("ragged_block", 2, 1, 100, 32, 100, "float32", None),
    ("blocks_of_7", 1, 2, 64, 16, 64, "float32", 7),
    ("bf16", 2, 2, 128, 16, 64, "bfloat16", None),
)


@pytest.mark.parametrize("case", RWKV_CASES, ids=[c[0] for c in RWKV_CASES])
def test_rwkv6_backward_matches_jax_vjp(case, monkeypatch):
    """``ref.rwkv6_backward`` against ``jax.vjp`` of the reference's
    ``rwkv6_chunked``: dr, dk, dv, dw, du and the initial state's
    gradient, from a nonzero initial state and nonzero cotangents of both
    outputs; each gradient in its input's dtype."""
    _, B, H, T, Dh, chunk, dtype, block = case
    if block:
        monkeypatch.setattr(t_ref, "RWKV_STEP_BLOCK", block)
    (r, k, v, w, u, state), dout, dstate = rwkv_inputs(B, H, T, Dh)
    jargs = [jax_in(a, dtype) for a in (r, k, v, w)] + [jnp.asarray(u),
                                                        jnp.asarray(state)]
    _, vjp = jax.vjp(lambda *a: j_ref.rwkv6_chunked(*a, chunk=chunk), *jargs)
    want = vjp((jax_in(dout, dtype), jnp.asarray(dstate)))
    targs = [torch_in(a, dtype) for a in (r, k, v, w)] + [
        torch.as_tensor(u), torch.as_tensor(state)]
    got = t_ref.rwkv6_backward(*targs, torch_in(dout, dtype),
                               torch.as_tensor(dstate))
    for name, g, wnt, a in zip(("dr", "dk", "dv", "dw", "du", "dstate"), got,
                               want, targs):
        assert g.dtype == a.dtype and tuple(g.shape) == wnt.shape, name
        tol = TOL[dtype] if a.dtype == torch.bfloat16 else TOL["float32"]
        assert rel(g, wnt) <= tol, (name, rel(g, wnt))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_rwkv6_function_backward_on_the_models_layout(dtype):
    """``RWKV6Scan`` on CPU tensors (the twin stands in for the launch) in
    the model's layout, ``(B, T, H, Dh)`` buffers viewed as ``(B, H, T,
    Dh)``: its out and state are the twin's bitwise, and autograd takes
    its gradients for the views; they match autograd through the twin."""
    B, H, T, Dh = 2, 2, 70, 16
    (r, k, v, w, u, state), dout, dstate = rwkv_inputs(B, H, T, Dh, seed=3)
    dt = getattr(torch, dtype)

    def leaves():
        bufs = [torch.as_tensor(a).transpose(1, 2).contiguous().to(dt)
                .requires_grad_(True) for a in (r, k, v, w)]
        return bufs + [torch.as_tensor(u).requires_grad_(True),
                       torch.as_tensor(state).requires_grad_(True)]

    def run(fn, ls):
        views = [b.transpose(1, 2) for b in ls[:4]]
        out, s = fn(*views, *ls[4:])
        grads = torch.autograd.grad(
            (out.float() * torch.as_tensor(dout)).sum()
            + (s * torch.as_tensor(dstate)).sum(), ls)
        return out, s, grads

    got_ls, want_ls = leaves(), leaves()
    out, s, got = run(rk.RWKV6Scan.apply, got_ls)
    w_out, w_s, want = run(rk.plain, want_ls)
    assert torch.equal(out, w_out) and torch.equal(s, w_s)
    for name, g, wnt, leaf in zip("r k v w u state".split(), got, want,
                                  got_ls):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        assert rel(g, wnt) <= TOL[str(leaf.dtype)[6:]], (name, rel(g, wnt))


def test_rwkv6_function_is_the_ops_path_only_on_the_card():
    """On the CPU ``ops.rwkv6`` differentiates the twin by autograd; the
    Function is what a CUDA tensor under grad takes."""
    from repro_torch.kernels import ops

    (r, k, v, w, u, state), _, _ = rwkv_inputs(1, 1, 8, 16)
    rt = torch.as_tensor(r).requires_grad_(True)
    out, _ = ops.rwkv6(rt, *(torch.as_tensor(a) for a in (k, v, w, u,
                                                             state)))
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ != "RWKV6ScanBackward"
    out2, _ = rk.RWKV6Scan.apply(rt, *(torch.as_tensor(a)
                                       for a in (k, v, w, u, state)))
    assert type(out2.grad_fn).__name__ == "RWKV6ScanBackward"


def test_rwkv_gradient_reaches_the_decay_the_mixes_and_ln_x():
    """The smoke rwkv6 in bf16 with its token-shift mixes and ``ln_x``
    perturbed (zero at init): through ``_decay`` and the decay's cast to
    the compute dtype, ``w_a``, ``w_b`` and ``w_base`` get a gradient, and
    so do every mix and ``ln_x``; all finite."""
    cfg = dataclasses.replace(t_cb.smoke_config("rwkv6_1_6b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = t_tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.split(".")[-1].startswith(("mu_", "cm_mu", "ln_x")):
                p.copy_(torch.rand(p.shape, generator=g) * 0.5)
    params.requires_grad_(True)
    batch = {k: torch.as_tensor(v)
             for k, v in t_pipe.batch_for(cfg, 0, 2, 24).items()}
    loss, _ = t_tfm.loss_fn(params, cfg, batch)
    names = [n for n, _ in params.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(
        loss, list(params.parameters()))))
    for leaf in ("w_a", "w_b", "w_base", "mu_r", "mu_k", "mu_v", "mu_w",
                 "mu_g", "cm_mu", "ln_x", "u"):
        gr = grads[f"streams.0.rwkv.{leaf}"]
        assert torch.isfinite(gr).all() and gr.abs().max() > 0, leaf


# ---------------------------------------------------------------------------
# the SSM scan (F4)
# ---------------------------------------------------------------------------

def ssm_inputs(B, T, Di, N, seed=0):
    """x, dt (softplus), A (``-exp``), Bm, Cm, D, a nonzero state, and the
    cotangents of y and of the final state, float32 numpy."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((B, T, Di)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((B, T, Di)))).astype(np.float32)
    A = -np.exp(rs.standard_normal((Di, N))).astype(np.float32)
    Bm, Cm = (rs.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    D = (1.0 + 0.1 * rs.standard_normal(Di)).astype(np.float32)
    state = (rs.standard_normal((B, Di, N)) * 0.5).astype(np.float32)
    gy = rs.standard_normal((B, T, Di)).astype(np.float32)
    gh = rs.standard_normal((B, Di, N)).astype(np.float32)
    return (x, dt, A, Bm, Cm, D, state), gy, gh


#: (label, B, T, Di, N, the reference's chunk, the dtype of x, Bm and Cm)
SSM_CASES = (
    ("one_block", 2, 40, 8, 4, 256, "float32"),
    ("three_blocks", 1, 150, 8, 4, 150, "float32"),
    ("two_chunks", 2, 128, 6, 3, 64, "float32"),
    ("bf16", 2, 96, 8, 4, 256, "bfloat16"),
)


@pytest.mark.parametrize("case", SSM_CASES, ids=[c[0] for c in SSM_CASES])
def test_ssm_scan_gradient_matches_jax_vjp(case):
    """``ref.ssm_scan`` under grad (``SSMScan``) against ``jax.vjp`` of the
    reference's ``ssm_scan``: y, the final state and the gradients of x,
    dt, A, Bm, Cm, D and the initial state (nonzero), for cotangents of
    both outputs."""
    _, B, T, Di, N, chunk, dtype = case
    arrs, gy, gh = ssm_inputs(B, T, Di, N)
    cast = (0, 3, 4)        # x, Bm, Cm in the compute dtype
    jargs = [jax_in(a, dtype) if i in cast else jnp.asarray(a)
             for i, a in enumerate(arrs)]
    (jy, jh), vjp = jax.vjp(lambda *a: j_ref.ssm_scan(*a, chunk=chunk),
                            *jargs)
    want = vjp((jax_in(gy, dtype), jnp.asarray(gh)))
    targs = [(torch_in(a, dtype) if i in cast else torch.as_tensor(a))
             .requires_grad_(True) for i, a in enumerate(arrs)]
    y, h = t_ref.ssm_scan(*targs)
    assert type(h.grad_fn).__name__ == "SSMScanBackward"
    assert rel(y, jy) <= TOL[dtype] and rel(h, jh) <= TOL["float32"]
    got = torch.autograd.grad((y, h), targs, (torch_in(gy, dtype),
                                              torch.as_tensor(gh)))
    for name, g, wnt, a in zip("x dt A Bm Cm D state".split(), got, want,
                               targs):
        assert g.dtype == a.dtype, name
        assert rel(g, wnt) <= TOL[str(a.dtype)[6:]], (name, rel(g, wnt))


def _in_place_ssm_steps(xf, dtf, Af, Bf, Cf, h):
    """The step loop as it was before the scan became differentiable: the
    no-grad path must give its values bitwise."""
    T = xf.shape[1]
    ys = []
    for t0 in range(0, T, 64):
        part = slice(t0, min(t0 + 64, T))
        dtb = dtf[:, part].transpose(0, 1)
        dA = torch.exp(dtb[..., None] * Af)
        dBx = ((dtb * xf[:, part].transpose(0, 1))[..., None]
               * Bf[:, part].transpose(0, 1)[:, :, None, :])
        hs = torch.empty_like(dA)
        for t in range(dA.shape[0]):
            torch.mul(dA[t], h, out=hs[t])
            h = hs[t].add_(dBx[t])
        ys.append(torch.matmul(hs, Cf[:, part].transpose(0, 1)[..., None])
                  [..., 0].transpose(0, 1))
    return h.clone(), torch.cat(ys, dim=1)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_ssm_scan_without_grad_is_bitwise_unchanged(dtype):
    """Serving's no-grad scan gives the step loop's values bit for bit, and
    builds no graph; the forward under grad (``SSMScan``) gives the same
    bits."""
    arrs, _, _ = ssm_inputs(2, 150, 8, 4, seed=5)
    t = [torch.as_tensor(a) for a in arrs]
    for i in (0, 3, 4):
        t[i] = t[i].to(getattr(torch, dtype))
    h, y = _in_place_ssm_steps(t[0].float(), t[1], t[2], t[3].float(),
                           t[4].float(), t[6])
    want = (y + t[0].float() * t[5][None, None, :]).to(t[0].dtype)
    with torch.no_grad():
        got_y, got_h = t_ref.ssm_scan(*t)
    assert got_y.grad_fn is None
    assert torch.equal(got_y, want) and torch.equal(got_h, h)
    t[1].requires_grad_(True)
    grad_y, grad_h = t_ref.ssm_scan(*t)
    assert grad_h.grad_fn is not None
    assert torch.equal(grad_y, want) and torch.equal(grad_h, h)


def test_f4_hymba_smoke_loss_is_differentiable():
    """F4: the in-place step loop made autograd refuse hymba's loss
    (``mul(): functions with out=... arguments don't support automatic
    differentiation``).  Now every leaf of the smoke hymba gets a finite
    gradient, the SSM heads' leaves a nonzero one, through ``SSMScan``."""
    cfg = t_cb.smoke_config("hymba_1_5b")
    params = t_tfm.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").requires_grad_(True)
    batch = {k: torch.as_tensor(v)
             for k, v in t_pipe.batch_for(cfg, 0, 2, 24).items()}
    loss, _ = t_tfm.loss_fn(params, cfg, batch)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    ssm = [(n, g) for n, g in zip(names, grads) if ".ssm." in n]
    assert {n.split(".")[-1] for n, _ in ssm} == {
        "in_proj", "conv", "x_proj", "dt_bias", "dt_w", "A_log", "D",
        "out_proj"}
    assert all(torch.isfinite(g).all() for g in grads)
    assert all(g.abs().max() > 0 for _, g in ssm)


# ---------------------------------------------------------------------------
# the MoE dispatch
# ---------------------------------------------------------------------------

def dispatch_tables(T, k, E, C, seed=0):
    """Unique kept (expert, pos) pairs for most slots, and dropped ones of
    every kind: expert -1, pos -1, and a flat row past ``E * C`` (the last
    expert at pos C + 1)."""
    rs = np.random.default_rng(seed)
    rows = rs.permutation(E * C)[:T * k]
    expert = (rows // C).astype(np.int32).reshape(T, k)
    pos = (rows % C).astype(np.int32).reshape(T, k)
    expert[0, 0] = -1
    pos[1, k - 1] = -1
    expert[2, 0], pos[2, 0] = E - 1, C + 1
    return expert, pos


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_moe_dispatch_gradient_matches_jax_vjp(dtype):
    """The dispatch's gradient in x against ``jax.vjp`` of the reference's
    ``moe_dispatch``, with dropped slots of every kind (they get none of
    their rows' gradient)."""
    T, k, E, C, D = 24, 3, 6, 16, 32
    expert, pos = dispatch_tables(T, k, E, C)
    rs = np.random.default_rng(1)
    x = rs.standard_normal((T, D)).astype(np.float32)
    g = rs.standard_normal((E, C, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_ref.moe_dispatch(
        a, jnp.asarray(expert), jnp.asarray(pos), E, C), jax_in(x, dtype))
    (want,) = vjp(jax_in(g, dtype))
    got = t_ref.moe_dispatch_backward(torch_in(g, dtype),
                                      torch.as_tensor(expert),
                                      torch.as_tensor(pos), E, C)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (T, D)
    assert rel(got, want) <= TOL[dtype]
    # tokens 0-2 each have one slot dropped: their gradient is the sum of
    # their kept slots' rows alone
    gq = npy(torch_in(g, dtype))
    for t in range(3):
        kept = [gq[e, p] for e, p in zip(expert[t], pos[t])
                if e >= 0 and 0 <= p < C]
        assert len(kept) == k - 1
        np.testing.assert_allclose(npy(got[t]), np.sum(kept, axis=0),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_moe_dispatch_backward_is_the_twins_autograd_bitwise(dtype):
    """``ref.moe_dispatch_backward`` and ``MoEDispatch`` (the twin standing
    in for the launch) give autograd's gradient through the twin bit for
    bit: the same ops in the same order.  Routing's own tables (unique
    kept rows) and a table with dropped slots."""
    T, k, E, C, D = 40, 2, 8, 12, 24
    rs = np.random.default_rng(2)
    logits = torch.as_tensor(rs.standard_normal((T, E)).astype(np.float32))
    r = t_bal.route(logits, k, C, t_bal.default_expert_groups(E, 2),
                    strategy="na_rp")
    tables = [(r.expert, r.pos)] + [tuple(
        torch.as_tensor(a) for a in dispatch_tables(T, k, E, C, seed=3))]
    dt = getattr(torch, dtype)
    x = torch.as_tensor(rs.standard_normal((T, D)).astype(np.float32)
                        ).to(dt).requires_grad_(True)
    g = torch.as_tensor(rs.standard_normal((E, C, D)).astype(np.float32)
                        ).to(dt)
    for expert, pos in tables:
        (want,) = torch.autograd.grad(
            t_ref.moe_dispatch(x, expert, pos, E, C), x, g)
        got = t_ref.moe_dispatch_backward(g, expert, pos, E, C)
        out = md.MoEDispatch.apply(x, expert, pos, E, C)
        assert type(out.grad_fn).__name__ == "MoEDispatchBackward"
        (fn_got,) = torch.autograd.grad(out, x, g)
        assert torch.equal(got, want) and torch.equal(fn_got, want)


# ---------------------------------------------------------------------------
# routing: where the reference stops the gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ("drop", "na_rp", "na_ws"))
def test_routing_gradient_matches_jax(strategy):
    """The gradient of the combine weights (rerouted slots included) and of
    the load-balance loss in the router logits against ``jax.vjp`` of the
    reference's ``route``: the ranks' priorities and the top-k indices
    carry none (the reference's ``stop_gradient``), the gate weights are
    re-gathered differentiably.  Four hot experts of 16 overflow their
    capacity, so the redirecting strategies reroute."""
    T, E, k, cap = 256, 16, 2, 48
    rs = np.random.default_rng(4)
    logits = (rs.standard_normal((T, E))
              + np.array([2.0] * 4 + [0.0] * 12)).astype(np.float32)
    cw = rs.standard_normal((T, k)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    def j_obj(lg):
        r = j_bal.route(lg, k, cap, j_bal.default_expert_groups(E, 4),
                        strategy=strategy, key=key)
        return (jnp.sum(r.weight * cw)
                + j_bal.load_balance_loss(r.probs, r.expert, k))

    want = jax.grad(j_obj)(jnp.asarray(logits))
    lg = torch.as_tensor(logits).requires_grad_(True)
    r = t_bal.route(lg, k, cap, t_bal.default_expert_groups(E, 4),
                    strategy=strategy, key=np.asarray(key))
    if strategy != "drop":
        assert int(r.stats["ntasks_stolen_local"]
                   + r.stats["ntasks_stolen_remote"]) > 0
    obj = ((r.weight * torch.as_tensor(cw)).sum()
           + t_bal.load_balance_loss(r.probs, r.expert, k))
    (got,) = torch.autograd.grad(obj, lg)
    assert rel(got, want) <= TOL["float32"]
