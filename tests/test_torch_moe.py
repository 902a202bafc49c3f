"""The port's MoE path (``repro_torch.kernels.ref`` / ``moe_dispatch`` /
``ops``, ``models.moe``, the MoE block of ``models.transformer`` and
serving) against the JAX package's, on the same inputs made with numpy and
with the JAX package's weights carried across (``params_from_numpy``).

On CPU tensors the kernel's wrapper runs its plain twin after the checks
the CUDA path makes; ``tests/test_torch_gpu.py`` holds the CUDA kernel
against the twin on the card, bit for bit.  Tolerances: the dispatch is
data movement, so it is held bitwise to the JAX ref and to the Pallas
kernel (interpret mode); the combine and the layer 2e-4 (atol and rtol),
as the whole smoke model, the JAX package's tolerance between its forward
and its decode (``tests/test_models.py``).  Routing decisions (experts,
slots, counters) are held equal.  Wherever decode is compared with a full
forward, capacity is contention-free (``capacity_factor=8.0``), as in
``tests/test_models.py``: with overflow, B tokens alone route otherwise
than B * S tokens together.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.core import balance as j_bal  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.moe_dispatch import moe_dispatch_pallas  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.kernels import moe_dispatch as t_md  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import registry as t_reg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

ARCHS = ("moonshot_v1_16b_a3b", "llama4_maverick_400b_a17b")
TOL = dict(atol=2e-4, rtol=2e-4)
#: the JAX package's dispatch-kernel test cases (tests/test_kernels.py)
DISPATCH_CASES = ((64, 32, 8, 16, 2), (128, 16, 4, 64, 1),
                  (256, 8, 16, 32, 4))


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(a, b, label="", tol=TOL):
    np.testing.assert_allclose(npy(a), npy(b), **tol, err_msg=str(label))


def routed(T, D, E, C, k, seed=0, strategy="na_rp"):
    """x (T, D) and the JAX package's routing of random logits into E
    experts of capacity C: (x, expert, pos) as numpy arrays."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((T, D)).astype(np.float32)
    logits = rs.standard_normal((T, E)).astype(np.float32)
    r = j_bal.route(jnp.asarray(logits), k, C,
                    j_bal.default_expert_groups(E, 2), strategy=strategy,
                    key=jax.random.PRNGKey(seed))
    return x, np.array(r.expert), np.array(r.pos)


# ---------------------------------------------------------------------------
# dispatch and combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,D,E,C,k", DISPATCH_CASES)
def test_dispatch_matches_the_jax_ref_and_the_pallas_kernel(T, D, E, C, k):
    x, e, p = routed(T, D, E, C, k)
    t_reg.reset_launches()
    got = t_md.moe_dispatch(torch.as_tensor(x), torch.as_tensor(e),
                            torch.as_tensor(p), n_experts=E, capacity=C)
    assert got.dtype == torch.float32 and tuple(got.shape) == (E, C, D)
    want = j_ref.moe_dispatch(jnp.asarray(x), jnp.asarray(e), jnp.asarray(p),
                              E, C)
    pallas = moe_dispatch_pallas(jnp.asarray(x), jnp.asarray(e),
                                 jnp.asarray(p), n_experts=E, capacity=C,
                                 block_t=64, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert t_reg.KERNELS["moe_dispatch"].launches == 0     # CPU: the twin
    # every kept slot's row is its token's row; the rest is zero
    kept = e >= 0
    assert int(kept.sum()) > 0
    rows = got.reshape(E * C, D)
    assert np.array_equal(rows[e[kept] * C + p[kept]].numpy(),
                          np.repeat(x, k, 0)[kept.reshape(-1)])
    assert int((rows.abs().sum(1) > 0).sum()) == int(kept.sum())


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_dispatch_drops_and_sums_as_the_jax_ref(dtype):
    """Off the routing path: negative slots, a pos past the capacity (whose
    flat row lands in the next expert's buffer, or past the end and is
    dropped) and duplicate pairs (summed), all as the JAX ref does."""
    T, D, E, C, k = 12, 8, 3, 4, 2
    rs = np.random.default_rng(1)
    x = rs.standard_normal((T, D)).astype(np.float32)
    e = rs.integers(-1, E, (T, k)).astype(np.int32)
    p = rs.integers(-1, C, (T, k)).astype(np.int32)
    p[0, 0], e[0, 0] = C + 1, 0           # row C + 1: expert 1's slot 1
    p[1, 0], e[1, 0] = C, E - 1           # past the last row: dropped
    e[2, 1], p[2, 1] = e[3, 0], p[3, 0] = 1, 2        # a duplicate pair
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = t_ref.moe_dispatch(tx, torch.as_tensor(e), torch.as_tensor(p), E,
                             C)
    want = j_ref.moe_dispatch(jx, jnp.asarray(e), jnp.asarray(p), E, C)
    assert got.dtype == tx.dtype
    assert np.array_equal(npy(got), npy(want))


def test_the_pallas_wrapper_drops_the_tail_and_the_port_does_not():
    """A reference behaviour, not a port fault: ``moe_dispatch_pallas``
    walks ``T // 256`` blocks of 256 tokens, so for T = 300 the last 44
    tokens are never dispatched.  The port dispatches every token."""
    T, D, E, C, k = 300, 8, 8, 128, 2
    x, e, p = routed(T, D, E, C, k, seed=2)
    pallas = np.asarray(moe_dispatch_pallas(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(p), n_experts=E,
        capacity=C, interpret=True))
    head = np.asarray(j_ref.moe_dispatch(
        jnp.asarray(x[:256]), jnp.asarray(e[:256]), jnp.asarray(p[:256]), E,
        C))
    whole = np.asarray(j_ref.moe_dispatch(jnp.asarray(x), jnp.asarray(e),
                                          jnp.asarray(p), E, C))
    assert np.array_equal(pallas, head)
    assert not np.array_equal(pallas, whole)
    got = t_md.moe_dispatch(torch.as_tensor(x), torch.as_tensor(e),
                            torch.as_tensor(p), n_experts=E, capacity=C)
    assert np.array_equal(got.numpy(), whole)


def kernel_rows(x, expert, pos, E, C):
    """The CUDA kernel's contract on the CPU: ``x[map]`` with the rows that
    no slot names zero, ``map`` the row map of ``ref.moe_dispatch_rows``."""
    rows = t_ref.moe_dispatch_rows(expert, pos, E, C)
    out = x[rows.clamp(min=0)]
    out[rows < 0] = 0
    return rows, out.reshape(E, C, x.shape[1])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_dispatch_rows_give_the_pallas_kernel_on_shared_rows(dtype):
    """Off the routing path, slots that share a row: the Pallas kernel's
    in-order last write leaves the highest token's row, and so does the
    CUDA kernel's row map (``ref.moe_dispatch_rows``), bit for bit; the
    twin sums them.  Every pos is in [0, C), or -1 with expert -1."""
    T, D, E, C, k = 64, 16, 4, 8, 3
    rs = np.random.default_rng(7)
    x = rs.standard_normal((T, D)).astype(np.float32)
    e = rs.integers(0, E, (T, k)).astype(np.int32)
    p = rs.integers(0, C, (T, k)).astype(np.int32)
    drop = rs.random((T, k)) < 0.2
    e[drop], p[drop] = -1, -1
    flat = (e * C + p)[e >= 0]
    assert len(flat) > len(np.unique(flat))             # shared rows
    pallas = moe_dispatch_pallas(
        jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(e), jnp.asarray(p),
        n_experts=E, capacity=C, block_t=32, interpret=True)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    rows, got = kernel_rows(tx, torch.as_tensor(e), torch.as_tensor(p), E, C)
    assert rows.dtype == torch.int64 and tuple(rows.shape) == (E * C,)
    assert got.dtype == tx.dtype
    assert np.array_equal(npy(got), npy(pallas))
    # each named row holds its highest token; the twin differs (sums)
    for r in np.unique(flat):
        assert int(rows[r]) == int(np.nonzero((e * C + p == r)
                                              & (e >= 0))[0].max())
    assert int((rows >= 0).sum()) == len(np.unique(flat))
    twin = t_ref.moe_dispatch(tx, torch.as_tensor(e), torch.as_tensor(p), E,
                              C)
    assert not np.array_equal(npy(twin), npy(got))


def test_dispatch_rows_match_the_jax_ref_without_shared_rows():
    """Tables with no shared row, but with a pos past C (its flat row the
    next expert's) and flat rows past E * C (dropped): the kernel's row map
    gives the JAX ref's buffer bit for bit."""
    T, D, E, C, k = 40, 8, 4, 6, 2
    rs = np.random.default_rng(8)
    x = rs.standard_normal((T, D)).astype(np.float32)
    # distinct flat rows in [0, E * C + C) for the kept slots
    kept = rs.random((T, k)) < 0.3
    flat = rs.permutation(E * C + C)[:int(kept.sum())]
    e = np.full((T, k), -1, np.int32)
    p = np.full((T, k), -1, np.int32)
    e[kept], p[kept] = flat // C, flat % C
    past = kept & (e > 0) & (rs.random((T, k)) < 0.5)
    e[past], p[past] = e[past] - 1, p[past] + C       # the same flat row
    assert past.any() and (e * C + p >= E * C).any()
    assert (p[kept] >= C).any()
    rows, got = kernel_rows(torch.as_tensor(x), torch.as_tensor(e),
                            torch.as_tensor(p), E, C)
    want = j_ref.moe_dispatch(jnp.asarray(x), jnp.asarray(e), jnp.asarray(p),
                              E, C)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert int((rows >= 0).sum()) == int((kept & (e * C + p < E * C)).sum())


def test_the_pallas_kernel_clamps_a_pos_past_the_capacity():
    """A reference behaviour, not a port fault (routing never makes such a
    slot): ``moe_dispatch_pallas`` writes a slot whose pos is past C into
    its expert's last row, and one whose pos is -1 with a kept expert
    there too.  The JAX ref and the port put the first at flat row
    ``expert * C + pos`` (the next expert's row) and drop the second."""
    T, D, E, C = 8, 4, 2, 4
    x = np.arange(1, T * D + 1, dtype=np.float32).reshape(T, D)
    e = np.full((T, 1), -1, np.int32)
    p = np.full((T, 1), -1, np.int32)
    e[0, 0], p[0, 0] = 0, C + 1          # expert 0, pos C + 1
    e[1, 0], p[1, 0] = 1, -1             # expert 1, pos -1
    pallas = np.asarray(moe_dispatch_pallas(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(p), n_experts=E,
        capacity=C, block_t=T, interpret=True)).reshape(E * C, D)
    want = np.zeros((E * C, D), np.float32)
    want[C - 1], want[2 * C - 1] = x[0], x[1]        # each expert's last row
    assert np.array_equal(pallas, want)
    jref = np.asarray(j_ref.moe_dispatch(jnp.asarray(x), jnp.asarray(e),
                                         jnp.asarray(p), E, C))
    port = np.zeros((E * C, D), np.float32)
    port[C + 1] = x[0]                               # expert 1's row 1
    assert np.array_equal(jref.reshape(E * C, D), port)
    te, tp = torch.as_tensor(e), torch.as_tensor(p)
    _, rows = kernel_rows(torch.as_tensor(x), te, tp, E, C)
    assert np.array_equal(rows.reshape(E * C, D).numpy(), port)
    got = t_md.moe_dispatch(torch.as_tensor(x), te, tp, n_experts=E,
                            capacity=C)
    assert np.array_equal(got.reshape(E * C, D).numpy(), port)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_combine_matches_jax(dtype):
    T, D, E, C, k = 96, 16, 8, 32, 2
    x, e, p = routed(T, D, E, C, k, seed=3)
    rs = np.random.default_rng(3)
    y = rs.standard_normal((E, C, D)).astype(np.float32)
    w = rs.random((T, k)).astype(np.float32) * (e >= 0)
    got = t_ref.moe_combine(torch.as_tensor(y).to(getattr(torch, dtype)),
                            torch.as_tensor(e), torch.as_tensor(p),
                            torch.as_tensor(w), T)
    want = j_ref.moe_combine(jnp.asarray(y, getattr(jnp, dtype)),
                             jnp.asarray(e), jnp.asarray(p), jnp.asarray(w),
                             T)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (T, D)
    if dtype == "float32":
        close(got, want)
    else:
        # the same bf16 products, summed in float32 and rounded once
        assert np.array_equal(npy(got), npy(want))
    # through ops, and the dispatch/combine round trip of the JAX tests
    back = t_ops.moe_combine(
        t_ops.moe_dispatch(torch.as_tensor(x), torch.as_tensor(e),
                           torch.as_tensor(p), n_experts=E, capacity=C),
        torch.as_tensor(e), torch.as_tensor(p),
        torch.as_tensor((e >= 0).astype(np.float32)), n_tokens=T)
    close(back, x * (e >= 0).sum(1, keepdims=True), "round trip")


def test_ops_dispatch_set_impl_and_the_kernel_row():
    x, e, p = routed(64, 16, 8, 16, 2, seed=4)
    tx, te, tp = map(torch.as_tensor, (x, e, p))
    want = np.asarray(j_ref.moe_dispatch(jnp.asarray(x), jnp.asarray(e),
                                         jnp.asarray(p), 8, 16))
    t_reg.reset_launches()
    try:
        for impl in (None, "ref"):
            t_ops.set_impl(impl)
            got = t_ops.moe_dispatch(tx, te, tp, n_experts=8, capacity=16)
            assert np.array_equal(got.numpy(), want), impl
        t_ops.set_impl("cuda")
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            t_ops.moe_dispatch(tx, te, tp, n_experts=8, capacity=16)
        # one op forced on its own; the others keep their setting
        t_ops.set_impl(None)
        t_ops.set_impl("cuda", "moe_dispatch")
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            t_ops.moe_dispatch(tx, te, tp, n_experts=8, capacity=16)
        q = torch.zeros((1, 1, 4, 16))
        t_ops.flash_attention(q, q, q)               # still the twin
        t_ops.set_impl("ref", "moe_dispatch")
        assert np.array_equal(t_ops.moe_dispatch(
            tx, te, tp, n_experts=8, capacity=16).numpy(), want)
        with pytest.raises(ValueError, match="not one of"):
            t_ops.set_impl("ref", "moe_combine")
        with pytest.raises(ValueError, match="must be one of"):
            t_ops.set_impl("pallas", "moe_dispatch")
    finally:
        t_ops.set_impl(None)
    assert t_ops._FORCE == dict.fromkeys(t_ops.KERNEL_OPS)
    assert t_reg.KERNELS["moe_dispatch"].launches == 0
    row = t_reg.KERNELS["moe_dispatch"].replaces
    assert row == "src/repro/kernels/moe_dispatch.py:65"
    path, line = row.rsplit(":", 1)
    root = os.path.join(os.path.dirname(__file__), "..")
    with open(os.path.join(root, path)) as f:
        assert "pl.pallas_call(" in f.read().splitlines()[int(line) - 1]


def test_wrapper_checks_its_inputs():
    x, e, p = map(torch.as_tensor, routed(16, 8, 4, 8, 2, seed=5))
    with pytest.raises(ValueError, match="x must be"):
        t_md.moe_dispatch(x[None], e, p, n_experts=4, capacity=8)
    with pytest.raises(ValueError, match="is not"):
        t_md.moe_dispatch(x, e[:8], p[:8], n_experts=4, capacity=8)
    with pytest.raises(ValueError, match="does not match"):
        t_md.moe_dispatch(x, e, p[:, :1], n_experts=4, capacity=8)
    with pytest.raises(TypeError, match="int32"):
        t_md.moe_dispatch(x, e.long(), p, n_experts=4, capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        t_md.moe_dispatch(x, e, p, n_experts=4, capacity=0)
    with pytest.raises(ValueError, match="on meta"):
        t_md.moe_dispatch(x, e.to("meta"), p, n_experts=4, capacity=8)


def test_copy_unit_is_the_widest_that_divides():
    assert t_md.vec_bytes(0, 256, 4096) == 16        # bf16 rows of 2048
    assert t_md.vec_bytes(0, 256, 16 * 4) == 16
    assert t_md.vec_bytes(8, 256, 4096) == 8         # an offset view
    assert t_md.vec_bytes(0, 256, 6 * 2) == 4
    assert t_md.vec_bytes(2, 0, 6) == 2
    assert t_md.vec_bytes(0, 0, 3) == 1


def test_copy_path_is_bulk_where_16_bytes_divide():
    """Bulk asynchronous copies need the row size and both base addresses
    to be multiples of 16 bytes; every other row takes the widest vector
    unit that divides all three."""
    assert t_md.copy_path(0, 256, 4096) == t_md.BULK   # bf16 rows of 2048
    assert t_md.copy_path(256, 512, 16) == t_md.BULK
    assert t_md.copy_path(0, 256, 8192 + 16) == t_md.BULK   # 2 chunks + 16
    assert t_md.copy_path(8, 256, 4096) == 8           # an offset view
    assert t_md.copy_path(0, 8, 4096) == 8
    assert t_md.copy_path(0, 256, 6 * 2) == 4
    assert t_md.copy_path(0, 0, 13 * 2) == 2           # 13 bf16 values
    assert t_md.copy_path(1, 0, 16) == 1
    assert t_md.BULK not in t_md.VEC_BYTES
    assert set(t_md.KERNEL_NAMES) == {"bulk", "vector"}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def layer_pair(arch, **moe_changes):
    """(JAX config, port config, JAX layer params, the port's)."""
    jcfg = j_cb.smoke_config(arch)
    tcfg = t_cb.smoke_config(arch)
    if moe_changes:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_changes))
    jp = j_moe.moe_init(jax.random.PRNGKey(7), jcfg)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dp_groups", (1, 2))
@pytest.mark.parametrize("strategy", ("drop", "na_rp", "na_ws"))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, strategy, dp_groups):
    """The layer on (2, 40, D) inputs under capacity pressure, with one and
    two token groups: output within 2e-4, counters equal, lb_loss close."""
    jcfg, tcfg, jp, tp = layer_pair(arch, strategy=strategy)
    rs = np.random.default_rng(8)
    # a direction all tokens share, so that a few experts overflow
    x = (rs.standard_normal((2, 40, tcfg.d_model))
         + 1.5 * rs.standard_normal(tcfg.d_model)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, j_aux = j_moe.moe_apply(jp, jnp.asarray(x), jcfg, ep_groups=4,
                                  rng=key, dp_groups=dp_groups)
    got, t_aux = t_moe.moe_apply(tp, torch.as_tensor(x), tcfg, ep_groups=4,
                                 rng=np.asarray(key), dp_groups=dp_groups)
    close(got, want, (arch, strategy))
    assert sorted(t_aux) == sorted(j_aux) == sorted(t_tfm.AUX_KEYS)
    for name in t_tfm.AUX_KEYS:
        assert t_aux[name].dtype == torch.float32
        if name == "lb_loss":
            close(t_aux[name], j_aux[name], name)
        else:
            assert float(t_aux[name]) == float(j_aux[name]), name
    placed = float(t_aux["ntasks_static"] + t_aux["ntasks_stolen_local"]
                   + t_aux["ntasks_stolen_remote"])
    assert placed + float(t_aux["ntasks_dropped"]) == 80 * tcfg.moe.top_k
    if strategy != "drop":
        assert float(t_aux["ntasks_stolen_local"]
                     + t_aux["ntasks_stolen_remote"]) > 0


def test_capacity_matches_jax():
    for arch in ARCHS:
        for fn in ("get", "smoke_config"):
            jcfg, tcfg = getattr(j_cb, fn)(arch), getattr(t_cb, fn)(arch)
            for n in (1, 4, 40, 4096, 10**5):
                assert t_moe.capacity_for(tcfg, n) == \
                    j_moe.capacity_for(jcfg, n)
    # the moonshot serving shapes: a 4 x 1024 prefill and a decode step of 4
    cfg = t_cb.get("moonshot_v1_16b_a3b")
    assert (t_moe.capacity_for(cfg, 4096), t_moe.capacity_for(cfg, 4)) == \
        (480, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_leaves_match_jax(arch):
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(t_cb.smoke_config(arch), param_dtype=dtype)
        jcfg = dataclasses.replace(j_cb.smoke_config(arch),
                                   param_dtype=dtype)
        jp = jax.tree_util.tree_flatten_with_path(
            j_moe.moe_init(jax.random.PRNGKey(0), jcfg))[0]
        want = {".".join(str(k.key) for k in path): (leaf.shape,
                                                    leaf.dtype.name)
                for path, leaf in jp}
        tp = t_moe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu",
                            lead=(3,))
        flat = {}
        for key, val in tp.items():
            for sub, leaf in (val.items() if isinstance(val, dict)
                              else [(None, val)]):
                flat[key if sub is None else f"{key}.{sub}"] = leaf
        assert {k: (tuple(v.shape[1:]), str(v.dtype).split(".")[-1])
                for k, v in flat.items()} == want
        assert all(v.shape[0] == 3 for v in flat.values())


def test_expert_leaves_are_drawn_one_layer_at_a_time():
    """Each layer's expert leaf is its own float32 draw, scaled by fan-in
    ** -0.5 and cast: the float32 copy never holds more than one layer."""
    cfg = dataclasses.replace(t_cb.smoke_config("moonshot_v1_16b_a3b"),
                              param_dtype="bfloat16")
    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert_ff
    got = t_moe._experts((E, D, F), D, torch.bfloat16,
                         torch.Generator().manual_seed(3), "cpu", (2, 3))
    gen = torch.Generator().manual_seed(3)
    want = torch.stack([(torch.randn((E, D, F), generator=gen) * D ** -0.5
                         ).to(torch.bfloat16) for _ in range(6)])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, E, D,
                                                                F)
    assert torch.equal(got.reshape(6, E, D, F), want)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

def models(arch, **moe_changes):
    """(config for each package, JAX params, the port's params)."""
    jcfg, tcfg = j_cb.smoke_config(arch), t_cb.smoke_config(arch)
    if moe_changes:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_changes))
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_map_one_to_one_onto_the_jax_tree(arch):
    jcfg, tcfg, jp, tp = models(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    jpaths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): np.asarray(leaf)
              for path, leaf in flat}
    tparams = dict(tp.named_parameters())
    assert sorted(tparams) == sorted(jpaths)
    assert any(name.endswith("mlp.router") for name in tparams)
    for name, leaf in jpaths.items():
        assert np.array_equal(tparams[name].numpy(), leaf), name
    drawn = t_tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {n: (tuple(p.shape), p.dtype)
            for n, p in drawn.named_parameters()} == \
        {n: (tuple(p.shape), p.dtype) for n, p in tparams.items()}


@pytest.mark.parametrize("key_seed", (None, 5))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_its_counters_match_jax(arch, key_seed):
    """Under capacity pressure (the config's own capacity factor) with the
    default key and another one: logits within 2e-4, the routing counters
    summed over the layers equal."""
    jcfg, tcfg, jp, tp = models(arch)
    tok = tokens(tcfg, 2, 40, seed=1)
    jkey = None if key_seed is None else jax.random.PRNGKey(key_seed)
    tkey = None if jkey is None else np.asarray(jkey)
    got, t_aux = t_tfm.forward(tp, tcfg, {"tokens": torch.as_tensor(tok)},
                               tkey)
    want, j_aux = j_tfm.forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                jkey)
    close(got, want, arch)
    assert sorted(t_aux) == sorted(j_tfm.AUX_KEYS)
    for name in j_tfm.AUX_KEYS:
        if name == "lb_loss":
            close(t_aux[name], j_aux[name], name)
        else:
            assert float(t_aux[name]) == float(j_aux[name]), name
    n_moe = sum(kd.moe for kd in t_tfm.pattern(tcfg)) * (
        tcfg.n_layers // len(t_tfm.pattern(tcfg)))
    assert float(t_aux["ntasks_static"] + t_aux["ntasks_stolen_local"]
                 + t_aux["ntasks_stolen_remote"] + t_aux["ntasks_dropped"]
                 ) == n_moe * 80 * tcfg.moe.top_k


def test_ep_groups_and_the_key_change_the_routing_as_in_jax():
    jcfg, tcfg, jp, tp = models("moonshot_v1_16b_a3b")
    tok = tokens(tcfg, 2, 40, seed=2)
    seen = set()
    for ep, seed in ((1, 0), (8, 0), (4, 3)):
        key = jax.random.PRNGKey(seed)
        got, t_aux = t_tfm.forward(tp, tcfg, {"tokens": torch.as_tensor(tok)},
                                   np.asarray(key), ep_groups=ep)
        want, j_aux = j_tfm.forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                                    key, ep_groups=ep)
        close(got, want, (ep, seed))
        counts = tuple(float(t_aux[k]) for k in j_tfm.AUX_KEYS[1:])
        assert counts == tuple(float(j_aux[k]) for k in j_tfm.AUX_KEYS[1:])
        seen.add(counts)
    assert len(seen) > 1


def state_close(t_state, j_state, label):
    assert np.array_equal(t_state.length.numpy(), np.asarray(j_state.length))
    assert len(t_state.caches) == len(j_state.caches)
    for p, (tc, jc) in enumerate(zip(t_state.caches, j_state.caches)):
        assert sorted(tc) == sorted(jc), (label, p)
        for key in tc:
            assert tuple(tc[key].shape) == jc[key].shape, (label, p, key)
            close(tc[key], jc[key], (label, p, key))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Contention-free capacity: prefill logits and decode state leaf for
    leaf, then 4 decode steps and the state after them."""
    jcfg, tcfg, jp, tp = models(arch, capacity_factor=8.0)
    B, S, EXTRA = 2, 30, 4
    tok = tokens(tcfg, B, S + EXTRA, seed=3)
    t_last, t_state = t_tfm.prefill(
        tp, tcfg, {"tokens": torch.as_tensor(tok[:, :S])}, S + EXTRA)
    j_last, j_state = j_tfm.prefill(
        jp, jcfg, {"tokens": jnp.asarray(tok[:, :S])}, S + EXTRA)
    close(t_last, j_last, "prefill")
    state_close(t_state, j_state, "prefill")
    for t in range(EXTRA):
        t_log, t_state = t_tfm.decode_step(tp, tcfg, t_state,
                                           torch.as_tensor(tok[:, S + t]))
        j_log, j_state = j_tfm.decode_step(jp, jcfg, j_state,
                                           jnp.asarray(tok[:, S + t]))
        close(t_log, j_log, ("decode", t))
    state_close(t_state, j_state, "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_full_forward(arch):
    """Teacher-forced decode reproduces the port's own full forward at
    contention-free capacity, as the JAX package checks for itself."""
    _, tcfg, _, tp = models(arch, capacity_factor=8.0)
    B, S, EXTRA = 2, 48, 4
    tok = torch.as_tensor(tokens(tcfg, B, S + EXTRA, seed=4))
    full, aux = t_tfm.forward(tp, tcfg, {"tokens": tok}, ep_groups=4)
    assert float(aux["ntasks_dropped"]) == 0
    last, state = t_tfm.prefill(tp, tcfg, {"tokens": tok[:, :S]}, S + EXTRA,
                                ep_groups=4)
    close(last, full[:, S - 1])
    for t in range(EXTRA):
        logits, state = t_tfm.decode_step(tp, tcfg, state, tok[:, S + t],
                                          ep_groups=4)
        close(logits, full[:, S + t], t)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_gives_the_jax_greedy_ids(arch):
    """``serve.main --arch <moe> --smoke --device cpu`` (its default batch
    4, prompt 48, 16 tokens, under the config's own capacity) against the
    JAX serving loop on the same weights and prompts, id for id."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    tcfg, jcfg = t_cb.smoke_config(arch), j_cb.smoke_config(arch)
    tp = t_tfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tok = t_pipe.batch_for(tcfg, 0, 4, 48)["tokens"]
    want = _jax_serve_loop(_as_jax_tree(tp), jcfg,
                           {"tokens": jnp.asarray(tok)}, 16)
    assert out.ids.dtype == torch.int32 and tuple(out.ids.shape) == (4, 16)
    assert len(np.unique(want)) > 10
    assert np.array_equal(out.ids.numpy(), want), (out.ids, want)
    zero = dict.fromkeys(t_reg.KERNELS, 0)
    assert out.launches == {"prefill": zero, "decode": zero}   # CPU: twins


def test_generate_gives_the_jax_greedy_ids_with_jax_weights():
    jcfg, tcfg, jp, tp = models("moonshot_v1_16b_a3b")
    tok = t_pipe.batch_for(tcfg, 5, 3, 40)["tokens"]
    want = _jax_serve_loop(jp, jcfg, {"tokens": jnp.asarray(tok)}, 12)
    got = serve.generate(tp, tcfg, {"tokens": torch.as_tensor(tok)}, 12)
    assert np.array_equal(got.ids.numpy(), want), (got.ids, want)
