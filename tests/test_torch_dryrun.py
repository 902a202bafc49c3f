"""The port's dry-run without HLO (``repro_torch.launch.dryrun``) and its
analyzer (``repro_torch.launch.hlo_analysis``) on the CPU.

The JAX dry-run's own cell (``rwkv6_1_6b x long_500k --multi-pod``) runs
in a subprocess with ``--device cpu``; every cell's skip, parameter counts,
model FLOPs, microbatches and placed state bytes are held to the JAX
package's, computed in one subprocess under the JAX dry-run's 512-device
flag without compiling (the JAX dry-run's own test fails in this jax, so
its compiled numbers are not a reference).  The analyzer is held to hand
counts, the scaled step loops to the same loops walked step by step, and
a smoke config's fake one-rank trace to the same step analyzed on real
CPU tensors.

Tolerances: every count compared here is exact (integer-valued floats);
the scaled loops' outputs on real tensors are bitwise the walked loops'.
"""

import dataclasses
import fcntl
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.data.pipeline import batch_for  # noqa: E402
from repro_torch.kernels import ops, ref, trace_hooks  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis as ha  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.shapes import SHAPES, ShapeCell, all_cells  # noqa
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
#: FLOPs a rank counts for a dense train step over 6 N D (N parameters, D
#: the rank's tokens): the forward and backward products (1) and the
#: forward's recomputation under remat (+1/3), plus attention's scores,
#: less the embedding table's share of N (a gather, no product); yi_9b's
#: smoke config at 4 x 128 counts 1.385
DENSE_TRAIN_BAND = (1.2, 1.6)


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")


@pytest.fixture
def no_world():
    """No process group before and after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX test's cell, and every cell against the JAX package
# ---------------------------------------------------------------------------

def test_the_jax_dryrun_cell_runs_in_a_subprocess(tmp_path):
    """``rwkv6_1_6b x long_500k --multi-pod`` (a batch of 1 on 32 data
    shards: F5's serve step) on 512 fake ranks, as
    ``tests/test_system.py::test_dryrun_one_cell_subprocess`` runs the JAX
    one: ``[OK]``, the step fits, 512 devices on the 2x16x16 mesh, no
    unknown loop, the state as the rules place it."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "rwkv6_1_6b", "--shape", "long_500k", "--multi-pod", "--force",
         "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[OK]" in r.stdout, r.stdout + r.stderr
    with open(tmp_path / "rwkv6_1_6b__long_500k__pod2.json") as f:
        rec = json.load(f)
    assert rec["fits_hbm"] and rec["n_devices"] == 512
    assert rec["mesh"] == "2x16x16" and rec["device"] == "cpu"
    assert rec["unknown_trip_loops"] == 0
    _, _, meta = dryrun.cell_meta("rwkv6_1_6b", "long_500k", True)
    assert rec["state_bytes_per_dev"] == meta["state_bytes_per_dev"]
    # every rank gathers the weights it serves with: all-gathers only
    assert set(rec["coll_by_op"]) == {"all_gather_into_tensor"}
    assert 0 < rec["arg_bytes"] <= rec["memory_per_device_bytes"]
    assert rec["memory_per_device_bytes"] == (
        rec["arg_bytes"] + rec["temp_bytes"] + rec["out_bytes"])
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_records_go_to_a_directory_of_the_port():
    assert dryrun.OUT_DIR == os.path.join("runs", "dryrun_torch")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "runs/" in f.read().split()


JAX_META = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math
import jax
import numpy as np
from repro.configs import base as cb
from repro.launch import dryrun, sharding as shd, steps
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import SHAPES, all_cells, supported


def placed(tree, specs):
    leaves = jax.tree_util.tree_leaves(tree)
    shards = jax.tree_util.tree_leaves(specs)
    assert len(leaves) == len(shards)
    return sum(math.prod(s.shard_shape(tuple(x.shape)))
               * np.dtype(x.dtype).itemsize for x, s in zip(leaves, shards))


out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch, shape in all_cells():
        cfg, cell = cb.get(arch), SHAPES[shape]
        key = f"{arch}/{shape}/{'pod2' if mp else 'pod1'}"
        ok, reason = supported(cfg, shape)
        if not ok:
            out[key] = {"skipped": True, "reason": reason}
            continue
        rec = {"mesh": "x".join(str(s) for s in mesh.devices.shape),
               "n_devices": int(mesh.devices.size),
               "params": cfg.n_params(), "active_params": cfg.active_params()}
        # the model FLOPs of dryrun.lower_cell, which compiles
        if cell.kind == "train":
            rec["microbatches"] = dryrun.DEFAULT_MB.get(arch, 1)
            rec["model_flops"] = (6 * cfg.active_params()
                                  * cell.global_batch * cell.seq)
        elif cell.kind == "prefill":
            rec["model_flops"] = (2 * cfg.active_params()
                                  * cell.global_batch * cell.seq)
        else:
            rec["model_flops"] = 2 * cfg.active_params() * cell.global_batch
        p_shape, o_shape = steps.init_shapes(cfg)
        n = placed(p_shape, shd.param_shardings(p_shape, cfg, mesh))
        if cell.kind == "train":
            o = shd.opt_shardings(o_shape, p_shape, cfg, mesh)
            n += placed(o_shape.m, o.m) + placed(o_shape.v, o.v)
        rec["state_bytes_per_dev"] = int(n)
        out[key] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    """Every cell's JAX numbers (see ``JAX_META``), by
    ``arch/shape/pod1|pod2``: one subprocess for the whole test run,
    whichever test process asks first (a file lock under the run's shared
    temporary directory)."""
    pytest.importorskip("jax")
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"dryrun_jax_{uid}" if uid else base / "dryrun_jax"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = root / "cells.json"
            if not done.exists():
                r = subprocess.run([sys.executable, "-c", JAX_META],
                                   capture_output=True, text=True,
                                   timeout=300, env=_env(), cwd=ROOT)
                assert r.returncode == 0, r.stderr[-4000:]
                done.write_text(r.stdout.splitlines()[-1])
            return json.loads(done.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


CELLS = [(arch, shape, mp) for mp in (False, True)
         for arch, shape in all_cells()]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS, ids=[
    f"{a}-{s}-{'pod2' if m else 'pod1'}" for a, s, m in CELLS])
def test_cell_meta_is_the_jax_packages(arch, shape, multi_pod, jax_cells):
    """The skip and its reason, ``mesh``, ``n_devices``, ``params``,
    ``active_params``, ``microbatches``, ``model_flops`` and the state's
    bytes on a rank (the parameters, and a train cell's moments, as the
    rules place them: the JAX ``NamedSharding.shard_shape`` bytes) equal
    the JAX package's."""
    want = jax_cells[f"{arch}/{shape}/{'pod2' if multi_pod else 'pod1'}"]
    _, _, meta = dryrun.cell_meta(arch, shape, multi_pod)
    assert {k: meta.get(k) for k in want} == want
    if not want.get("skipped"):
        assert meta["shape"] == shape and meta["variant"] == ""


def test_every_cell_is_covered():
    assert len(CELLS) == 2 * len(cb.ARCH_IDS) * len(SHAPES) == 80


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

def test_a_loop_of_ten_matmuls_counts_ten():
    """The JAX module's own case: a 10-step loop of one matmul counts ten
    products, each 2 M N K, and each reads and writes its operands."""
    x, w = torch.randn(8, 16), torch.randn(16, 16)

    def loop(x, w):
        for _ in range(10):
            x = x @ w
        return x

    _, c = ha.analyze(loop, x, w)
    _, one = ha.analyze(torch.mm, x, w)
    assert c.flops == 10 * one.flops == 10 * 2 * 8 * 16 * 16
    assert c.hbm_bytes == 10 * one.hbm_bytes == 10 * (8 + 16 + 8) * 16 * 4
    assert c.by_op == {"aten.mm": {"calls": 10.0, "flops": c.flops,
                                   "bytes": c.hbm_bytes}}
    assert c.flop_counter_flops == c.flops
    assert c.arg_bytes == (8 * 16 + 16 * 16) * 4
    assert c.unknown_trip_loops == 0 and not c.coll_by_op


@pytest.mark.parametrize("op", ("mm", "bmm", "addmm", "einsum", "matmul"))
def test_a_matmul_counts_2_m_n_k(op):
    M, K, N, G = 5, 7, 3, 4
    a, b = torch.randn(G, M, K), torch.randn(G, K, N)
    fns = {"mm": lambda: torch.mm(a[0], b[0]),
           "bmm": lambda: torch.bmm(a, b),
           "addmm": lambda: torch.addmm(torch.zeros(M, N), a[0], b[0]),
           "einsum": lambda: torch.einsum("gmk,gkn->gmn", a, b),
           "matmul": lambda: a @ b}
    _, c = ha.analyze(fns[op])
    assert c.flops == 2 * M * N * K * (1 if op in ("mm", "addmm") else G)


def test_a_copy_between_devices_counts_no_bytes():
    """A host value copied to another device (here the meta device, as a
    learning rate goes to the card) crosses the host link: the call is
    tallied, its bytes are not, so a step counts the same bytes on the
    card as on the CPU, where it makes no such copy; a copy on one device
    counts its input and output."""
    x = torch.ones(6, 8)
    _, c = ha.analyze(lambda: x.to("meta"))
    assert c.hbm_bytes == 0 and c.by_op["aten._to_copy"]["calls"] == 1
    _, c = ha.analyze(lambda: x.to(torch.float64))
    assert c.hbm_bytes == 6 * 8 * (4 + 8)


def test_views_count_no_bytes_and_ops_count_inputs_and_outputs():
    x = torch.randn(6, 8)

    def views(x):
        return x.view(8, 6).t().reshape(6, 8)[1:3].unsqueeze(0).expand(
            4, 2, 8).transpose(1, 2)

    _, c = ha.analyze(views, x)
    assert c.hbm_bytes == 0 and c.flops == 0
    _, c = ha.analyze(lambda x: x @ torch.ones(8, 3), torch.randn(2, 6, 8))
    assert c.by_op["aten._unsafe_view"]["bytes"] == 0   # matmul's reshape
    _, c = ha.analyze(lambda x: x + 1.0, x)
    assert c.hbm_bytes == 2 * 6 * 8 * 4
    _, c = ha.analyze(lambda x: torch.empty_like(x), x)
    assert c.hbm_bytes == 0
    y = torch.randn(6, 8)
    _, c = ha.analyze(lambda x, y: x.add_(y), x, y)
    assert c.hbm_bytes == 3 * 6 * 8 * 4       # the target read and written


def test_peak_memory_counts_live_storages_on_top_of_the_arguments():
    x = torch.randn(256)

    def fn(x):
        a = x * 2          # 1 KiB
        b = a * 2          # 2 KiB live
        del a
        c = b * 2          # 2 KiB live
        return c.sum()     # 4 bytes kept

    _, c = ha.analyze(fn, x)
    assert c.arg_bytes == 1024
    assert c.out_bytes == 4
    assert c.temp_bytes + c.out_bytes == 2048 + 4
    assert c.peak_bytes == 1024 + 2048 + 4


def test_merged_adds_counts_and_keeps_the_larger_memory():
    a = ha.HloCost(1.0, 2.0, 3.0, {"all_reduce": 3.0}, 1, 4.0,
                   {"k": {"calls": 1.0, "flops": 1.0, "bytes": 2.0}},
                   10, 20, 30, 60)
    b = ha.HloCost(10.0, 20.0, 30.0, {"all_reduce": 10.0,
                                      "all_gather": 20.0}, 2, 40.0,
                   {"k": {"calls": 1.0, "flops": 5.0, "bytes": 6.0}},
                   1, 50, 3, 54)
    b.by_op = {"aten.mm": {"calls": 1.0, "flops": 2.0, "bytes": 3.0}}
    m = a.merged(b, 3)
    assert m.by_op == {"aten.mm": {"calls": 3.0, "flops": 6.0, "bytes": 9.0}}
    assert (m.flops, m.hbm_bytes, m.coll_bytes, m.flop_counter_flops) == (
        31.0, 62.0, 93.0, 124.0)
    assert dict(m.coll_by_op) == {"all_reduce": 33.0, "all_gather": 60.0}
    assert m.unknown_trip_loops == 3
    assert m.kernels == {"k": {"calls": 4.0, "flops": 16.0, "bytes": 20.0}}
    assert (m.arg_bytes, m.temp_bytes, m.out_bytes, m.peak_bytes) == (
        10, 50, 30, 60)


def test_one_analysis_at_a_time():
    def inner():
        return ha.analyze(torch.zeros, 3)

    with pytest.raises(RuntimeError, match="already running"):
        ha.analyze(inner)
    assert trace_hooks.ACTIVE is None


def test_full_tensor_of_a_shard_on_a_fake_2x2_world_is_one_all_gather(
        no_world):
    """A ``Shard(0)`` DTensor over ``"data"`` (replicated over
    ``"model"``) of a fake (2, 2) world: ``full_tensor`` is one
    ``all_gather_into_tensor`` of the rank's local bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with dryrun.fake_world(4):
        mesh = make_test_mesh(2, 2, device="cpu")
        with FakeTensorMode():
            d = distribute_tensor(torch.empty(64, 10), mesh,
                                  [Shard(0), Replicate()])
            local = d.to_local().numel() * 4
            assert local == 32 * 10 * 4
            full, c = ha.analyze(lambda: d.full_tensor())
            assert tuple(full.shape) == (64, 10)
    assert dict(c.coll_by_op) == {"all_gather_into_tensor": local}
    assert c.coll_bytes == local and c.flops == 0


def test_the_fake_world_is_a_fake_group_of_its_size(no_world):
    with dryrun.fake_world(8):
        assert dist.get_backend() == "fake" and dist.get_world_size() == 8
        assert dist.get_rank() == 0
    assert not dist.is_initialized()
    with open(os.path.join(SRC, "repro_torch", "launch", "dryrun.py")) as f:
        text = f.read()
    assert text.count("torch.testing._internal") == 1
    fn = text[text.index("def fake_world"):text.index("def apply_variant")]
    assert "from torch.testing._internal" in fn


def test_the_dryrun_refuses_a_real_process_group(no_world, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="already initialized"):
        with dryrun.fake_world(1):
            pass
    rec = dryrun.run_cell("rwkv6_1_6b", "long_500k", True, str(tmp_path),
                          force=True, verbose=False, device="cpu")
    assert "already initialized" in rec["error"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "rwkv6_1_6b", "--shape", "long_500k",
                     "--out", str(tmp_path), "--force", "--device", "cpu"])
    assert e.value.code == 1


# ---------------------------------------------------------------------------
# the model kernels by formula
# ---------------------------------------------------------------------------

def _kernel(cost, name):
    return cost.kernels[name]


@pytest.mark.parametrize("causal,window", ((True, 0), (True, 5), (False, 0),
                                           (False, 5)))
def test_flash_attention_counts_its_formula(causal, window):
    """Forward: 4 Dh B H (kept pairs) operations, q, k, v read and out
    written; the output is the twin's.  Under grad the lse is written too
    and the backward (``ref._attn_bwd``) counts op by op."""
    g = torch.Generator().manual_seed(1)
    B, H, KV, S, Dh = 2, 4, 2, 12, 16
    q = torch.randn(B, H, S, Dh, generator=g)
    k, v = (torch.randn(B, KV, S, Dh, generator=g) for _ in range(2))
    out, c = ha.analyze(lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    pos = torch.arange(S)
    pairs = int(ref._block_mask(pos, pos, causal, window).sum())
    flops = 4 * Dh * B * H * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
    assert _kernel(c, "flash_attention") == dict(calls=1, flops=flops,
                                                 bytes=nbytes)
    assert c.flops == flops and c.hbm_bytes >= nbytes
    assert torch.equal(out, ref.flash_attention(q, k, v, causal, window))
    qg = q.clone().requires_grad_(True)

    def train():
        y = ops.flash_attention(qg, k, v, causal=causal, window=window)
        return torch.autograd.grad(y.sum(), qg)[0]

    dq, c = ha.analyze(train)
    assert _kernel(c, "flash_attention")["bytes"] == nbytes + 4 * B * H * S
    assert c.flops > flops                       # the backward's products
    qr = q.clone().requires_grad_(True)
    want = torch.autograd.grad(ref.flash_attention(qr, k, v, causal,
                                                   window).sum(), qr)[0]
    assert torch.equal(dq, want)


def test_rwkv6_counts_its_formula():
    g = torch.Generator().manual_seed(2)
    B, H, T, Dh = 2, 3, 10, 8
    r, k, v = (torch.randn(B, H, T, Dh, generator=g) for _ in range(3))
    w = torch.rand(B, H, T, Dh, generator=g)
    u = torch.randn(H, Dh, generator=g)
    s = torch.randn(B, H, Dh, Dh, generator=g)
    (out, st), c = ha.analyze(ops.rwkv6, r, k, v, w, u, s)
    assert _kernel(c, "rwkv6_scan") == dict(
        calls=1, flops=(5 * Dh * Dh + 5 * Dh) * B * H * T,
        bytes=(5 * r.numel() + u.numel() + 2 * s.numel()) * 4)
    want = ref.rwkv6_naive(r, k, v, w, u, s)
    assert torch.equal(out, want[0]) and torch.equal(st, want[1])


def test_moe_dispatch_counts_its_bytes():
    g = torch.Generator().manual_seed(3)
    T, D, k, E, C = 12, 8, 2, 4, 5
    x = torch.randn(T, D, generator=g)
    expert = torch.randint(-1, E, (T, k), generator=g, dtype=torch.int32)
    pos = torch.randint(-1, C, (T, k), generator=g, dtype=torch.int32)
    buf, c = ha.analyze(lambda: ops.moe_dispatch(x, expert, pos,
                                                 n_experts=E, capacity=C))
    assert _kernel(c, "moe_dispatch") == dict(
        calls=1, flops=0, bytes=(T * D + 2 * T * k + E * C * D) * 4)
    assert torch.equal(buf, ref.moe_dispatch(x, expert, pos, E, C))


def test_no_analysis_leaves_the_kernel_ops_as_they_were():
    """With no analysis active the ops take their usual path (the twins on
    the CPU) and count nothing."""
    assert trace_hooks.ACTIVE is None and trace_hooks.counting() is None
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v))


# ---------------------------------------------------------------------------
# the scaled step loops against the loops walked step by step
# ---------------------------------------------------------------------------

def _rwkv_inputs(T, seed=5):
    g = torch.Generator().manual_seed(seed)
    B, H, Dh = 2, 3, 4
    r, k, v = (torch.randn(B, H, T, Dh, generator=g) for _ in range(3))
    w = torch.rand(B, H, T, Dh, generator=g)
    return (r, k, v, w, torch.randn(H, Dh, generator=g),
            torch.randn(B, H, Dh, Dh, generator=g))


def _ssm_inputs(T, seed=6):
    g = torch.Generator().manual_seed(seed)
    B, Di, N = 2, 5, 3
    x, dt = (torch.randn(B, T, Di, generator=g) for _ in range(2))
    A = -torch.rand(Di, N, generator=g)
    Bm, Cm = (torch.randn(B, T, N, generator=g) for _ in range(2))
    return x, dt.abs() * 0.1, A, Bm, Cm, torch.randn(B, Di, N, generator=g)


def _same_count(a, b):
    assert (a.flops, a.hbm_bytes, a.coll_bytes) == (b.flops, b.hbm_bytes,
                                                    b.coll_bytes)


def _bitwise(a, b):
    fa, fb = tfm.tree_leaves(list(a)), tfm.tree_leaves(list(b))
    return len(fa) == len(fb) and all(torch.equal(x, y)
                                      for x, y in zip(fa, fb))


@pytest.fixture(params=[(16, 4), (200, 64)], ids=["T16_block4",
                                                 "T200_block64"])
def scaled_T(request, monkeypatch):
    """T = 16 with the loops' block cut to 4 steps (so the loop is scaled,
    over 4 blocks), and T = 200 with the loops' own 64."""
    T, block = request.param
    monkeypatch.setattr(ref, "RWKV_STEP_BLOCK", block)
    monkeypatch.setattr(ref, "SSM_STEP_BLOCK", block)
    return T


def test_scaled_rwkv6_loops_count_as_walked(scaled_T):
    T = scaled_T
    args = _rwkv_inputs(T)
    r, k, v, w, u, s = args
    g = torch.Generator().manual_seed(7)
    dout = torch.randn(r.shape, generator=g)
    ds = torch.randn(s.shape, generator=g)
    f32 = (r, k, v, w, u, s)
    got, scaled = ha.analyze(ref._rwkv6_steps, *f32)
    want, walked = ha.analyze(ref._rwkv6_walk, *f32)
    _same_count(scaled, walked)
    assert scaled.unknown_trip_loops == 0 and _bitwise(got, want)
    got, scaled = ha.analyze(ref.rwkv6_backward, *args, dout, ds)
    want, walked = ha.analyze(ref._rwkv6_backward_walk, *args, dout, ds)
    _same_count(scaled, walked)
    assert scaled.unknown_trip_loops == 0 and _bitwise(got, want)


def test_scaled_ssm_loops_count_as_walked(scaled_T):
    T = scaled_T
    x, dt, A, Bm, Cm, h = _ssm_inputs(T)
    starts_s, starts_w = [], []
    got, scaled = ha.analyze(ref._ssm_steps, x, dt, A, Bm, Cm, h, starts_s)
    want, walked = ha.analyze(ref._ssm_walk, x, dt, A, Bm, Cm, h, starts_w)
    _same_count(scaled, walked)
    assert _bitwise(got, want) and _bitwise(starts_s, starts_w)
    assert len(starts_s) == -(-T // ref.SSM_STEP_BLOCK)
    g = torch.Generator().manual_seed(8)
    gy = torch.randn(x.shape, generator=g)
    gh = torch.randn(h.shape, generator=g)
    got, scaled = ha.analyze(ref.ssm_backward, x, dt, A, Bm, Cm, starts_s,
                             gy, gh)
    want, walked = ha.analyze(ref._ssm_backward_walk, x, dt, A, Bm, Cm,
                              starts_s, gy, gh)
    _same_count(scaled, walked)
    assert scaled.unknown_trip_loops == 0 and _bitwise(got, want)


def test_scaled_loops_on_fake_inputs_return_full_shapes(monkeypatch):
    """On fake tensors a scaled loop returns empty outputs of the walked
    loop's shapes and layouts, and the SSM forward its block starts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(ref, "RWKV_STEP_BLOCK", 4)
    monkeypatch.setattr(ref, "SSM_STEP_BLOCK", 4)
    args = _rwkv_inputs(16)
    dout = torch.randn(args[0].shape)
    walked = ref._rwkv6_backward_walk(*args, args[0], args[5])
    x, dt, A, Bm, Cm, h = _ssm_inputs(16)
    with FakeTensorMode() as fm:
        fargs = [fm.from_tensor(a) for a in args]
        got, _ = ha.analyze(ref.rwkv6_backward, *fargs, fm.from_tensor(dout),
                            fargs[5])
        starts = []
        (hf, y), _ = ha.analyze(ref._ssm_steps, *(fm.from_tensor(t) for t in
                                                  (x, dt, A, Bm, Cm, h)),
                                starts)
    for a, b in zip(got, walked):
        assert a.shape == b.shape and a.stride() == b.stride()
        assert a.dtype == b.dtype
    assert tuple(y.shape) == tuple(x.shape) and tuple(hf.shape) == h.shape
    assert len(starts) == 4 and all(tuple(t.shape) == h.shape
                                    for t in starts)


def test_a_loop_that_does_not_scale_is_walked_and_counted():
    """A loop whose cost is not ``a + b T + c blocks`` (here quadratic in
    its steps) fails the 4-step check: it is walked, counted as walked,
    and counted in ``unknown_trip_loops``."""
    def part(n):
        return torch.ones(n, n).sum()

    def fn():
        return trace_hooks.ACTIVE.loop(100, 8, part, lambda: part(100))

    out, c = ha.analyze(fn)
    _, walked = ha.analyze(part, 100)
    assert c.unknown_trip_loops == 1
    assert c.hbm_bytes == walked.hbm_bytes and float(out) == 100 * 100


# ---------------------------------------------------------------------------
# steps: a fake one-rank trace against the same step on real tensors
# ---------------------------------------------------------------------------

def _real_train_cost(cfg, S, tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(1, 1, device="cpu")
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
        p, o = steps.shard_train_state(cfg, mesh, params, opt)
        del params, opt
        batch = {k: torch.as_tensor(v) for k, v in
                 batch_for(cfg, 0, 2, S).items()}
        (_, _, metrics), cost = ha.analyze(
            steps.make_train_step(cfg, mesh), p, o, batch, 0)
        assert np.isfinite(float(metrics["loss"]))
        return cost
    finally:
        dist.destroy_process_group()


#: the smoke configs traced against their real step: each model kernel and
#: both scan families (rwkv6 over 80 steps: its loops scaled)
STEP_CASES = (("gemma2_2b", 40), ("rwkv6_1_6b", 80),
              ("moonshot_v1_16b_a3b", 40), ("hymba_1_5b", 24))


@pytest.mark.parametrize("arch,S", STEP_CASES, ids=[a for a, _ in
                                                     STEP_CASES])
def test_a_fake_trace_counts_as_the_real_step(arch, S, no_world, tmp_path):
    """A smoke config's sharded train step on a one-rank mesh, traced on
    fake tensors by ``trace_cell`` and analyzed on real CPU tensors: the
    same FLOPs, bytes, collective bytes by op, flop-counter total and
    kernel tallies."""
    cfg = cb.smoke_config(arch)
    cell = ShapeCell("smoke_train", "train", S, 2)
    with dryrun.fake_world(1):
        fake, meta = dryrun.trace_cell(arch, "smoke_train", False,
                                       microbatches=1, device="cpu",
                                       cell=cell, mesh_shape=(1, 1), cfg=cfg)
    assert meta["mesh"] == "1x1" and meta["n_devices"] == 1
    real = _real_train_cost(cfg, S, tmp_path)
    _same_count(fake, real)
    assert fake.flop_counter_flops == real.flop_counter_flops
    assert dict(fake.coll_by_op) == dict(real.coll_by_op)
    assert fake.kernels == real.kernels and fake.kernels
    assert fake.arg_bytes == real.arg_bytes
    assert fake.unknown_trip_loops == real.unknown_trip_loops == 0


def test_a_dense_train_cell_counts_about_6_n_d(no_world):
    """yi_9b's smoke config, 4 rows of 128 on a one-rank mesh: the counted
    FLOPs over 6 N D within ``DENSE_TRAIN_BAND``."""
    cfg = cb.smoke_config("yi_9b")
    cell = ShapeCell("smoke_train", "train", 128, 4)
    with dryrun.fake_world(1):
        cost, meta = dryrun.trace_cell("yi_9b", "smoke_train", False,
                                       microbatches=1, device="cpu",
                                       cell=cell, mesh_shape=(1, 1), cfg=cfg)
    ratio = cost.flops / meta["model_flops"]
    lo, hi = DENSE_TRAIN_BAND
    assert lo <= ratio <= hi, ratio
    rec = dryrun.analyze_cell(cost, meta)
    assert rec["useful_flops_ratio"] == pytest.approx(1 / ratio)
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * cfg.n_layers


def test_a_probed_train_cell_counts_as_the_whole_step(no_world):
    """``probe``: yi_9b's smoke config at 6 layers (3 checkpointed groups
    of 2) and 5 microbatches, counted from the step at 1 and 2 groups and
    2 and 3 microbatches, equals the whole step traced: FLOPs, bytes,
    collectives, flop-counter total, kernel tallies and memory."""
    cfg = dataclasses.replace(cb.smoke_config("yi_9b"), n_layers=6)
    cell = ShapeCell("smoke_train", "train", 24, 10)
    kw = dict(microbatches=5, device="cpu", cell=cell, mesh_shape=(1, 1),
              cfg=cfg)
    with dryrun.fake_world(1):
        whole, _ = dryrun.trace_cell("yi_9b", "smoke_train", False, **kw)
        probed, meta = dryrun.trace_cell("yi_9b", "smoke_train", False,
                                         probe=True, **kw)
    assert meta["probes"] == {"layers_per_group": 2, "groups": [1, 2],
                              "of_groups": 3, "microbatches": [2, 3]}
    _same_count(whole, probed)
    assert whole.flop_counter_flops == probed.flop_counter_flops
    assert dict(whole.coll_by_op) == {k: v for k, v in
                                      probed.coll_by_op.items() if v}
    assert whole.kernels == probed.kernels
    assert (whole.arg_bytes, whole.temp_bytes, whole.out_bytes,
            whole.peak_bytes) == (probed.arg_bytes, probed.temp_bytes,
                                  probed.out_bytes, probed.peak_bytes)


# ---------------------------------------------------------------------------
# FSDP's per-layer gathers and fault F6 in the dry-run
# ---------------------------------------------------------------------------

def _fsdp_trace(mesh_shape, fsdp: bool, monkeypatch, rows_a_rank: int = 2):
    """Smoke llama4 (``fsdp`` as given) one train step traced on a fake
    world of ``mesh_shape``, each data rank holding ``rows_a_rank`` rows of
    16: ``(cost, got)``, ``got`` rank 0's FSDP piece bytes of the stacked
    leaves and of the others, the operand bytes of the model's gathers
    over ``"data"`` (``tensor_parallel._gather``) and their count."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import dp_size
    from repro_torch.models import tensor_parallel as tpo

    arch = "llama4_maverick_400b_a17b"
    cfg = dataclasses.replace(cb.smoke_config(arch), fsdp=fsdp)
    n = int(np.prod(mesh_shape))
    got = dict(stacked=0, other=0, gathered=0, gathers=0)
    gather = tpo._gather

    def counted(x, group, size, dim):
        if dist.get_process_group_ranks(group) == data_ranks:
            got["gathered"] += x.numel() * x.element_size()
            got["gathers"] += 1
        return gather(x, group, size, dim)

    with dryrun.fake_world(n), monkeypatch.context() as mp:
        mesh = dryrun._mesh(tuple(mesh_shape), torch.device("cpu"))
        data_ranks = dist.get_process_group_ranks(mesh.get_group("data"))
        mp.setattr(tpo, "_gather", counted)
        dp = dp_size(mesh)
        cell = ShapeCell("smoke_train", "train", 16, rows_a_rank * dp)
        cost, _ = dryrun.trace_cell(arch, "smoke_train", True,
                                    microbatches=1, device="cpu", cell=cell,
                                    mesh_shape=mesh_shape, cfg=cfg)
        params = tfm.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                              steps.init_shapes(cfg)[0])
        p, _ = steps.shard_train_state(cfg, mesh, params,
                                       adamw_init(params))
        for path, leaf in tfm.tree_items(p):
            if shd.fsdp_dim(leaf) is None and leaf.to_local().numel() % (
                    mesh_shape[-2]) == 0:
                # summed by the tree all-reduce: reduce-scattered in a pod
                got["tree"] = got.get("tree", 0) + \
                    leaf.to_local().numel() * leaf.element_size()
            if shd.fsdp_dim(leaf) is not None:
                got["stacked" if path[0] == "streams" else "other"] += \
                    leaf.to_local().numel() * leaf.element_size()
                got["layers"] = got.get("layers", 0) + (
                    leaf.shape[0] if path[0] == "streams" else 0)
                got["heads"] = got.get("heads", 0) + (path[0] != "streams")
    got["data"] = mesh_shape[-2]
    return cost, got


def test_an_fsdp_train_cell_gathers_each_layer_and_reduce_scatters_back(
        no_world, monkeypatch):
    """Smoke llama4 with ``fsdp`` on a fake (2, 2, 2) world: the model
    gathers over ``"data"`` each FSDP piece of a layer twice (the forward
    and its recompute) and the embedding's and head's once, one gather
    a leaf and layer, and ``coll_by_op`` counts those operands among its
    ``all_gather_into_tensor`` bytes; its ``reduce_scatter_tensor``
    operands are each gathered leaf once (``data`` times the piece) and
    the other leaves' gradients, which the tree all-reduce reduce-scatters
    inside the pod.  Without ``fsdp`` nothing is gathered over ``"data"``
    (the tensor-parallel heads and vocabulary gather nothing in a train
    step) and every leaf's gradient goes through the tree all-reduce."""
    cost, b = _fsdp_trace((2, 2, 2), True, monkeypatch)
    assert b["stacked"] > 0 and b["other"] > 0
    assert b["gathers"] == 2 * b["layers"] + b["heads"]
    assert b["gathered"] == 2 * b["stacked"] + b["other"]
    assert cost.coll_by_op["all_gather_into_tensor"] >= b["gathered"]
    assert cost.coll_by_op["reduce_scatter_tensor"] == b["data"] * (
        b["stacked"] + b["other"]) + b["tree"]
    plain, b0 = _fsdp_trace((2, 2, 2), False, monkeypatch)
    assert b0["stacked"] == b0["other"] == b0["gathers"] == 0
    assert plain.coll_by_op["reduce_scatter_tensor"] == b0["tree"]
    assert b0["tree"] > b["tree"]


def test_an_fsdp_train_cells_peak_falls_as_the_data_axis_grows(
        no_world, monkeypatch):
    """The same step, each data rank holding 2 rows, on (2, 2, 2) and
    (2, 4, 2): a rank's arguments (its pieces of the weights and moments)
    and its peak fall as the data axis grows; without ``fsdp`` the
    arguments stay (the moments' ZeRO shards fall, the weights do not)
    and more than the FSDP step's."""
    fsdp2, _ = _fsdp_trace((2, 2, 2), True, monkeypatch)
    fsdp4, _ = _fsdp_trace((2, 4, 2), True, monkeypatch)
    assert fsdp4.arg_bytes < fsdp2.arg_bytes
    assert fsdp4.peak_bytes < fsdp2.peak_bytes
    plain4, _ = _fsdp_trace((2, 4, 2), False, monkeypatch)
    assert plain4.arg_bytes > fsdp4.arg_bytes
    assert plain4.peak_bytes > fsdp4.peak_bytes


@pytest.mark.parametrize("arch", ("gemma2_2b", "moonshot_v1_16b_a3b"))
def test_a_train_cell_whose_microbatch_the_data_shards_do_not_divide_traces(
        arch, no_world):
    """Fault F6 in the dry-run: a batch of 4 rows in 2 microbatches on a
    fake (2, 2, 2) world (2 rows a microbatch, 4 data shards) traces, each
    rank computing both microbatches whole, so it counts more FLOPs than
    the same step with 8 rows in 2 (a row a rank a microbatch); a batch
    the data shards do not divide is still refused."""
    cfg = cb.smoke_config(arch)
    costs = {}
    with dryrun.fake_world(8):
        for rows in (4, 8):
            cell = ShapeCell("smoke_train", "train", 16, rows)
            costs[rows], _ = dryrun.trace_cell(
                arch, "smoke_train", True, microbatches=2, device="cpu",
                cell=cell, mesh_shape=(2, 2, 2), cfg=cfg)
        with pytest.raises(ValueError, match="does not split"):
            dryrun.trace_cell(arch, "smoke_train", True, microbatches=2,
                              device="cpu", cfg=cfg, mesh_shape=(2, 2, 2),
                              cell=ShapeCell("smoke_train", "train", 16, 6),
                              probe=True)
    assert costs[4].flops > costs[8].flops > 0


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------

def test_variants_override_the_config_as_in_jax():
    cfg = cb.get("moonshot_v1_16b_a3b")
    c, mb = dryrun.apply_variant(cfg, "", 0)
    assert c == cfg and mb == 0
    c, mb = dryrun.apply_variant(cfg, "capacity_1_0,remat_group_3,mb_2", 0)
    assert c.moe.capacity_factor == 1.0 and c.remat_group == 3 and mb == 2
    off = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, shard_routing=False))
    c, _ = dryrun.apply_variant(off, "moe_shard_routing", 0)
    assert c.moe.shard_routing and not off.moe.shard_routing
    _, _, meta = dryrun.cell_meta("gemma2_2b", "train_4k", False,
                                  variant="mb_4")
    assert meta["microbatches"] == 4 and meta["variant"] == "mb_4"


@pytest.mark.parametrize("variant", ("rwkv_chunk_16", "ssm_chunk_64"))
def test_chunk_variants_raise_for_the_scans_take_no_chunk(variant):
    with pytest.raises(ValueError, match="take no chunk"):
        dryrun.apply_variant(cb.get("rwkv6_1_6b"), variant, 0)


def test_an_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.apply_variant(cb.get("yi_9b"), "bogus", 0)


def test_a_skipped_cell_is_recorded_with_its_variant_and_cached(tmp_path,
                                                               no_world,
                                                               capsys):
    rec = dryrun.run_cell("yi_9b", "long_500k", False, str(tmp_path),
                          variant="mb_2,remat_group_2", device="cpu")
    assert rec["skipped"] and "sub-quadratic" in rec["reason"]
    path = tmp_path / "yi_9b__long_500k__pod1__mb_2+remat_group_2.json"
    with open(path) as f:
        assert json.load(f) == rec
    assert "[SKIP]" in capsys.readouterr().out
    again = dryrun.run_cell("yi_9b", "long_500k", False, str(tmp_path),
                            variant="mb_2,remat_group_2", device="cpu")
    assert again == rec and "[skip-cached]" in capsys.readouterr().out


def test_roofline_terms_use_the_h100_constants():
    t = dryrun.roofline_terms(989e12, 3.35e12, 50e9)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert dryrun.HBM_PER_CHIP > 80 * 10 ** 9


def test_the_records_directory_is_made_on_demand(tmp_path):
    out = tmp_path / "new"
    rec = dryrun.run_cell("hubert_xlarge", "decode_32k", True, str(out),
                          device="cpu", verbose=False)
    assert rec["skipped"] and out.is_dir()
