"""The port's tree all-reduce (``repro_torch.runtime.collectives``) against
the flat sum and against the JAX package's ``tree_allreduce`` under
``shard_map``: 8 gloo ranks as a (2, 2, 2) ``("pod", "data", "model")``
mesh (``make_test_mesh(2, 2, multi_pod=True)``) beside one JAX process with
8 host devices; integer-valued floats compare bitwise, normal ones within
1e-6.  On a world of one every collective is the identity, bit for bit."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.runtime import collectives as col  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
MESH = (2, 2, 2)
#: per-rank lengths: every intra size divides 64; 6 splits over "data"
#: (2) but not over ("data", "model") (4); 3 takes the flat fallback
LENGTHS = (64, 6, 3)
INTRA = {"data": ("data",), "data_model": ("data", "model")}
#: the gradient tree of flat_psum_grads / hierarchical_psum_grads
TREE = {"w": (4, 6), "b": (3,), "s": ((8,), (2, 5))}

RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.runtime import collectives as col

rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=8)
try:
    mesh = make_test_mesh(2, 2, multi_pod=True, device="cpu")
    coord = tuple(mesh.get_coordinate())
    inputs = np.load(f"{tmp}/inputs.npz")
    out = {"coord": np.asarray(coord)}
    for name in inputs.files:
        if not name.startswith("x_"):
            continue
        x = torch.from_numpy(inputs[name][coord][None, None, None].copy())
        for tag, intra in (("data", ("data",)),
                           ("data_model", ("data", "model"))):
            y = col.tree_allreduce(x, mesh, intra_axes=intra,
                                   inter_axis="pod")
            assert y.shape == x.shape and y.dtype == x.dtype
            out[f"{name}__{tag}"] = y.numpy()
    tree = {"w": inputs["t_w"][coord], "b": inputs["t_b"][coord],
            "s": (inputs["t_s0"][coord], inputs["t_s1"][coord])}
    tree = {k: (tuple(torch.from_numpy(a.copy()) for a in v)
                if isinstance(v, tuple) else torch.from_numpy(v.copy()))
            for k, v in tree.items()}
    flat = col.flat_psum_grads(tree, mesh, ("pod", "data"))
    hier = col.hierarchical_psum_grads(tree, mesh)
    for tag, t in (("flat", flat), ("hier", hier)):
        assert isinstance(t["s"], tuple)
        out[f"{tag}_w"], out[f"{tag}_b"] = t["w"].numpy(), t["b"].numpy()
        out[f"{tag}_s0"], out[f"{tag}_s1"] = (t["s"][0].numpy(),
                                              t["s"][1].numpy())
    np.savez(f"{tmp}/rank{rank}.npz", **out)
finally:
    dist.destroy_process_group()
print("PASS", rank)
"""

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.runtime.collectives import tree_allreduce

tmp = sys.argv[1]
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
assert [d.id for d in mesh.devices.reshape(-1)] == list(range(8))
inputs = np.load(f"{tmp}/inputs.npz")
spec = P("pod", "data", "model", None)
out = {}
for name in inputs.files:
    if not name.startswith("x_"):
        continue
    for tag, intra in (("data", ("data",)), ("data_model", ("data", "model"))):
        f = jax.jit(shard_map(
            lambda v: tree_allreduce(v, intra_axes=intra, inter_axis="pod"),
            mesh=mesh, in_specs=spec, out_specs=spec))
        out[f"{name}__{tag}"] = np.asarray(f(inputs[name]))
np.savez(f"{tmp}/jax.npz", **out)
print("PASS")
"""


def _inputs(tmp):
    """The global (2, 2, 2, L) arrays: rank (p, d, m) holds block [p, d,
    m]."""
    rng = np.random.default_rng(20)
    arrays = {}
    for n in LENGTHS:
        arrays[f"x_int_{n}"] = rng.integers(
            -50, 50, MESH + (n,)).astype(np.float32)
        arrays[f"x_normal_{n}"] = rng.standard_normal(
            MESH + (n,)).astype(np.float32)
    for k, shape in (("w", TREE["w"]), ("b", TREE["b"]),
                     ("s0", TREE["s"][0]), ("s1", TREE["s"][1])):
        arrays[f"t_{k}"] = rng.integers(-9, 9, MESH + shape).astype(
            np.float32)
    np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
    return arrays


def _env():
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _wait(procs, deadline):
    """Every process's (rc, output); all are killed at the deadline."""
    out = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=max(1.0,
                                                  deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a process passed the deadline: {p.args}")
        out.append((p.returncode, stdout))
    return out


def test_tree_allreduce_on_8_gloo_ranks_matches_the_flat_sum_and_jax(
        tmp_path):
    """One launch of 8 gloo ranks (file store under ``tmp_path``, no
    ports) beside one JAX process, each under its own deadline."""
    tmp = str(tmp_path)
    arrays = _inputs(tmp)
    kw = dict(env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
              stderr=subprocess.STDOUT, text=True)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, tmp], **kw)]
    procs += [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                                tmp], **kw) for r in range(8)]
    for rc, stdout in _wait(procs, time.time() + 240):
        assert rc == 0 and "PASS" in stdout, stdout
    jx = np.load(os.path.join(tmp, "jax.npz"))
    seen = 0
    for r in range(8):
        got = np.load(os.path.join(tmp, f"rank{r}.npz"))
        coord = tuple(int(c) for c in got["coord"])
        # rank r is mesh coordinate r in row-major order, as JAX device r
        assert np.ravel_multi_index(coord, MESH) == r
        for name in arrays:
            if not name.startswith("x_"):
                continue
            x = arrays[name]
            for tag, intra in INTRA.items():
                axes = (0, 1) if intra == ("data",) else (0, 1, 2)
                want = x.sum(axis=axes, keepdims=True)
                want = np.broadcast_to(want, x.shape)[coord][None, None,
                                                              None]
                y = got[f"{name}__{tag}"]
                j = jx[f"{name}__{tag}"][coord][None, None, None]
                if name.startswith("x_int"):
                    np.testing.assert_array_equal(y, want, err_msg=name)
                    np.testing.assert_array_equal(y, j, err_msg=name)
                else:
                    np.testing.assert_allclose(y, want, rtol=1e-6,
                                               atol=1e-6, err_msg=name)
                    np.testing.assert_allclose(y, j, rtol=1e-6, atol=1e-6,
                                               err_msg=name)
                seen += 1
        for k in ("w", "b", "s0", "s1"):
            t = arrays[f"t_{k}"]
            want = np.broadcast_to(t.sum(axis=(0, 1), keepdims=True),
                                   t.shape)[coord]
            np.testing.assert_array_equal(got[f"flat_{k}"], want)
            np.testing.assert_array_equal(got[f"hier_{k}"], want)
    assert seen == 8 * 2 * 2 * len(LENGTHS)


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo process group (file store under ``tmp_path``) and
    its (1, 1, 1) pod mesh, destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fn", ["tree_allreduce", "flat_psum_grads",
                                "hierarchical_psum_grads"])
@pytest.mark.parametrize("intra", sorted(INTRA))
def test_a_world_of_one_is_the_identity(world_of_one, fn, intra):
    """What phase 14 (c) of ``chip_smoke.py`` holds on the card: a sum over
    one rank returns its input bitwise, in its structure, never written."""
    mesh, axes = world_of_one, INTRA[intra]
    rng = np.random.default_rng(21)
    tree = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dt) for s, dt in (((5, 7), torch.float32),
                                  ((256,), torch.bfloat16),
                                  ((3,), torch.float32))]
    before = [t.clone() for t in tree]
    if fn == "tree_allreduce":
        out = [col.tree_allreduce(t, mesh, intra_axes=axes, inter_axis="pod")
               for t in tree]
    elif fn == "flat_psum_grads":
        out = col.flat_psum_grads(tree, mesh, ("pod",) + axes)
    else:
        out = col.hierarchical_psum_grads(tree, mesh, intra_axes=axes)
    assert isinstance(out, list) and len(out) == len(tree)
    for a, b, c in zip(out, tree, before):
        assert a.dtype == b.dtype and torch.equal(a, b) and a is not b
        assert torch.equal(b, c)


@pytest.mark.parametrize("axes,want", [
    (("data", "model"), [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (("model", "data"), [[0, 2, 1, 3], [4, 6, 5, 7]]),
    (("pod", "data"), [[0, 2, 4, 6], [1, 3, 5, 7]]),
    (("pod", "data", "model"), [list(range(8))]),
])
def test_groups_of_several_axes_follow_the_listed_order(axes, want):
    """A group over several axes lists its ranks by the axes as given, so
    its reduce-scatter hands out the shards a ``psum_scatter`` over that
    tuple would (rank r at mesh coordinate r in row-major order)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=8)
    try:
        mesh = init_device_mesh("cpu", MESH,
                                mesh_dim_names=("pod", "data", "model"))
        assert col._group_ranks(mesh, axes) == want
    finally:
        dist.destroy_process_group()
