"""The port's shape cells, meshes and sharding rules against the JAX
package: ``launch/shapes`` on every cell; every spec of every leaf of the
10 full configs (parameters, ZeRO-1 optimizer state, a train batch, decode
states) on mesh descriptions of (16, 16) and (2, 16, 16), as data; every
rank's shard of each smoke config's leaves on a (2, 2, 2) mesh of a fake
world of 8 against ``NamedSharding.devices_indices_map`` of one JAX
process with 8 host devices; and the placements on a one-rank gloo mesh,
bitwise through ``full_tensor``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch import sharding as tshd  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


class FakeMesh:
    """A mesh description with no devices, as ``tests/test_sharding.py``
    has it."""

    def __init__(self, data=16, model=16, pod=None):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")
        if pod:
            self.shape = {"pod": pod, **self.shape}
            self.axis_names = ("pod",) + self.axis_names


MESHES = {"16x16": FakeMesh(), "2x16x16": FakeMesh(pod=2)}
#: decode states of the (2, 2, 2) shard test: a batch that shards over the
#: data axes and one that cannot (the sequence dim takes them)
SMOKE_DECODE = {"decode_b8": (8, 64), "decode_b1": (1, 64)}


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree


def _jax_specs(inp, out):
    """``{path: tuple(PartitionSpec)}`` of a JAX sharding tree (its
    ``NamedSharding`` replaced by its spec) at the input's leaf paths."""
    return {p: tuple(_at(out, p)) for p, _ in jshd._flatten_paths(inp)}


def _port_specs(inp, out):
    return {p: _at(out, p) for p, _ in tshd._flatten_paths(inp)}


@pytest.fixture
def specs_only(monkeypatch):
    """The JAX ``*_shardings`` on a mesh description: ``NamedSharding``
    needs devices, so the test keeps the spec it would wrap."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


# ---------------------------------------------------------------------------
# shape cells
# ---------------------------------------------------------------------------

def test_shape_cells_are_the_jax_cells():
    assert list(tshapes.all_cells()) == list(jshapes.all_cells())
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, cell in jshapes.SHAPES.items():
        assert tshapes.SHAPES[name] == tshapes.ShapeCell(
            cell.name, cell.kind, cell.seq, cell.global_batch)


@pytest.mark.parametrize("arch,shape", list(jshapes.all_cells()))
def test_supported_matches_jax(arch, shape):
    assert tshapes.supported(tcb.get(arch), shape) == \
        jshapes.supported(jcb.get(arch), shape)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [FakeMesh(), FakeMesh(pod=2),
                                  FakeMesh(4, 2), FakeMesh(1, 1, pod=2)])
def test_mesh_helpers_match_jax_on_descriptions(mesh):
    assert tmesh.dp_axes(mesh) == jmesh.dp_axes(mesh)
    assert tmesh.tp_size(mesh) == jmesh.tp_size(mesh)
    assert tmesh.dp_size(mesh) == jmesh.dp_size(mesh)


@pytest.fixture
def fake_world():
    """``fake_world(rank, size)``: a fake process group (no transport),
    destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank, size):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=size)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default goes there")
@pytest.mark.parametrize("make", ["production", "production_multi_pod",
                                  "test", "test_multi_pod"])
def test_meshes_raise_without_a_device(make, fake_world):
    """No device and no ``device="cpu"`` is an error, never a CPU mesh."""
    fake_world(0, 1)
    fn = {"production": lambda: tmesh.make_production_mesh(),
          "production_multi_pod":
              lambda: tmesh.make_production_mesh(multi_pod=True),
          "test": lambda: tmesh.make_test_mesh(1, 1),
          "test_multi_pod": lambda: tmesh.make_test_mesh(1, 1,
                                                         multi_pod=True)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn[make]()


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_a_production_mesh_names_the_world_it_needs(multi_pod, need,
                                                    fake_world):
    with pytest.raises(RuntimeError, match="none is initialized"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    fake_world(0, 1)
    with pytest.raises(RuntimeError, match=f"needs {need} ranks; the "
                       "process group has 1"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    # the multi-pod test mesh has two pods: a world of one cannot hold it
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        tmesh.make_test_mesh(1, 1, multi_pod=True, device="cpu")


def test_a_test_mesh_of_a_fake_world_reads_as_the_jax_one(fake_world):
    fake_world(3, 8)
    mesh = tmesh.make_test_mesh(2, 2, multi_pod=True, device="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert tuple(mesh.shape) == (2, 2, 2) and mesh.device_type == "cpu"
    assert tmesh.axis_sizes(mesh) == {"pod": 2, "data": 2, "model": 2}
    assert (tmesh.dp_axes(mesh), tmesh.tp_size(mesh), tmesh.dp_size(mesh)) \
        == (("pod", "data"), 2, 4)
    fake_world(0, 1)
    one = tmesh.make_test_mesh(1, 1, device="cpu")
    assert (tmesh.dp_axes(one), tmesh.tp_size(one), tmesh.dp_size(one)) == \
        (("data",), 1, 1)


# ---------------------------------------------------------------------------
# specs of the full configs, as data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_every_spec_of_the_full_configs_matches_jax(arch, mesh_name,
                                                    specs_only):
    mesh = MESHES[mesh_name]
    jc, tc = jcb.get(arch), tcb.get(arch)
    jp, jo = jsteps.init_shapes(jc)
    tp, to = tsteps.init_shapes(tc)
    # parameters
    want = _jax_specs(jp, jshd.param_shardings(jp, jc, mesh))
    got = _port_specs(tp, tshd.param_shardings(tp, tc, mesh))
    assert got == want
    assert all(isinstance(s, tuple) for s in got.values())
    assert tshd.count_params(tp) == jshd.count_params(jp) == \
        sum(t.numel() for t in ttfm.tree_leaves(tp))
    # ZeRO-1 optimizer state
    jos = jshd.opt_shardings(jo, jp, jc, mesh)
    tos = tshd.opt_shardings(to, tp, tc, mesh)
    assert type(tos).__name__ == "AdamWState" and tos.step == tuple(jos.step)
    for f in ("m", "v"):
        assert _port_specs(getattr(to, f), getattr(tos, f)) == \
            _jax_specs(getattr(jo, f), getattr(jos, f))
    # a train batch (train_4k)
    cell = jshapes.SHAPES["train_4k"]
    jb = jpipe.batch_specs(jc, cell.global_batch, cell.seq)
    tb = tpipe.batch_specs(tc, cell.global_batch, cell.seq)
    assert tshd.batch_shardings(tb, mesh) == {
        k: tuple(v) for k, v in jshd.batch_shardings(jb, mesh).items()}
    # decode states where the cell is supported
    n_decode = 0
    for shape in ("decode_32k", "long_500k"):
        if not jshapes.supported(jc, shape)[0]:
            continue
        cell = jshapes.SHAPES[shape]
        js = jax.eval_shape(lambda: jtfm.init_decode_state(
            jc, cell.global_batch, cell.seq))
        ts = ttfm.init_decode_state(tc, cell.global_batch, cell.seq,
                                    device="meta")
        got = _port_specs(ts, tshd.decode_state_shardings(ts, tc, mesh))
        assert got == _jax_specs(js, jshd.decode_state_shardings(js, jc,
                                                                 mesh))
        # DecodeState.length flattens as ("1",), never "length"
        assert got[("1",)] == (None,)
        n_decode += 1
    assert n_decode == (0 if jc.encoder_only else
                        2 if jc.subquadratic else 1)


def test_the_folded_sequence_spec_lists_its_axes_in_mesh_order(specs_only):
    """long_500k's batch of 1 cannot shard, so the KV cache's sequence dim
    takes the data axes and "model" (the multi-axis spec of the rules)."""
    tc = tcb.get("hymba_1_5b")
    cell = tshapes.SHAPES["long_500k"]
    ts = ttfm.init_decode_state(tc, cell.global_batch, cell.seq,
                                device="meta")
    spec = tshd.decode_state_shardings(ts, tc, MESHES["2x16x16"])
    assert spec.caches[0]["k"][3] == ("pod", "data", "model")
    assert spec.caches[0]["k_scale"] == (None, None, None,
                                         ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# every rank's shard on (2, 2, 2) against devices_indices_map
# ---------------------------------------------------------------------------

JAX_INDICES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import base as cb
from repro.launch import sharding as shd, steps
from repro.models import transformer as tfm

decode = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
assert [d.id for d in mesh.devices.reshape(-1)] == list(range(8))


def at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree


def indices(tree, shardings):
    out = {}
    for path, v in shd._flatten_paths(tree):
        shape = tuple(v.shape)
        m = at(shardings, path).devices_indices_map(shape)
        out["/".join(path)] = {
            str(d.id): [[s.start or 0, n if s.stop is None else s.stop]
                        for s, n in zip(idx, shape)]
            for d, idx in m.items()}
    return out


result = {}
for arch in cb.ARCH_IDS:
    cfg = cb.smoke_config(arch)
    p, o = steps.init_shapes(cfg)
    r = {"params": indices(p, shd.param_shardings(p, cfg, mesh))}
    os_ = shd.opt_shardings(o, p, cfg, mesh)
    r["m"], r["v"] = indices(o.m, os_.m), indices(o.v, os_.v)
    if not cfg.encoder_only:
        for name, (b, s) in decode.items():
            st = jax.eval_shape(lambda: tfm.init_decode_state(cfg, b, s))
            r[name] = indices(st, shd.decode_state_shardings(st, cfg, mesh))
    result[arch] = r
print(json.dumps(result))
"""


@pytest.fixture(scope="module")
def jax_indices():
    """Each smoke config's leaves' device index maps on (2, 2, 2), from one
    JAX process with 8 host devices (device i at mesh coordinate i)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_INDICES, json.dumps(SMOKE_DECODE)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_every_rank_holds_the_jax_shard_on_2x2x2(arch, jax_indices,
                                                 fake_world):
    """DTensor's local shape and offset under :func:`placements` of the
    port's spec, rank by rank of a fake world of 8, equal the JAX
    package's index map of its spec for the same device: the nested
    shards of a multi-axis spec split major to minor as JAX does."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_of

    cfg = tcb.smoke_config(arch)
    p, o = tsteps.init_shapes(cfg)
    trees = {"params": p, "m": o.m, "v": o.v}
    if not cfg.encoder_only:
        for name, (b, s) in SMOKE_DECODE.items():
            trees[name] = ttfm.init_decode_state(cfg, b, s, device="meta")
    want = jax_indices[arch]
    assert set(want) == set(trees)
    n_multi = 0
    for rank in range(8):
        fake_world(rank, 8)
        mesh = tmesh.make_test_mesh(2, 2, multi_pod=True, device="cpu")
        specs = {"params": tshd.param_shardings(p, cfg, mesh)}
        opt = tshd.opt_shardings(o, p, cfg, mesh)
        specs["m"], specs["v"] = opt.m, opt.v
        for name in SMOKE_DECODE:
            if name in trees:
                specs[name] = tshd.decode_state_shardings(trees[name], cfg,
                                                          mesh)
        for kind, tree in trees.items():
            leaves = tshd._flatten_paths(tree)
            assert {"/".join(q) for q, _ in leaves} == set(want[kind])
            for path, v in leaves:
                spec = _at(specs[kind], path)
                shape = tuple(v.shape)
                lshape, offset = local_of(shape, mesh,
                                          tshd.placements(spec, mesh))
                got = [[o_, o_ + n] for o_, n in zip(offset, lshape)]
                assert got == want[kind]["/".join(path)][str(rank)], \
                    (kind, path, spec, rank)
                n_multi += any(isinstance(e, tuple) for e in spec)
    if not cfg.encoder_only:
        assert n_multi > 0      # decode_b1's caches fold (pod, data, model)


def test_placements_nest_in_mesh_order_and_refuse_any_other(fake_world):
    from torch.distributed.tensor import Replicate, Shard

    fake_world(0, 8)
    mesh = tmesh.make_test_mesh(2, 2, multi_pod=True, device="cpu")
    assert tshd.placements((None, ("pod", "data"), "model"), mesh) == \
        (Shard(1), Shard(1), Shard(2))
    assert tshd.placements((), mesh) == (Replicate(),) * 3
    assert tshd.placements(("data",), mesh) == (Replicate(), Shard(0),
                                                Replicate())
    with pytest.raises(ValueError, match="not in the mesh's order"):
        tshd.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        tshd.placements(("model", "model"), mesh)


def test_specs_normalise_as_partition_spec_does():
    for entries in [(("data",), None), ((), "model"),
                    (("pod", "data"), None, ("data", "model"))]:
        assert tshd._spec(*entries) == tuple(P(*entries))


# ---------------------------------------------------------------------------
# DTensors on a one-rank mesh: what phase 14 (d) of chip_smoke.py holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2_2b", "moonshot_v1_16b_a3b"])
def test_distributed_smoke_state_is_bitwise_on_one_rank(arch, tmp_path):
    cfg = tcb.smoke_config(arch)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    for leaf in ttfm.tree_leaves(opt.m):
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_test_mesh(1, 1, device="cpu")
        p_specs = tshd.param_shardings(params, cfg, mesh)
        o_specs = tshd.opt_shardings(opt, params, cfg, mesh)
        n_shard = 0
        for tree, specs in ((params, p_specs), (opt.m, o_specs.m),
                            (opt.v, o_specs.v)):
            dt = tshd.distribute_tree(tree, specs, mesh)
            for (path, leaf), (_, d) in zip(tshd._flatten_paths(tree),
                                            tshd._flatten_paths(dt)):
                assert d.placements == tshd.placements(_at(specs, path),
                                                       mesh)
                assert torch.equal(d.full_tensor(), leaf), path
                n_shard += any(pl.is_shard() for pl in d.placements)
        # a one-wide "model" axis divides every dim: the rules shard
        assert n_shard > 0
        assert tshd.count_params(params) == sum(
            t.numel() for t in ttfm.tree_leaves(params))
    finally:
        dist.destroy_process_group()
