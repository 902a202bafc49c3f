"""FSDP's per-layer gathers over ``"data"`` in the mesh-bound steps
(``repro_torch.launch.steps`` with each rank's ``"data"`` pieces of the
leaves a ``cfg.fsdp`` config's rules split there, gathered one layer at a
time by ``repro_torch.models.layers.fsdp_gather`` through
``repro_torch.models.tensor_parallel.gather_over``) and the repair of
fault F6 (a train microbatch whose rows the data shards do not divide),
against the JAX package on the CPU.

The multi-rank checks share one launch: 8 gloo ranks as the (2, 2, 2)
``("pod", "data", "model")`` mesh (``OMP_NUM_THREADS=1``, a ``file://``
store) beside one JAX process with 8 host devices on a (2, 2, 2) mesh of
``AxisType.Auto`` axes.  It runs once for the whole test run, whichever
test process asks first (a file lock under the run's shared temporary
directory), and its results are read by several tests.  The JAX weights
(``PRNGKey(0)``) are made once here and carried to both packages.

FSDP: ``dataclasses.replace(smoke_config(a), fsdp=True)`` in both
packages for nemotron_4_340b (dense, squared-ReLU MLP, untied head) and
llama4_maverick_400b_a17b (MoE every second layer, a shared expert): 3
train steps each with 1 and with 2 microbatches of a batch of 8 x 16,
then ``serve.generate_on_mesh``'s prefill and 4 greedy decode steps.
F6: smoke gemma2_2b and moonshot_v1_16b_a3b train 3 steps on a batch of 4
in 2 microbatches (2 rows a microbatch, 4 data shards).  The AdamW
moments are float32 in both packages (``adamw_init``'s default).

Tolerances: ``TOL`` = 1e-5 for float32 sums taken in another order (of
the largest magnitude, per loss and AdamW moment; the parameters are held
through the moments, as ``tests/test_torch_tensor_parallel.py`` says
why); greedy ids, routing tables and counters equal; prefill logits
within 2e-4.
"""

import dataclasses
import fcntl
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")

from repro.configs import base as j_cb  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.launch import dryrun as t_dry  # noqa: E402
from repro_torch.launch.hlo_analysis import HloCost  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import sharding as t_shd  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import tensor_parallel as t_tpo  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import collectives as t_col  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5
LOGIT_TOL = 2e-4
FSDP_ARCHS = ("nemotron_4_340b", "llama4_maverick_400b_a17b")
MOE = "llama4_maverick_400b_a17b"
F6_ARCHS = ("gemma2_2b", "moonshot_v1_16b_a3b")
#: the FSDP train batch: 8 rows of 16, so 2 microbatches give each of the
#: 4 data shards one row; warmup is 2 of 20 steps
TRAIN = dict(B=8, S=16, steps=3, total=20)
#: F6: 4 rows in 2 microbatches, 2 rows a microbatch on 4 data shards
F6 = dict(B=4, S=16, mb=2, steps=3, total=20)
#: 4 lanes (one a data shard), a 16-token prompt, the prefill's token and
#: 4 greedy decode steps'
SERVE = dict(B=4, S=16, gen=5)
DEADLINE_S = 240


@pytest.fixture(autouse=True)
def _no_hints_leak():
    t_layers.clear_axis_hints()
    yield
    t_layers.clear_axis_hints()


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def jax_weights(arch):
    """The JAX package's smoke weights of ``arch`` (``PRNGKey(0)``;
    ``fsdp`` changes no shape); gemma2's embeddings scaled down as
    ``tests/test_torch_sharded_step.py`` scales them."""
    p = j_tfm.init_params(j_cb.smoke_config(arch), jax.random.PRNGKey(0))
    if arch == "gemma2_2b":
        p = dict(p, embed=p["embed"] * 0.02)
    return p


# ---------------------------------------------------------------------------
# the launch: 8 gloo ranks beside one JAX process, once per test run
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import base as cb
from repro_torch.core import balance
from repro_torch.data.pipeline import batch_for
from repro_torch.launch import serve, sharding as shd, steps
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import tensor_parallel as tpo
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init

rank, tmp = int(sys.argv[1]), sys.argv[2]
TR, F6, SV, FSDP_ARCHS, F6_ARCHS = (json.loads(a) for a in sys.argv[3:8])
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=8)


def config(arch, fsdp):
    return dataclasses.replace(cb.smoke_config(arch), fsdp=fsdp)


def weights(arch):
    w = np.load(f"{tmp}/weights_{arch}.npz")
    like = tfm.init_params(cb.smoke_config(arch), None, "meta")
    return tfm.tree_unflatten(like, [torch.from_numpy(w[".".join(path)])
                                     for path, _ in tfm.tree_items(like)])


def full(tree):
    return {".".join(p): v.full_tensor().numpy()
            for p, v in tfm.tree_items(tree)}


# the collectives of FSDP's gathers: every gather and reduce-scatter of
# the model's region operations, over which axis and of what shape
calls, counting = [], [False]
gather0, scatter0 = tpo._gather, tpo._scatter_sum


def gather(x, group, size, dim):
    out = gather0(x, group, size, dim)
    if counting[0]:
        calls.append(("gather", axis_of(group), tuple(out.shape)))
    return out


def scatter_sum(g, group, size, dim):
    out = scatter0(g, group, size, dim)
    if counting[0]:
        calls.append(("scatter", axis_of(group), tuple(g.shape)))
    return out


tpo._gather, tpo._scatter_sum = gather, scatter_sum
# every DTensor redistributed from a "data" split to a layout without
# one: (its shape, the split dim)
whole_gathers, redistribute0 = [], DTensor.redistribute


def redistribute(self, *a, **kw):
    names = self.device_mesh.mesh_dim_names
    before = self.placements[names.index("data")]
    out = redistribute0(self, *a, **kw)
    if before.is_shard() and not out.placements[
            names.index("data")].is_shard():
        whole_gathers.append((tuple(self.shape), before.dim))
    return out


DTensor.redistribute = redistribute
tables, route0 = [], balance.route


def route(*a, **kw):
    r = route0(*a, **kw)
    tables.append(torch.stack([r.expert, r.pos]).numpy())
    return r


balance.route = route


def train(arch, cfg, B, mb, n_steps, total, out, tag, count=False):
    params = weights(arch)
    p, o = steps.shard_train_state(cfg, mesh, params, adamw_init(params))
    step = steps.make_train_step(cfg, mesh, microbatches=mb,
                                 total_steps=total)
    fsdp = {(tuple(leaf.shape), shd.fsdp_dim(leaf))
            for leaf in tfm.tree_leaves(p) if shd.fsdp_dim(leaf) is not None}
    for i in range(n_steps):
        counting[0] = count and i == 0
        del whole_gathers[:]
        p, o, m = step(p, o, batch_for(cfg, i, B, TR["S"]), i)
        counting[0] = False
        if count and i == 0:
            # the ZeRO write-backs of the other leaves, and those of FSDP's
            out[f"{tag}/whole_gathers"] = np.asarray(
                [len(whole_gathers),
                 sum(g in fsdp for g in whole_gathers)])
        for k, v in m.items():
            out[f"{tag}/{i}/{k}"] = np.asarray(float(v))
        for part in ("m", "v"):
            for k, v in full(getattr(o, part)).items():
                out[f"{tag}/{i}/{part}/{k}"] = v
    for k, v in full(p).items():
        out[f"{tag}/param/{k}"] = v
    return p


out = {}
try:
    mesh = make_test_mesh(2, 2, multi_pod=True, device="cpu")
    groups = {a: mesh.get_group(a) for a in ("pod", "data", "model")}

    def axis_of(group):
        return next(a for a, g in groups.items() if g is group)

    for arch in FSDP_ARCHS:
        cfg = config(arch, True)
        for mb in (1, 2):
            p = train(arch, cfg, TR["B"], mb, TR["steps"], TR["total"], out,
                      f"{arch}/train{mb}", count=mb == 1)
            if mb == 1:
                out[f"{arch}/calls"] = np.asarray(
                    [json.dumps(c) for c in calls])
                del calls[:]
        # each leaf: its local and whole elements, its FSDP dim (-1: none),
        # whether "model" splits it, its stacked layers (0: not stacked)
        # and the shape of one layer of it as the model gathers it
        for path, leaf in tfm.tree_items(p):
            name = ".".join(path)
            d = shd.fsdp_dim(leaf)
            local = tuple(leaf.to_local().shape)
            stacked = path[0] == "streams"
            layer = list(local[1:] if stacked else local)
            if d is not None:
                layer[d - stacked] *= mesh.shape[1]
            out[f"{arch}/leaf/{name}"] = np.asarray(
                [leaf.to_local().numel(), leaf.numel(),
                 -1 if d is None else d, int(shd.is_model_split(leaf)),
                 local[0] if stacked else 0] + layer)
        # the prefill and 4 greedy decode steps, the weights as DTensors;
        # then the same weights without FSDP (llama4's routing tables and
        # the prefill logits bitwise)
        for fsdp in (True, False):
            c = config(arch, fsdp)
            params = weights(arch)
            p = shd.distribute_tree(params, shd.param_shardings(
                params, c, mesh), mesh)
            batch = {k: torch.as_tensor(v) for k, v in
                     batch_for(c, 0, SV["B"], SV["S"]).items()}
            del tables[:]
            counting[0] = fsdp
            g = serve.generate_on_mesh(p, c, batch, SV["gen"], mesh)
            counting[0] = False
            tag = f"{arch}/serve" + ("" if fsdp else "_unsplit")
            out[f"{tag}/ids"] = g.ids.numpy()
            out[f"{tag}/logits"] = g.prefill_logits.numpy()
            out[f"{tag}/tables"] = np.asarray(len(tables))
            for i, t in enumerate(tables):
                out[f"{tag}/table{i}"] = t
            if fsdp:
                out[f"{arch}/serve_calls"] = np.asarray(
                    [json.dumps(c) for c in calls])
                del calls[:]
    # the gather and its reduce-scatter in blocks: bitwise the one-call
    # results on every dim, over "data" and over "model"
    gen = torch.Generator().manual_seed(rank)
    x = torch.randn((6, 5, 4), generator=gen)
    blocked = []
    for axis in ("data", "model"):
        for dim in range(3):
            one = tpo._gather(x, groups[axis], 2, dim)
            summed = tpo._scatter_sum(one, groups[axis], 2, dim)
            tpo.BLOCK_BYTES, keep = 40, tpo.BLOCK_BYTES
            try:
                blocked.append(torch.equal(one, tpo._gather(
                    x, groups[axis], 2, dim)) and torch.equal(
                    summed, tpo._scatter_sum(one, groups[axis], 2, dim)))
            finally:
                tpo.BLOCK_BYTES = keep
    out["blocked"] = np.asarray(blocked)
    # F6: microbatches of 2 rows on 4 data shards
    for arch in F6_ARCHS:
        train(arch, cb.smoke_config(arch), F6["B"], F6["mb"], F6["steps"],
              F6["total"], out, f"f6/{arch}")
    # a divisible batch (8 rows in 2 microbatches): the steps bitwise those
    # of a copy of the step before F6's repair
    def unrepaired_train_step(cfg, mesh, microbatches, total_steps):
        from repro_torch.core import prng
        from repro_torch.optim import (AdamWState, adamw_update,
                                       cosine_schedule)
        from torch.distributed.tensor import Replicate

        dp, tp = steps.dp_size(mesh), steps.tp_size(mesh)
        tpc = shd.tp_compute(cfg)
        warmup = max(1, min(2000, total_steps // 10))

        def source(leaf):
            return tuple(p if name == "model" else Replicate() for name, p
                         in zip(mesh.mesh_dim_names, leaf.placements))

        def train_step(params, opt_state, batch, step):
            with steps._hints(mesh, tp=tpc):
                dleaves = tfm.tree_leaves(params)
                device = dleaves[0].device
                leaves = [p.detach().requires_grad_(True)
                          for p in tfm.tree_leaves(steps._pieces(params,
                                                                 cfg))]
                tree = tfm.tree_unflatten(params, leaves)
                rng = prng.fold_in(prng.PRNGKey(17), int(step))
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in batch.items()}
                mbs = [{k: steps._rows(v, mesh, device)
                        for k, v in mb.items()}
                       for mb in steps._split(batch, microbatches)]

                def value_and_grad(mb):
                    loss, metrics = tfm.loss_fn(tree, cfg, mb, rng,
                                                ep_groups=tp, dp_groups=dp)
                    share = metrics["ce"] * (1.0 / dp) \
                        + 0.01 * metrics["lb_loss"]
                    grads = steps._grads(share, leaves)
                    metrics = {k: v.detach() for k, v in metrics.items()}
                    total = steps._sum_over_data([torch.stack([
                        share.detach(), metrics["ce"] * (1.0 / dp),
                        metrics["lb_loss"]])], mesh)[0]
                    metrics.update(ce=total[1], lb_loss=total[2])
                    return total[0], metrics, grads

                loss, metrics, local = steps._accumulate(
                    value_and_grad, leaves, mbs, device)
                grads = steps._sum_over_data(local, mesh)
                lr = cosine_schedule(step, total=total_steps,
                                     warmup=warmup).to(device)
                with torch.no_grad():
                    gnorm = steps._grad_norm(grads, dleaves, mesh, cfg)
                    ms = tfm.tree_leaves(opt_state.m)
                    vs = tfm.tree_leaves(opt_state.v)
                    pieces = [steps._placed(p.detach(), mesh, source(d),
                                            m.placements)
                              for p, d, m in zip(leaves, dleaves, ms)]
                    g_pieces = [steps._placed(g, mesh, source(d),
                                              m.placements)
                                for g, d, m in zip(grads, dleaves, ms)]
                    local_state = AdamWState(opt_state.step.to_local(),
                                             [m.to_local() for m in ms],
                                             [v.to_local() for v in vs])
                    _, new_state, opt_metrics = adamw_update(
                        g_pieces, local_state, pieces, lr=lr,
                        grad_norm=gnorm)
                    for p, piece, m in zip(dleaves, pieces, ms):
                        p.to_local().copy_(DTensor.from_local(
                            piece, mesh, m.placements, run_check=False
                        ).redistribute(mesh, p.placements).to_local())
                    step_t = DTensor.from_local(
                        new_state.step, mesh, opt_state.step.placements,
                        run_check=False)
            metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
            return params, AdamWState(step_t, opt_state.m, opt_state.v), \
                metrics

        return train_step

    for arch in F6_ARCHS:
        cfg = cb.smoke_config(arch)
        runs = []
        for make in (steps.make_train_step, unrepaired_train_step):
            params = weights(arch)
            p, o = steps.shard_train_state(cfg, mesh, params,
                                           adamw_init(params))
            step = make(cfg, mesh, microbatches=2, total_steps=TR["total"]) \
                if make is steps.make_train_step else make(cfg, mesh, 2,
                                                           TR["total"])
            got = []
            for i in range(TR["steps"]):
                p, o, m = step(p, o, batch_for(cfg, i, TR["B"], TR["S"]), i)
                got += [m[k].reshape(1) for k in sorted(m)]
            runs.append(got + [d.to_local() for d in tfm.tree_leaves(p)]
                        + [d.to_local() for d in tfm.tree_leaves(o.m)]
                        + [d.to_local() for d in tfm.tree_leaves(o.v)])
        out[f"divisible/{arch}"] = np.asarray(len(runs[0]) == len(runs[1])
                                              and all(
            a.dtype == b.dtype and torch.equal(
                a.view(torch.int32) if a.is_floating_point() else a,
                b.view(torch.int32) if b.is_floating_point() else b)
            for a, b in zip(*runs)))
    # a global batch the data axes do not divide stays refused
    cfg = cb.smoke_config(F6_ARCHS[0])
    params = weights(F6_ARCHS[0])
    p, o = steps.shard_train_state(cfg, mesh, params, adamw_init(params))
    try:
        steps.make_train_step(cfg, mesh, microbatches=1)(
            p, o, batch_for(cfg, 0, 6, TR["S"]), 0)
        out["refused"] = np.asarray("")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    np.savez(f"{tmp}/rank{rank}.npz", **out)
finally:
    dist.destroy_process_group()
print("PASS", rank)
"""

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs import base as cb
from repro.data.pipeline import batch_for
from repro.launch import steps
from repro.models import layers, transformer as tfm
from repro.optim import adamw_init

tmp = sys.argv[1]
TR, F6, SV, FSDP_ARCHS, F6_ARCHS = (json.loads(a) for a in sys.argv[2:7])
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
assert [d.id for d in mesh.devices.reshape(-1)] == list(range(8))


def key(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def weights(arch):
    w = np.load(f"{tmp}/weights_{arch}.npz")
    ref = tfm.init_params(cb.smoke_config(arch), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(w[key(path)]), ref)


def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{prefix}/{key(path)}"] = np.asarray(leaf)


def train(arch, cfg, B, mb, n_steps, total, out, tag):
    try:
        _, jit_for, (_, _, p_shard, o_shard) = steps.make_train_step(
            cfg, mesh, microbatches=mb, total_steps=total, donate=False)
        batches = [batch_for(cfg, i, B, TR["S"]) for i in range(n_steps)]
        jstep = jit_for(jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batches[0]))
        p = jax.device_put(weights(arch), p_shard)
        o = jax.device_put(adamw_init(p), o_shard)
        for i, b in enumerate(batches):
            p, o, m = jstep(p, o, b, jnp.int32(i))
            for k, v in m.items():
                out[f"{tag}/{i}/{k}"] = np.asarray(v)
            flat(f"{tag}/{i}/m", o.m, out)
            flat(f"{tag}/{i}/v", o.v, out)
        flat(f"{tag}/param", p, out)
    finally:
        layers.clear_axis_hints()


out = {}
with jax.set_mesh(mesh):
    for arch in FSDP_ARCHS:
        cfg = dataclasses.replace(cb.smoke_config(arch), fsdp=True)
        for mb in (1, 2):
            train(arch, cfg, TR["B"], mb, TR["steps"], TR["total"], out,
                  f"{arch}/train{mb}")
        try:
            max_len = SV["S"] + SV["gen"]
            batch = {k: jnp.asarray(v) for k, v in
                     batch_for(cfg, 0, SV["B"], SV["S"]).items()}
            _, pf_for, _ = steps.make_prefill_step(cfg, mesh, max_len)
            pf = pf_for(jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch))
            _, serve_step, _ = steps.make_serve_step(cfg, mesh, SV["B"],
                                                     max_len)
            p = weights(arch)
            logits, state = pf(p, batch)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            ids = [np.asarray(tok)]
            for _ in range(SV["gen"] - 1):
                tok, state = serve_step(p, state, tok)
                ids.append(np.asarray(tok))
            out[f"{arch}/serve/ids"] = np.stack(ids, axis=1)
            out[f"{arch}/serve/logits"] = np.asarray(logits, np.float32)
        finally:
            layers.clear_axis_hints()
    for arch in F6_ARCHS:
        train(arch, cb.smoke_config(arch), F6["B"], F6["mb"], F6["steps"],
              F6["total"], out, f"f6/{arch}")
np.savez(f"{tmp}/jax.npz", **out)
print("PASS")
"""


def _wait(procs, deadline):
    """Every process's (rc, output), or a RuntimeError at the deadline."""
    out = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=max(1.0,
                                                  deadline - time.time()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a process passed the deadline: {p.args}")
        out.append((p.returncode, stdout))
    return out


def _launch(tmp: str) -> dict:
    for arch in FSDP_ARCHS + F6_ARCHS:
        np.savez(os.path.join(tmp, f"weights_{arch}.npz"),
                 **jax_paths(jax_weights(arch)))
    args = [json.dumps(a) for a in (TRAIN, F6, SERVE, FSDP_ARCHS, F6_ARCHS)]
    kw = dict(cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
              text=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    t0 = time.time()
    groups = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, tmp] + args, env=env, **kw)]}
    groups["ranks"] = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), tmp] + args, env=env,
        **kw) for r in range(8)]
    result = {}
    try:
        for name in ("ranks", "jax"):
            for rc, stdout in _wait(groups[name], t0 + DEADLINE_S):
                if rc != 0 or "PASS" not in stdout:
                    return {"error": f"{name}: rc {rc}\n{stdout[-6000:]}"}
            result[f"{name}_s"] = time.time() - t0
    finally:
        for p in groups["jax"] + groups["ranks"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return result


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launch's directory (``jax.npz``, ``rank<r>.npz``), made by
    whichever test process of this run asks first."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"fsdp_{uid}" if uid else base / "fsdp"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = root / "done.json"
            if not done.exists():
                try:
                    res = _launch(str(root))
                except Exception as e:   # every test reports it
                    res = {"error": repr(e)}
                done.write_text(json.dumps(res))
            res = json.loads(done.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if "error" in res:
        pytest.fail(res["error"])
    return root


def _ranks(root) -> list:
    return [np.load(root / f"rank{r}.npz") for r in range(8)]


METRICS = ("loss", "lr", "grad_norm", "ce", "lb_loss", "ntasks_static",
           "ntasks_stolen_local", "ntasks_stolen_remote", "ntasks_dropped",
           "max_load")
COUNTERS = METRICS[5:]


def through_the_moments(p0, moments, lrs):
    """The parameters AdamW (``b1`` 0.9, ``b2`` 0.95, ``eps`` 1e-8,
    weight decay 0.1) makes of ``p0`` in float64 from each step's moments
    after it, ``moments`` ``[(m, v), ...]``, and learning rates ``lrs``."""
    p = np.asarray(p0, np.float64)
    for i, ((m, v), lr) in enumerate(zip(moments, lrs)):
        mhat = np.asarray(m, np.float64) / (1 - 0.9 ** (i + 1))
        vhat = np.asarray(v, np.float64) / (1 - 0.95 ** (i + 1))
        p = p - lr * (mhat / (np.sqrt(vhat) + 1e-8) + 0.1 * p)
    return p


def _held(jx, ranks, tag, arch, n_steps):
    """A run's metrics at every step (losses, ``lr``, ``grad_norm``,
    ``ce``, ``lb_loss`` within ``TOL``, counters equal, every rank alike),
    every AdamW moment within ``TOL`` after every step, and every
    parameter within ``TOL`` of AdamW of the run's own moments, in both
    packages."""
    for i in range(n_steps):
        for k in METRICS:
            want = float(jx[f"{tag}/{i}/{k}"])
            got = [float(r[f"{tag}/{i}/{k}"]) for r in ranks]
            assert len(set(got)) == 1, (i, k, got)
            if k in COUNTERS:
                assert got[0] == want, (i, k, got[0], want)
            else:
                assert got[0] == pytest.approx(want, rel=TOL, abs=1e-12), \
                    (i, k, got[0], want)
    p0 = jax_paths(jax_weights(arch))
    assert len(p0) > 10
    lrs = [float(jx[f"{tag}/{i}/lr"]) for i in range(n_steps)]
    assert lrs[0] == 0.0 and all(lr > 0 for lr in lrs[1:])
    for name in p0:
        for i in range(n_steps):
            for part in ("m", "v"):
                key = f"{tag}/{i}/{part}/{name}"
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[key], ranks[0][key])
                assert rel(ranks[0][key], jx[key]) <= TOL, key
        for got in (ranks[0], jx):
            want = through_the_moments(p0[name], [
                (got[f"{tag}/{i}/m/{name}"], got[f"{tag}/{i}/v/{name}"])
                for i in range(n_steps)], lrs)
            assert rel(got[f"{tag}/param/{name}"], want) <= TOL, name


@pytest.mark.parametrize("mb", (1, 2))
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_train_steps_on_a_2x2x2_mesh_match_jax(launched, arch, mb):
    """3 FSDP train steps on the (2, 2, 2) mesh, each rank holding its
    ``"data"`` and ``"model"`` pieces: the JAX step's metrics, moments and
    (through the moments) parameters; llama4's MoE layers place tokens
    at every step and redirect some in the first with one microbatch, so
    its counters are live."""
    jx = np.load(launched / "jax.npz")
    ranks = _ranks(launched)
    tag = f"{arch}/train{mb}"
    _held(jx, ranks, tag, arch, TRAIN["steps"])
    if arch == MOE:
        assert all(float(jx[f"{tag}/{i}/ntasks_static"]) > 0
                   for i in range(TRAIN["steps"]))
        if mb == 1:
            assert float(jx[f"{tag}/0/ntasks_stolen_local"]) \
                + float(jx[f"{tag}/0/ntasks_stolen_remote"]) > 0


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_prefill_and_greedy_decode_match_jax(launched, arch):
    """``serve.generate_on_mesh`` (the prefill and 4 serve steps, FSDP's
    leaves gathered a layer at a time) against the JAX steps on the
    (2, 2, 2) mesh: greedy ids equal, prefill logits within 2e-4."""
    jx = np.load(launched / "jax.npz")
    want = jx[f"{arch}/serve/ids"]
    assert want.shape == (SERVE["B"], SERVE["gen"])
    assert len(np.unique(want)) > 1
    for r in _ranks(launched):
        np.testing.assert_array_equal(r[f"{arch}/serve/ids"], want)
        np.testing.assert_allclose(r[f"{arch}/serve/logits"],
                                   jx[f"{arch}/serve/logits"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_prefill_is_bitwise_the_unsplit_weights(launched, arch):
    """The gathers make each layer's weights bitwise the rank's
    ``"model"`` pieces: the FSDP prefill's logits, greedy ids and every
    MoE layer's routing table (expert and capacity slot of each token)
    equal those of the same weights without FSDP on the same mesh."""
    for r in _ranks(launched):
        for k in ("ids", "logits"):
            np.testing.assert_array_equal(r[f"{arch}/serve/{k}"],
                                          r[f"{arch}/serve_unsplit/{k}"])
        n = int(r[f"{arch}/serve/tables"])
        assert n == int(r[f"{arch}/serve_unsplit/tables"])
        assert (n > 0) == (arch == MOE)
        for i in range(n):
            np.testing.assert_array_equal(
                r[f"{arch}/serve/table{i}"],
                r[f"{arch}/serve_unsplit/table{i}"])


def _leaves(r, arch) -> dict:
    prefix = f"{arch}/leaf/"
    return {k[len(prefix):]: [int(x) for x in r[k]] for k in r.files
            if k.startswith(prefix)}


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_a_rank_holds_its_data_and_model_piece(launched, arch):
    """A leaf the rules split over both ``"data"`` and ``"model"`` has
    1/(2 x 2) of its elements on a rank, one split over one of them 1/2,
    any other all of them; llama4's experts are among the leaves split
    over both."""
    for r in _ranks(launched):
        leaves = _leaves(r, arch)
        both = [n for n, v in leaves.items() if v[2] >= 0 and v[3]]
        assert len(both) >= 3
        if arch == MOE:
            assert {"streams.1.mlp.wg", "streams.1.mlp.wu",
                    "streams.1.mlp.wd"} <= set(both)
        for name, (local, whole, d, model, *_rest) in leaves.items():
            assert local * (2 if d >= 0 else 1) * (2 if model else 1) \
                == whole, name


def _expected(leaves, recompute: int) -> Counter:
    """The data gathers of one forward: each FSDP leaf's layers, each one
    gathered ``recompute`` times (2 under remat: the forward and its
    recompute), the embedding and head once per use."""
    want = Counter()
    for name, (_l, _w, d, _m, stacked, *layer) in leaves.items():
        if d < 0:
            continue
        uses = stacked * recompute if stacked else 1
        want[tuple(layer)] += uses
    return want


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_fsdp_gathers_each_layer_over_data_and_reduce_scatters_back(
        launched, arch):
    """In a train step (one microbatch) every all-gather over ``"data"``
    is one layer's FSDP leaf (never a stack), each layer's leaves gathered
    in the forward and again in the recompute, the head once; each gather
    of the forward is reduce-scattered once in the backward; in the
    prefill (no gradient) one gather a layer leaf and no
    reduce-scatter."""
    cfg = t_cb.smoke_config(arch)
    assert cfg.remat and not cfg.tie_embeddings
    for r in _ranks(launched):
        leaves = _leaves(r, arch)
        calls = [json.loads(c) for c in r[f"{arch}/calls"]]
        gathers = Counter(tuple(c[2]) for c in calls
                          if c[0] == "gather" and c[1] == "data")
        scatters = Counter(tuple(c[2]) for c in calls
                           if c[0] == "scatter" and c[1] == "data")
        assert gathers == _expected(leaves, 2)
        assert scatters == _expected(leaves, 1)
        serve = [json.loads(c) for c in r[f"{arch}/serve_calls"]]
        prefill = Counter(tuple(c[2]) for c in serve
                          if c[0] == "gather" and c[1] == "data")
        # the prefill and 4 decode steps: each gathers every layer once
        assert prefill == Counter({k: v * SERVE["gen"] for k, v in
                                   _expected(leaves, 1).items()})
        assert not [c for c in serve if c[0] == "scatter"]


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_no_fsdp_leaf_is_gathered_whole_outside_its_layer(launched, arch):
    """No FSDP leaf leaves its ``"data"`` split in a train step (its
    moments' pieces and its write-back are identities; the ZeRO
    write-backs of the other leaves do gather theirs), and no tensor
    gathered over ``"data"`` holds more than one layer."""
    for r in _ranks(launched):
        others, fsdp = (int(x) for x in r[f"{arch}/train1/whole_gathers"])
        assert others > 0 and fsdp == 0
        leaves = _leaves(r, arch)
        layer_shapes = {tuple(v[5:]) for v in leaves.values() if v[2] >= 0}
        for c in (json.loads(c) for c in r[f"{arch}/calls"]):
            if c[1] == "data":
                assert tuple(c[2]) in layer_shapes, c


@pytest.mark.parametrize("arch", F6_ARCHS)
def test_f6_microbatches_the_data_shards_do_not_divide_match_jax(
        launched, arch):
    """F6: a batch of 4 in 2 microbatches on the (2, 2, 2) mesh (2 rows a
    microbatch, 4 data shards): every rank computes each microbatch whole
    and its share is the mean over the data ranks; the JAX step's
    metrics, counters, moments and (through the moments) parameters
    (moonshot's MoE layers route each microbatch's 32 tokens over the 4
    data shards with the capacity of 16, as the JAX ``shard_map``
    does)."""
    jx = np.load(launched / "jax.npz")
    ranks = _ranks(launched)
    _held(jx, ranks, f"f6/{arch}", arch, F6["steps"])


def test_gathers_in_blocks_are_bitwise_one_gather(launched):
    """A gather and its reduce-scatter whose tensor passes
    ``BLOCK_BYTES`` go in blocks of rows (a row a block at 40 bytes, on each
    of 3 dims, over ``"data"`` and ``"model"``) and give the one call's
    results bit for bit."""
    for r in _ranks(launched):
        assert r["blocked"].shape == (6,) and r["blocked"].all()


@pytest.mark.parametrize("arch", F6_ARCHS)
def test_a_divisible_batch_is_bitwise_the_step_before_the_repair(
        launched, arch):
    """A batch whose microbatches the data shards divide (8 rows in 2 on 4
    shards) takes the path it took before F6's repair: on every rank, 3
    steps give the metrics, parameters and moments of a copy of the
    unrepaired step bit for bit."""
    for r in _ranks(launched):
        assert bool(r[f"divisible/{arch}"])


def test_a_batch_the_data_axes_do_not_divide_is_still_refused(launched):
    """6 rows on 4 data shards: refused, as the JAX step's batch
    shardings refuse it."""
    for r in _ranks(launched):
        assert "does not split" in str(r["refused"])


# ---------------------------------------------------------------------------
# the pieces, one process
# ---------------------------------------------------------------------------

class _Mesh:
    """A mesh's axis names and sizes, as the region operations read
    them."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())

    def get_group(self, axis):
        raise AssertionError(f"a collective over {axis}")


@pytest.mark.parametrize("axis", ("data", "model"))
def test_gather_over_an_axis_of_one_is_the_identity(axis):
    """At an axis of one rank the gather returns its input and runs no
    collective, with and without a gradient; a mesh without the axis
    raises."""
    x = torch.randn(4, 6, requires_grad=True)
    mesh = _Mesh(data=1, model=1)
    assert t_tpo.gather_over(x, mesh, axis, 0) is x
    with torch.no_grad():
        assert t_tpo.gather_over(x, mesh, axis, -1) is x
    with pytest.raises(ValueError, match=axis):
        t_tpo.gather_over(x, _Mesh(pod=1), axis)


def test_fsdp_gather_is_the_identity_without_fsdp_hints():
    """``layers.fsdp_gather`` returns a layer as it is when no step set
    FSDP hints, and under hints without FSDP dims."""
    layer = {"attn": {"wq": torch.zeros(3, 4)}, "ln1": torch.zeros(4)}
    assert t_layers.fsdp_gather(layer, "streams", 0, lead=1) is layer
    with t_layers.axis_hints(dp_axes=("data",), dp_size=2, tp_size=1,
                             mesh=_Mesh(data=2, model=1)):
        assert t_layers.fsdp_gather(layer, "streams", 0, lead=1) is layer
    assert t_layers._FSDP == {"mesh": None, "dims": None}


def test_fsdp_dims_of_a_one_rank_mesh_are_none(tmp_path):
    """On a (1, 1) mesh FSDP splits nothing (a data axis of one rank
    holds the whole), so the steps take their non-FSDP path and stay
    bitwise the one-device step; on every mesh a config without ``fsdp``
    has no FSDP dims."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
        for fsdp in (True, False):
            cfg = dataclasses.replace(t_cb.smoke_config(FSDP_ARCHS[0]),
                                      fsdp=fsdp)
            params = t_tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
            p = t_shd.distribute_tree(params, t_shd.param_shardings(
                params, cfg, mesh), mesh)
            assert t_shd.fsdp_dims(p) is None
            assert all(t_shd.fsdp_dim(leaf) is None
                       for leaf in t_tfm.tree_leaves(p))
    finally:
        dist.destroy_process_group()


def test_collectives_tree_map_keeps_structure_and_order():
    """``runtime.collectives``'s own tree walk: dicts (keys sorted for
    the calls), lists, tuples and NamedTuples keep their types."""
    seen = []
    tree = {"b": [1, (2, 3)], "a": t_tfm.DecodeState(caches=(4,), length=5)}
    out = t_col.tree_map(lambda x: seen.append(x) or x * 10, tree)
    assert seen == [4, 5, 1, 2, 3]
    assert list(out) == ["b", "a"] and out["b"] == [10, (20, 30)]
    assert out["a"] == t_tfm.DecodeState(caches=(40,), length=50)


@pytest.mark.parametrize("arch,mesh,want", [
    ("nemotron_4_340b", (2, 16, 16), (2, 4)),
    ("nemotron_4_340b", (16, 16), (2, 3)),
    ("llama4_maverick_400b_a17b", (2, 16, 16), (2, 3)),
    ("gemma2_2b", (16, 16), (2,)),
])
def test_train_probes_take_batches_the_data_shards_divide(arch, mesh, want,
                                                          monkeypatch):
    """The dry-run's train probes: 2 and 3 microbatches where the data
    shards divide a microbatch, else (F6's cell, nemotron on 32 data
    shards: 16 rows a microbatch) the two smallest counts whose batch
    they divide; a step of 2 microbatches is probed whole."""
    seen = []
    monkeypatch.setattr(t_dry, "_trace", lambda c, cell, m, dev, mb: (
        seen.append((cell.global_batch, mb)) or HloCost(), 0))
    cfg, cell, meta = t_dry.cell_meta(arch, "train_4k", len(mesh) == 3)
    _, probes = t_dry._probed(cfg, cell, _desc(mesh), "cpu",
                              meta["microbatches"])
    assert tuple(probes["microbatches"]) == want
    dp = mesh[-2] * (mesh[0] if len(mesh) == 3 else 1)
    assert all(rows % dp == 0 for rows, _ in seen)


def _desc(shape):
    names = ("pod", "data", "model")[-len(shape):]

    class Desc:
        axis_names = names

    Desc.shape = dict(zip(names, shape))
    return Desc()
