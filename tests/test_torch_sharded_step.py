"""The sharded step (``repro_torch.launch.steps`` on a mesh, the shard-local
MoE routing of ``repro_torch.models.moe``, the axis hints of
``repro_torch.models.layers``, ``checkpoint.restore_resharded`` and the
drivers' meshes) against the JAX package on the CPU.

The multi-rank checks share one launch: 8 gloo ranks as the (2, 2, 2)
``("pod", "data", "model")`` mesh (``OMP_NUM_THREADS=1``, a ``file://``
store) beside one JAX process with 8 host devices on a mesh of the same
shape with ``AxisType.Auto`` axes (this jax's default explicit axes turn
the JAX step's sharding constraints into asserts that its inputs fail).
Each has its own deadline; the launch runs once for the whole test run,
whichever test process asks first (a file lock under the run's shared
temporary directory), and its results are read by several tests.  The
JAX weights are made once here and carried to both.

Tolerances: ``TOL`` = 1e-5 for float32 sums taken in another order (of
the largest magnitude, per gradient and parameter leaf); routing tables,
counters and greedy ids equal; prefill logits within 2e-4; checkpoints and
one-rank meshes bitwise.

Fault F5 (a serve batch that the data axes do not divide): every rank
decodes all lanes of a batch of 1 and of 2 on the (2, 2, 2) mesh (4 data
shards), against the JAX serve step on its mesh and the one-device decode
of both packages; a divisible batch's steps stay bitwise those of the step
before the repair.
"""

import dataclasses
import fcntl
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as j_cb  # noqa: E402
from repro.core import balance as j_bal  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.core import balance as t_bal  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import sharding as t_shd  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import cosine_schedule  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5
LOGIT_TOL = 2e-4
MOE = "moonshot_v1_16b_a3b"
SERVE_ARCHS = (MOE, "gemma2_2b")
#: the train batch: 8 rows of 16, so 2 microbatches give each of the 4
#: data shards one row; warmup is 2 of 20 steps
TRAIN = dict(B=8, S=16, steps=3, total=20)
#: the serve batch: 4 lanes (one a data shard), a 16-token prompt, 4 new
#: tokens (the prefill's and 3 serve steps')
SERVE = dict(B=4, S=16, gen=4)
#: F5: serve batches of 1 and 2 lanes, which the 4 data shards do not
#: divide, a 16-token prompt and 4 new tokens, per arch
F5 = dict(archs=["gemma2_2b", "rwkv6_1_6b"], batches=[1, 2], S=16, gen=4)
DEADLINE_S = 240


@pytest.fixture(autouse=True)
def _no_hints_leak():
    """Both packages' axis hints are off before and after every test."""
    j_layers.clear_axis_hints()
    t_layers.clear_axis_hints()
    yield
    j_layers.clear_axis_hints()
    t_layers.clear_axis_hints()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """A mesh description: the axes and sizes the rules and hints read."""

    def __init__(self, pod=2, data=2, model=2):
        self.axis_names = (("pod",) if pod else ()) + ("data", "model")
        self.shape = dict(zip(self.axis_names, (
            (pod,) if pod else ()) + (data, model)))


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def bits(t: torch.Tensor):
    """``t``'s bits, for bitwise comparisons of float tensors."""
    t = t.detach().contiguous()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def bitwise(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        bits(a), bits(b))


def jax_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def jax_weights(arch):
    """The JAX package's weights (``PRNGKey(0)``) for the smoke ``arch``;
    gemma2's embeddings scaled down so greedy decoding does not repeat its
    last token (as ``tests/test_torch_serve.py`` does)."""
    cfg = j_cb.smoke_config(arch)
    p = j_tfm.init_params(cfg, jax.random.PRNGKey(0))
    if arch == "gemma2_2b":
        p = dict(p, embed=p["embed"] * 0.02)
    return p


def port_params(flat: dict, arch):
    """The port's parameters holding the arrays of ``flat`` (by key
    path)."""
    like = t_tfm.init_params(t_cb.smoke_config(arch), None, "meta")
    return t_tfm.tree_unflatten(like, [
        torch.from_numpy(np.array(flat[".".join(path)]))
        for path, _ in t_tfm.tree_items(like)])


# ---------------------------------------------------------------------------
# the launch: 8 gloo ranks beside one JAX process, once per test run
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import checkpoint as ckpt
from repro_torch.configs import base as cb
from repro_torch.data.pipeline import batch_for
from repro_torch.launch import serve, sharding as shd, steps, train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers, transformer as tfm
from repro_torch.optim import adamw_init

rank, tmp = int(sys.argv[1]), sys.argv[2]
T, SV, MOE, ARCHS, F5 = (json.loads(a) for a in sys.argv[3:8])
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=8)


def weights(arch):
    w = np.load(f"{tmp}/weights_{arch}.npz")
    like = tfm.init_params(cb.smoke_config(arch), None, "meta")
    return tfm.tree_unflatten(like, [torch.from_numpy(w[".".join(path)])
                                     for path, _ in tfm.tree_items(like)])


def full(tree):
    return {".".join(p): v.full_tensor() for p, v in tfm.tree_items(tree)}


def spec_at(specs, path):
    for k in path:
        specs = specs[int(k)] if k.isdigit() else (
            getattr(specs, k) if hasattr(specs, "_fields") else specs[k])
    return specs


def same(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


out = {}
try:
    mesh = make_test_mesh(2, 2, multi_pod=True, device="cpu")
    out["coord"] = np.asarray(mesh.get_coordinate())
    cfg = cb.smoke_config(MOE)
    # 3 sharded train steps, microbatches 1 and 2
    for mb in (1, 2):
        params = weights(MOE)
        p, o = steps.shard_train_state(cfg, mesh, params,
                                       adamw_init(params))
        step = steps.make_train_step(cfg, mesh, microbatches=mb,
                                     total_steps=T["total"])
        for i in range(T["steps"]):
            p, o, m = step(p, o, batch_for(cfg, i, T["B"], T["S"]), i)
            for k, v in m.items():
                out[f"train{mb}/{i}/{k}"] = np.asarray(float(v))
        for k, v in full(p).items():
            out[f"train{mb}/param/{k}"] = v.numpy()
        out[f"train{mb}/opt_step"] = np.asarray(int(o.step.full_tensor()))
    # the state of the last run saved (collectively), then restored onto
    # the (4, 2) mesh of the same ranks
    ckpt.save(f"{tmp}/ckpt", 3, {"params": p, "opt": o})
    saved = full({"params": p, "opt": o})
    mesh42 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    specs = {"params": shd.param_shardings(p, cfg, mesh42),
             "opt": shd.opt_shardings(o, p, cfg, mesh42)}
    tree, s = ckpt.restore_resharded(f"{tmp}/ckpt", {"params": p, "opt": o},
                                     specs, mesh42)
    got = full(tree)
    placed = [(v.placements, spec_at(specs, path))
              for path, v in tfm.tree_items(tree)]
    out["restore42/step"] = np.asarray(s)
    out["restore42/leaves"] = np.asarray(len(got))
    out["restore42/sharded"] = np.asarray(sum(
        any(pl.is_shard() for pl in have) for have, _ in placed))
    out["restore42/placed"] = np.asarray(all(
        have == shd.placements(spec, mesh42) for have, spec in placed))
    out["restore42/bitwise"] = np.asarray(sorted(got) == sorted(saved) and
                                          all(same(got[k], saved[k])
                                              for k in saved))
    if rank == 0:
        np.savez(f"{tmp}/saved.npz", **{k: v.numpy() for k, v in
                                        saved.items()})
    # prefill and 3 serve steps, the weights as DTensors
    for arch in ARCHS:
        c = cb.smoke_config(arch)
        params = weights(arch)
        p = shd.distribute_tree(params, shd.param_shardings(params, c, mesh),
                                mesh)
        batch = {k: torch.as_tensor(v) for k, v in
                 batch_for(c, 0, SV["B"], SV["S"]).items()}
        g = serve.generate_on_mesh(p, c, batch, SV["gen"], mesh)
        out[f"serve/{arch}/ids"] = g.ids.numpy()
        out[f"serve/{arch}/logits"] = g.prefill_logits.numpy()
    # a divisible batch: the serve steps bitwise those of the step before
    # F5's repair (a copy of it), from one prefill state each.  Both
    # configs compute over "model": the copy takes each leaf's local
    # piece (none is split over the data axes) and the greedy token from
    # every rank's vocabulary columns, gathered here
    def unrepaired_serve_step(cfg, mesh, batch, max_len):
        dp, tp = steps.dp_size(mesh), steps.tp_size(mesh)
        device = steps._device(mesh)
        steps._check_rows(batch, mesh, "a batch")
        group = mesh.get_group("model")

        def serve_step(params, state, tokens):
            with torch.no_grad(), layers.axis_hints(
                    dp_axes=steps.dp_axes(mesh), dp_size=dp, tp_size=tp,
                    mesh=mesh, tp_mesh=mesh, seq_mesh=mesh,
                    max_len=max_len):
                logits, state = tfm.decode_step(
                    tfm.tree_map(lambda x: x.to_local(), params), cfg,
                    state, steps._rows(tokens, mesh, device),
                    ep_groups=tp, dp_groups=dp)
                parts = [torch.empty_like(logits) for _ in range(tp)]
                dist.all_gather(parts, logits.contiguous(), group=group)
                ids = torch.argmax(torch.cat(parts, -1), -1)
                return steps.rows_on_mesh(ids.to(torch.int32), mesh), state

        return serve_step

    for arch in ARCHS:
        c = cb.smoke_config(arch)
        params = weights(arch)
        p = shd.distribute_tree(params, shd.param_shardings(params, c, mesh),
                                mesh)
        batch = {k: torch.as_tensor(v) for k, v in
                 batch_for(c, 0, SV["B"], SV["S"]).items()}
        max_len = SV["S"] + SV["gen"]
        runs = []
        for make in (steps.make_serve_step, unrepaired_serve_step):
            logits, state = steps.make_prefill_step(c, mesh, max_len)(
                p, batch)
            tok = steps.rows_on_mesh(torch.argmax(logits.to_local(), -1).to(
                torch.int32), mesh)
            step = make(c, mesh, SV["B"], max_len)
            toks = []
            for _ in range(SV["gen"] - 1):
                tok, state = step(p, state, tok)
                toks.append(tok.to_local())
            runs.append((toks, tfm.tree_leaves(state)))
        (a_toks, a_state), (b_toks, b_state) = runs
        out[f"serve/{arch}/divisible_bitwise"] = np.asarray(
            len(a_toks) == len(b_toks) and all(
                same(x, y) for x, y in zip(a_toks + a_state,
                                           b_toks + b_state)))
    # F5: batches the data axes do not divide; every rank decodes all
    # lanes of a one-device prefill's state (placed as the serve step's
    # decode_state_shardings lay it out),
    # the weights as DTensors
    for arch in F5["archs"]:
        c = cb.smoke_config(arch)
        params = weights(arch)
        p = shd.distribute_tree(params, shd.param_shardings(params, c, mesh),
                                mesh)
        for B in F5["batches"]:
            batch = {k: torch.as_tensor(v) for k, v in
                     batch_for(c, 0, B, F5["S"]).items()}
            max_len = F5["S"] + F5["gen"]
            with torch.no_grad():
                logits, state = tfm.prefill(params, c, batch, max_len)
                first = torch.argmax(logits, -1).to(torch.int32)
                tok, one = first, [first]
                for _ in range(F5["gen"] - 1):
                    lg, state = tfm.decode_step(params, c, state, tok)
                    tok = torch.argmax(lg, -1).to(torch.int32)
                    one.append(tok)
                _, state = tfm.prefill(params, c, batch, max_len)
            state = steps.shard_decode_state(c, mesh, state)
            step = steps.make_serve_step(c, mesh, B, max_len)
            tok, ids, replicated = first, [first], True
            for _ in range(F5["gen"] - 1):
                tok, state = step(p, state, tok)
                replicated = replicated and tuple(tok.shape) == (B,) and all(
                    pl.is_replicate() for pl in tok.placements)
                ids.append(tok.to_local())
            out[f"f5/{arch}/{B}/ids"] = torch.stack(ids, 1).numpy()
            out[f"f5/{arch}/{B}/one_device_ids"] = torch.stack(one, 1).numpy()
            out[f"f5/{arch}/{B}/logits"] = logits.float().numpy()
            out[f"f5/{arch}/{B}/replicated"] = np.asarray(replicated)
    # the train driver on the (4, 2) mesh of the world, through a fault
    run = train.run(["--arch", MOE, "--smoke", "--steps", "4",
                     "--global-batch", "8", "--seq", "16", "--device", "cpu",
                     "--ckpt-dir", f"{tmp}/driver", "--ckpt-every", "2",
                     "--fault-at", "3", "--log-every", "100"])
    out["driver/losses"] = np.asarray(run.losses)
    out["driver/restarts"] = np.asarray(run.restarts)
    out["driver/recovered_from"] = np.asarray(run.recovered_from)
    out["driver/end_step"] = np.asarray(run.end_step)
    out["driver/mesh"] = np.asarray(
        [p.device_mesh.shape for _, p in tfm.tree_items(run.params)][0])
    np.savez(f"{tmp}/rank{rank}.npz", **out)
finally:
    dist.destroy_process_group()
print("PASS", rank)
"""

JAX_SCRIPT = r"""
import json, os, sys
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
T, SV, MOE, ARCHS, F5 = (json.loads(a) for a in sys.argv[2:7])
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


out = {}
cfg = cb.smoke_config(MOE)
with jax.set_mesh(mesh):
    # the loss and gradient under the mesh's hints, with the train step's
    # key of step 0 and its groups
    try:
        layers.set_axis_hints(dp_axes=("pod", "data"), dp_size=4, tp_size=2,
                              mesh=mesh)
        batch = {k: jnp.asarray(v) for k, v in
                 batch_for(cfg, 0, T["B"], T["S"]).items()}
        rng = jax.random.fold_in(jax.random.PRNGKey(17), 0)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: tfm.loss_fn(p, cfg, b, rng, ep_groups=2,
                                     dp_groups=4), has_aux=True))
        (loss, metrics), grads = fn(weights(MOE), batch)
        out["grad/loss"] = np.asarray(loss)
        for k, v in metrics.items():
            out[f"grad/metric/{k}"] = np.asarray(v)
        flat("grad/leaf", grads, out)
    finally:
        layers.clear_axis_hints()
    for mb in (1, 2):
        try:
            _, jit_for, (_, _, p_shard, o_shard) = steps.make_train_step(
                cfg, mesh, microbatches=mb, total_steps=T["total"],
                donate=False)
            batches = [batch_for(cfg, i, T["B"], T["S"])
                       for i in range(T["steps"])]
            jstep = jit_for(jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                batches[0]))
            p = jax.device_put(weights(MOE), p_shard)
            o = jax.device_put(adamw_init(p), o_shard)
            for i, b in enumerate(batches):
                p, o, m = jstep(p, o, b, jnp.int32(i))
                for k, v in m.items():
                    out[f"train{mb}/{i}/{k}"] = np.asarray(v)
            flat(f"train{mb}/param", p, out)
        finally:
            layers.clear_axis_hints()
    for arch in ARCHS:
        c = cb.smoke_config(arch)
        try:
            max_len = SV["S"] + SV["gen"]
            batch = {k: jnp.asarray(v) for k, v in
                     batch_for(c, 0, SV["B"], SV["S"]).items()}
            _, pf_for, _ = steps.make_prefill_step(c, mesh, max_len)
            pf = pf_for(jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), batch))
            _, serve_step, _ = steps.make_serve_step(c, mesh, SV["B"],
                                                     max_len)
            p = weights(arch)
            logits, state = pf(p, batch)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            ids = [np.asarray(tok)]
            for _ in range(SV["gen"] - 1):
                tok, state = serve_step(p, state, tok)
                ids.append(np.asarray(tok))
            out[f"serve/{arch}/ids"] = np.stack(ids, axis=1)
            out[f"serve/{arch}/logits"] = np.asarray(logits, np.float32)
        finally:
            layers.clear_axis_hints()
    # F5: the serve step on batches the 4 data shards do not divide, from
    # the one-device prefill's state
    for arch in F5["archs"]:
        c = cb.smoke_config(arch)
        for B in F5["batches"]:
            try:
                max_len = F5["S"] + F5["gen"]
                batch = {k: jnp.asarray(v) for k, v in
                         batch_for(c, 0, B, F5["S"]).items()}
                p = weights(arch)
                logits, state = tfm.prefill(p, c, batch, max_len)
                _, serve_step, (_, _, p_shard, s_shard, tok_shard) = \
                    steps.make_serve_step(c, mesh, B, max_len)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                ids = [np.asarray(tok)]
                p, state, tok = jax.device_put((p, state, tok),
                                               (p_shard, s_shard, tok_shard))
                for _ in range(F5["gen"] - 1):
                    tok, state = serve_step(p, state, tok)
                    ids.append(np.asarray(tok))
                out[f"f5/{arch}/{B}/ids"] = np.stack(ids, axis=1)
                out[f"f5/{arch}/{B}/logits"] = np.asarray(logits, np.float32)
            finally:
                layers.clear_axis_hints()
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
    for arch in set(SERVE_ARCHS) | set(F5["archs"]):
        np.savez(os.path.join(tmp, f"weights_{arch}.npz"),
                 **jax_paths(jax_weights(arch)))
    args = [json.dumps(a) for a in (TRAIN, SERVE, MOE, SERVE_ARCHS, F5)]
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
    """The launch's directory (``jax.npz``, ``rank<r>.npz``, ``saved.npz``,
    the checkpoint), made by whichever test process of this run asks
    first."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"sharded_step_{uid}" if uid else base / "sharded"
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


@pytest.mark.parametrize("mb", (1, 2))
def test_three_sharded_train_steps_on_8_ranks_match_jax(launched, mb):
    """Losses, ``lr``, ``grad_norm``, ``ce``, ``lb_loss`` within ``TOL``
    and the summed routing counters equal at every step; every parameter
    within ``TOL`` after the third; every rank reports the same."""
    jx = np.load(launched / "jax.npz")
    ranks = _ranks(launched)
    for i in range(TRAIN["steps"]):
        for k in METRICS:
            want = float(jx[f"train{mb}/{i}/{k}"])
            got = [float(r[f"train{mb}/{i}/{k}"]) for r in ranks]
            assert len(set(got)) == 1, (i, k, got)
            if k in COUNTERS:
                assert got[0] == want, (i, k, got[0], want)
            else:
                assert got[0] == pytest.approx(want, rel=TOL, abs=1e-12), \
                    (i, k)
    # the MoE layers really redirected and dropped (the counters are live)
    assert float(jx[f"train{mb}/0/ntasks_stolen_local"]) \
        + float(jx[f"train{mb}/0/ntasks_stolen_remote"]) > 0
    names = [k.split("/", 2)[2] for k in jx.files
             if k.startswith(f"train{mb}/param/")]
    assert len(names) > 10
    for name in names:
        want = jx[f"train{mb}/param/{name}"]
        assert rel(ranks[0][f"train{mb}/param/{name}"], want) <= TOL, name
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"train{mb}/param/{name}"],
                                          ranks[0][f"train{mb}/param/{name}"])
    assert int(ranks[0][f"train{mb}/opt_step"]) == TRAIN["steps"]


def test_global_view_loss_and_gradient_match_jax_under_hints(launched):
    """The port's ``loss_fn`` in one process on the global batch, under the
    hints of a (2, 2, 2) mesh description (shard routing looped over the
    4 data shards), against the JAX ``loss_fn`` under the hints of the
    8-device mesh (``shard_map`` over the data axes): loss and every
    gradient within ``TOL``, the summed counters equal; and different
    from the unsharded loss, so the shard-local path was taken."""
    jx = np.load(launched / "jax.npz")
    flat = jax_paths(jax_weights(MOE))
    tcfg = t_cb.smoke_config(MOE)
    tp = port_params(flat, MOE).requires_grad_(True)
    batch = {k: torch.as_tensor(v) for k, v in
             t_pipe.batch_for(tcfg, 0, TRAIN["B"], TRAIN["S"]).items()}
    rng = prng.fold_in(prng.PRNGKey(17), 0)
    with t_layers.axis_hints(dp_axes=("pod", "data"), dp_size=4, tp_size=2,
                             mesh=FakeMesh()):
        loss, metrics = t_tfm.loss_fn(tp, tcfg, batch, rng, ep_groups=2,
                                      dp_groups=4)
        grads = torch.autograd.grad(loss, t_tfm.tree_leaves(tp))
    assert float(loss) == pytest.approx(float(jx["grad/loss"]), rel=TOL)
    for k, v in metrics.items():
        want = float(jx[f"grad/metric/{k}"])
        if k in COUNTERS:
            assert float(v) == want, k
        else:
            assert float(v) == pytest.approx(want, rel=TOL, abs=1e-12), k
    for (path, _), g in zip(t_tfm.tree_items(tp), grads):
        name = ".".join(path)
        assert rel(g.numpy(), jx[f"grad/leaf/{name}"]) <= TOL, name
    unsharded, _ = t_tfm.loss_fn(tp, tcfg, batch, rng, ep_groups=2,
                                 dp_groups=4)
    assert abs(float(unsharded) - float(loss)) > 1e-4


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_prefill_and_serve_steps_on_8_ranks_match_jax(launched, arch):
    """``serve.generate_on_mesh`` (the mesh-bound prefill and 3 serve
    steps, weights as DTensors) on every rank against the JAX steps on the
    (2, 2, 2) mesh: greedy ids equal, prefill logits within 2e-4."""
    jx = np.load(launched / "jax.npz")
    want_ids = jx[f"serve/{arch}/ids"]
    assert want_ids.shape == (SERVE["B"], SERVE["gen"])
    assert len(np.unique(want_ids)) > 1
    for r in _ranks(launched):
        np.testing.assert_array_equal(r[f"serve/{arch}/ids"], want_ids)
        np.testing.assert_allclose(r[f"serve/{arch}/logits"],
                                   jx[f"serve/{arch}/logits"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("B", F5["batches"])
@pytest.mark.parametrize("arch", F5["archs"])
def test_f5_serve_step_decodes_a_batch_the_data_axes_do_not_divide(
        launched, arch, B):
    """F5: ``make_serve_step`` at a batch of 1 and of 2 lanes on the
    (2, 2, 2) mesh of 8 ranks (4 data shards split neither): every rank's
    greedy ids equal the JAX serve step's on its (2, 2, 2) mesh and both
    packages' one-device decode; the tokens come back as DTensors
    replicated over the mesh; the prefill logits within 2e-4."""
    jx = np.load(launched / "jax.npz")
    want = jx[f"f5/{arch}/{B}/ids"]
    assert want.shape == (B, F5["gen"])
    for r in _ranks(launched):
        np.testing.assert_array_equal(r[f"f5/{arch}/{B}/ids"], want)
        np.testing.assert_array_equal(r[f"f5/{arch}/{B}/one_device_ids"],
                                      want)
        assert bool(r[f"f5/{arch}/{B}/replicated"])
        np.testing.assert_allclose(r[f"f5/{arch}/{B}/logits"],
                                   jx[f"f5/{arch}/{B}/logits"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_step_on_a_divisible_batch_is_bitwise_the_unrepaired_one(
        launched, arch):
    """A batch the data axes divide (4 lanes on 4 shards) takes the path it
    took before F5's repair: on every rank, 3 serve steps from one prefill
    state give the tokens and state of a copy of the unrepaired step bit
    for bit."""
    for r in _ranks(launched):
        assert bool(r[f"serve/{arch}/divisible_bitwise"])


def test_restore_resharded_from_2x2x2_onto_4x2_is_bitwise(launched):
    """The state the (2, 2, 2) run saved, restored onto the (4, 2) mesh
    of the same 8 ranks: each leaf under its rules' placements there,
    every ``full_tensor`` bitwise the saved one."""
    for r in _ranks(launched):
        assert int(r["restore42/step"]) == 3
        assert bool(r["restore42/placed"]) and bool(r["restore42/bitwise"])
        assert int(r["restore42/sharded"]) > 0
        assert int(r["restore42/leaves"]) == 3 * len(
            t_tfm.tree_leaves(port_params(jax_paths(jax_weights(MOE)),
                                          MOE))) + 1


def test_restore_resharded_from_2x2x2_onto_one_rank_is_bitwise(launched,
                                                               tmp_path):
    """The same checkpoint restored onto a (1, 1) mesh of one rank."""
    saved = np.load(launched / "saved.npz")
    cfg = t_cb.smoke_config(MOE)
    params = t_tfm.init_params(cfg, None, "meta")
    template = {"params": params, "opt": adamw_init(params)}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
        specs = {"params": t_shd.param_shardings(params, cfg, mesh),
                 "opt": t_shd.opt_shardings(template["opt"], params, cfg,
                                            mesh)}
        tree, step = t_ckpt.restore_resharded(str(launched / "ckpt"),
                                              template, specs, mesh)
        assert step == 3
        n = 0
        for path, leaf in t_tfm.tree_items(tree):
            got = leaf.full_tensor()
            want = torch.from_numpy(saved[".".join(path)])
            assert bitwise(got, want), path
            n += 1
        assert n == len(saved.files)
    finally:
        dist.destroy_process_group()


def test_train_driver_runs_the_sharded_step_on_a_world_through_a_fault(
        launched):
    """``launch.train.run`` in a world of 8: ``build_mesh`` gives (4, 2);
    the run saves DTensor checkpoints, restores from step 2 after the
    fault at step 3 and ends at step 4 with finite losses, equal on every
    rank."""
    ranks = _ranks(launched)
    for r in ranks:
        assert list(r["driver/mesh"]) == [4, 2]
        assert int(r["driver/restarts"]) == 1
        assert int(r["driver/recovered_from"]) == 2
        assert int(r["driver/end_step"]) == 4
        assert np.isfinite(r["driver/losses"]).all()
        np.testing.assert_array_equal(r["driver/losses"],
                                      ranks[0]["driver/losses"])


# ---------------------------------------------------------------------------
# the axis hints
# ---------------------------------------------------------------------------

HINT_CASES = (
    ((8, 4, 16, 16), ("dp", "tp", None, None)),
    ((6, 3, 16), ("dp", "tp")),           # neither divides: replicated
    ((8, 20, 64), ("dp", None, "tp")),
    ((12, 5), ("dp",)),                    # trailing dims default to None
    ((4, 8, 2, 16), ("tp", "dp", "tp", None)),
)


@pytest.mark.parametrize("mesh", [FakeMesh(), FakeMesh(pod=0, data=4),
                                  FakeMesh(pod=0, data=1, model=1)],
                         ids=["pod_2x2x2", "4x2", "1x1"])
@pytest.mark.parametrize("shape,axes", HINT_CASES)
def test_hint_spec_is_the_layout_the_jax_hint_pins(shape, axes, mesh,
                                                   monkeypatch):
    """The port's ``hint_spec`` against the ``PartitionSpec`` the JAX
    ``hint`` hands ``with_sharding_constraint`` (captured), with the hints
    of each mesh description; ``hint`` is the identity, and with the
    hints off neither package pins anything."""
    pinned = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: pinned.append(tuple(spec)) or x)
    x = jnp.zeros(shape)
    assert j_layers.hint(x, *axes) is x and not pinned
    assert t_layers.hint_spec(shape, *axes) == ()
    dp = t_mesh.dp_axes(mesh)
    kw = dict(dp_axes=dp, dp_size=t_mesh.dp_size(mesh),
              tp_size=t_mesh.tp_size(mesh), mesh=mesh)
    j_layers.set_axis_hints(**kw)
    j_layers.hint(x, *axes)
    with t_layers.axis_hints(**kw):
        got = t_layers.hint_spec(shape, *axes)
        t = torch.zeros(shape)
        assert t_layers.hint(t, *axes) is t
    assert pinned == [got]


def test_axis_hints_last_one_block_and_are_restored_when_it_raises():
    mesh = FakeMesh()
    outer = dict(dp_axes=("data",), dp_size=2, tp_size=1, mesh=mesh)
    t_layers.set_axis_hints(**outer)
    before = dict(t_layers._AXIS_HINTS)
    with pytest.raises(KeyError):
        with t_layers.axis_hints(dp_axes=("pod", "data"), dp_size=4,
                                 tp_size=2, mesh=mesh):
            assert t_layers._AXIS_HINTS["dp_size"] == 4
            assert not t_layers.rank_local()   # a description: global view
            raise KeyError("inside")
    assert t_layers._AXIS_HINTS == before
    t_layers.clear_axis_hints()
    assert t_layers._AXIS_HINTS == dict(on=False, dp=None, dp_size=0,
                                        tp_size=0, mesh=None)


@pytest.mark.parametrize("kind", ("full", "local", "bidir"))
def test_gqa_kv_expansion_under_tensor_parallel_hints_matches_jax(
        kind, monkeypatch):
    """One KV head for 4 query heads, hints of 2-way tensor parallelism:
    both packages expand KV to 4 heads before the attention (the port's
    flash call sees 4 KV heads), and the layer equals JAX's within
    ``TOL`` and its own unhinted output."""
    jcfg = dataclasses.replace(j_cb.smoke_config("gemma2_2b"), n_kv_heads=1)
    tcfg = dataclasses.replace(t_cb.smoke_config("gemma2_2b"), n_kv_heads=1)
    jp = j_layers.attn_init(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 40, 64)).astype(
        np.float32)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    kw = dict(dp_axes=("data",), dp_size=1, tp_size=2)
    with jax.set_mesh(jmesh):
        j_layers.set_axis_hints(mesh=jmesh, **kw)
        want, _ = jax.jit(lambda p, v: j_layers.attn_apply(p, v, jcfg,
                                                           kind))(jp, x)
    heads = []
    flash = t_layers.ops.flash_attention
    monkeypatch.setattr(t_layers.ops, "flash_attention",
                        lambda q, k, v, **a: heads.append(k.shape[1])
                        or flash(q, k, v, **a))
    plain, (kt, _) = t_layers.attn_apply(tp, torch.from_numpy(x), tcfg, kind)
    with t_layers.axis_hints(mesh=FakeMesh(pod=0, data=1, model=2), **kw):
        got, (kh, _) = t_layers.attn_apply(tp, torch.from_numpy(x), tcfg,
                                           kind)
    assert heads == [1, 4]
    assert kh.shape[1] == kt.shape[1] == 1      # the cache keeps 1 head
    assert rel(got.numpy(), np.asarray(want)) <= TOL
    assert rel(got.numpy(), plain.numpy()) <= TOL


# ---------------------------------------------------------------------------
# shard-local routing, dispatch and combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ("na_rp", "na_ws", "drop"))
@pytest.mark.parametrize("G", (2, 4))
def test_global_view_shard_routing_matches_jax_per_shard(G, strategy):
    """``route_dispatch_shards`` over G shards of 64 tokens (as many
    slots as assignments, so skewed logits redirect and drop) against the
    JAX package's ``balance.route`` and ``ops.moe_dispatch`` called per
    shard with ``fold_in(rng, shard)`` on one device: expert ids, virtual
    expert ids and slots equal, weights, probabilities and buffers within ``TOL``,
    the counters summed over the shards equal; then ``combine_shards``
    against JAX's ``moe_combine`` per shard on local ids."""
    moe = dict(capacity_factor=1.0, strategy=strategy)
    jcfg = j_cb.smoke_config(MOE)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe))
    tcfg = t_cb.smoke_config(MOE)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             **moe))
    m, t, D = jcfg.moe, 64, jcfg.d_model
    E, k = m.n_experts, m.top_k
    rng = np.random.default_rng(G * 10 + len(strategy))
    xt = rng.standard_normal((G * t, D)).astype(np.float32)
    logits = (rng.standard_normal((G * t, E)) * 2).astype(np.float32)
    cap = t_moe.capacity_for(tcfg, t)
    assert cap == 16            # as many slots as assignments
    y = rng.standard_normal((G, E, cap, D)).astype(np.float32)
    buf, ve, pos, weight, probs, stats = t_moe.route_dispatch_shards(
        torch.from_numpy(xt), torch.from_numpy(logits), tcfg, cap,
        t_bal.default_expert_groups(E, 2), prng.PRNGKey(5), G)
    assert tuple(buf.shape) == (G, E, cap, D)
    jgroups = j_bal.default_expert_groups(E, 2)
    jstats = dict.fromkeys(stats, 0)
    outs = []
    for s in range(G):
        rows = slice(s * t, (s + 1) * t)
        r = j_bal.route(jnp.asarray(logits[rows]), k, cap, jgroups,
                        strategy=strategy, p_local=m.p_local,
                        key=jax.random.fold_in(jax.random.PRNGKey(5), s))
        jbuf = j_ops.moe_dispatch(jnp.asarray(xt[rows]), r.expert, r.pos,
                                  n_experts=E, capacity=cap)
        jve = np.where(np.asarray(r.expert) >= 0,
                       s * E + np.asarray(r.expert), -1)
        np.testing.assert_array_equal(ve[rows].numpy(), jve)
        np.testing.assert_array_equal(pos[rows].numpy(), np.asarray(r.pos))
        assert rel(weight[rows].numpy(), np.asarray(r.weight)) <= TOL
        assert rel(probs[rows].numpy(), np.asarray(r.probs)) <= TOL
        assert rel(buf[s].numpy(), np.asarray(jbuf)) <= TOL
        for key_ in jstats:
            jstats[key_] += int(r.stats[key_])
        outs.append(np.asarray(j_ops.moe_combine(
            jnp.asarray(y[s]), r.expert, r.pos, r.weight, n_tokens=t)))
    assert {k_: int(v) for k_, v in stats.items()} == jstats
    if strategy != "drop":
        assert jstats["ntasks_stolen_local"] + jstats[
            "ntasks_stolen_remote"] > 0
    assert jstats["ntasks_dropped"] > 0 or strategy != "drop"
    out = t_moe.combine_shards(torch.from_numpy(y), ve, pos, weight, tcfg)
    assert rel(out.numpy(), np.concatenate(outs)) <= TOL


def test_load_balance_shares_sum_to_the_global_loss():
    """The shares of 4 shards, each from its own probabilities and the
    global counts, add up to ``load_balance_loss`` over all tokens, and
    so do their gradients."""
    rng = np.random.default_rng(9)
    E, k, t, G = 8, 2, 16, 4
    logits = torch.from_numpy(rng.standard_normal((G * t, E)).astype(
        np.float32)).requires_grad_(True)
    probs = torch.softmax(logits, -1)
    expert = torch.from_numpy(rng.integers(-1, E, (G * t, k)).astype(
        np.int32))
    want = t_bal.load_balance_loss(probs, expert, k)
    (g_want,) = torch.autograd.grad(want, logits, retain_graph=True)
    counts = sum(t_moe._expert_counts(expert[s * t:(s + 1) * t], E,
                                      torch.float32) for s in range(G))
    got = sum(t_moe.load_balance_share(probs[s * t:(s + 1) * t],
                                       expert[s * t:(s + 1) * t], k, counts,
                                       G * t) for s in range(G))
    (g_got,) = torch.autograd.grad(got, logits)
    assert float(got) == pytest.approx(float(want), rel=TOL)
    assert rel(g_got.numpy(), g_want.numpy()) <= TOL


# ---------------------------------------------------------------------------
# one-device and one-rank steps, bitwise
# ---------------------------------------------------------------------------

def _unrefactored_train_step(cfg, device, *, microbatches, total_steps):
    """``make_train_step(cfg, device)`` as it was before the sharded step
    shared its microbatch loop: the oracle of the one-device step."""
    warmup = max(1, min(2000, total_steps // 10))

    def value_and_grad(params, leaves, batch, rng):
        loss, metrics = t_tfm.loss_fn(params, cfg, batch, rng, ep_groups=1)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch, step):
        params.requires_grad_(True)
        leaves = t_tfm.tree_leaves(params)
        rng = prng.fold_in(prng.PRNGKey(17), int(step))
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if microbatches > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for p in leaves]
            lsum = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss, metrics, grads = value_and_grad(params, leaves, mb,
                                                      rng)
                for acc, g in zip(gsum, grads):
                    acc += g
                del grads
                lsum = lsum + loss
            grads = [g / microbatches for g in gsum]
            del gsum
            loss = lsum / microbatches
        else:
            loss, metrics, grads = value_and_grad(params, leaves, batch, rng)
        lr = cosine_schedule(step, total=total_steps, warmup=warmup).to(
            device)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, lr=lr)
        return params, opt_state, dict(metrics, loss=loss, lr=lr,
                                       **opt_metrics)

    return train_step


@pytest.fixture
def deterministic():
    """Bitwise whole-model gradients on the CPU (the embedding's
    ``index_put_(accumulate=True)`` backward)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _run_steps(step, params, opt, cfg, n=3):
    metrics = []
    for i in range(n):
        params, opt, m = step(params, opt, t_pipe.batch_for(
            cfg, i, TRAIN["B"], TRAIN["S"]), i)
        metrics.append({k: v.clone() for k, v in m.items()})
    return params, opt, metrics


@pytest.mark.parametrize("mb", (1, 2))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_the_one_device_step_is_bitwise_the_unrefactored_one(
        arch, mb, deterministic):
    cfg = t_cb.smoke_config(arch)
    runs = []
    for make in (t_steps.make_train_step, _unrefactored_train_step):
        params = port_params(jax_paths(jax_weights(arch)), arch)
        step = make(cfg, "cpu", microbatches=mb, total_steps=TRAIN["total"])
        runs.append(_run_steps(step, params, adamw_init(params), cfg))
    (p, o, m), (p0, o0, m0) = runs
    for got, want in zip(m, m0):
        assert got.keys() == want.keys()
        assert all(bitwise(got[k], want[k]) for k in want), (got, want)
    for a, b in zip(t_tfm.tree_leaves((p, o)), t_tfm.tree_leaves((p0, o0))):
        assert bitwise(a, b)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("mesh_shape", ((1, 1), (1, 1, 1)),
                         ids=["data_model", "pod_data_model"])
@pytest.mark.parametrize("mb", (1, 2))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_a_one_rank_mesh_step_is_bitwise_the_one_device_step(
        arch, mb, mesh_shape, world_of_one, deterministic):
    """3 sharded steps on a mesh of one rank (the flat all-reduce without
    pods, the tree one with) against ``make_train_step(cfg, "cpu")``:
    every metric, parameter and moment bit for bit, and the hints off
    after each step."""
    cfg = t_cb.smoke_config(arch)
    from torch.distributed.device_mesh import init_device_mesh

    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    params = port_params(jax_paths(jax_weights(arch)), arch)
    want = _run_steps(t_steps.make_train_step(
        cfg, "cpu", microbatches=mb, total_steps=TRAIN["total"]),
        params, adamw_init(params), cfg)
    params = port_params(jax_paths(jax_weights(arch)), arch)
    p, o = t_steps.shard_train_state(cfg, mesh, params, adamw_init(params))
    assert any(pl.is_shard() for _, leaf in t_tfm.tree_items(o.m)
               for pl in leaf.placements)
    got = _run_steps(t_steps.make_train_step(
        cfg, mesh, microbatches=mb, total_steps=TRAIN["total"]), p, o, cfg)
    assert not t_layers._AXIS_HINTS["on"]
    for g, w in zip(got[2], want[2]):
        assert g.keys() == w.keys()
        for k in w:
            assert bitwise(g[k].full_tensor() if hasattr(g[k], "full_tensor")
                           else g[k], w[k]), k
    for (path, a), b in zip(t_tfm.tree_items((got[0], got[1])),
                            t_tfm.tree_leaves((want[0], want[1]))):
        assert bitwise(a.full_tensor(), b.detach()), path


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_one_rank_mesh_prefill_and_serve_are_bitwise_generate(
        arch, world_of_one):
    """``generate_on_mesh`` on a (1, 1) mesh (weights as DTensors) against
    ``serve.generate``: ids equal, prefill logits bitwise."""
    cfg = t_cb.smoke_config(arch)
    params = port_params(jax_paths(jax_weights(arch)), arch)
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             t_pipe.batch_for(cfg, 0, SERVE["B"], SERVE["S"]).items()}
    want = t_serve.generate(params, cfg, batch, SERVE["gen"])
    dp = t_shd.distribute_tree(params, t_shd.param_shardings(
        params, cfg, mesh), mesh)
    got = t_serve.generate_on_mesh(dp, cfg, batch, SERVE["gen"], mesh)
    assert torch.equal(got.ids, want.ids)
    assert bitwise(got.prefill_logits, want.prefill_logits)
    assert got.launches == want.launches
    assert not t_layers._AXIS_HINTS["on"]


def test_mesh_steps_restore_the_hints_when_they_raise(world_of_one):
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    cfg = t_cb.smoke_config("gemma2_2b")
    outer = dict(dp_axes=("data",), dp_size=3, tp_size=5, mesh=None)
    t_layers.set_axis_hints(**outer)
    before = dict(t_layers._AXIS_HINTS)
    params = port_params(jax_paths(jax_weights("gemma2_2b")), "gemma2_2b")
    with pytest.raises(KeyError):
        t_steps.make_prefill_step(cfg, mesh, 20)(params, {"frames": []})
    assert t_layers._AXIS_HINTS == before
    p, o = t_steps.shard_train_state(cfg, mesh, params, adamw_init(params))
    with pytest.raises(ValueError, match="3 microbatches"):
        t_steps.make_train_step(cfg, mesh, microbatches=3)(
            p, o, t_pipe.batch_for(cfg, 0, 4, 8), 0)
    assert t_layers._AXIS_HINTS == before


# ---------------------------------------------------------------------------
# meshes of the drivers, checkpoints on a mesh
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("n,shape", ((1, (1, 1)), (2, (1, 2)), (8, (4, 2)),
                                     (16, (8, 2))))
def test_build_mesh_splits_the_world_as_jax_does(n, shape, fake_world):
    """Without ``--production``: no process group, no mesh (the one-device
    step); a world of n ranks, ``(max(1, n // 2) if n > 1 else 1, n //
    d)`` over ``("data", "model")``, the JAX formula over n devices."""
    assert t_train.build_mesh(False, True, "cpu") is None
    fake_world(n - 1, n)
    mesh = t_train.build_mesh(False, True, "cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == shape
    d = max(1, n // 2) if n > 1 else 1
    assert shape == (d, n // d)


def test_build_mesh_production_on_a_world_of_256(fake_world):
    fake_world(17, 256)
    mesh = t_train.build_mesh(True, False, "cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (16, 16)


@pytest.mark.parametrize("argv,need", (
    (["--production"], 256), (["--production", "--multi-pod"], 512)))
def test_train_production_is_refused_on_a_small_world(argv, need,
                                                      world_of_one):
    with pytest.raises(RuntimeError, match=f"needs {need} ranks"):
        t_train.main(["--arch", "gemma2_2b", "--smoke", "--steps", "1",
                      "--device", "cpu"] + argv)


def test_serve_production_is_refused_on_a_small_world(world_of_one):
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        t_serve.main(["--smoke", "--production", "--device", "cpu"])


def test_dp_index_is_the_row_major_data_shard(fake_world):
    """Rank r of a (2, 2, 2) world holds mesh coordinate r, so its data
    shard is pod * 2 + data = r // 2."""
    for r in range(8):
        fake_world(r, 8)
        mesh = t_mesh.make_test_mesh(2, 2, multi_pod=True, device="cpu")
        assert t_mesh.dp_index(mesh) == r // 2


@pytest.mark.parametrize("change", ("no_shard_routing", "dp_groups_1"))
def test_a_rank_of_a_data_parallel_step_routes_its_own_tokens_only(
        change, fake_world):
    """On a rank of a 4-way data-parallel mesh, an MoE layer without
    ``shard_routing`` (or told of one data group) would need the other
    ranks' tokens: refused before any collective."""
    fake_world(0, 8)
    mesh = t_mesh.make_test_mesh(2, 2, multi_pod=True, device="cpu")
    cfg = t_cb.smoke_config(MOE)
    dp_groups = 4
    if change == "no_shard_routing":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, shard_routing=False))
    else:
        dp_groups = 1
    p = t_moe.moe_init(cfg, torch.Generator().manual_seed(0), "cpu")
    with t_layers.axis_hints(dp_axes=("pod", "data"), dp_size=4, tp_size=2,
                             mesh=mesh):
        assert t_layers.rank_local()
        with pytest.raises(ValueError, match="routes its own tokens"):
            t_moe.moe_apply(p, torch.zeros(2, 4, cfg.d_model), cfg,
                            ep_groups=2, rng=prng.PRNGKey(0),
                            dp_groups=dp_groups)


def test_a_dtensor_checkpoint_restores_as_saved_on_one_rank(tmp_path,
                                                            world_of_one):
    """A state of DTensors saved (gathered, rank 0 writes) reads back with
    ``restore`` as plain tensors and with ``restore_resharded`` as
    DTensors, both bitwise; a missing checkpoint restores as None."""
    cfg = t_cb.smoke_config(MOE)
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    params = port_params(jax_paths(jax_weights(MOE)), MOE)
    opt = adamw_init(params)
    for i, leaf in enumerate(t_tfm.tree_leaves(opt.v)):
        leaf.fill_(0.5 + i)
    p, o = t_steps.shard_train_state(cfg, mesh, params, opt)
    d = str(tmp_path / "ckpt")
    assert t_ckpt.restore_resharded(d, {"params": p, "opt": o}, None,
                                    mesh) == (None, None)
    t_ckpt.save(d, 7, {"params": p, "opt": o})
    plain, step = t_ckpt.restore(d, {"params": params, "opt": opt})
    assert step == 7
    specs = {"params": t_shd.param_shardings(p, cfg, mesh),
             "opt": t_shd.opt_shardings(o, p, cfg, mesh)}
    placed, step = t_ckpt.restore_resharded(d, {"params": p, "opt": o},
                                            specs, mesh)
    assert step == 7
    for a, b, c in zip(t_tfm.tree_leaves({"params": params, "opt": opt}),
                       t_tfm.tree_leaves(plain), t_tfm.tree_leaves(placed)):
        assert bitwise(b, a.detach()) and bitwise(c.full_tensor(),
                                                  a.detach())
