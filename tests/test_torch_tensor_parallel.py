"""Tensor and expert parallelism over ``"model"`` in the mesh-bound steps
(``repro_torch.launch.steps`` with each rank's ``"model"`` pieces, the
region operations of ``repro_torch.models.tensor_parallel``, the
column/row-parallel layers, the vocab-parallel embedding, logits,
cross-entropy and argmax, and the expert-parallel MoE layer) against the
JAX package on the CPU.

The multi-rank checks share one launch: 8 gloo ranks as the (2, 4)
``("data", "model")`` mesh (``OMP_NUM_THREADS=1``, a ``file://`` store)
beside one JAX process with 8 host devices on a (2, 4) mesh of
``AxisType.Auto`` axes.  It runs once for the whole test run, whichever
test process asks first (a file lock under the run's shared temporary
directory), and its results are read by several tests.  The JAX weights
are made once here and carried to both packages.

The smoke configs of gemma2_2b (H 4, KV 2: tp = 4 takes the GQA + TP
expansion), moonshot_v1_16b_a3b (8 experts, 2 a rank) and hubert_xlarge
(bidirectional attention, the audio frontend) each train 2 steps with 1
and with 2 microbatches; gemma2_2b and moonshot prefill and decode 4
greedy steps, hubert runs the prefill step's one forward.

Tolerances: ``TOL`` = 1e-5 for float32 sums taken in another order (of
the largest magnitude, per loss, parameter leaf and AdamW moment); greedy
ids, routing tables and counters equal; prefill logits within 2e-4.
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
pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")

from repro.configs import base as j_cb  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.launch import sharding as t_shd  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TOL = 1e-5
LOGIT_TOL = 2e-4
MOE = "moonshot_v1_16b_a3b"
ARCHS = ("gemma2_2b", MOE, "hubert_xlarge")
DECODERS = ("gemma2_2b", MOE)
MESH = (2, 4)
TP = MESH[1]
#: the train batch: 8 rows of 16, so 2 microbatches give each of the 2
#: data shards 2 rows; warmup is 2 of 20 steps
TRAIN = dict(B=8, S=16, steps=2, total=20)
#: the serve batch: 4 lanes (2 a data shard), a 16-token prompt, the
#: prefill's token and 4 greedy decode steps'
SERVE = dict(B=4, S=16, gen=5)
DEADLINE_S = 240


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_weights(arch):
    """The JAX package's weights (``PRNGKey(0)``) for the smoke ``arch``;
    gemma2's embeddings scaled down so greedy decoding does not repeat its
    last token (as ``tests/test_torch_serve.py`` does)."""
    p = j_tfm.init_params(j_cb.smoke_config(arch), jax.random.PRNGKey(0))
    if arch == "gemma2_2b":
        p = dict(p, embed=p["embed"] * 0.02)
    flat, _ = jax.tree_util.tree_flatten_with_path(p)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


# ---------------------------------------------------------------------------
# the launch: 8 gloo ranks beside one JAX process, once per test run
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import base as cb
from repro_torch.core import prng
from repro_torch.data.pipeline import batch_for
from repro_torch.launch import serve, sharding as shd, steps
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers, moe, tensor_parallel as tpo
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init

rank, tmp = int(sys.argv[1]), sys.argv[2]
T, SV, ARCHS, DECODERS, MOE = (json.loads(a) for a in sys.argv[3:8])
torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=8)

# every gather over "model" of a leaf split there, while STEP[0] is on
GATHERS, STEP = [], [False]
_redistribute, _full_tensor = DTensor.redistribute, DTensor.full_tensor


def _model_dim(d):
    return list(d.device_mesh.mesh_dim_names).index("model")


def redistribute(self, device_mesh=None, placements=None, **kw):
    if STEP[0] and placements is not None:
        i = _model_dim(self)
        if self.placements[i].is_shard() and not placements[i].is_shard():
            GATHERS.append(tuple(self.shape))
    return _redistribute(self, device_mesh, placements, **kw)


def full_tensor(self, **kw):
    if STEP[0] and self.placements[_model_dim(self)].is_shard():
        GATHERS.append(tuple(self.shape))
    return _full_tensor(self, **kw)


DTensor.redistribute, DTensor.full_tensor = redistribute, full_tensor


def counted(fn):
    def call(*args):
        STEP[0] = True
        try:
            return fn(*args)
        finally:
            STEP[0] = False
    return call


def weights(arch):
    w = np.load(f"{tmp}/weights_{arch}.npz")
    like = tfm.init_params(cb.smoke_config(arch), None, "meta")
    return tfm.tree_unflatten(like, [torch.from_numpy(w[".".join(path)])
                                     for path, _ in tfm.tree_items(like)])


def full(tree):
    # copies: a replicated leaf's full_tensor is its local storage, which
    # a later step would update in place
    return {".".join(p): v.full_tensor().clone() for p, v in
            tfm.tree_items(tree)}


out = {}
try:
    mesh = make_test_mesh(*T["mesh"], device="cpu")
    tp = T["mesh"][1]
    r_model = mesh.get_local_rank("model")
    out["coord"] = np.asarray(mesh.get_coordinate())
    for arch in ARCHS:
        cfg = cb.smoke_config(arch)
        params = weights(arch)
        # a rank's "model" piece of each leaf
        p = shd.distribute_tree(params, shd.param_shardings(params, cfg,
                                                             mesh), mesh)
        sizes = [(shd.is_model_split(d), shd.model_piece(d).numel(),
                  w.numel()) for d, w in zip(tfm.tree_leaves(p),
                                             tfm.tree_leaves(params))]
        out[f"{arch}/pieces"] = np.asarray(sizes)
        for mb in (1, 2):
            # fresh weights: the state of a replicated leaf shares them
            params = weights(arch)
            p, o = steps.shard_train_state(cfg, mesh, params,
                                           adamw_init(params))
            step = counted(steps.make_train_step(
                cfg, mesh, microbatches=mb, total_steps=T["total"]))
            for i in range(T["steps"]):
                p, o, m = step(p, o, batch_for(cfg, i, T["B"], T["S"]), i)
                for k, v in m.items():
                    out[f"{arch}/train{mb}/{i}/{k}"] = np.asarray(float(v))
            for k, v in full(p).items():
                out[f"{arch}/train{mb}/param/{k}"] = v.numpy()
            for k, v in full(o.m).items():
                out[f"{arch}/train{mb}/m/{k}"] = v.numpy()
            for k, v in full(o.v).items():
                out[f"{arch}/train{mb}/v/{k}"] = v.numpy()
        params = weights(arch)
        p = shd.distribute_tree(params, shd.param_shardings(params, cfg,
                                                             mesh), mesh)
        batch = {k: torch.as_tensor(v) for k, v in
                 batch_for(cfg, 0, SV["B"], SV["S"]).items()}
        if cfg.encoder_only:
            logits = counted(steps.make_prefill_step(cfg, mesh, SV["S"]))(
                p, batch)
            out[f"{arch}/logits"] = logits.full_tensor().numpy()
        else:
            make = (steps.make_prefill_step, steps.make_serve_step)
            steps.make_prefill_step = lambda *a: counted(make[0](*a))
            steps.make_serve_step = lambda *a: counted(make[1](*a))
            try:
                g = serve.generate_on_mesh(p, cfg, batch, SV["gen"], mesh)
            finally:
                steps.make_prefill_step, steps.make_serve_step = make
            out[f"{arch}/ids"] = g.ids.numpy()
            out[f"{arch}/logits"] = g.prefill_logits.numpy()
    out["gathers"] = np.asarray(len(GATHERS))
    # the counter's own check: a gathered leaf is counted
    STEP[0] = True
    steps._full(p["lm_head"] if "lm_head" in p else p["embed"])
    STEP[0] = False
    out["gathers_control"] = np.asarray(len(GATHERS))

    # the vocab-parallel cross-entropy and argmax at shard boundaries
    cfg = cb.smoke_config("gemma2_2b")
    V, N = cfg.vocab, 6
    n = V // tp
    lo = r_model * n
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((N, V), generator=g)
    targets = torch.tensor([0, n - 1, n, 2 * n - 1, V - 1, 3 * n + 7])
    # maxima tied across ranks (rows 0-2) and within one (row 3)
    for row, ids in ((0, (10, n + 10)), (1, (n - 1, n)), (2, (2 * n, V - 1)),
                     (3, (5, 6)), (4, (3 * n + 1, 3 * n + 1))):
        logits[row, list(ids)] = 9.0
    with steps._hints(mesh, tp=True):
        local = logits[:, lo:lo + n].clone().requires_grad_(True)
        loss = tfm._ce_mean_tp.apply(local, targets, mesh, lo)
        (grad,) = torch.autograd.grad(loss, local)
        ids = tfm.greedy_ids(logits[:, lo:lo + n], cfg)
    whole = logits.clone().requires_grad_(True)
    want = tfm._ce_mean.apply(whole, targets)
    (wgrad,) = torch.autograd.grad(want, whole)
    out["ce/loss"] = np.asarray([float(loss), float(want)])
    out["ce/grad"] = grad.numpy()
    out["ce/want_grad"] = wgrad[:, lo:lo + n].numpy()
    out["ce/ids"] = ids.numpy()
    out["ce/want_ids"] = torch.argmax(logits, -1).numpy()

    # the expert-parallel MoE layer against the whole one on the rank's
    # rows: routing tables, output, gradients
    cfg = cb.smoke_config(MOE)
    params = weights(MOE)
    lp = tfm._index(params["streams"][0], 0)["mlp"]
    d = shd.distribute_tree(params, shd.param_shardings(params, cfg, mesh),
                            mesh)
    pieces = tfm._index(tfm.tree_map(shd.model_piece, d)["streams"][0],
                        0)["mlp"]
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(
                        11 + steps.dp_index(mesh)))
    rng = prng.fold_in(prng.PRNGKey(17), 0)
    tables, route = [], moe.route_dispatch_shard

    def record(*a, **kw):
        res = route(*a, **kw)
        tables.append(torch.stack([res[1], res[2]]))
        return res

    moe.route_dispatch_shard = record
    runs = {}
    for name, (w, tp_on) in {"ep": (pieces, True), "whole": (lp, False)
                             }.items():
        xi = x.clone().requires_grad_(True)
        wi = {k: v.detach().requires_grad_(True) if torch.is_tensor(v)
              else v for k, v in w.items()}
        with steps._hints(mesh, tp=tp_on):
            y, aux = moe.moe_apply(wi, xi, cfg, ep_groups=tp, rng=rng,
                                   dp_groups=2)
        gx, grt = torch.autograd.grad((y * y).sum(), [xi, wi["router"]])
        runs[name] = (y.detach(), gx, grt, tables.pop(), aux)
    moe.route_dispatch_shard = route
    for i, k in enumerate(("out", "dx", "drouter", "tables")):
        out[f"ep/{k}"] = runs["ep"][i].numpy()
        out[f"ep/want_{k}"] = runs["whole"][i].numpy()
    out["ep/aux"] = np.asarray([float(runs["ep"][4][k]) for k in
                                tfm.AUX_KEYS])
    out["ep/want_aux"] = np.asarray([float(runs["whole"][4][k]) for k in
                                     tfm.AUX_KEYS])

    # ops (i)-(iv): values and gradients, and the plain inputs of every
    # model rank to hold them to autograd of the plain version
    def seeded(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed), dtype=torch.float64)

    same = seeded((3, 8), 100)                    # every rank's x
    own = seeded((3, 8), 200 + r_model)            # the rank's x
    w_own = seeded((3, 8), 300 + r_model)
    w_cat = seeded((3, 8 * tp), 400 + r_model)
    x = same.clone().requires_grad_(True)
    (out["ops/into_grad"],) = [t.numpy() for t in torch.autograd.grad(
        (tpo.into_tp(x, mesh) * w_own).sum(), [x])]
    x = own.clone().requires_grad_(True)
    y = tpo.out_of_tp(x, mesh)
    out["ops/out_value"] = y.detach().numpy()
    (out["ops/out_grad"],) = [t.numpy() for t in torch.autograd.grad(
        (y * same).sum(), [x])]
    out["ops/max_value"] = tpo.max_over_model(own, mesh).numpy()
    x = own.clone().requires_grad_(True)
    y = tpo.gather_over_model(x, mesh, dim=1)
    out["ops/gather_value"] = y.detach().numpy()
    (out["ops/gather_grad"],) = [t.numpy() for t in torch.autograd.grad(
        (y * w_cat).sum(), [x])]
    # at a "model" axis of one rank every op is the identity; without
    # one, each raises
    mesh81 = init_device_mesh("cpu", (8, 1), mesh_dim_names=("data",
                                                             "model"))
    out["ops/identity"] = np.asarray(all(
        op(own, mesh81) is own for op in (tpo.into_tp, tpo.out_of_tp,
                                           tpo.gather_over_model)) and
        torch.equal(tpo.max_over_model(own, mesh81), own))
    mesh8 = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    raised = 0
    for op in (tpo.into_tp, tpo.out_of_tp, tpo.max_over_model,
               tpo.gather_over_model):
        try:
            op(own, mesh8)
        except ValueError:
            raised += 1
    out["ops/raised"] = np.asarray(raised)
    out["ops/same"] = same.numpy()
    out["ops/own"] = own.numpy()
    out["ops/w_own"] = w_own.numpy()
    out["ops/w_cat"] = w_cat.numpy()
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
T, SV, ARCHS, DECODERS, MOE = (json.loads(a) for a in sys.argv[2:7])
mesh = jax.make_mesh(tuple(T["mesh"]), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
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


def shapes(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


out = {}
with jax.set_mesh(mesh):
    for arch in ARCHS:
        cfg = cb.smoke_config(arch)
        for mb in (1, 2):
            try:
                _, jit_for, (_, _, p_shard, o_shard) = steps.make_train_step(
                    cfg, mesh, microbatches=mb, total_steps=T["total"],
                    donate=False)
                batches = [batch_for(cfg, i, T["B"], T["S"])
                           for i in range(T["steps"])]
                jstep = jit_for(shapes(batches[0]))
                p = jax.device_put(weights(arch), p_shard)
                o = jax.device_put(adamw_init(p), o_shard)
                for i, b in enumerate(batches):
                    p, o, m = jstep(p, o, b, jnp.int32(i))
                    for k, v in m.items():
                        out[f"{arch}/train{mb}/{i}/{k}"] = np.asarray(v)
                flat(f"{arch}/train{mb}/param", p, out)
                flat(f"{arch}/train{mb}/m", o.m, out)
                flat(f"{arch}/train{mb}/v", o.v, out)
            finally:
                layers.clear_axis_hints()
        try:
            batch = {k: jnp.asarray(v) for k, v in
                     batch_for(cfg, 0, SV["B"], SV["S"]).items()}
            p = weights(arch)
            if cfg.encoder_only:
                _, pf_for, _ = steps.make_prefill_step(cfg, mesh, SV["S"])
                out[f"{arch}/logits"] = np.asarray(
                    pf_for(shapes(batch))(p, batch), np.float32)
                continue
            max_len = SV["S"] + SV["gen"]
            _, pf_for, _ = steps.make_prefill_step(cfg, mesh, max_len)
            _, serve_step, _ = steps.make_serve_step(cfg, mesh, SV["B"],
                                                     max_len)
            logits, state = pf_for(shapes(batch))(p, batch)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            ids = [np.asarray(tok)]
            for _ in range(SV["gen"] - 1):
                tok, state = serve_step(p, state, tok)
                ids.append(np.asarray(tok))
            out[f"{arch}/ids"] = np.stack(ids, axis=1)
            out[f"{arch}/logits"] = np.asarray(logits, np.float32)
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
    for arch in ARCHS:
        np.savez(os.path.join(tmp, f"weights_{arch}.npz"),
                 **jax_weights(arch))
    args = [json.dumps(a) for a in (dict(TRAIN, mesh=MESH), SERVE, ARCHS,
                                    DECODERS, MOE)]
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
    root = base.parent / f"tensor_parallel_{uid}" if uid else base / "tp"
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


def adamw_of(p0, m, v, lr, n_steps: int):
    """The parameters AdamW (``b1`` 0.9, ``b2`` 0.95, ``eps`` 1e-8, weight
    decay 0.1) makes of the initial ``p0`` when only the last of
    ``n_steps`` steps has a learning rate (``lr``; the warmup's first is
    0) and ``m``, ``v`` are the moments after it, in float64."""
    p0, m, v = (np.asarray(a, np.float64) for a in (p0, m, v))
    mhat = m / (1 - 0.9 ** n_steps)
    vhat = v / (1 - 0.95 ** n_steps)
    return p0 - lr * (mhat / (np.sqrt(vhat) + 1e-8) + 0.1 * p0)


@pytest.mark.parametrize("mb", (1, 2))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_steps_on_a_2x4_mesh_match_jax(launched, arch, mb):
    """2 steps on the (2, 4) mesh, each rank computing its pieces: the
    losses, ``lr``, ``grad_norm``, ``ce`` and ``lb_loss`` within ``TOL``
    and the routing counters equal at every step; every AdamW moment
    within ``TOL`` after the second; every parameter within ``TOL`` of
    AdamW of those moments (as it is for JAX's own parameters and
    moments); every rank reports the same.

    The parameters are held through the moments: the warmup's first step
    has a learning rate of 0, so after the second each parameter is
    AdamW's elementwise normalisation of its moments, which turns a
    moment element 100 times smaller than its leaf's largest into an
    update as large as the largest, with its relative error (a
    zero-initialised norm scale's parameters differ from JAX's by up to
    3.6e-5 of the leaf's largest here, and JAX's own (1, 1) and (2, 4)
    meshes by up to 1.4e-5, while every moment agrees within 3e-6)."""
    jx = np.load(launched / "jax.npz")
    ranks = _ranks(launched)
    for i in range(TRAIN["steps"]):
        for k in METRICS:
            want = float(jx[f"{arch}/train{mb}/{i}/{k}"])
            got = [float(r[f"{arch}/train{mb}/{i}/{k}"]) for r in ranks]
            assert len(set(got)) == 1, (i, k, got)
            if k in COUNTERS:
                assert got[0] == want, (i, k, got[0], want)
            else:
                assert got[0] == pytest.approx(want, rel=TOL, abs=1e-12), \
                    (i, k)
    if arch == MOE:
        assert float(jx[f"{arch}/train{mb}/0/ntasks_stolen_local"]) \
            + float(jx[f"{arch}/train{mb}/0/ntasks_stolen_remote"]) > 0
    for part in ("param", "m", "v"):
        prefix = f"{arch}/train{mb}/{part}/"
        names = [k[len(prefix):] for k in jx.files if k.startswith(prefix)]
        assert len(names) > 10
        for name in names:
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[prefix + name],
                                              ranks[0][prefix + name])
            if part != "param":
                assert rel(ranks[0][prefix + name], jx[prefix + name]) \
                    <= TOL, (part, name)
    n = TRAIN["steps"]
    assert float(jx[f"{arch}/train{mb}/0/lr"]) == 0.0 and n == 2
    lr = float(ranks[0][f"{arch}/train{mb}/{n - 1}/lr"])
    p0 = jax_weights(arch)
    for name in p0:
        for got in (ranks[0], jx):
            key = f"{arch}/train{mb}/%s/{name}"
            want = adamw_of(p0[name], got[key % "m"], got[key % "v"], lr, n)
            assert rel(got[key % "param"], want) <= TOL, name


@pytest.mark.parametrize("arch", DECODERS)
def test_tp_prefill_and_greedy_decode_match_jax(launched, arch):
    """``serve.generate_on_mesh`` (the prefill and 4 serve steps, each
    rank with its heads, vocab columns and experts) against the JAX steps
    on the (2, 4) mesh: greedy ids equal, prefill logits within 2e-4."""
    jx = np.load(launched / "jax.npz")
    want = jx[f"{arch}/ids"]
    assert want.shape == (SERVE["B"], SERVE["gen"])
    assert len(np.unique(want)) > 1
    for r in _ranks(launched):
        np.testing.assert_array_equal(r[f"{arch}/ids"], want)
        np.testing.assert_allclose(r[f"{arch}/logits"],
                                   jx[f"{arch}/logits"], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_tp_encoder_forward_matches_jax(launched):
    """hubert_xlarge's prefill step, one bidirectional forward over the
    audio frontend, with the rank's heads and vocab columns (gathered for
    the result): every position's logits within 2e-4 of the JAX step."""
    jx = np.load(launched / "jax.npz")
    want = jx["hubert_xlarge/logits"]
    assert want.shape == (SERVE["B"], SERVE["S"], 256)
    for r in _ranks(launched):
        np.testing.assert_allclose(r["hubert_xlarge/logits"], want,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_no_model_split_leaf_is_gathered_over_model_in_a_step(launched):
    """No ``full_tensor`` or ``redistribute`` of a leaf split over
    ``"model"`` to a layout whole over ``"model"`` runs inside the train,
    prefill or serve steps of any of the three configs; the counter sees
    one such gather when the test makes it."""
    for r in _ranks(launched):
        assert int(r["gathers"]) == 0
        assert int(r["gathers_control"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_a_rank_piece_of_a_split_leaf_has_one_tp_th_of_its_elements(
        launched, arch):
    """``sharding.model_piece`` of each leaf the rules split over
    ``"model"`` holds 1/tp of its elements, every other leaf all of them;
    the rules split the leaves of attention, MLP, vocabulary and
    experts."""
    for r in _ranks(launched):
        sizes = r[f"{arch}/pieces"]
        split = sizes[:, 0].astype(bool)
        assert split.sum() >= 5 and (~split).sum() >= 3
        np.testing.assert_array_equal(sizes[split, 1] * TP, sizes[split, 2])
        np.testing.assert_array_equal(sizes[~split, 1], sizes[~split, 2])


def test_vocab_parallel_ce_and_argmax_hold_at_shard_boundaries(launched):
    """The vocab-parallel cross-entropy over each rank's 64 of 256
    columns, with targets at the first and last rows of shards: the loss
    of the whole logits within 1e-6 on every rank and the rank's columns
    of its gradient within 1e-6; the greedy ids with maxima tied across
    two ranks (and within one) the lowest id, as ``jnp.argmax`` takes
    it."""
    n = 256 // TP
    for r in _ranks(launched):
        got, want = r["ce/loss"]
        assert got == pytest.approx(want, rel=1e-6)
        assert rel(r["ce/grad"], r["ce/want_grad"]) <= 1e-6
        np.testing.assert_array_equal(r["ce/ids"], r["ce/want_ids"])
        assert list(r["ce/ids"][:5]) == [10, n - 1, 2 * n, 5, 3 * n + 1]


def test_ep_combine_matches_the_whole_layer(launched):
    """moonshot's MoE layer with 2 of its 8 experts a rank against the
    layer with every expert on the rank's rows: routing tables and
    counters equal, the output and the gradients of the tokens and the
    router within ``TOL``; some token's two experts live on different
    model ranks (its combine is summed across them)."""
    across = 0
    for r in _ranks(launched):
        np.testing.assert_array_equal(r["ep/tables"], r["ep/want_tables"])
        np.testing.assert_array_equal(r["ep/aux"][1:], r["ep/want_aux"][1:])
        assert r["ep/aux"][0] == pytest.approx(r["ep/want_aux"][0],
                                               rel=TOL)
        for k in ("out", "dx", "drouter"):
            assert rel(r[f"ep/{k}"], r[f"ep/want_{k}"]) <= TOL, k
        experts = r["ep/tables"][0] % 8          # (T, k) global ids
        kept = (r["ep/tables"][0] >= 0).all(axis=1)
        owner = experts // 2
        across += int((kept & (owner[:, 0] != owner[:, 1])).sum())
    assert across > 0


def _model_group(ranks):
    """The ranks of each data shard's model group, by coordinate."""
    groups = {}
    for r in ranks:
        data, model = (int(c) for c in r["coord"])
        groups.setdefault(data, {})[model] = r
    return [[g[m] for m in range(TP)] for g in groups.values()]


@pytest.mark.parametrize("op", ("into_tp", "out_of_tp", "max_over_model",
                                "gather_over_model"))
def test_region_ops_match_autograd_of_the_plain_version(launched, op):
    """Each region operation over the ranks of one model group against
    the plain single-process function of every rank's inputs, its
    gradient that of the sum of the ranks' losses (the loss after
    ``out_of_tp`` counted once): (i) ``into_tp`` the sum of the ranks'
    weights, (ii) ``out_of_tp`` the sum and the weight itself, (iii) the
    maximum, (iv) ``gather_over_model`` the concatenation and each rank's
    block of the summed weights; the identity on a one-rank ``"model"``
    axis, a ``ValueError`` on a mesh without one."""
    for group in _model_group(_ranks(launched)):
        same = torch.from_numpy(group[0]["ops/same"])
        own = [torch.from_numpy(r["ops/own"]).requires_grad_(True)
               for r in group]
        w_own = [torch.from_numpy(r["ops/w_own"]) for r in group]
        w_cat = [torch.from_numpy(r["ops/w_cat"]) for r in group]
        for r in group:
            assert bool(r["ops/identity"]) and int(r["ops/raised"]) == 4
        if op == "into_tp":
            x = same.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(sum((x * w).sum() for w in w_own),
                                       [x])
            for r in group:
                np.testing.assert_allclose(r["ops/into_grad"], g.numpy(),
                                           rtol=1e-12)
        elif op == "out_of_tp":
            y = sum(own)
            grads = torch.autograd.grad((y * same).sum(), own)
            for r, gr in zip(group, grads):
                np.testing.assert_allclose(r["ops/out_value"],
                                           y.detach().numpy(), rtol=1e-12)
                np.testing.assert_allclose(r["ops/out_grad"], gr.numpy(),
                                           rtol=1e-12)
        elif op == "max_over_model":
            want = torch.stack([o.detach() for o in own]).amax(0)
            for r in group:
                np.testing.assert_array_equal(r["ops/max_value"],
                                              want.numpy())
        else:
            y = torch.cat(own, dim=1)
            grads = torch.autograd.grad(sum((y * w).sum() for w in w_cat),
                                        own)
            for r, gr in zip(group, grads):
                np.testing.assert_array_equal(r["ops/gather_value"],
                                              y.detach().numpy())
                np.testing.assert_allclose(r["ops/gather_grad"],
                                           gr.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# the plans, without a launch
# ---------------------------------------------------------------------------

class _Region:
    """A region's size and rank without a mesh (what the plans read)."""

    def __init__(self, size, rank):
        self.size, self.rank, self.mesh = size, rank, None


#: (config, tp): the kind of each full-width config's attention split at
#: the production mesh's tp = 16, and the smoke configs' at 2 and 4
PLAN_CASES = (
    ("gemma2_2b", 16, "all", 8, 4),          # H 8: replicated heads
    ("yi_9b", 16, "expand", 2, 2),           # H 32, KV 4
    ("mistral_nemo_12b", 16, "expand", 2, 2),
    ("moonshot_v1_16b_a3b", 16, "aligned", 1, 1),
    ("hubert_xlarge", 16, "aligned", 1, 1),
    ("gemma2_2b_smoke", 4, "expand", 1, 1),
    ("gemma2_2b_smoke", 2, "aligned", 2, 1),
)


@pytest.mark.parametrize("arch,tp,kind,n_q,n_kv", PLAN_CASES)
def test_head_plan_places_the_heads_as_the_jax_rules_do(arch, tp, kind, n_q,
                                                        n_kv):
    cfg = (t_cb.smoke_config(arch[:-6]) if arch.endswith("_smoke")
           else t_cb.get(arch))
    for rank in range(tp):
        plan = t_layers.head_plan(cfg, _Region(tp, rank))
        assert (plan.kv, plan.n_q, plan.n_kv) == (kind, n_q, n_kv)
        assert plan.q_lo == (0 if kind == "all" else rank * n_q)
    assert t_layers.head_plan(cfg, None) is None


@pytest.mark.parametrize("H,KV,tp", ((4, 2, 4), (32, 4, 16), (12, 3, 2),
                                     (8, 8, 4), (6, 2, 4)))
def test_take_kv_heads_is_the_jax_expansion_sliced(H, KV, tp):
    """A rank's k / v heads are its block of ``jnp.repeat(k, H // KV)``
    (the JAX package's GQA + TP expansion) under ``"expand"``, its block
    of the KV heads under ``"aligned"``, all of them under ``"all"``."""
    cfg = dataclasses.replace(t_cb.smoke_config("yi_9b"), n_heads=H,
                              n_kv_heads=KV)
    y = np.random.default_rng(H * KV + tp).standard_normal(
        (2, KV, 3, 5)).astype(np.float32)
    expanded = np.asarray(jax.numpy.repeat(y, H // KV, axis=1))
    for rank in range(tp):
        plan = t_layers.head_plan(cfg, _Region(tp, rank))
        got = t_layers.take_kv_heads(torch.from_numpy(y), cfg, plan, rank,
                                     1).numpy()
        if plan.kv == "expand":
            want = expanded[:, plan.q_lo:plan.q_lo + plan.n_q]
        elif plan.kv == "aligned":
            want = y[:, rank * plan.n_kv:(rank + 1) * plan.n_kv]
        else:
            want = y
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", tuple(t_cb.ARCH_IDS))
def test_every_family_but_rwkv6_and_hymba_computes_over_model(arch):
    cfg = t_cb.get(arch)
    assert t_shd.tp_compute(cfg) == (arch not in ("rwkv6_1_6b",
                                                  "hymba_1_5b"))


def test_a_region_needs_a_model_axis_of_more_than_one_rank():
    """Without a ``tp_mesh`` (or with the hints off) there is no region,
    so the layers take whole weights."""
    assert t_layers.tp_region() is None
    with t_layers.axis_hints(dp_axes=("data",), dp_size=2, tp_size=4,
                             mesh=None):
        assert t_layers.tp_region() is None
        assert t_tfm.vocab_piece(t_cb.smoke_config("gemma2_2b")) is None
        assert t_layers.seq_plan(16) is None


@pytest.mark.parametrize("H,KV,tp", ((4, 2, 2), (4, 2, 4), (8, 2, 4),
                                     (8, 8, 16)))
def test_shard_decode_state_cuts_a_whole_state_to_the_jax_piece(H, KV, tp):
    """A whole decode state (every KV head, as one device's prefill makes
    it) placed on each rank of a (1, tp) mesh is the rank's piece of
    ``decode_state_shardings``: every KV head of every lane, and the
    rank's block of the slots where tp divides them (one ``max_len`` it
    divides, one it does not: the full layers' cache then stays whole,
    as JAX replicates it), shaped as ``init_decode_state`` on the mesh
    makes a rank's state; whatever head plan tp gives."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as t_mesh
    from repro_torch.launch import steps as t_steps

    cfg = dataclasses.replace(t_cb.smoke_config("gemma2_2b"), n_heads=H,
                              n_kv_heads=KV)
    B = 2
    split = 0
    try:
        for max_len in (2 * tp, 2 * tp + 1):
            state = t_tfm.init_decode_state(cfg, B, max_len)
            g = torch.Generator().manual_seed(H * KV + tp + max_len)
            state = t_tfm.DecodeState(caches=tuple(
                {k: torch.randn(v.shape, generator=g).to(v.dtype)
                 for k, v in c.items()} for c in state.caches),
                length=state.length)
            for rank in range(tp):
                dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                        world_size=tp)
                mesh = t_mesh.make_test_mesh(1, tp, device="cpu")
                specs = t_shd.decode_state_shardings(state, cfg, mesh)
                got = t_steps.shard_decode_state(cfg, mesh, state)
                empty = t_steps.init_decode_state(cfg, mesh, B, max_len,
                                                  device="cpu")
                for c, w, e, sp in zip(got.caches, state.caches,
                                       empty.caches, specs.caches):
                    for k in t_tfm.CACHE_KEYS:
                        whole = w[k].numpy()
                        C = whole.shape[3]
                        assert sp[k][3] == ("model" if C % tp == 0
                                            else None)
                        if sp[k][3] == "model":
                            n = C // tp
                            want = whole[:, :, :, rank * n:(rank + 1) * n]
                            split += 1
                        else:
                            want = whole
                        assert c[k].shape[2] == KV
                        np.testing.assert_array_equal(c[k].numpy(), want)
                        assert c[k].shape == e[k].shape
                dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert split > 0
