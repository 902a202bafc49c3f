"""The KV caches' sequence split over ``"model"`` in the mesh-bound prefill
and serve steps (``repro_torch.models.layers.seq_plan``, the cache layout
of ``attn_cache_init`` / ``attn_cache_from_prefill``, the split decode of
``attn_decode`` with the exact merge of ``kernels.ref``, and
``repro_torch.launch.steps.shard_decode_state`` / ``init_decode_state``)
against the JAX package's ``decode_state_shardings`` on the CPU.

The multi-rank checks share one launch: 8 gloo ranks (``OMP_NUM_THREADS=1``,
a ``file://`` store), which lay out the (2, 4) ``("data", "model")`` and
the (2, 2, 2) ``("pod", "data", "model")`` meshes on one world, beside
JAX processes with 8 host devices (two a mesh, each half of the
configs), their axes ``AxisType.Auto``.  It runs once for the whole test
run, whichever test process asks first (a file lock under the run's
shared temporary directory).  The JAX weights (``PRNGKey(0)``) are made
the same way here and in each JAX process.

Configs, changed alike in both packages (``dataclasses.replace``): smoke
gemma2_2b with H = KV = 2 (tp = 4 takes the ``"all"`` plan, tp = 2
``"aligned"``) and a window of 8 (the local layers' ring wraps in the
prefill; attention and final softcaps); llama4_maverick with ``fsdp``;
nemotron with int8 caches (``"expand"`` at tp = 4); moonshot (MoE); hymba
(attention beside SSM heads, computed whole over ``"model"``) with a
window of 8.  Each prefills 4 lanes of 11 tokens for 16 slots and decodes
4 greedy steps on both meshes.  gemma2 also runs a ``max_len`` of 19,
which tp does not divide (its full layers' caches stay whole); gemma2 and
nemotron decode one lane (F5: the data axes fold into the slots) from the
JAX package's one-device prefill.

int8 caches quantise each (lane, head, slot) vector: a value within an
ulp of a rounding boundary gets a code one step away in the other package
(1 code in 2048, about 1e-3 on a decode logit), so nemotron's serve steps
decode from the JAX prefill's codes, placed by ``shard_decode_state``,
and its own prefill's codes are held to one step.

Tolerances: greedy ids equal; prefill and decode logits within
``LOGIT_TOL`` = 2e-4 (the blocks' float32 sums merge in another order
than one softmax, and XLA's partitioned softmax sums in yet another);
cache values (the smoke configs' compute dtype, float32) within
``CACHE_TOL`` = 2e-4, int8 codes at most one step away in at most 1 code
in 1000.
"""

import dataclasses
import fcntl
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")

from repro.configs import base as j_cb  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.launch import dryrun as t_dry  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import sharding as t_shd  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
LOGIT_TOL = 2e-4
CACHE_TOL = 2e-4
#: the share of int8 codes that may sit one step away
FLIP_SHARE = 1e-3
MESHES = {"2x4": (2, 4), "2x2x2": (2, 2, 2)}
#: each config's changes, in both packages
CHANGES = {
    "gemma2_2b": dict(n_heads=2, n_kv_heads=2, window=8),
    "llama4_maverick_400b_a17b": dict(fsdp=True),
    "nemotron_4_340b": dict(kv_cache_dtype="int8"),
    "moonshot_v1_16b_a3b": {},
    "hymba_1_5b": dict(window=8),
}
INT8 = "nemotron_4_340b"
#: 4 lanes, an 11-token prompt, the prefill's token and 4 greedy decode
#: steps': 16 slots, which tp and the data axes times tp divide
SERVE = dict(B=4, S=11, gen=5)
#: 19 slots, which tp does not divide
UNEVEN = dict(arch="gemma2_2b", B=4, S=14, gen=5)
#: one lane (F5), decoded from the JAX package's one-device prefill
F5 = dict(archs=["gemma2_2b", INT8], B=1, S=11, gen=5)
DEADLINE_S = 240
#: the cases of each JAX process (one a mesh and part): the int8 config
#: and F5 in the one that writes the states the ranks decode from
JAX_PARTS = ((INT8, "gemma2_2b", "uneven", "f5"),
             ("llama4_maverick_400b_a17b", "moonshot_v1_16b_a3b",
              "hymba_1_5b"))
#: the head plan each config's attention takes at tp = 4 and 2
PLANS = {("gemma2_2b", 4): "all", ("gemma2_2b", 2): "aligned",
         (INT8, 4): "expand", (INT8, 2): "aligned"}


@pytest.fixture(autouse=True)
def _no_hints_leak():
    t_layers.clear_axis_hints()
    yield
    t_layers.clear_axis_hints()


def t_config(arch):
    return dataclasses.replace(t_cb.smoke_config(arch), **CHANGES[arch])


def j_config(arch):
    return dataclasses.replace(j_cb.smoke_config(arch), **CHANGES[arch])


def jax_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf) for path, leaf in flat}


def jax_weights(arch):
    """The JAX package's weights of the changed smoke ``arch``
    (``PRNGKey(0)``); gemma2's embeddings scaled down so greedy decoding
    does not repeat its last token."""
    p = j_tfm.init_params(j_config(arch), jax.random.PRNGKey(0))
    if arch == "gemma2_2b":
        p = dict(p, embed=p["embed"] * 0.02)
    return p


# ---------------------------------------------------------------------------
# the launch: 8 gloo ranks beside one JAX process, once per test run
# ---------------------------------------------------------------------------

COMMON = r"""
import dataclasses, json, os, sys, time
import numpy as np

tmp = sys.argv[1]
CHANGES, SERVE, UNEVEN, F5, MESHES, INT8, DEADLINE = (
    json.loads(a) for a in sys.argv[2:9])


def wait_for(name):
    path = f"{tmp}/{name}"
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > DEADLINE:
            raise RuntimeError(f"{name} never came")
        time.sleep(0.2)
    return np.load(path)


def cases():
    # (tag, arch, mesh name, lanes, prompt, tokens)
    for m in MESHES:
        for arch in CHANGES:
            yield f"{m}/{arch}", arch, m, SERVE["B"], SERVE["S"], SERVE["gen"]
        yield (f"{m}/uneven", UNEVEN["arch"], m, UNEVEN["B"], UNEVEN["S"],
               UNEVEN["gen"])
"""

RANK_SCRIPT = COMMON + r"""
rank = int(sys.argv[9])
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import base as cb
from repro_torch.data.pipeline import batch_for
from repro_torch.launch import sharding as shd, steps
from repro_torch.models import tensor_parallel as tpo
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=8)


def config(arch):
    return dataclasses.replace(cb.smoke_config(arch), **CHANGES[arch])


def weights(arch):
    w = np.load(f"{tmp}/weights_{arch}.npz")
    like = tfm.init_params(config(arch), None, "meta")
    return tfm.tree_unflatten(like, [torch.from_numpy(w[".".join(path)])
                                     for path, _ in tfm.tree_items(like)])


# every decode step's logits (gathered over a vocabulary split over
# "model"), read where the serve step takes its greedy ids
logs, greedy0 = [], tfm.greedy_ids


def greedy(logits, cfg):
    vp = tfm.vocab_piece(cfg)
    whole = logits if vp is None else tpo.gather_over_model(logits,
                                                            vp[0].mesh)
    logs.append(whole.float().numpy().copy())
    return greedy0(logits, cfg)


tfm.greedy_ids = greedy


def save_state(prefix, state, out):
    for i, c in enumerate(state.caches):
        for k, v in c.items():
            # a copy: decoding writes into the caches in place
            out[f"{prefix}/caches.{i}.{k}"] = (
                v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
    out[f"{prefix}/length"] = state.length.numpy().copy()


def whole_state(w, prefix, cfg, B, max_len):
    like = tfm.init_decode_state(cfg, B, max_len, "meta")
    caches = tuple({k: torch.from_numpy(w[f"{prefix}/caches.{i}.{k}"]).to(
        v.dtype) for k, v in c.items()} for i, c in enumerate(like.caches))
    return tfm.DecodeState(caches=caches, length=torch.from_numpy(
        w[f"{prefix}/length"]))


def decode(tag, cfg, p, mesh, B, max_len, state, tok, n, out):
    step = steps.make_serve_step(cfg, mesh, B, max_len)
    del logs[:]
    ids = [tok.to_local() if hasattr(tok, "to_local") else tok]
    for _ in range(n):
        tok, state = step(p, state, tok)
        ids.append(tok.to_local())
    out[f"{tag}/ids"] = torch.stack(ids, 1).numpy()
    out[f"{tag}/logits"] = np.stack(logs)
    save_state(f"{tag}/final", state, out)


out = {}
try:
    meshes = {"2x4": init_device_mesh("cpu", (2, 4),
                                      mesh_dim_names=("data", "model")),
              "2x2x2": init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=(
                  "pod", "data", "model"))}
    late = []
    for tag, arch, m, B, S, gen in cases():
        cfg, mesh = config(arch), meshes[m]
        params = weights(arch)
        p = shd.distribute_tree(params, shd.param_shardings(params, cfg,
                                                            mesh), mesh)
        batch = {k: torch.as_tensor(v) for k, v in
                 batch_for(cfg, 0, B, S).items()}
        max_len = S + gen
        logits, state = steps.make_prefill_step(cfg, mesh, max_len)(p, batch)
        out[f"{tag}/prefill_logits"] = logits.to_local().float().numpy()
        save_state(f"{tag}/prefill", state, out)
        tok = steps.rows_on_mesh(torch.argmax(logits.to_local(), -1).to(
            torch.int32), mesh)
        if arch == INT8:
            late.append((tag, cfg, p, mesh, B, max_len, tok, gen - 1))
            continue
        decode(tag, cfg, p, mesh, B, max_len, state, tok, gen - 1, out)
    # from the JAX package's states: the int8 caches its mesh prefill
    # wrote, and F5's one-device prefill
    for tag, cfg, p, mesh, B, max_len, tok, n in late:
        w = wait_for(f"jax_states_{tag.split('/')[0]}.npz")
        state = steps.shard_decode_state(cfg, mesh, whole_state(
            w, tag, cfg, B, max_len))
        decode(tag, cfg, p, mesh, B, max_len, state, tok, n, out)
    for m, mesh in meshes.items():
        w = wait_for(f"jax_states_{m}.npz")
        for arch in F5["archs"]:
            cfg, tag = config(arch), f"{m}/f5/{arch}"
            params = weights(arch)
            p = shd.distribute_tree(params, shd.param_shardings(
                params, cfg, mesh), mesh)
            max_len = F5["S"] + F5["gen"]
            state = steps.shard_decode_state(cfg, mesh, whole_state(
                w, f"f5/{arch}", cfg, F5["B"], max_len))
            save_state(f"{tag}/prefill", state, out)
            tok = torch.from_numpy(w[f"f5/{arch}/first"])
            decode(tag, cfg, p, mesh, F5["B"], max_len, state, tok,
                   F5["gen"] - 1, out)
    np.savez(f"{tmp}/rank{rank}.npz", **out)
finally:
    dist.destroy_process_group()
print("PASS", rank)
"""

JAX_SCRIPT = COMMON + r"""
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import base as cb
from repro.data.pipeline import batch_for
from repro.launch import steps
from repro.launch.mesh import dp_axes, dp_size, tp_size
from repro.models import layers, transformer as tfm

import functools

M, PART = sys.argv[9], json.loads(sys.argv[10])
meshes = {M: jax.make_mesh(tuple(MESHES[M]),
                           ("pod", "data", "model")[-len(MESHES[M]):],
                           axis_types=(AxisType.Auto,) * len(MESHES[M]))}
assert [d.id for d in meshes[M].devices.reshape(-1)] == list(range(8))


def key(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path)


def config(arch):
    return dataclasses.replace(cb.smoke_config(arch), **CHANGES[arch])


@functools.lru_cache(maxsize=None)
def weights(arch):
    # the test's ``jax_weights``, on the host (each step places them)
    p = tfm.init_params(config(arch), jax.random.PRNGKey(0))
    if arch == "gemma2_2b":
        p = dict(p, embed=p["embed"] * 0.02)
    return jax.tree.map(np.asarray, p)


def host(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def save_state(prefix, state, out):
    # every leaf whole, and each device's index of it
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        name = key(path)
        out[f"{prefix}/{name}"] = host(leaf)
        idx = leaf.sharding.devices_indices_map(leaf.shape)
        out[f"{prefix}/{name}/index"] = np.asarray(
            [[s.indices(n)[:2] for s, n in zip(idx[d], leaf.shape)]
             for d in sorted(idx, key=lambda d: d.id)], np.int64)


def shapes(tree):
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        tree)


def decoder(cfg, mesh, B, max_len):
    # the serve step's function and shardings, returning the logits too
    _, _, (_, _, p_shard, s_shard, tok_shard) = steps.make_serve_step(
        cfg, mesh, B, max_len)
    dp, tp = dp_size(mesh), tp_size(mesh)
    lg_shard = NamedSharding(mesh, P(dp_axes(mesh) if B % dp == 0 else None,
                                     None))
    fn = jax.jit(lambda p, s, t: tfm.decode_step(p, cfg, s, t, ep_groups=tp,
                                                 dp_groups=dp),
                 in_shardings=(p_shard, s_shard, tok_shard),
                 out_shardings=(lg_shard, s_shard))
    return fn, (p_shard, s_shard, tok_shard)


def placed(states, prefix, cfg, B, max_len, mesh, s_shard=None):
    # a whole state of the arrays ``states[prefix/<path>]`` placed onto
    # the serve step's shardings
    if s_shard is None:
        s_shard = decoder(cfg, mesh, B, max_len)[1][1]
    like = jax.eval_shape(lambda: tfm.init_decode_state(cfg, B, max_len))
    return jax.device_put(jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(states[f"{prefix}/{key(path)}"],
                                       leaf.dtype), like), s_shard)


def prefill(tag, arch, mesh, B, S, gen, out):
    cfg = config(arch)
    batch = {k: jnp.asarray(v) for k, v in batch_for(cfg, 0, B, S).items()}
    _, pf_for, _ = steps.make_prefill_step(cfg, mesh, S + gen)
    logits, state = pf_for(shapes(batch))(weights(arch), batch)
    out[f"{tag}/prefill_logits"] = host(logits)
    save_state(f"{tag}/prefill", state, out)
    return logits, state


def decode(tag, arch, fn, state, tok, n, out):
    p = weights(arch)
    ids, logs = [np.asarray(tok)], []
    for _ in range(n):
        lg, state = fn(p, state, tok)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        ids.append(np.asarray(tok))
        logs.append(host(lg))
    out[f"{tag}/ids"] = np.stack(ids, 1)
    out[f"{tag}/logits"] = np.stack(logs)
    save_state(f"{tag}/final", state, out)


out, states = {}, {}
mesh = meshes[M]
try:
    # first what the ranks decode from: the int8 config's mesh prefill
    # and F5's one-device prefills, written whole
    for tag, arch, m, B, S, gen in cases():
        if arch == INT8 and m == M and INT8 in PART:
            with jax.set_mesh(mesh):
                prefill(tag, arch, mesh, B, S, gen, out)
            for k, v in out.items():
                if k.startswith(f"{tag}/prefill/") and not k.endswith(
                        "/index"):
                    states[tag + k[len(f"{tag}/prefill"):]] = v
            layers.clear_axis_hints()
    for arch in F5["archs"] if "f5" in PART else ():
        cfg = config(arch)
        batch = {k: jnp.asarray(v) for k, v in
                 batch_for(cfg, 0, F5["B"], F5["S"]).items()}
        logits, state = jax.jit(lambda p, b: tfm.prefill(
            p, cfg, b, F5["S"] + F5["gen"]))(weights(arch), batch)
        states[f"f5/{arch}/first"] = np.asarray(
            jnp.argmax(logits, -1).astype(jnp.int32))
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
            states[f"f5/{arch}/{key(path)}"] = host(leaf)
    if states:
        np.savez(f"{tmp}/jax_states_{M}.tmp.npz", **states)
        os.replace(f"{tmp}/jax_states_{M}.tmp.npz",
                   f"{tmp}/jax_states_{M}.npz")
    with jax.set_mesh(mesh):
        for tag, arch, m, B, S, gen in cases():
            if m != M or tag.split("/")[1] not in PART:
                continue
            if arch == INT8:
                # from the codes the ranks decode from
                logits = out[f"{tag}/prefill_logits"]
                state = placed(states, tag, config(arch), B, S + gen,
                               mesh)
            else:
                logits, state = prefill(tag, arch, mesh, B, S, gen, out)
            fn, (_, _, tok_shard) = decoder(config(arch), mesh, B, S + gen)
            tok = jax.device_put(jnp.argmax(jnp.asarray(logits), -1).astype(
                jnp.int32), tok_shard)
            decode(tag, arch, fn, state, tok, gen - 1, out)
            layers.clear_axis_hints()
        for arch in F5["archs"] if "f5" in PART else ():
            cfg, max_len = config(arch), F5["S"] + F5["gen"]
            fn, (_, s_shard, tok_shard) = decoder(cfg, mesh, F5["B"],
                                                  max_len)
            state = placed(states, f"f5/{arch}", cfg, F5["B"], max_len,
                           mesh, s_shard)
            save_state(f"{M}/f5/{arch}/prefill", state, out)
            decode(f"{M}/f5/{arch}", arch, fn, state, jax.device_put(
                states[f"f5/{arch}/first"], tok_shard), F5["gen"] - 1, out)
            layers.clear_axis_hints()
finally:
    layers.clear_axis_hints()
np.savez(f"{tmp}/jax_{M}_{PART[0]}.npz", **out)
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
    args = [json.dumps(a) for a in (CHANGES, SERVE, UNEVEN, F5, MESHES,
                                    INT8, DEADLINE_S)]
    kw = dict(cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
              text=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    t0 = time.time()
    # a JAX process for each mesh and part of the cases, which make their
    # own weights, started first; then the ranks' weights
    groups = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, tmp] + args + [m, json.dumps(part)],
        env=env, **kw) for m in MESHES for part in JAX_PARTS]}
    for arch in CHANGES:
        np.savez(os.path.join(tmp, f"weights_{arch}.npz"),
                 **jax_paths(jax_weights(arch)))
    groups["ranks"] = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, tmp] + args + [str(r)], env=env,
        **kw) for r in range(8)]
    result = {}
    try:
        for name in ("jax", "ranks"):
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
    """The launch's directory (``jax_<mesh>_<part>.npz``, ``rank<r>.npz``),
    made by whichever test process of this run asks first."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"seq_{uid}" if uid else base / "seq"
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


def _jax(root, mesh) -> dict:
    """The JAX processes' results on ``mesh``, by key."""
    out = {}
    for part in JAX_PARTS:
        out.update(np.load(root / f"jax_{mesh}_{part[0]}.npz"))
    return out


def _lanes(rank: int, mesh: str, B: int) -> slice:
    """The lanes a rank decodes: its data shard's (row-major over the
    data axes) when they divide ``B``, else all."""
    shape = MESHES[mesh]
    dpn = math.prod(shape[:-1])
    if B % dpn:
        return slice(0, B)
    shard, b = rank // shape[-1], B // dpn
    return slice(shard * b, (shard + 1) * b)


def _held(jx, r, rank, prefix, mesh, B):
    """Each cache leaf of a rank's state is exactly its device's shard of
    the JAX state in shape and within the tolerance in value; the other
    leaves (which the port keeps whole over ``"model"``) are the JAX
    state's rows of the rank's lanes.  Returns the caches' slots."""
    names = [k[len(prefix) + 1:] for k in jx
             if k.startswith(prefix + "/") and not k.endswith("/index")]
    assert names
    lanes = _lanes(rank, mesh, B)
    slots = {}
    for name in names:
        want, got = jx[f"{prefix}/{name}"], r[f"{prefix}/{name}"]
        key = name.rsplit(".", 1)[-1]
        if key in t_tfm.CACHE_KEYS:
            idx = jx[f"{prefix}/{name}/index"][rank]
            want = want[tuple(slice(a, b) for a, b in idx)]
            slots[name] = got.shape[3]
        elif name == "length":
            want = want[lanes]
        else:
            want = want[:, lanes]
        assert got.shape == want.shape, (prefix, name, got.shape,
                                         want.shape)
        if got.dtype == np.int8:
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE, \
                (prefix, name)
        else:
            np.testing.assert_allclose(got, want, atol=CACHE_TOL,
                                       rtol=CACHE_TOL,
                                       err_msg=f"{prefix} {name} {rank}")
    return slots


def _slots(cfg, name, sv, split) -> int:
    """The slots a rank holds of the cache ``name`` (``caches.<i>.k``)
    split ``split`` ways: all of them where ``split`` does not divide
    them."""
    kind = t_tfm.pattern(cfg)[int(name.split(".")[1])].attn
    C = t_layers._cache_len(cfg, kind, sv["S"] + sv["gen"])
    return C if C % split else C // split


def _case_ids():
    return [f"{m}-{a}" for m in MESHES for a in CHANGES] + [
        f"{m}-uneven" for m in MESHES]


def _cases():
    return [(m, a, SERVE) for m in MESHES for a in CHANGES] + [
        (m, "uneven", UNEVEN) for m in MESHES]


@pytest.mark.parametrize("mesh,arch,sv", _cases(), ids=_case_ids())
def test_ranks_hold_their_devices_jax_shard_of_every_cache(launched, mesh,
                                                           arch, sv):
    """After the prefill and after 4 greedy decode steps, each rank's
    caches are its device's shard of the JAX state
    (``devices_indices_map``): every KV head of the rank's lanes and its
    block of the slots (the int8 config's decoded state from the JAX
    prefill's codes); a cache of 16 slots holds 16 / tp of them."""
    jx = _jax(launched, mesh)
    cfg = t_config(sv.get("arch", arch))
    for rank, r in enumerate(_ranks(launched)):
        for when in ("prefill", "final"):
            prefix = f"{mesh}/{arch}/{when}"
            slots = _held(jx, r, rank, prefix, mesh, sv["B"])
            for name, n in slots.items():
                assert r[f"{prefix}/{name}"].shape[2] == cfg.n_kv_heads
                assert n == _slots(cfg, name, sv, MESHES[mesh][-1])


@pytest.mark.parametrize("mesh,arch,sv", _cases(), ids=_case_ids())
def test_greedy_ids_and_logits_match_jax(launched, mesh, arch, sv):
    """Greedy ids equal, prefill and decode logits within ``LOGIT_TOL``
    of the JAX steps' on the same mesh."""
    jx = _jax(launched, mesh)
    tag = f"{mesh}/{arch}"
    want_ids = jx[f"{tag}/ids"]
    assert want_ids.shape == (sv["B"], sv["gen"])
    assert len(np.unique(want_ids)) > 1
    for rank, r in enumerate(_ranks(launched)):
        lanes = _lanes(rank, mesh, sv["B"])
        np.testing.assert_array_equal(r[f"{tag}/ids"], want_ids[lanes])
        np.testing.assert_allclose(r[f"{tag}/prefill_logits"],
                                   jx[f"{tag}/prefill_logits"][lanes],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        got = r[f"{tag}/logits"]
        assert got.shape[0] == sv["gen"] - 1
        np.testing.assert_allclose(got, jx[f"{tag}/logits"][:, lanes],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_the_cases_take_every_head_plan():
    """The configs above take the ``"all"``, ``"aligned"`` and
    ``"expand"`` plans on the two meshes' tp, and hymba none (its
    attention is computed whole over ``"model"``)."""

    class Region:
        def __init__(self, size):
            self.size, self.rank, self.mesh = size, 0, None

    for (arch, tp), kind in PLANS.items():
        assert t_layers.head_plan(t_config(arch), Region(tp)).kv == kind
    assert not t_shd.tp_compute(t_config("hymba_1_5b"))


@pytest.mark.parametrize("arch", F5["archs"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_one_lane_batch_folds_the_data_axes_into_the_slots(launched, mesh,
                                                            arch):
    """F5: one lane on 2 or 4 data shards.  Every rank decodes the lane
    and its caches are its device's JAX shard: the slots split over the
    data axes and ``"model"`` together, 16 / 8 = 2 a rank (the local
    layers' 8: 1); ids equal and logits within ``LOGIT_TOL``."""
    jx = _jax(launched, mesh)
    tag = f"{mesh}/f5/{arch}"
    cfg = t_config(arch)
    for rank, r in enumerate(_ranks(launched)):
        for when in ("prefill", "final"):
            slots = _held(jx, r, rank, f"{tag}/{when}", mesh, F5["B"])
            assert slots
            for name, n in slots.items():
                assert n == _slots(cfg, name, F5, 8) < 16
        np.testing.assert_array_equal(r[f"{tag}/ids"], jx[f"{tag}/ids"])
        np.testing.assert_allclose(r[f"{tag}/logits"], jx[f"{tag}/logits"],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_max_len_tp_does_not_divide_keeps_the_cache_whole(launched, mesh):
    """19 slots: gemma2's full layers keep all 19 on every rank, as JAX
    replicates them; its local layers' ring of 8 is split."""
    tp = MESHES[mesh][-1]
    for r in _ranks(launched):
        tag = f"{mesh}/uneven/prefill/caches"
        assert r[f"{tag}.1.k"].shape[3] == 19
        assert r[f"{tag}.0.k"].shape[3] == 8 // tp


# ---------------------------------------------------------------------------
# the merge, the plan and the dry-run without the launch
# ---------------------------------------------------------------------------

class ThreadGroup:
    """A fake process group of ``n`` ranks, each a thread of this
    process: an all-reduce waits for every rank's tensor and returns
    their elementwise sum (in rank order) or maximum."""

    def __init__(self, n):
        self.n, self.parts = n, [None] * n
        self.barrier = threading.Barrier(n)

    def reducer(self, rank, op):
        def reduce(x):
            self.parts[rank] = x
            self.barrier.wait()
            out = torch.stack(self.parts)
            out = out.amax(0) if op == "max" else out.sum(0)
            self.barrier.wait()
            return out
        return reduce


@pytest.mark.parametrize("lens", ([1, 5], [3, 16], [16, 2]))
@pytest.mark.parametrize("softcap", (None, 50.0))
def test_the_merge_of_the_blocks_is_decode_attention(lens, softcap):
    """Four ranks' blocks of a 16-slot cache, their partial softmaxes
    merged through a fake group: ``decode_attention`` of the whole cache
    within 1e-6 (float32), also where ranks hold no filled slot (a lane
    of length 1 fills the first rank's block only)."""
    g = torch.Generator().manual_seed(len(lens) + lens[0])
    B, H, KV, C, Dh, R = 2, 4, 2, 16, 8, 4
    q = torch.randn(B, H, Dh, generator=g)
    k = torch.randn(B, KV, C, Dh, generator=g)
    v = torch.randn(B, KV, C, Dh, generator=g)
    eff = torch.tensor(lens)
    want = t_ref.decode_attention(q, k, v, eff, softcap=softcap)
    group, got, n = ThreadGroup(R), [None] * R, C // R

    def rank(r):
        filled = r * n + torch.arange(n) < eff[:, None]
        m, l, o = t_ref.decode_attention_partial(
            q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
            filled, softcap)
        got[r] = t_ref.decode_attention_merge(
            m, l, o, q.dtype, group.reducer(r, "max"),
            group.reducer(r, "sum"))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(R)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert min(lens) < n                  # some rank holds no filled slot
    for r in range(R):
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(got[r], got[0], rtol=0, atol=0)
    m, l, o = t_ref.decode_attention_partial(q, k, v, torch.arange(C)
                                             < eff[:, None], softcap)
    np.testing.assert_allclose(t_ref.decode_attention_merge(
        m, l, o, q.dtype).numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.fixture
def fake_rank():
    """``init(rank, size)``: this process as ``rank`` of a fake group of
    ``size``; destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank, size):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=size)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("shape,rows,C,axes", (
    ((2, 4), True, 16, ("model",)),
    ((2, 4), False, 16, ("data", "model")),
    ((2, 4), False, 12, ("model",)),
    ((2, 4), True, 6, None),
    ((2, 2, 2), False, 16, ("pod", "data", "model")),
    ((2, 2, 2), True, 8, ("model",)),
    ((4, 1), False, 8, ("data", "model")),
    ((1, 1), True, 8, None)))
def test_seq_plan_tiles_the_cache_in_mesh_order(shape, rows, C, axes,
                                                fake_rank):
    """The blocks of every rank tile the C slots, each block's index the
    row-major index of the rank's coordinate over the plan's axes in mesh
    order (what ``devices_indices_map`` gives), the axes those of
    ``decode_state_shardings`` for a batch that splits (``rows``) or not;
    None where the cache stays whole or the split is of one rank."""
    names = ("pod", "data", "model")[-len(shape):]
    world = math.prod(shape)
    B = 2 * world if rows else 1
    blocks = {}
    for rank in range(world):
        fake_rank(rank, world)
        mesh = t_mesh.make_test_mesh(*shape[-2:], multi_pod=len(shape) == 3,
                                     device="cpu")
        state = t_tfm.init_decode_state(t_cb.smoke_config("yi_9b"), B, C,
                                        "meta")
        spec = t_shd.decode_state_shardings(state, t_cb.smoke_config(
            "yi_9b"), mesh).caches[0]["k"][3]
        plan = t_layers.seq_plan(C, mesh, rows)
        if axes is None:
            assert plan is None
            continue
        assert plan.axes == axes
        assert spec == (axes[0] if len(axes) == 1 else axes)
        coord = dict(zip(names, mesh.get_coordinate()))
        block = 0
        for a in axes:
            block = block * dict(zip(names, shape))[a] + coord[a]
        assert plan.lo == block * plan.n
        blocks.setdefault(plan.lo, set()).add(rank)
    if axes is not None:
        n = C // math.prod(dict(zip(names, shape))[a] for a in axes)
        assert sorted(blocks) == list(range(0, C, n))


@pytest.mark.parametrize("shape,lanes", (((2, 4), 4), ((2, 4), 1)))
def test_a_decode_cell_traces_split_caches_and_the_merge(shape, lanes,
                                                         fake_rank,
                                                         monkeypatch):
    """A smoke gemma2 decode cell of 16 slots on a fake (2, 4) world:
    rank 0's state holds every KV head and 16 / 4 (4 lanes) or 16 / 8
    (one lane, the data axes folded in) slots of each cache, and the
    trace runs the merge's all-reduces (a max and a sum a layer, over
    those axes) and counts them, and the gathers, by op."""
    from repro_torch.models import tensor_parallel as t_tpo

    merges, reduce0 = [], t_tpo.reduce_over
    monkeypatch.setattr(t_tpo, "reduce_over", lambda x, mesh, axes, op="sum":
                        merges.append((tuple(axes), op))
                        or reduce0(x, mesh, axes, op))
    cfg = t_config("gemma2_2b")
    cfg = dataclasses.replace(cfg, n_heads=4, n_kv_heads=2)
    cell = ShapeCell("smoke_decode", "decode", 16, lanes)
    fake_rank(0, 8)
    mesh = t_mesh.make_test_mesh(*shape, device="cpu")
    state = t_steps.init_decode_state(cfg, mesh, lanes, 16, "cpu")
    n = 16 // (4 if lanes % 2 == 0 else 8)
    for c, kind in zip(state.caches, ("local", "full")):
        C = 8 if kind == "local" else 16
        assert tuple(c["k"].shape[2:4]) == (cfg.n_kv_heads,
                                            n * C // 16)
    dist.destroy_process_group()
    with t_dry.fake_world(8):
        cost, _ = t_dry.trace_cell("gemma2_2b", "smoke_decode", False,
                                   device="cpu", cell=cell, mesh_shape=shape,
                                   cfg=cfg)
    axes = ("model",) if lanes % 2 == 0 else ("data", "model")
    assert merges == [(axes, "max"), (axes, "sum")] * cfg.n_layers
    assert cost.coll_by_op["all_reduce"] > 0
    assert cost.coll_by_op["all_gather_into_tensor"] > 0


@pytest.mark.parametrize("arch", list(CHANGES))
def test_a_one_rank_mesh_is_bitwise_the_one_device_decode(arch, tmp_path):
    """On a (1, 1) mesh the prefill and serve steps are the one-device
    ``prefill`` and ``decode_step`` bit for bit: no split of one rank
    changes the arithmetic."""
    cfg = t_config(arch)
    params = t_tfm.params_from_numpy(
        jax.tree.map(np.asarray, jax_weights(arch)), cfg)
    B, S, gen = 2, 11, 4
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))}
    with torch.no_grad():
        logits, state = t_tfm.prefill(params, cfg, batch, S + gen)
        want = [logits]
        tok = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(gen - 1):
            lg, state = t_tfm.decode_step(params, cfg, state, tok)
            tok = torch.argmax(lg, -1).to(torch.int32)
            want.append(lg)
    want_state = t_tfm.tree_leaves(state)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
        logits, state = t_steps.make_prefill_step(cfg, mesh, S + gen)(
            params, batch)
        got = [logits.to_local()]
        tok = torch.argmax(got[0], -1).to(torch.int32)
        grabbed, greedy0 = [], t_tfm.greedy_ids
        t_tfm.greedy_ids = lambda lg, c: grabbed.append(lg) or greedy0(lg, c)
        try:
            step = t_steps.make_serve_step(cfg, mesh, B, S + gen)
            for _ in range(gen - 1):
                tok, state = step(params, state, tok)
        finally:
            t_tfm.greedy_ids = greedy0
        got += grabbed
    finally:
        dist.destroy_process_group()
    assert len(got) == len(want)
    for a, b in zip(got + t_tfm.tree_leaves(state), want + want_state):
        assert a.dtype == b.dtype and torch.equal(a, b)
