"""The port's checkpoints, supervisor and train driver on the CPU: the
on-disk format against the JAX package's (a checkpoint either package
writes restores in the other: names, files, CRCs and values equal), the
CRC fallback, ``cleanup``, a bitwise resume, the supervisor's crash, NaN
and straggler paths, and ``launch.train`` through an injected fault."""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import base as j_cb  # noqa: E402
from repro.models import transformer as j_tfm  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch.configs import base as t_cb  # noqa: E402
from repro_torch.data.pipeline import batch_for  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as t_tfm  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.runtime import (SimulatedFault, StragglerMonitor,  # noqa: E402
                                 Supervisor)


@pytest.fixture(autouse=True)
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them many
    times faster than a pool of them, which contends with the other test
    processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trees():
    """gemma2's smoke parameters in bf16 and float32 AdamW state after one
    update, in both packages (the port's carried across)."""
    import dataclasses

    jcfg = dataclasses.replace(j_cb.smoke_config("gemma2_2b"),
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(t_cb.smoke_config("gemma2_2b"),
                               param_dtype="bfloat16")
    jp = j_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    jo = j_adamw.adamw_init(jp)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype), jp)
    jp, jo, _ = j_adamw.adamw_update(g, jo, jp, lr=1e-3)
    tp = t_tfm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)

    def tree(t):
        return t_tfm.ParamTree(jax.tree.map(t_tfm._tensor_from_numpy,
                                            jax.tree.map(np.asarray, t)))

    to = t_adamw.AdamWState(
        step=torch.tensor(int(jo.step), dtype=torch.int32), m=tree(jo.m),
        v=tree(jo.v))
    return {"params": jp, "opt": jo}, {"params": tp, "opt": to}


def manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def same_leaves(t_tree, j_tree):
    got = dict(t_ckpt.checkpoint._flatten(t_tree))
    want = j_ckpt.checkpoint._flatten(jax.device_get(j_tree))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = want[name]
        assert tuple(t.shape) == w.shape, name
        if t.dtype == torch.bfloat16:
            assert str(w.dtype) == "bfloat16", name
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  w.view(np.int16)), name
        else:
            assert str(t.numpy().dtype) == str(w.dtype), name
            assert np.array_equal(t.numpy(), w), name


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The same tree written by each package: equal manifests (names,
    files, shapes, dtypes, views, CRCs) and equal files; each restores the
    other's into its own template, value for value."""
    jtree, ttree = trees()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_ckpt.save(jdir, 3, jtree)
    t_ckpt.save(tdir, 3, ttree)
    jm, tm = manifest(jdir, 3), manifest(tdir, 3)
    assert tm == jm
    assert "/opt/step" in tm["arrays"]
    assert tm["arrays"]["/params/embed"]["view"] == "bfloat16"
    for info in tm["arrays"].values():
        with open(os.path.join(jdir, "step_00000003", info["file"]),
                  "rb") as a, open(os.path.join(tdir, "step_00000003",
                                                info["file"]), "rb") as b:
            assert a.read() == b.read(), info["file"]
    restored, step = t_ckpt.restore(jdir, ttree)
    assert step == 3
    same_leaves(restored, jtree)
    assert isinstance(restored["params"], t_tfm.ParamTree)
    assert isinstance(restored["opt"], t_adamw.AdamWState)
    back, step = j_ckpt.restore(tdir, jtree)
    assert step == 3
    same_leaves(ttree, back)


def test_restore_keeps_each_template_leafs_type_device_and_grad(tmp_path):
    _, ttree = trees()
    ttree["params"].requires_grad_(True)
    t_ckpt.save(str(tmp_path), 1, ttree)
    template = {"params": ttree["params"].float(), "opt": ttree["opt"]}
    out, _ = t_ckpt.restore(str(tmp_path), template)
    for t, want in zip(out["params"].parameters(),
                       template["params"].parameters()):
        assert t.dtype == torch.float32 and t.requires_grad
        assert torch.equal(t, want)
    meta = t_tfm.init_params(t_cb.smoke_config("gemma2_2b"), None, "meta")
    out, _ = t_ckpt.restore(str(tmp_path), {"params": meta,
                                            "opt": ttree["opt"]})
    assert out["params"]["embed"].device.type == "cpu"


def test_checkpoint_corruption_falls_back(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    t_ckpt.save(str(tmp_path), 1, tree)
    t_ckpt.save(str(tmp_path), 2, {"w": tree["w"] * 2})
    victim = os.path.join(str(tmp_path), "step_00000002", "w.npy")
    with open(victim, "wb") as f:
        f.write(b"garbage")
    out, step = t_ckpt.restore(str(tmp_path), tree)
    assert step == 1
    assert torch.equal(out["w"], tree["w"])
    assert t_ckpt.restore(str(tmp_path), tree, step=2) == (None, None)
    assert t_ckpt.restore(str(tmp_path / "none"), tree) == (None, None)


def test_checkpoint_cleanup_and_steps(tmp_path):
    for s in range(5):
        t_ckpt.save(str(tmp_path), s, {"w": torch.zeros(2)})
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    t_ckpt.cleanup(str(tmp_path), keep=2)
    assert t_ckpt.steps(str(tmp_path)) == [3, 4]
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp.")]
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_resume_is_bitwise(tmp_path):
    """Stop at step 4, save, restore, continue: the same loss and
    parameters as 6 steps uninterrupted, bit for bit."""
    cfg = t_cb.smoke_config("gemma2_2b")

    def run(n, state=None, start=0):
        if state is None:
            p = t_tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu").requires_grad_(True)
            state = (p, t_adamw.adamw_init(p))
        p, o = state
        for i in range(start, n):
            b = {k: torch.as_tensor(v)
                 for k, v in batch_for(cfg, i, 2, 32).items()}
            loss, _ = t_tfm.loss_fn(p, cfg, b)
            g = torch.autograd.grad(loss, t_tfm.tree_leaves(p))
            p, o, _ = t_adamw.adamw_update(g, o, p, lr=torch.tensor(1e-3))
        return (p, o), float(loss)

    (p_full, _), l_full = run(6)
    state, _ = run(4)
    tree = {"p": state[0], "o": state[1]}
    t_ckpt.save(str(tmp_path), 4, tree)
    restored, s = t_ckpt.restore(str(tmp_path), tree)
    assert s == 4
    (p_res, _), l_res = run(6, (restored["p"], restored["o"]), start=4)
    assert l_res == l_full
    for a, b in zip(p_full.parameters(), p_res.parameters()):
        assert torch.equal(a, b)


def test_supervisor_recovers_from_a_crash():
    saved = {}

    def save_fn(state, step):
        saved["state"], saved["step"] = state, step

    sup = Supervisor(save_fn=save_fn,
                     restore_fn=lambda: (saved.get("state"),
                                         saved.get("step")),
                     ckpt_every=5)
    state, end = sup.run(0, lambda s, i: (s + 1, 1.0), 20,
                         fault_at={12: "crash"})
    assert end == 20 and state == 20
    assert sup.restarts == 1 and sup.recovered_from == 10


def test_supervisor_restores_on_nan_and_gives_up_past_its_budget():
    saved = {}
    sup = Supervisor(save_fn=lambda s, i: saved.update(s=s, i=i),
                     restore_fn=lambda: (saved.get("s"), saved.get("i")),
                     ckpt_every=4)
    state, end = sup.run(0, lambda s, i: (s + 1, 1.0), 10,
                         fault_at={6: "nan"})
    assert end == 10 and state == 10 and sup.restarts == 1
    stubborn = Supervisor(save_fn=lambda s, i: None,
                          restore_fn=lambda: (None, None), max_restarts=2)
    with pytest.raises(SimulatedFault, match="non-finite"):
        stubborn.run(0, lambda s, i: (s + 1, float("nan")), 3)
    assert stubborn.restarts == 3


def test_straggler_monitor_and_slow_step():
    m = StragglerMonitor(threshold=2.0, warmup=2)
    for _ in range(5):
        assert not m.record(1.0)
    assert m.record(5.0)
    assert m.flagged == 1
    assert m.baseline == pytest.approx(1.0)
    # steps of 10 ms, so that scheduling jitter stays below the threshold
    # and only the injected slow step (4 x the baseline, at least 50 ms)
    # is flagged
    def step(s, i):
        time.sleep(0.01)
        return s + 1, 1.0

    sup = Supervisor(save_fn=lambda s, i: None,
                     restore_fn=lambda: (None, None),
                     monitor=StragglerMonitor(threshold=3.0, warmup=2))
    state, end = sup.run(0, step, 8, fault_at={6: "slow"})
    assert end == 8 and sup.monitor.flagged == 1 and sup.restarts == 0


def test_train_main_recovers_from_an_injected_fault(tmp_path):
    """Checkpoints every 3 steps, a node failure at step 5: steps 3 and 4
    run again from the step-3 checkpoint, with the same losses."""
    argv = ["--arch", "gemma2_2b", "--smoke", "--steps", "8",
            "--global-batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "3", "--fault-at", "5",
            "--device", "cpu", "--log-every", "100"]
    run = train.run(argv)
    assert run.restarts == 1 and run.recovered_from == 3
    assert run.end_step == 8 and len(run.losses) == 10
    assert run.losses[3:5] == run.losses[5:7]
    assert all(np.isfinite(run.losses)) and all(np.isfinite(run.grad_norms))
    assert t_ckpt.steps(str(tmp_path)) == [3, 6, 8]
    plain = train.main(argv[:9] + ["--device", "cpu", "--log-every", "100"])
    assert plain == run.losses[:5] + run.losses[7:]


def test_train_without_a_device_is_an_error_not_a_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default run goes there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma2_2b", "--smoke", "--steps", "1"])
