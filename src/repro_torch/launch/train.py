"""Training driver: data pipeline -> train step -> checkpoints, with the
fault-tolerance supervisor (auto-restore, straggler monitor) wrapped
around the loop.  The port of the JAX package's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch repro_100m \\
      --steps 300 --global-batch 8 --seq 256 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \\
      --smoke --steps 3 --global-batch 2 --seq 32 --device cpu

Without ``--device`` it runs on the CUDA device and raises when there is
none.  In a process that set up a process group
(``torch.distributed.init_process_group``, one process a rank), it trains
with the sharded step on :func:`build_mesh`'s mesh (``--production``: the
(16, 16) mesh, ``--multi-pod`` the (2, 16, 16) one, which need 256 and 512
ranks); without a process group, on one device as the single-device step
does.  Weights are random, drawn from ``--seed`` on the device; batches
come from ``batch_for(step)`` (deterministic addressing, so a restart
resumes the same data).  On the card every attention layer's forward runs
the flash kernel (twice a step under rematerialisation) and its backward
the reference's chunked ``_attn_bwd``.  ``main`` returns the losses of
every step run (a step redone after a restore counts again); :func:`run`
also returns the supervisor's counts, the per-step wall times and the
final state.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import base as cb
from repro_torch.core.scheduler import resolve_device
from repro_torch.data.pipeline import SyntheticPipeline, batch_for
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import StragglerMonitor, Supervisor


def build_mesh(production: bool, multi_pod: bool, device=None):
    """The training mesh: the production (16, 16) mesh (``multi_pod``: (2,
    16, 16)) when ``production``, else ``("data", "model")`` over the
    initialized world of n ranks, (n // 2, 2) for n > 1 and (1, 1) for
    one; None without a process group (the one-device step)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if production:
        return make_production_mesh(multi_pod=multi_pod, device=device)
    if not (dist.is_available() and dist.is_initialized()):
        return None
    n = dist.get_world_size()
    d = max(1, n // 2) if n > 1 else 1
    return init_device_mesh(resolve_device(device).type, (d, n // d),
                            mesh_dim_names=("data", "model"))


class TrainRun(NamedTuple):
    losses: list            # the loss of every step run, in order
    grad_norms: list        # beside each loss
    step_s: list            # wall seconds of each step run
    restarts: int
    recovered_from: Optional[int]   # the step last restored, if any
    stragglers: int
    end_step: int
    params: object          # a ParamTree; on a mesh a dict of DTensors
    opt: AdamWState


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro_100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of --arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fault-at", type=int, default=-1,
                    help="inject a simulated node failure at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    return ap


def run(argv=None) -> TrainRun:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = cb.smoke_config(args.arch) if args.smoke else cb.get(args.arch)
    mesh = build_mesh(args.production, args.multi_pod, device)
    where = device if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape))
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"{'device' if mesh is None else 'mesh'}={where}")

    train_step = steps_mod.make_train_step(
        cfg, device if mesh is None else mesh,
        microbatches=args.microbatches, peak_lr=args.peak_lr,
        total_steps=args.steps)
    # the sharded step takes the global batch on every rank and slices its
    # own rows; the one-device step, this process's rows
    pipe = SyntheticPipeline(cfg, args.global_batch, args.seq,
                             **({} if mesh is None else
                                dict(process_index=0, process_count=1)))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = tfm.init_params(cfg, generator, device).requires_grad_(True)
    opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
    if mesh is not None:
        params, opt = steps_mod.shard_train_state(cfg, mesh, params, opt)

    def save_fn(state, step):
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step,
                      {"params": state[0], "opt": state[1]})
            ckpt.cleanup(args.ckpt_dir, keep=3)

    def restore_fn():
        if not args.ckpt_dir:
            return None, None
        template = {"params": params, "opt": opt}
        if mesh is None:
            tree, s = ckpt.restore(args.ckpt_dir, template)
        else:
            p_specs = shd.param_shardings(params, cfg, mesh)
            tree, s = ckpt.restore_resharded(
                args.ckpt_dir, template, {
                    "params": p_specs,
                    "opt": shd.opt_shardings(opt, params, cfg, mesh)},
                mesh)
        if tree is None:
            return None, None
        return (tree["params"], tree["opt"]), s

    losses, grad_norms, step_s = [], [], []

    def batch_for_step(step_idx):
        return batch_for(cfg, step_idx, args.global_batch, args.seq,
                         lo=pipe.lo, hi=pipe.hi)

    def step_fn(state, step_idx):
        p, o = state
        batch = batch_for_step(step_idx)
        t0 = time.monotonic()
        p, o, metrics = train_step(p, o, batch, step_idx)
        loss = float(metrics["loss"])      # waits for the step
        step_s.append(time.monotonic() - t0)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step_idx % args.log_every == 0:
            print(f"step {step_idx:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {grad_norms[-1]:7.3f} {step_s[-1]:5.2f}s",
                  flush=True)
        return (p, o), loss

    sup = Supervisor(save_fn=save_fn, restore_fn=restore_fn,
                     ckpt_every=args.ckpt_every, monitor=StragglerMonitor())
    fault = {args.fault_at: "crash"} if args.fault_at >= 0 else None
    try:
        (params, opt), end = sup.run((params, opt), step_fn, args.steps,
                                     fault_at=fault)
    finally:
        pipe.close()
    print(f"done at step {end}; restarts={sup.restarts} "
          f"stragglers={sup.monitor.flagged} "
          f"loss {losses[0]:.4f} -> {np.mean(losses[-5:]):.4f}")
    return TrainRun(losses, grad_norms, step_s, sup.restarts,
                    sup.recovered_from, sup.monitor.flagged, end, params,
                    opt)


def main(argv=None) -> list:
    """Train as the flags say; returns the losses (see :func:`run`)."""
    return run(argv).losses


if __name__ == "__main__":
    main()
