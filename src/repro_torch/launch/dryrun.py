"""Multi-pod dry-run: the port of the JAX package's ``launch/dryrun.py``.
Each (architecture x input-shape) cell's step is traced for a rank of the
production mesh and its roofline terms are counted, without HLO.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_9b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The JAX module lowers and compiles each cell for 512 fake devices.  The
port's steps are eager PyTorch over DTensors, so here :func:`main` sets up
a fake process group of the mesh's size (256 or 512 ranks, all in this
process; ``torch.testing``'s fake backend moves no bytes) and
:func:`trace_cell` runs rank 0's step, the port's own
``steps.make_train_step(cfg, mesh)``, ``make_prefill_step`` or
``make_serve_step``, on fake tensors (``FakeTensorMode``: shapes, no
memory) placed by the sharding rules, under
:func:`repro_torch.launch.hlo_analysis.analyze`.  It refuses to run where a
real process group is initialized.

Per cell it prints the memory and roofline line and writes a JSON record
with the JAX record's keys; what differs in meaning:

  trace_s                  seconds of the trace (the JAX ``compile_s``)
  probes                   a train cell is counted from short probes: the
                           step at 1 and 2 checkpointed layer groups and 2
                           and 3 microbatches, carried to the cell's depth
                           and microbatches by the bilinear fit its loops
                           make exact (walked whole, a large model's train
                           step takes minutes to an hour under fake
                           tensors)
  hlo_flops_per_dev, hlo_hbm_bytes_per_dev, coll_bytes_per_dev,
  coll_by_op, unknown_trip_loops
                           the analysis of the traced ops
                           (:mod:`repro_torch.launch.hlo_analysis`)
  xla_cost_analysis_flops  ``FlopCounterMode``'s total for the same call
                           (the model kernels not included)
  memory_per_device_bytes  arg_bytes + temp_bytes + out_bytes: the
                           arguments' storages and the peak of the live
                           storages the step makes
  state_bytes_per_dev      the parameters (and, for a train cell, AdamW's
                           moments) as placed on rank 0
  kernels                  the model kernels' calls, flops and bytes, by
                           formula

The records show what a rank of the port's step holds and moves: its
``"model"`` pieces of the attention, MLP, vocabulary and expert leaves
(tensor and expert parallelism; RWKV6 and hymba still gather every leaf
whole), for a ``cfg.fsdp`` config its ``"data"`` pieces too, each
gathered over ``"data"`` one layer at a time (``all_gather_into_tensor``
in ``coll_by_op``; its gradient's ``reduce_scatter_tensor``), and its
data shard's rows, or a whole microbatch that the data shards do not
divide (fault F6); a prefill or decode cell's KV caches hold every KV
head and the rank's block of their slots, split over ``"model"`` (with
the data axes folded in when the batch does not split), the decode's
softmax merged by an all-reduce max and sum over those axes.  The
gradients' reduce-scatter into ZeRO's layout is ROADMAP item 11g.

Records go to ``runs/dryrun_torch/`` (``--out``), which ``.gitignore``
lists; never ``experiments/dryrun``, which holds the JAX package's.  Cells
already recorded are skipped unless ``--force``.  ``--device`` picks the
fake tensors' device (the CUDA device by default; the CPU tests pass
``cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

#: NVIDIA H100 80GB HBM3 (SXM), 700.00 W, per GPU: the dense bf16
#: tensor-core peak and the HBM3 rate of NVIDIA's data sheet (the
#: constants chip_smoke.py uses)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: one 400 Gb/s NDR InfiniBand port per GPU, bytes/s: a data-sheet figure,
#: not a measurement (one card moves no bytes between ranks)
NET_BW = 50e9
#: ``torch.cuda.get_device_properties(0).total_memory`` as an NVIDIA H100
#: 80GB HBM3, 700.00 W card reports it
HBM_PER_CHIP = 85_017_493_504

#: where the records go unless ``--out`` says otherwise
OUT_DIR = os.path.join("runs", "dryrun_torch")


def roofline_terms(flops, hbm_bytes, coll_bytes):
    """All inputs are per rank (the traced step is one rank's program)."""
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": coll_bytes / NET_BW,
    }


#: Per-arch gradient-accumulation defaults for train_4k (global batch 256),
#: copied from the JAX package: chosen there so that a microbatch's
#: activations fit v5e's 16 GB a chip; kept as they are so that the two
#: packages' records stay comparable.
DEFAULT_MB = {
    "nemotron_4_340b": 16, "llama4_maverick_400b_a17b": 8, "yi_9b": 8,
    "mistral_nemo_12b": 8, "pixtral_12b": 8, "moonshot_v1_16b_a3b": 8,
    "hubert_xlarge": 4, "gemma2_2b": 2, "hymba_1_5b": 4, "rwkv6_1_6b": 4,
}


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks in this process (this
    process rank 0; no transport), destroyed on exit.  Refuses to run
    where a process group is already initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            f"the dry-run traces on a fake process group of its own; one "
            f"({dist.get_backend()}, {dist.get_world_size()} ranks) is "
            "already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def apply_variant(cfg, variant: str, microbatches: int):
    """``(cfg, microbatches)`` under the named overrides of ``variant``
    (comma-separated): ``moe_shard_routing``, ``capacity_1_0``,
    ``remat_group_N``, ``mb_N``.  The JAX package's ``rwkv_chunk_N`` and
    ``ssm_chunk_N`` raise ``ValueError``: the port's scans take no chunk."""
    for v in [v for v in variant.split(",") if v]:
        if v == "moe_shard_routing":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, shard_routing=True))
        elif v == "capacity_1_0":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=1.0))
        elif v.startswith("remat_group_"):
            cfg = dataclasses.replace(cfg, remat_group=int(v.rsplit("_", 1)[1]))
        elif v.startswith("mb_"):
            microbatches = int(v.split("_")[1])
        elif v.startswith(("rwkv_chunk_", "ssm_chunk_")):
            raise ValueError(f"variant {v}: the port's RWKV6 and SSM scans "
                             "take no chunk (the chunk does not change the "
                             "result)")
        else:
            raise ValueError(f"unknown variant {v}")
    return cfg, microbatches


def mesh_shape_of(multi_pod: bool) -> tuple:
    return (2, 16, 16) if multi_pod else (16, 16)


def _split_rows(n: int, spec, sizes: dict) -> int:
    """The size of a dim of ``n`` split by a spec entry over ``sizes``."""
    axes = () if spec is None else ((spec,) if isinstance(spec, str)
                                    else tuple(spec))
    return n // math.prod(sizes[a] for a in axes)


def state_bytes(cfg, kind: str, mesh_shape: tuple) -> int:
    """The bytes of the parameters (and, for a ``"train"`` cell, AdamW's
    ``m`` and ``v``) as placed on a rank of a mesh of ``mesh_shape``, from
    the sharding rules' specs (no tensors)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm

    names = ("pod", "data", "model")[-len(mesh_shape):]

    class Description:
        axis_names = names
        shape = dict(zip(names, mesh_shape))

    mesh = Description()
    sizes = Description.shape
    p_shape, o_shape = steps_mod.init_shapes(cfg)

    def placed(tree, specs):
        total = 0
        for path, leaf in tfm.tree_items(tree):
            spec = specs
            for k in path:
                spec = spec[int(k)] if isinstance(spec, (tuple, list)) \
                    else spec[k]
            n = math.prod(_split_rows(d, spec[i] if i < len(spec) else None,
                                      sizes) for i, d in
                          enumerate(leaf.shape))
            total += n * leaf.element_size()
        return total

    total = placed(p_shape, shd.param_shardings(p_shape, cfg, mesh))
    if kind == "train":
        o_specs = shd.opt_shardings(o_shape, p_shape, cfg, mesh)
        total += placed(o_shape.m, o_specs.m) + placed(o_shape.v, o_specs.v)
    return total


def cell_meta(arch: str, shape: str, multi_pod: bool, microbatches: int = 0,
              variant: str = "", *, cell=None, mesh_shape=None, cfg=None):
    """``(cfg, cell, meta)`` of a cell without tracing it: the JAX
    record's skip and reason, or its ``arch``, ``shape``, ``variant``,
    ``mesh``, ``n_devices``, ``params``, ``active_params``,
    ``microbatches`` (train) and ``model_flops`` (6ND for a train cell,
    2ND otherwise, N the active parameters), and ``state_bytes_per_dev``.
    ``cell`` (a ``ShapeCell``), ``mesh_shape`` and ``cfg`` replace the
    named cell, the production mesh and the named config."""
    from repro_torch.configs import base as cb
    from repro_torch.launch.shapes import SHAPES, supported

    cfg, microbatches = apply_variant(cfg or cb.get(arch), variant,
                                      microbatches)
    cell = cell or SHAPES[shape]
    ok, reason = supported(cfg, shape) if shape in SHAPES else (True, "")
    if not ok:
        return cfg, cell, {"skipped": True, "reason": reason}
    mesh_shape = tuple(mesh_shape or mesh_shape_of(multi_pod))
    meta = {"arch": arch, "shape": shape, "variant": variant,
            "mesh": "x".join(str(s) for s in mesh_shape),
            "n_devices": math.prod(mesh_shape),
            "params": cfg.n_params(), "active_params": cfg.active_params()}
    tokens = cell.global_batch * (cell.seq if cell.kind != "decode" else 1)
    if cell.kind == "train":
        meta["microbatches"] = microbatches or DEFAULT_MB.get(arch, 1)
        meta["model_flops"] = 6 * cfg.active_params() * tokens
    else:
        meta["model_flops"] = 2 * cfg.active_params() * tokens
    meta["state_bytes_per_dev"] = state_bytes(cfg, cell.kind, mesh_shape)
    return cfg, cell, meta


def _mesh(mesh_shape: tuple, device):
    """The production mesh (``make_production_mesh``) for (16, 16) and (2,
    16, 16), else the ``make_test_mesh`` of ``mesh_shape``."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

    if mesh_shape in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                    device=device)
    if len(mesh_shape) == 2:
        return make_test_mesh(*mesh_shape, device=device)
    if len(mesh_shape) == 3 and mesh_shape[0] == 2:
        return make_test_mesh(*mesh_shape[1:], multi_pod=True, device=device)
    raise ValueError(f"no mesh of shape {mesh_shape}")


def _trace(cfg, cell, mesh, dev, microbatches: int):
    """One step of ``cfg`` on ``mesh`` traced on fake tensors: ``(cost,
    the parameters' and moments' bytes on this rank)``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import batch_specs
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init

    p_meta, _ = steps_mod.init_shapes(cfg)
    with FakeTensorMode():
        params = tfm.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=dev), p_meta)
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device=dev) for k, v
                 in batch_specs(cfg, cell.global_batch, cell.seq).items()}
        if cell.kind == "train":
            opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
            p, o = steps_mod.shard_train_state(cfg, mesh, params, opt)
            placed = [p, o.m, o.v]
            fn = steps_mod.make_train_step(cfg, mesh,
                                           microbatches=microbatches)
            args = (p, o, batch, 0)
        else:
            p = shd.distribute_tree(params, shd.param_shardings(
                params, cfg, mesh), mesh)
            placed = [p]
            if cell.kind == "prefill":
                fn = steps_mod.make_prefill_step(cfg, mesh, cell.seq)
                args = (p, batch)
            else:
                B = cell.global_batch
                fn = steps_mod.make_serve_step(cfg, mesh, B, cell.seq)
                args = (p, steps_mod.init_decode_state(cfg, mesh, B,
                                                       cell.seq, dev),
                        torch.zeros((B,), dtype=torch.int32, device=dev))
        del params
        state = sum(leaf.to_local().numel() * leaf.element_size()
                    for leaf in tfm.tree_leaves(placed))
        _, cost = hlo_analysis.analyze(fn, *args)
    return cost, state


def _weights(probes: tuple, x: int) -> list:
    """Lagrange weights that carry a quantity affine in ``x`` from its
    values at ``probes`` (one or two points) to ``x``."""
    if len(probes) == 1:
        return [1.0]
    p0, p1 = probes
    return [(p1 - x) / (p1 - p0), (x - p0) / (p1 - p0)]


def _probed(cfg, cell, mesh, dev, microbatches: int):
    """A train step's cost from short probes: the step at one and two
    checkpointed layer groups (the full step's group) and at two and
    three microbatches of the full step's rows (a batch of two and three
    microbatches), carried to the full depth and microbatch count by the
    bilinear fit its loops make exact (every group and every microbatch
    dispatches the same ops; the JAX analyzer multiplies a scan body by
    its trip count).  The memory is carried by the same fit; a peak is a
    maximum, not a sum, so the whole step's can differ a little (1.5 %
    more on a smoke config's (2, 2, 2) step).  Returns ``(cost,
    probes)``."""
    from repro_torch.launch.hlo_analysis import HloCost
    from repro_torch.launch.mesh import dp_size
    from repro_torch.models import transformer as tfm

    dp = dp_size(mesh)
    if cell.global_batch % microbatches or cell.global_batch % dp:
        raise ValueError(f"a batch of {cell.global_batch} rows does not "
                         f"split into {microbatches} microbatches over {dp} "
                         "data shards")
    kinds = len(tfm.pattern(cfg))
    n = cfg.n_layers // kinds
    g = tfm._remat_group(cfg, n) if cfg.remat else 1
    groups = n // g
    ks = (1, 2) if groups > 2 else (groups,)
    # the two smallest probes whose batch the data shards divide (the step
    # refuses another, as JAX does): 2 and 3 microbatches where the
    # shards divide one, else (fault F6's cells) e.g. 2 and 4
    rows = cell.global_batch // microbatches
    ms = tuple([m for m in range(2, microbatches)
                if rows * m % dp == 0][:2])
    if len(ms) < 2:
        ms = (microbatches,)
    total, mem = HloCost(), dict.fromkeys(("arg_bytes", "out_bytes",
                                           "peak_bytes"), 0.0)
    unknown = 0
    for k, wk in zip(ks, _weights(ks, groups)):
        c = dataclasses.replace(cfg, n_layers=k * g * kinds, remat_group=g)
        for m, wm in zip(ms, _weights(ms, microbatches)):
            rows = cell.global_batch * m // microbatches
            cost, _ = _trace(c, dataclasses.replace(cell, global_batch=rows),
                             mesh, dev, m)
            unknown = max(unknown, cost.unknown_trip_loops)
            total = total.merged(dataclasses.replace(
                cost, unknown_trip_loops=0), wk * wm)
            for key in mem:
                mem[key] += wk * wm * getattr(cost, key)
    total.unknown_trip_loops = unknown
    total.arg_bytes, total.out_bytes, total.peak_bytes = (
        int(round(mem[k])) for k in ("arg_bytes", "out_bytes", "peak_bytes"))
    total.temp_bytes = total.peak_bytes - total.arg_bytes - total.out_bytes
    return total, {"layers_per_group": g * kinds, "groups": list(ks),
                   "of_groups": groups, "microbatches": list(ms)}


def trace_cell(arch: str, shape: str, multi_pod: bool, microbatches: int = 0,
               variant: str = "", *, device=None, cell=None, mesh_shape=None,
               cfg=None, probe: bool = False):
    """Trace rank 0's step of one cell on fake tensors: the counterpart of
    the JAX ``lower_cell``.  Needs a (fake) process group of the mesh's
    size (see :func:`fake_world`).  Returns ``(cost, meta)``: the
    :class:`~repro_torch.launch.hlo_analysis.HloCost` of one step (None
    for a skipped cell) and the cell's meta (:func:`cell_meta`, with
    ``trace_s`` and ``device``).  With ``probe`` a train cell is counted
    from short probes (:func:`_probed`; ``meta["probes"]`` says which)."""
    from repro_torch.core.scheduler import resolve_device

    cfg, cell, meta = cell_meta(arch, shape, multi_pod, microbatches,
                                variant, cell=cell, mesh_shape=mesh_shape,
                                cfg=cfg)
    if meta.get("skipped"):
        return None, meta
    dev = resolve_device(device)
    mesh = _mesh(tuple(int(s) for s in meta["mesh"].split("x")), dev)
    t0 = time.time()
    if probe and cell.kind == "train":
        cost, meta["probes"] = _probed(cfg, cell, mesh, dev,
                                       meta["microbatches"])
    else:
        cost, meta["state_bytes_per_dev"] = _trace(
            cfg, cell, mesh, dev, meta.get("microbatches", 1))
    meta["trace_s"] = round(time.time() - t0, 1)
    meta["device"] = dev.type
    return cost, meta


def analyze_cell(cost, meta) -> dict:
    """The record of a traced cell: the JAX record's keys (see the module
    docstring for their meaning here)."""
    n = meta["n_devices"]
    terms = roofline_terms(cost.flops, cost.hbm_bytes, cost.coll_bytes)
    dominant = max(terms, key=terms.get)
    return dict(
        meta,
        hlo_flops_per_dev=cost.flops,
        hlo_hbm_bytes_per_dev=cost.hbm_bytes,
        coll_bytes_per_dev=cost.coll_bytes,
        coll_by_op=dict(cost.coll_by_op),
        unknown_trip_loops=cost.unknown_trip_loops,
        xla_cost_analysis_flops=float(cost.flop_counter_flops),
        memory_per_device_bytes=int(cost.peak_bytes),
        arg_bytes=int(cost.arg_bytes),
        temp_bytes=int(cost.temp_bytes),
        out_bytes=int(cost.out_bytes),
        fits_hbm=bool(cost.peak_bytes <= HBM_PER_CHIP),
        model_flops_per_dev=meta["model_flops"] / n,
        useful_flops_ratio=(meta["model_flops"] / n) / max(cost.flops, 1.0),
        kernels=cost.kernels,
        **terms,
        dominant=dominant,
    )


def run_cell(arch, shape, multi_pod, out_dir, force=False, microbatches=0,
             verbose=True, variant="", device=None):
    """Trace one cell (a train cell from probes, :func:`_probed`), write
    its record and return it."""
    os.makedirs(out_dir, exist_ok=True)
    mp = "pod2" if multi_pod else "pod1"
    suffix = f"__{variant.replace(',', '+')}" if variant else ""
    fn = os.path.join(out_dir, f"{arch}__{shape}__{mp}{suffix}.json")
    if os.path.exists(fn) and not force:
        if verbose:
            print(f"[skip-cached] {fn}")
        with open(fn) as f:
            return json.load(f)
    try:
        with fake_world(math.prod(mesh_shape_of(multi_pod))):
            cost, meta = trace_cell(arch, shape, multi_pod, microbatches,
                                    variant, device=device, probe=True)
        if cost is None:
            rec = meta | {"arch": arch, "shape": shape, "mesh": mp}
            print(f"[SKIP] {arch} x {shape}: {meta['reason']}")
        else:
            rec = analyze_cell(cost, meta)
            if verbose:
                print(f"[OK] {arch} x {shape} ({rec['mesh']}): "
                      f"mem/dev={rec['memory_per_device_bytes']/2**30:.2f}GiB "
                      f"fits={rec['fits_hbm']} "
                      f"compute={rec['compute_s']*1e3:.2f}ms "
                      f"memory={rec['memory_s']*1e3:.2f}ms "
                      f"coll={rec['collective_s']*1e3:.2f}ms "
                      f"dom={rec['dominant']} "
                      f"useful={rec['useful_flops_ratio']:.2f} "
                      f"trace={rec['trace_s']}s")
                print(f"  memory: args {rec['arg_bytes']/2**30:.3f} GiB, "
                      f"temp {rec['temp_bytes']/2**30:.3f} GiB, out "
                      f"{rec['out_bytes']/2**30:.3f} GiB; state "
                      f"{rec['state_bytes_per_dev']/2**30:.3f} GiB")
                print("  flop counter (model kernels not included): "
                      f"{rec['xla_cost_analysis_flops']:.3e}")
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "mesh": mp, "error": str(e),
               "traceback": traceback.format_exc()}
        print(f"[FAIL] {arch} x {shape}: {e}")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--variant", default="")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.launch.shapes import SHAPES

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out, force=args.force,
                               microbatches=args.microbatches,
                               variant=args.variant, device=args.device)
                n_fail += 1 if "error" in rec else 0
    print(f"done; failures={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
