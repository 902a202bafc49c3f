"""Train, prefill and serve steps: the port of the JAX package's
``launch/steps.py``.

``make_train_step(cfg, device)`` builds the canonical step on one device:
the loss's value and gradient (summed in float32 over microbatches and
divided, when there are several), the cosine schedule and AdamW, the
parameters and the state updated in place (as the JAX step's donated
buffers are).

``make_train_step(cfg, mesh)`` with a ``DeviceMesh`` builds the sharded
step.  The parameters and AdamW's ``m`` and ``v`` are DTensors under the
rules' placements (:func:`shard_train_state`: ``param_shardings`` /
``opt_shardings``, ZeRO-1 for the moments), and a rank computes with its
local tensors (``sharding.model_piece``; every config that
``sharding.tp_compute`` names):

- over ``"model"`` its piece of each leaf (tensor and expert
  parallelism): the layers compute its heads, FFN columns, vocabulary
  rows and experts and sum the partial results over the ``"model"``
  group (:mod:`repro_torch.models.layers`, ``moe``, ``transformer``);
- over ``"data"``, for a ``cfg.fsdp`` config, its piece of each leaf the
  rules split there too: the model gathers each one whole over
  ``"data"`` just before its layer (``layers.fsdp_gather``, inside the
  layer's checkpointed group), and the gather's backward reduce-scatters
  its gradient, summed over ``"data"``, back into the rank's piece.

RWKV6 and hymba gather every leaf whole (``full_tensor``) and compute
over ``"model"`` replicated.  Each rank takes its data shard of every
microbatch (the rows of its :func:`~repro_torch.launch.mesh.dp_index`)
and its loss is its share of the global one: the cross-entropy of its
rows times their share of the batch, and its share of the load-balance
loss (MoE layers route shard-locally, :mod:`repro_torch.models.moe`).  A
microbatch whose rows the data shards do not divide (fault F6) is
computed whole by every data rank under the model's global view, as the
JAX step's hints leave such a dim unsplit, and its share is its mean
loss over the data ranks.  The gradients are summed over the data axes
(``runtime.collectives``: the tree all-reduce when the mesh has pods),
FSDP's pieces over ``"pod"`` only, so they are the global gradient of the
rank's pieces; a leaf every model rank holds whole gets its whole
gradient on each (the region's entry sums it).  The gradient norm sums
the squares of a leaf split over ``"model"`` or ``"data"`` over that
axis.  AdamW then updates each rank's shard of the moments (FSDP's leaf
its own piece), and the parameters are gathered back into their own
placements (over the data axes; an identity for FSDP's pieces).
Reported are the global loss, ``ce``, ``lb_loss``, counters and
``grad_norm``.  Like the JAX step, it does not compress gradients.

``make_prefill_step`` and ``make_serve_step`` are bound to a mesh the same
way: a rank prefills and decodes its data shard's rows with its pieces
(FSDP's gathered a layer at a time);
logits and tokens come back as DTensors split over the data axes (the
logits gathered over the vocabulary), and the decode state is the rank's
piece of ``decode_state_shardings``: each attention cache every KV head
and the rank's block of its slots, split over ``"model"``
(:func:`repro_torch.models.layers.seq_plan`).  A serve batch that the data
axes do not divide (the ``long_500k`` cell's one lane on 32 data shards)
is decoded whole by every rank, its caches' slots split over the data
axes and ``"model"`` together, its tokens replicated DTensors, as the JAX
step replicates them; the prefill refuses such a batch, as the JAX
``batch_shardings`` does.  A whole state (as one device's ``prefill``
makes it) becomes a rank's through :func:`shard_decode_state`, as the JAX
package places a state onto the serve step's shardings.

Every mesh-bound step sets the model's axis hints
(:func:`repro_torch.models.layers.axis_hints`) for the length of one call
and restores the previous ones on exit.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import dp_axes, dp_index, dp_size, tp_size
from repro_torch.models import layers
from repro_torch.models import tensor_parallel as tpo
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.runtime import collectives as col


def init_shapes(cfg: ModelConfig):
    """Parameters and optimizer state as meta tensors: shapes and types,
    no allocation."""
    p_shape = tfm.init_params(cfg, None, "meta")
    return p_shape, adamw_init(p_shape, getattr(torch, cfg.opt_state_dtype))


def _is_mesh(x) -> bool:
    return hasattr(x, "mesh_dim_names")


def _split(batch: dict, microbatches: int) -> list:
    """The microbatches of ``batch``: consecutive blocks of its rows."""
    if microbatches == 1:
        return [batch]
    return [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                          + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(microbatches)]


def _grads(loss, leaves) -> list:
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read (hubert's token embedding) has a zero
    # gradient, as in JAX
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _accumulate(value_and_grad, leaves, mbs: list, device):
    """``(loss, metrics, grads)`` of one microbatch, or over several: the
    gradients summed in float32 and divided by their count, the loss their
    mean, the metrics the last one's."""
    if len(mbs) == 1:
        return value_and_grad(mbs[0])
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=device)
            for p in leaves]
    lsum = 0.0
    for mb in mbs:
        loss, metrics, grads = value_and_grad(mb)
        for acc, g in zip(gsum, grads):
            acc += g
        del grads
        lsum = lsum + loss
    n = len(mbs)
    return lsum / n, metrics, [g / n for g in gsum]


def make_train_step(cfg: ModelConfig, device, *, microbatches: int = 1,
                    peak_lr: float = 3e-4, total_steps: int = 100_000):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``.  ``batch`` holds numpy arrays or tensors of the global
    batch; ``params`` (made trainable) and ``opt_state`` are updated in
    place and returned.  MoE layers route with ``fold_in(PRNGKey(17),
    step)`` over one expert group, as on the JAX package's one-device
    mesh.  Metrics: ``loss`` (the mean over microbatches), ``lr``,
    ``grad_norm`` and, from the last microbatch, ``ce`` and the aux
    sums.  With a ``DeviceMesh`` for ``device``, the sharded step (see the
    module's docstring) over the state :func:`shard_train_state` gives."""
    if _is_mesh(device):
        return _sharded_train_step(cfg, device, microbatches=microbatches,
                                   peak_lr=peak_lr, total_steps=total_steps)
    device = torch.device(device)
    warmup = max(1, min(2000, total_steps // 10))

    def train_step(params, opt_state, batch, step):
        params.requires_grad_(True)
        leaves = tfm.tree_leaves(params)
        rng = prng.fold_in(prng.PRNGKey(17), int(step))
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}

        def value_and_grad(mb):
            # MoE routing's expert groups: the tensor-parallel size of the
            # JAX package's one-device mesh
            loss, metrics = tfm.loss_fn(params, cfg, mb, rng, ep_groups=1)
            return loss.detach(), {k: v.detach() for k, v in
                                   metrics.items()}, _grads(loss, leaves)

        loss, metrics, grads = _accumulate(
            value_and_grad, leaves, _split(batch, microbatches), device)
        lr = cosine_schedule(step, peak_lr=peak_lr, total=total_steps,
                             warmup=warmup).to(device)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, lr=lr)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# mesh-bound steps
# ---------------------------------------------------------------------------

class _Description:
    """A mesh's axes and sizes without its ranks: under hints of a
    description the model takes the global view (every row on this
    rank)."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))


def _hints(mesh, *, rank_rows: bool = True, tp: bool = False, fsdp=None,
           max_len=None):
    """The model's axis hints of ``mesh`` for one step call; with
    ``rank_rows`` False the rank holds the whole batch (global view); with
    ``tp`` the weights are the rank's ``"model"`` pieces; ``fsdp`` (the
    parameters' :func:`~repro_torch.launch.sharding.fsdp_dims`) names the
    leaves that are the rank's ``"data"`` pieces, gathered one layer at a
    time; with ``max_len`` the decode caches of that many slots are split
    along their slots as ``decode_state_shardings`` lays them out
    (:func:`repro_torch.models.layers.seq_plan`)."""
    return layers.axis_hints(dp_axes=dp_axes(mesh), dp_size=dp_size(mesh),
                             tp_size=tp_size(mesh),
                             mesh=mesh if rank_rows else _Description(mesh),
                             tp_mesh=mesh if tp else None, fsdp_mesh=mesh,
                             fsdp_dims=fsdp,
                             seq_mesh=None if max_len is None else mesh,
                             max_len=max_len)


def _full(x):
    """A DTensor's whole tensor (gathered), a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _pieces(params, cfg: ModelConfig):
    """The leaves a rank computes with: its local pieces (over
    ``"model"`` and, for FSDP's leaves, ``"data"``) for a config that the
    steps split over ``"model"``, else the whole tensors."""
    return tfm.tree_map(shd.model_piece if shd.tp_compute(cfg) else _full,
                        params)


def _fsdp(params, cfg: ModelConfig):
    """The parameters' FSDP dims for the hints (None when no leaf is a
    ``"data"`` piece: a config the steps gather whole, or no FSDP)."""
    return shd.fsdp_dims(params) if shd.tp_compute(cfg) else None


def _source(leaf, mesh, cfg: ModelConfig) -> tuple:
    """The placements of the tensor a rank computes with for ``leaf``:
    the leaf's own (its local pieces), or replicated for a whole
    tensor."""
    from torch.distributed.tensor import Replicate

    if shd.tp_compute(cfg) and hasattr(leaf, "placements"):
        return tuple(leaf.placements)
    return (Replicate(),) * mesh.ndim


def _placed(t, mesh, src, placements):
    """This rank's piece under ``placements`` of the tensor ``t`` placed
    as ``src`` (local slicing: every rank of an axis ``src`` replicates
    holds ``t``)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, src, run_check=False).redistribute(
        mesh, placements).to_local()


def _check_rows(n: int, mesh, what: str) -> None:
    if n % dp_size(mesh):
        raise ValueError(f"{what} of {n} rows does not split over the "
                         f"{dp_size(mesh)} data shards of the mesh")


def _rows(x, mesh, device):
    """This rank's data shard of ``x``: the local rows of a DTensor split
    over the data axes (as these steps return them), else the rank's
    block of the global rows."""
    if hasattr(x, "to_local"):
        return x.to_local()
    x = torch.as_tensor(x, device=device)
    _check_rows(x.shape[0], mesh, "a batch")
    b = x.shape[0] // dp_size(mesh)
    s = dp_index(mesh)
    return x[s * b:(s + 1) * b]


def _replicated(x, mesh):
    """``x``, which every rank holds whole, as a DTensor replicated over
    the mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def rows_on_mesh(x, mesh):
    """This rank's rows as a DTensor split over the data axes (replicated
    over ``"model"``)."""
    from torch.distributed.tensor import DTensor

    spec = (dp_axes(mesh),) + (None,) * (x.dim() - 1)
    return DTensor.from_local(x, mesh, shd.placements(spec, mesh),
                              run_check=False)


def _device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_train_state(cfg: ModelConfig, mesh, params, opt_state):
    """``(params, opt_state)`` as DTensors on ``mesh`` under
    ``param_shardings`` and ``opt_shardings`` (the parameters' tree a
    dict, the state an ``AdamWState``): what the sharded step takes."""
    params = tfm.tree_map(torch.Tensor.detach, params)
    return (shd.distribute_tree(params, shd.param_shardings(params, cfg,
                                                            mesh), mesh),
            shd.distribute_tree(opt_state, shd.opt_shardings(
                opt_state, params, cfg, mesh), mesh))


def _sum_over_data(tensors: list, mesh, fsdp=None) -> list:
    """Each tensor summed over the data axes: the tree all-reduce with
    pods, one flat all-reduce without.  A tensor whose flag in ``fsdp`` is
    set (a gradient of FSDP's ``"data"`` piece, which the gather's
    backward has summed over ``"data"`` already) is summed over ``"pod"``
    only, and with no pods left as it is."""
    def psum(ts):
        if "pod" in mesh.mesh_dim_names:
            return col.hierarchical_psum_grads(ts, mesh)
        return col.flat_psum_grads(ts, mesh, ("data",))

    if not fsdp or not any(fsdp):
        return psum(tensors)
    rest = iter(psum([t for t, f in zip(tensors, fsdp) if not f]))
    pieces = [t for t, f in zip(tensors, fsdp) if f]
    if "pod" in mesh.mesh_dim_names:
        pieces = col.flat_psum_grads(pieces, mesh, ("pod",))
    pieces = iter(pieces)
    return [next(pieces) if f else next(rest) for f in fsdp]


def _grad_norm(grads, dleaves, mesh, cfg: ModelConfig, fsdp=None):
    """The global gradient norm of the rank's gradients (summed over the
    data axes): the squares of leaves split over ``"model"`` summed over
    ``"model"``, of FSDP's ``"data"`` pieces (flags ``fsdp``) over
    ``"data"``, of a leaf split over both over both; a leaf every rank of
    an axis holds whole is counted once there."""
    tp = tp_size(mesh) > 1 and shd.tp_compute(cfg)
    if not fsdp or not any(fsdp):
        fsdp = None
        if not tp:
            return global_norm(grads)
    zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    # [whole, split over "model", over "data", over both]
    sums = [zero] * 4
    for i, (g, p) in enumerate(zip(grads, dleaves)):
        k = (tp and shd.is_model_split(p)) + 2 * bool(fsdp and fsdp[i])
        sums[k] = sums[k] + torch.sum(torch.square(g.float()))
    whole, split = sums[0], sums[1]
    if fsdp is not None:
        data, both = col.flat_psum_grads([torch.stack(sums[2:])], mesh,
                                         ("data",))[0]
        whole, split = whole + data, split + both
    return torch.sqrt(tpo.out_of_tp(split, mesh) + whole)


def _sharded_train_step(cfg: ModelConfig, mesh, *, microbatches: int,
                        peak_lr: float, total_steps: int):
    from torch.distributed.tensor import DTensor

    dp, tp = dp_size(mesh), tp_size(mesh)
    tpc = shd.tp_compute(cfg)
    warmup = max(1, min(2000, total_steps // 10))

    def train_step(params, opt_state, batch, step):
        dleaves = tfm.tree_leaves(params)
        device = dleaves[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % microbatches or n % dp:
            raise ValueError(
                f"a batch of {n} rows does not split into "
                f"{microbatches} microbatches over {dp} data shards")
        # F6: a microbatch whose rows the data shards do not divide is
        # computed whole by every data rank (the global view), as the JAX
        # step's hints leave such a dim unsplit
        whole = (n // microbatches) % dp != 0
        fsdp = _fsdp(params, cfg)
        flags = None if fsdp is None else [
            shd.fsdp_dim(p) is not None for p in dleaves]
        with _hints(mesh, rank_rows=not whole, tp=tpc, fsdp=fsdp):
            leaves = [p.detach().requires_grad_(True)
                      for p in tfm.tree_leaves(_pieces(params, cfg))]
            tree = tfm.tree_unflatten(params, leaves)
            rng = prng.fold_in(prng.PRNGKey(17), int(step))
            mbs = _split(batch, microbatches)
            if not whole:
                mbs = [{k: _rows(v, mesh, device) for k, v in mb.items()}
                       for mb in mbs]

            def value_and_grad(mb):
                loss, metrics = tfm.loss_fn(tree, cfg, mb, rng,
                                            ep_groups=tp, dp_groups=dp)
                if whole:
                    # every data rank holds the whole microbatch: its
                    # share is the mean loss over the data ranks
                    share = loss * (1.0 / dp)
                    lb = metrics["lb_loss"] * (1.0 / dp)
                else:
                    # the rank's share of the global loss: its rows' mean
                    # cross-entropy weighted by their share of the rows,
                    # and its share of the load-balance loss
                    share = metrics["ce"] * (1.0 / dp) \
                        + 0.01 * metrics["lb_loss"]
                    lb = metrics["lb_loss"]
                grads = _grads(share, leaves)
                metrics = {k: v.detach() for k, v in metrics.items()}
                total = _sum_over_data([torch.stack([
                    share.detach(), metrics["ce"] * (1.0 / dp),
                    lb.detach()])], mesh)[0]
                metrics.update(ce=total[1], lb_loss=total[2])
                return total[0], metrics, grads

            loss, metrics, local = _accumulate(value_and_grad, leaves, mbs,
                                               device)
            grads = _sum_over_data(local, mesh, flags)
            del local
            lr = cosine_schedule(step, peak_lr=peak_lr, total=total_steps,
                                 warmup=warmup).to(device)
            with torch.no_grad():
                gnorm = _grad_norm(grads, dleaves, mesh, cfg, flags)
                ms = tfm.tree_leaves(opt_state.m)
                vs = tfm.tree_leaves(opt_state.v)
                src = [_source(p, mesh, cfg) for p in dleaves]
                # AdamW on this rank's shard of each moment (ZeRO-1)
                pieces = [_placed(p.detach(), mesh, s, m.placements)
                          for p, s, m in zip(leaves, src, ms)]
                g_pieces = [_placed(g, mesh, s, m.placements)
                            for g, s, m in zip(grads, src, ms)]
                del grads
                local_state = AdamWState(opt_state.step.to_local(),
                                         [m.to_local() for m in ms],
                                         [v.to_local() for v in vs])
                _, new_state, opt_metrics = adamw_update(
                    g_pieces, local_state, pieces, lr=lr, grad_norm=gnorm)
                # the updated pieces back into the parameters' placements
                for p, piece, m in zip(dleaves, pieces, ms):
                    p.to_local().copy_(DTensor.from_local(
                        piece, mesh, m.placements, run_check=False
                    ).redistribute(mesh, p.placements).to_local())
                step_t = DTensor.from_local(new_state.step, mesh,
                                            opt_state.step.placements,
                                            run_check=False)
        metrics = dict(metrics, loss=loss, lr=lr, **opt_metrics)
        return params, AdamWState(step_t, opt_state.m, opt_state.v), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh, max_len: int):
    """``prefill_step(params, batch)`` on ``mesh``: this rank's data shard
    of the global ``batch`` prefilled for caches of ``max_len`` slots.
    Returns ``(logits, state)``: the last position's logits (gathered over
    a vocabulary split over ``"model"``) as a DTensor split over the data
    axes and the rank's ``DecodeState``; an encoder-only config returns
    the full forward's logits alone (its "prefill" is one bidirectional
    forward, as in the JAX package).  ``params`` are DTensors (their
    ``"model"`` pieces taken here) or plain tensors."""
    dp, tp = dp_size(mesh), tp_size(mesh)
    device = _device(mesh)
    tpc = shd.tp_compute(cfg)

    def whole(logits):
        return (tpo.gather_over_model(logits, mesh)
                if logits.shape[-1] != cfg.vocab else logits)

    @torch.no_grad()
    def prefill_step(params, batch):
        with _hints(mesh, tp=tpc, fsdp=_fsdp(params, cfg), max_len=max_len):
            pieces = _pieces(params, cfg)
            local = {k: _rows(v, mesh, device) for k, v in batch.items()}
            if cfg.encoder_only:
                logits, _aux = tfm.forward(pieces, cfg, local,
                                           ep_groups=tp, dp_groups=dp)
                return rows_on_mesh(whole(logits), mesh)
            logits, state = tfm.prefill(pieces, cfg, local, max_len,
                                        ep_groups=tp, dp_groups=dp)
            return rows_on_mesh(whole(logits), mesh), state

    return prefill_step


def shard_decode_state(cfg: ModelConfig, mesh, state):
    """A whole decode ``state`` (every lane, as one device's ``prefill``
    makes it) as a rank of ``mesh`` holds it for :func:`make_serve_step`,
    as the JAX package places a state onto the serve step's shardings
    (``decode_state_shardings``): the rank's lanes where the data axes
    divide the batch (else every lane), and each attention cache's block
    of slots under the sequence split
    (:func:`repro_torch.models.layers.seq_plan`; whole where tp does not
    divide its slots).  The RWKV6 and SSM states stay whole over
    ``"model"``, as the steps compute those layers.  The pieces are
    copies: decoding writes into them in place."""
    B = state.length.shape[0]
    rows = B % dp_size(mesh) == 0
    b = B // dp_size(mesh) if rows else B
    lanes = dp_index(mesh) * b if rows else 0
    caches = []
    for c in state.caches:
        sp = layers.seq_plan(c["k"].shape[3], mesh, rows) if "k" in c \
            else None
        piece = {}
        for f, t in c.items():
            t = t.narrow(1, lanes, b)
            if sp is not None and f in tfm.CACHE_KEYS:
                t = t.narrow(3, sp.lo, sp.n)
            piece[f] = t.clone(memory_format=torch.contiguous_format)
        caches.append(piece)
    return tfm.DecodeState(caches=tuple(caches),
                           length=state.length.narrow(0, lanes, b).clone())


def make_serve_step(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """``serve_step(params, state, tokens) -> (next_tokens, state)``: one
    greedy decode step on ``mesh`` for a global batch of ``batch`` lanes
    with caches of ``max_len`` slots, the state a rank's own (as
    :func:`make_prefill_step`, :func:`init_decode_state` or
    :func:`shard_decode_state` give it; updated in place).
    ``tokens`` is the global ``(batch,)`` vector or the DTensor the
    previous step returned; so are the next tokens.  When the data axes
    divide ``batch``, a rank decodes its data shard's lanes and the tokens
    are split over the data axes; else every rank decodes all ``batch``
    lanes (its state holds them all) and the tokens are replicated, as in
    the JAX step (``P(dp if batch % dpn == 0 else None)``).  The greedy
    token is the lowest id among equal maxima, also over a vocabulary
    split over ``"model"`` (:func:`repro_torch.models.transformer.
    greedy_ids`)."""
    dp, tp = dp_size(mesh), tp_size(mesh)
    device = _device(mesh)
    split = batch % dp == 0
    tpc = shd.tp_compute(cfg)

    @torch.no_grad()
    def serve_step(params, state, tokens):
        with _hints(mesh, rank_rows=split, tp=tpc, fsdp=_fsdp(params, cfg),
                    max_len=max_len):
            if split:
                tokens = _rows(tokens, mesh, device)
            elif hasattr(tokens, "to_local"):
                tokens = tokens.to_local()
            else:
                tokens = torch.as_tensor(tokens, device=device)
            logits, state = tfm.decode_step(
                _pieces(params, cfg), cfg, state, tokens, ep_groups=tp,
                dp_groups=dp)
            # greedy next token (serving drivers may replace with sampling)
            nxt = tfm.greedy_ids(logits, cfg)
            return (rows_on_mesh(nxt, mesh) if split
                    else _replicated(nxt, mesh)), state

    return serve_step


def init_decode_state(cfg: ModelConfig, mesh, batch: int, max_len: int,
                      device=None):
    """An empty decode state for a global batch of ``batch`` lanes as a
    rank of ``mesh`` holds it for :func:`make_serve_step`: the rank's
    lanes where the data axes divide ``batch`` (else every lane), each
    attention cache every KV head and its block of slots."""
    rows = batch % dp_size(mesh) == 0
    with _hints(mesh, rank_rows=rows, tp=shd.tp_compute(cfg),
                max_len=max_len):
        return tfm.init_decode_state(
            cfg, batch // dp_size(mesh) if rows else batch, max_len,
            device or _device(mesh))
