"""The decoder / encoder stack: the port of the JAX package's
``models/transformer.py`` on one device (its inference and training
paths).

Layers are grouped into a repeating *pattern* of P block kinds (gemma2:
(local, full); llama4: (dense, moe); hymba: (full, local x7)); parameters
are stacked per pattern position with a leading dim of ``n_layers / P``,
as in the JAX package, and the stack is applied by a Python loop over that
dim (the JAX package's ``lax.scan``).  Training rematerialises as the JAX
package does: with ``cfg.remat``, grad enabled and no cache collected,
each group of ``_remat_group(cfg, n)`` pattern steps runs under
``torch.utils.checkpoint`` (non-reentrant), so only a group's input is kept
and its activations are recomputed in the backward (gemma2_2b: 13 groups
of one pattern step, so each attention layer's forward runs twice a
step).

Parameters are a :class:`ParamTree`, an ``nn.Module`` whose parameters map
one to one onto the JAX parameter tree's leaves (``embed``,
``final_norm``, ``lm_head`` when the head is untied, ``frontend.proj``
for a modality frontend, and ``streams``: one tree per pattern position);
``params_from_numpy`` carries a JAX tree across leaf for leaf.

Public API:
  pattern(cfg)                              -> tuple of BlockKind
  init_params(cfg, generator, device)       -> ParamTree
  params_from_numpy(tree, cfg, device)      -> ParamTree
  forward(params, cfg, batch, rng)          -> (logits, aux)
  loss_fn(params, cfg, batch, rng)          -> (loss, metrics)
  prefill(params, cfg, batch, max_len, rng) -> (last logits, DecodeState)
  init_decode_state(cfg, B, max_len, dev)   -> DecodeState (zeros)
  decode_step(params, cfg, state, tokens, rng) -> (logits, DecodeState)

Every block kind runs: dense attention, MoE (an MoE block every
``interleave``-th layer, routed by :mod:`repro_torch.models.moe`), RWKV6
(``family == "ssm"``: time mix and channel mix, O(1) decode state) and
hymba's parallel attention + SSM heads (:mod:`repro_torch.models.ssm`,
``0.5 * (rmsnorm(attn_ln, a) + rmsnorm(ssm_ln, s))``, with the SSM state
and conv carry in the decode cache).  Two stub frontends embed the
inputs: ``audio_frames`` projects precomputed frames and has no token
embedding (hubert, encoder-only: ``forward`` only), ``vit_patches``
prepends projected patches to the embedded text (pixtral), so a prompt
of S text tokens fills ``frontend_len + S`` cache slots.  ``loss_fn``
is the mean next-token cross-entropy (encoder-only: against
``targets``; vision: over the text positions) plus 0.01 times the MoE
load-balance loss, through :class:`_ce_mean`, the reference's custom VJP:
no ``(N, V)`` float32 gradient is kept.  Every block kind trains: the
kernels' backwards are plain PyTorch (see :mod:`repro_torch.kernels.ops`),
and a rematerialised group routes its MoE layers again from the same host
keys, so the recompute dispatches exactly as the first pass did.

The routing key ``rng`` is a pair of uint32 words
(:mod:`repro_torch.core.prng`), ``PRNGKey(0)`` by default as in the JAX
package; layer ``idx`` of pattern position ``pidx`` routes with
``fold_in(rng, idx * P + pidx)``, derived on the host.  ``ep_groups`` (16 by
default, as in the JAX package) is the expert-group count of the routing's
locality bonus; ``dp_groups`` (1 by default) the data shards an MoE layer
routes apart (:func:`repro_torch.models.moe.moe_apply`).

Under a mesh-bound step's FSDP hints the leaves a ``cfg.fsdp`` config
splits over ``"data"`` are the rank's pieces: ``forward`` and
``decode_step`` gather each layer's just before its block (inside the
checkpointed group, so the recompute gathers again), the embedding and
head where they are read (:func:`repro_torch.models.layers.fsdp_gather`).
Under its sequence hints the decode caches are the rank's blocks of
their slots (:func:`repro_torch.models.layers.seq_plan`): ``prefill``
builds each layer's as the layer ends.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models import layers, moe, rwkv, ssm
from repro_torch.models import tensor_parallel as tpo

AUX_KEYS = ("lb_loss", "ntasks_static", "ntasks_stolen_local",
            "ntasks_stolen_remote", "ntasks_dropped", "max_load")
CACHE_KEYS = ("k", "v", "k_scale", "v_scale")


class BlockKind(NamedTuple):
    attn: Optional[str]   # "full" | "local" | "bidir" | None (rwkv)
    moe: bool
    ssm: bool
    rwkv: bool


def pattern(cfg: ModelConfig):
    if cfg.family == "ssm":
        return (BlockKind(None, False, False, True),)
    ilv = cfg.moe.interleave if cfg.moe else 1
    P = math.lcm(len(cfg.attn_pattern), ilv)
    return tuple(
        BlockKind(attn=cfg.attn_pattern[i % len(cfg.attn_pattern)],
                  moe=bool(cfg.moe) and (i % ilv == ilv - 1),
                  ssm=cfg.parallel_ssm, rwkv=False)
        for i in range(P))


class ParamTree(nn.Module):
    """A nested mapping of tensors as a module: a dict becomes a
    ``ParamTree``, a tuple an ``nn.ModuleList``, a tensor a frozen
    ``nn.Parameter``; ``named_parameters()`` paths are the JAX tree's key
    paths (``streams.0.attn.wq``).  ``tree["key"]`` reads a child.  Serving
    keeps the parameters frozen; ``requires_grad_()`` (``nn.Module``'s)
    makes them trainable, as the train step does."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, (tuple, list)):
                self.add_module(key, nn.ModuleList(ParamTree(x)
                                                   for x in val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def keys(self):
        return list(self._parameters) + list(self._modules)


def tree_items(tree, path: tuple = ()):
    """``(key path, leaf)`` pairs of a tree in the JAX package's leaf
    order: mapping keys (a dict's, a ``ParamTree``'s) sorted, a
    NamedTuple's fields in order, a sequence (tuple, list,
    ``nn.ModuleList``) by index (its path key the index as a string)."""
    if isinstance(tree, (dict, ParamTree)):
        for k in sorted(tree.keys()):
            yield from tree_items(tree[k], path + (k,))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_items(getattr(tree, k), path + (k,))
    elif isinstance(tree, (tuple, list, nn.ModuleList)):
        for i, x in enumerate(tree):
            yield from tree_items(x, path + (str(i),))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves of a tree in the JAX package's order (see
    :func:`tree_items`)."""
    return [leaf for _, leaf in tree_items(tree)]


def _unflatten(node, path: tuple, by_path: dict):
    if isinstance(node, (dict, ParamTree)):
        return {k: _unflatten(node[k], path + (k,), by_path)
                for k in node.keys()}
    if hasattr(node, "_fields"):
        return type(node)(*(_unflatten(getattr(node, k), path + (k,), by_path)
                            for k in node._fields))
    if isinstance(node, (tuple, list, nn.ModuleList)):
        out = [_unflatten(x, path + (str(i),), by_path)
               for i, x in enumerate(node)]
        return out if isinstance(node, list) else tuple(out)
    return by_path[path]


def tree_unflatten(like, leaves) -> object:
    """``like``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order: a ``ParamTree`` stays one (of frozen
    parameters), dicts, lists, tuples and NamedTuples keep their types.
    (A plain recursive function, not a closure: a closure's reference
    cycle would keep the leaves alive until the cyclic collector ran.)"""
    paths, leaves = [p for p, _ in tree_items(like)], list(leaves)
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    tree = _unflatten(like, (), dict(zip(paths, leaves)))
    return ParamTree(tree) if isinstance(like, ParamTree) else tree


def tree_map(fn, tree):
    """A tree of ``tree``'s structure holding ``fn(leaf)`` for each leaf,
    called in leaf order (a ``ParamTree`` stays one)."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _index(tree, i: int) -> dict:
    """Layer ``i`` of a stacked tree, as a dict of views."""
    return {k: _index(tree[k], i) if isinstance(tree[k], (ParamTree, dict))
            else tree[k][i] for k in tree.keys()}


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, as dicts of views: each leaf is
    unbound once, so its gradient is one stack of the layers' gradients
    (indexing layer by layer would add a zero-padded stacked-size gradient
    per layer)."""
    out = [{} for _ in range(n)]
    for k in tree.keys():
        parts = (_unstack(tree[k], n) if isinstance(tree[k], (ParamTree, dict))
                 else tree[k].unbind(0))
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _block_init(cfg: ModelConfig, kind: BlockKind, n: int, generator,
                device):
    D = cfg.d_model

    def zeros():
        return torch.zeros((n, D), dtype=cfg.pdtype, device=device)

    p = {"ln1": zeros(), "ln2": zeros()}
    if kind.rwkv:
        p["rwkv"] = rwkv.rwkv_init(cfg, generator, device, lead=(n,))
        return p
    p["attn"] = layers.attn_init(cfg, generator, device, lead=(n,))
    if kind.ssm:
        p["ssm"] = ssm.ssm_init(cfg, generator, device, lead=(n,))
        p["attn_ln"] = zeros()
        p["ssm_ln"] = zeros()
    p["mlp"] = (moe.moe_init(cfg, generator, device, lead=(n,)) if kind.moe
                else layers.mlp_init(cfg, cfg.d_ff, generator, device,
                                     lead=(n,)))
    if cfg.post_block_norms:
        p["pln1"] = zeros()
        p["pln2"] = zeros()
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device) -> ParamTree:
    """Random weights drawn from ``generator`` (a ``torch.Generator`` on
    ``device``) with the JAX package's scales: embeddings N(0, 1), dense
    weights N(0, 1/fan_in), norm scales 0.  The MoE experts' leaves are
    drawn one layer at a time (see :func:`repro_torch.models.moe.moe_init`);
    every other leaf in one draw per stacked leaf; the frontend's
    projection is drawn last, so the other leaves of a config are the
    same with or without one.  The JAX package draws other numbers from
    its keys; tests carry its weights across with
    :func:`params_from_numpy`."""
    kinds = pattern(cfg)
    P = len(kinds)
    if cfg.n_layers % P:
        raise ValueError(f"{cfg.n_layers} layers do not fill a pattern of "
                         f"{P}")
    n = cfg.n_layers // P
    tree = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                             device=device,
                             dtype=torch.float32).to(cfg.pdtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.pdtype,
                                  device=device),
        "streams": tuple(_block_init(cfg, kind, n, generator, device)
                         for kind in kinds),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = layers._dense_init(
            (cfg.d_model, cfg.vocab), cfg.pdtype, generator, device)
    if cfg.frontend:
        tree["frontend"] = {"proj": layers._dense_init(
            (cfg.frontend_dim, cfg.d_model), cfg.pdtype, generator, device)}
    return ParamTree(tree)


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu"
                      ) -> ParamTree:
    """The JAX parameter tree (``embed``, ``final_norm``, optional
    ``lm_head`` and ``frontend``, ``streams``), given as numpy arrays, as
    the port's parameters.  Both packages keep weights ``(in, out)``, so
    each leaf is copied as it is, never transposed; its key path, shape and
    dtype must be the ones :func:`init_params` makes for ``cfg``."""
    want = init_params(cfg, None, "meta")

    def conv(node, spec, path):
        if isinstance(spec, (ParamTree, nn.ModuleList)):
            keys = (list(range(len(spec))) if isinstance(spec, nn.ModuleList)
                    else sorted(spec.keys()))
            have = (list(range(len(node))) if isinstance(node, (tuple, list))
                    else sorted(node.keys()))
            if have != keys:
                raise ValueError(f"{path or 'tree'}: keys {have}, expected "
                                 f"{keys}")
            out = [conv(node[k], spec[k], f"{path}.{k}".lstrip("."))
                   for k in keys]
            return (tuple(out) if isinstance(spec, nn.ModuleList)
                    else dict(zip(keys, out)))
        t = _tensor_from_numpy(node)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(spec.shape)} {spec.dtype}")
        return t.to(device)

    return ParamTree(conv(tree, want, ""))


def _zero_aux(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _remat_group(cfg: ModelConfig, n: int) -> int:
    """Pattern steps per checkpointed group: ``cfg.remat_group`` where it
    divides ``n``, else the largest divisor of ``n`` up to ``isqrt(n)``
    (1 for a prime ``n``)."""
    if cfg.remat_group and n % cfg.remat_group == 0:
        return cfg.remat_group
    best = 1
    for g in range(2, int(math.isqrt(n)) + 1):
        if n % g == 0:
            best = g
    return best


def _apply_block(bp, x, cfg: ModelConfig, kind: BlockKind, rng, ep_groups,
                 dp_groups, max_len=None):
    """Prefill block.  Returns (x, cache, aux): with ``max_len`` the
    layer's decode state (its attention cache of ``max_len`` slots, built
    here from every KV head in the rank's layout, and, with SSM heads, the
    SSM state and conv carry; or the RWKV state and token-shift tails; all
    final), else None; and the MoE layer's counters (None for other
    blocks)."""
    h = layers.rmsnorm(bp["ln1"], x)
    if kind.rwkv:
        state0 = torch.zeros((x.shape[0], cfg.n_heads, cfg.head_dim,
                              cfg.head_dim), dtype=torch.float32,
                             device=x.device)
        a, state, tail = rwkv.time_mix(bp["rwkv"], h, cfg, state0)
        x = x + a
        m, tail2 = rwkv.channel_mix(bp["rwkv"],
                                    layers.rmsnorm(bp["ln2"], x))
        return x + m, {"rwkv_state": state, "tm_last": tail,
                       "cm_last": tail2}, None
    a, (kt, vt) = layers.attn_apply(bp["attn"], h, cfg, kind.attn,
                                    all_kv=max_len is not None)
    src = None if max_len is None else layers.attn_cache_from_prefill(
        cfg, kind.attn, kt, vt, max_len)._asdict()
    del kt, vt
    if kind.ssm:
        s_out, s_state, s_conv = ssm.ssm_apply(bp["ssm"], h, cfg)
        if src is not None:
            src.update(ssm_state=s_state, ssm_conv=s_conv)
        a = 0.5 * (layers.rmsnorm(bp["attn_ln"], a)
                   + layers.rmsnorm(bp["ssm_ln"], s_out))
    if cfg.post_block_norms:
        a = layers.rmsnorm(bp["pln1"], a)
    x = x + a
    h2 = layers.rmsnorm(bp["ln2"], x)
    aux = None
    if kind.moe:
        m, aux = moe.moe_apply(bp["mlp"], h2, cfg, ep_groups=ep_groups,
                               rng=rng, dp_groups=dp_groups)
    else:
        m = layers.mlp_apply(bp["mlp"], h2, cfg)
    if cfg.post_block_norms:
        m = layers.rmsnorm(bp["pln2"], m)
    return x + m, src, aux


def vocab_piece(cfg: ModelConfig):
    """``(region, lo, n)`` when a tensor-parallel region splits the vocab
    over ``"model"`` (the rank's rows ``[lo, lo + n)`` of ``embed``, its
    columns of ``lm_head`` and of the logits), else None: the rules split
    it where tp divides it."""
    t = layers.tp_region()
    if t is None or cfg.vocab % t.size:
        return None
    n = cfg.vocab // t.size
    return t, t.rank * n, n


def _embed_tokens(params, cfg: ModelConfig, tok):
    embed = layers.fsdp_gather(params["embed"], "embed")
    vp = vocab_piece(cfg)
    if vp is None:
        x = embed[tok.long()].to(cfg.cdtype)
    else:
        # vocab-parallel: the rank's rows, zeros for the ids it does not
        # hold, summed over "model"
        t, lo, n = vp
        layers._split(t, embed, 0, cfg.vocab)
        ids = tok.long() - lo
        mine = (ids >= 0) & (ids < n)
        rows = embed[ids.clamp(0, n - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        x = tpo.out_of_tp(rows, t.mesh).to(cfg.cdtype)
    if cfg.tie_embeddings:
        # the scale is rounded to the compute dtype first, as in JAX
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype,
                             device=x.device)
    return x


def _embed_inputs(params, cfg: ModelConfig, batch):
    if cfg.frontend == "audio_frames":
        return batch["frames"].to(cfg.cdtype) @ params["frontend"]["proj"]
    x = _embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend == "vit_patches":
        xp = batch["patches"].to(cfg.cdtype) @ params["frontend"]["proj"]
        x = torch.cat([xp, x], dim=1)
    return x


def prompt_len(cfg: ModelConfig, batch) -> int:
    """Positions a prefill of ``batch`` fills: the frames of an audio
    batch; the text tokens, behind ``frontend_len`` patches for a vision
    batch."""
    if cfg.frontend == "audio_frames":
        return batch["frames"].shape[1]
    S = batch["tokens"].shape[1]
    return S + cfg.frontend_len if cfg.frontend == "vit_patches" else S


def _logits(params, cfg: ModelConfig, x):
    """Logits in the compute dtype, with the final softcap; the rank's
    vocab columns when a tensor-parallel region splits the vocab
    (:func:`vocab_piece`)."""
    x = layers.rmsnorm(params["final_norm"], x)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head = layers.fsdp_gather(params[name], name)
    vp = vocab_piece(cfg)
    if vp is not None:
        layers._split(vp[0], head, 0 if cfg.tie_embeddings else 1, cfg.vocab)
        x = tpo.into_tp(x, vp[0].mesh)
    logits = x @ (head.T if cfg.tie_embeddings else head)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _layer_keys(rng, cfg: ModelConfig):
    """The routing key of every MoE layer, ``[idx][pidx]``: ``fold_in(rng,
    idx * P + pidx)`` (host integers; ``rng`` None is ``PRNGKey(0)``); None
    for the other layers."""
    rng = prng.PRNGKey(0) if rng is None else prng.as_key(rng)
    kinds = pattern(cfg)
    P = len(kinds)
    return [[prng.fold_in(rng, idx * P + pidx) if kind.moe else None
             for pidx, kind in enumerate(kinds)]
            for idx in range(cfg.n_layers // P)]


def forward(params, cfg: ModelConfig, batch, rng=None, *, ep_groups=16,
            dp_groups=1, max_len=None):
    """Full-sequence forward.  Returns (logits, aux[, caches]): aux is
    the JAX package's MoE counters summed over the layers (all zero for a
    stack without MoE layers); with ``max_len``, caches holds per pattern
    position the stacked decode state: each layer's attention cache of
    ``max_len`` slots (:func:`repro_torch.models.layers.
    attn_cache_from_prefill`, made as its layer ends, so no layer's k / v
    of every position outlives it), with the stacked SSM states and conv
    carries of SSM heads, or the stacked RWKV states and tails."""
    collect_cache = max_len is not None
    kinds = pattern(cfg)
    keys = _layer_keys(rng, cfg)
    x = _embed_inputs(params, cfg, batch)
    n = cfg.n_layers // len(kinds)
    layers_p = [_unstack(params["streams"][pidx], n)
                for pidx in range(len(kinds))]
    srcs = [[] for _ in kinds]

    def steps(idxs, x, *aux_vals):
        """Pattern steps ``idxs`` from ``x``, the aux sums carried along
        as the JAX package's scan carries them."""
        aux = dict(zip(AUX_KEYS, aux_vals))
        for idx in idxs:
            for pidx, kind in enumerate(kinds):
                # FSDP: the layer's leaves gathered over "data" here,
                # inside the checkpointed group (the recompute gathers
                # again), and dropped before the next layer gathers
                bp = layers.fsdp_gather(layers_p[pidx][idx], "streams",
                                        pidx, lead=1)
                x, src, layer_aux = _apply_block(
                    bp, x, cfg, kind, keys[idx][pidx], ep_groups, dp_groups,
                    max_len)
                del bp
                if layer_aux is not None:
                    aux = {k: aux[k] + layer_aux[k] for k in AUX_KEYS}
                if collect_cache:
                    srcs[pidx].append(src)
        return (x, *(aux[k] for k in AUX_KEYS))

    carry = (x, *_zero_aux(x.device).values())
    if cfg.remat and not collect_cache and torch.is_grad_enabled():
        g = _remat_group(cfg, n)
        for start in range(0, n, g):
            carry = checkpoint(steps, range(start, start + g), *carry,
                               use_reentrant=False)
    else:
        carry = steps(range(n), *carry)
    x, aux = carry[0], dict(zip(AUX_KEYS, carry[1:]))
    logits = _logits(params, cfg, x)
    if collect_cache:
        return logits, aux, tuple(
            {k: torch.stack([s[k] for s in per]) for k in per[0]}
            for per in srcs)
    return logits, aux


class _ce_mean(torch.autograd.Function):
    """Mean cross-entropy over rows.  flat: (N, V) logits (any dtype), idx:
    (N,) int targets.  The reference's custom VJP, for its memory
    behaviour: the forward saves only (logits [already live], lse (N,)
    float32), and the backward rebuilds the softmax from lse *in the
    logits' dtype*, so no (N, V) float32 gradient is kept."""

    @staticmethod
    def forward(ctx, flat, idx):
        with torch.profiler.record_function("cross_entropy"):
            N = flat.shape[0]
            rows = torch.arange(N, device=flat.device)
            idx = idx.long()
            m = torch.amax(flat, dim=-1)
            s = (flat - m[:, None]).float().exp_().sum(dim=-1)
            lse = m.float() + torch.log(s)
            tgt = flat[rows, idx].float()
        ctx.save_for_backward(flat, idx, lse)
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        flat, idx, lse = ctx.saved_tensors
        with torch.profiler.record_function("cross_entropy_backward"):
            N = flat.shape[0]
            rows = torch.arange(N, device=flat.device)
            p = flat.to(torch.float32, copy=True).sub_(lse[:, None]).exp_()
            dflat = p.to(flat.dtype)
            del p
            dflat[rows, idx] += torch.tensor(-1.0, dtype=flat.dtype,
                                             device=flat.device)
            dflat *= (g / N).to(flat.dtype)
        return dflat, None


class _ce_mean_tp(torch.autograd.Function):
    """:class:`_ce_mean` over vocab-split logits: flat (N, V / tp) is the
    rank's columns ``[lo, lo + V / tp)``.  The row maxima's maximum over
    ``"model"`` (no gradient), then one sum over ``"model"`` of the
    float32 sums of exponentials and of the target's logit (from the rank
    that holds it, zero elsewhere); the backward is the rank's columns of
    the softmax less the one-hot, with no collective."""

    @staticmethod
    def forward(ctx, flat, idx, mesh, lo):
        with torch.profiler.record_function("cross_entropy"):
            N, n = flat.shape
            rows = torch.arange(N, device=flat.device)
            ids = idx.long() - lo
            mine = (ids >= 0) & (ids < n)
            ids = ids.clamp(0, n - 1)
            m = tpo.max_over_model(torch.amax(flat, dim=-1), mesh)
            s = (flat - m[:, None]).float().exp_().sum(dim=-1)
            tgt = torch.where(mine, flat[rows, ids].float(), 0.0)
            s, tgt = tpo.out_of_tp(torch.stack([s, tgt]), mesh)
            lse = m.float() + torch.log(s)
        ctx.save_for_backward(flat, ids, mine, lse)
        return (lse - tgt).mean()

    @staticmethod
    def backward(ctx, g):
        flat, ids, mine, lse = ctx.saved_tensors
        with torch.profiler.record_function("cross_entropy_backward"):
            N = flat.shape[0]
            rows = torch.arange(N, device=flat.device)
            p = flat.to(torch.float32, copy=True).sub_(lse[:, None]).exp_()
            dflat = p.to(flat.dtype)
            del p
            dflat[rows, ids] -= mine.to(flat.dtype)
            dflat *= (g / N).to(flat.dtype)
        return dflat, None, None, None


def greedy_ids(logits, cfg: ModelConfig):
    """The greedy next token of each row of ``logits`` (int32): the lowest
    index among equal maxima, as ``jnp.argmax`` takes it, also over
    vocab-split logits (each rank's first maximum, the maxima and their
    global ids gathered over ``"model"``, the first rank's of the largest
    kept)."""
    vp = vocab_piece(cfg)
    if vp is None:
        return torch.argmax(logits, -1).to(torch.int32)
    t, lo, _ = vp
    idx = torch.argmax(logits, -1, keepdim=True)
    val = torch.gather(logits, -1, idx).float()
    vals = tpo.gather_over_model(val, t.mesh)               # (..., tp)
    ids = tpo.gather_over_model(idx + lo, t.mesh)
    first = torch.argmax((vals == vals.amax(-1, keepdim=True)).to(
        torch.int32), -1, keepdim=True)
    return torch.gather(ids, -1, first)[..., 0].to(torch.int32)


def loss_fn(params, cfg: ModelConfig, batch, rng=None, *, ep_groups=16,
            dp_groups=1):
    """``(total, metrics)``: total is the mean cross-entropy plus 0.01 times
    the summed load-balance loss; metrics hold ``ce`` and the
    :data:`AUX_KEYS` sums.  Next-token targets (``tokens[:, 1:]`` from the
    positions before them; a vision config's from its text positions
    only), or an encoder-only config's ``targets`` at every position."""
    logits, aux = forward(params, cfg, batch, rng, ep_groups=ep_groups,
                          dp_groups=dp_groups)

    vp = vocab_piece(cfg)

    def _ce(lg, tg):
        V = lg.shape[-1]
        if vp is not None:
            return _ce_mean_tp.apply(lg.reshape(-1, V), tg.reshape(-1),
                                     vp[0].mesh, vp[1])
        return _ce_mean.apply(lg.reshape(-1, V), tg.reshape(-1))

    if cfg.encoder_only:
        loss = _ce(logits, batch["targets"])
    else:
        tok = batch["tokens"]
        if cfg.frontend == "vit_patches":
            # text tokens occupy the tail; predict token t+1 from position
            # frontend_len + t
            logits = logits[:, cfg.frontend_len:, :]
        loss = _ce(logits[:, :-1], tok[:, 1:])
    total = loss + 0.01 * aux["lb_loss"]
    metrics = {"ce": loss, **{k: aux[k] for k in AUX_KEYS}}
    return total, metrics


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: tuple             # per pattern position: stacked (n, ...) caches
    length: torch.Tensor      # (B,) int32 tokens already in cache


def init_decode_state(cfg: ModelConfig, B: int, max_len: int,
                      device="cpu") -> DecodeState:
    kinds = pattern(cfg)
    n = cfg.n_layers // len(kinds)
    caches = []
    for kind in kinds:
        if kind.rwkv:
            H, dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
            caches.append({
                "rwkv_state": torch.zeros((n, B, H, dh, dh),
                                          dtype=torch.float32, device=device),
                "tm_last": torch.zeros((n, B, D), dtype=cfg.cdtype,
                                       device=device),
                "cm_last": torch.zeros((n, B, D), dtype=cfg.cdtype,
                                       device=device)})
            continue
        c = layers.attn_cache_init(cfg, kind.attn, B, max_len, device=device)
        d = c._asdict()
        if kind.ssm:
            d["ssm_state"], d["ssm_conv"] = ssm.ssm_state_init(cfg, B,
                                                               device)
        caches.append({f: t[None].repeat((n,) + (1,) * t.dim())
                       for f, t in d.items()})
    return DecodeState(caches=tuple(caches),
                       length=torch.zeros((B,), dtype=torch.int32,
                                          device=device))


def prefill(params, cfg: ModelConfig, batch, max_len: int, rng=None, *,
            ep_groups=16, dp_groups=1):
    """Run the full prompt, build the decode state.  Returns (logits of the
    last position, state)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it does not decode")
    logits, _aux, caches = forward(params, cfg, batch, rng,
                                   ep_groups=ep_groups, dp_groups=dp_groups,
                                   max_len=max_len)
    S = prompt_len(cfg, batch)
    B = logits.shape[0]
    state = DecodeState(caches=caches,
                        length=torch.full((B,), S, dtype=torch.int32,
                                          device=logits.device))
    return logits[:, -1], state


def _decode_block(bp, x, cfg: ModelConfig, kind: BlockKind, cache, length,
                  rng, ep_groups, dp_groups):
    h = layers.rmsnorm(bp["ln1"], x)
    if kind.rwkv:
        a, st, tail = rwkv.time_mix_decode(bp["rwkv"], h, cfg,
                                           cache["rwkv_state"],
                                           cache["tm_last"])
        x = x + a
        h2 = layers.rmsnorm(bp["ln2"], x)
        m, tail2 = rwkv.channel_mix_decode(bp["rwkv"], h2, cache["cm_last"])
        cache["rwkv_state"].copy_(st)
        cache["tm_last"].copy_(tail)
        cache["cm_last"].copy_(tail2)
        return x + m
    ac = layers.AttnCache(*(cache[f] for f in CACHE_KEYS))
    a, _ = layers.attn_decode(bp["attn"], h, cfg, kind.attn, ac, length)
    if kind.ssm:
        s_out, s_state, s_conv = ssm.ssm_decode_step(
            bp["ssm"], h, cfg, cache["ssm_state"], cache["ssm_conv"])
        a = 0.5 * (layers.rmsnorm(bp["attn_ln"], a)
                   + layers.rmsnorm(bp["ssm_ln"], s_out))
        cache["ssm_state"].copy_(s_state)
        cache["ssm_conv"].copy_(s_conv)
    if cfg.post_block_norms:
        a = layers.rmsnorm(bp["pln1"], a)
    x = x + a
    h2 = layers.rmsnorm(bp["ln2"], x)
    if kind.moe:
        m, _aux = moe.moe_apply(bp["mlp"], h2[:, None], cfg,
                                ep_groups=ep_groups, rng=rng,
                                dp_groups=dp_groups)
        m = m[:, 0]
    else:
        m = layers.mlp_apply(bp["mlp"], h2, cfg)
    if cfg.post_block_norms:
        m = layers.rmsnorm(bp["pln2"], m)
    return x + m


def decode_step(params, cfg: ModelConfig, state: DecodeState, tokens,
                rng=None, *, ep_groups=16, dp_groups=1):
    """One autoregressive step.  tokens: (B,) int.  Returns (logits,
    state).  The caches of ``state`` are updated in place (see
    :func:`repro_torch.models.layers.attn_decode`; RWKV and SSM states,
    tails and conv carries alike); the returned state holds the same cache
    tensors and the advanced lengths."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it does not decode")
    kinds = pattern(cfg)
    keys = _layer_keys(rng, cfg)
    x = _embed_tokens(params, cfg, tokens)
    n = cfg.n_layers // len(kinds)
    for idx in range(n):
        for pidx, kind in enumerate(kinds):
            bp = layers.fsdp_gather(_index(params["streams"][pidx], idx),
                                    "streams", pidx, lead=1)
            x = _decode_block(bp, x, cfg, kind,
                              _index(state.caches[pidx], idx),
                              state.length, keys[idx][pidx], ep_groups,
                              dp_groups)
            del bp
    logits = _logits(params, cfg, x)
    return logits, DecodeState(caches=state.caches,
                               length=state.length + 1)
