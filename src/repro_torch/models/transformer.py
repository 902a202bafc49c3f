"""The decoder / encoder stack: the port of the JAX package's
``models/transformer.py`` on one device (its inference paths).

Layers are grouped into a repeating *pattern* of P block kinds (gemma2:
(local, full); llama4: (dense, moe); hymba: (full, local x7)); parameters
are stacked per pattern position with a leading dim of ``n_layers / P``,
as in the JAX package, and the stack is applied by a Python loop over that
dim (the JAX package's ``lax.scan``).  There is no rematerialisation: that
is for training.

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
waits for training.

The routing key ``rng`` is a pair of uint32 words
(:mod:`repro_torch.core.prng`), ``PRNGKey(0)`` by default as in the JAX
package; layer ``idx`` of pattern position ``pidx`` routes with
``fold_in(rng, idx * P + pidx)``, derived on the host.  ``ep_groups`` (16 by
default, as in the JAX package) is the expert-group count of the routing's
locality bonus.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models import layers, moe, rwkv, ssm

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
    paths (``streams.0.attn.wq``).  ``tree["key"]`` reads a child."""

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


def _index(tree, i: int) -> dict:
    """Layer ``i`` of a stacked tree, as a dict of views."""
    return {k: _index(tree[k], i) if isinstance(tree[k], (ParamTree, dict))
            else tree[k][i] for k in tree.keys()}


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


def _apply_block(bp, x, cfg: ModelConfig, kind: BlockKind, rng, ep_groups):
    """Prefill block.  Returns (x, cache_src, aux): what decode needs (k/v
    and, with SSM heads, the SSM state and conv carry; or the RWKV state
    and token-shift tails; all final), and the MoE layer's counters (None
    for other blocks)."""
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
    a, (kt, vt) = layers.attn_apply(bp["attn"], h, cfg, kind.attn)
    src = {"k": kt, "v": vt}
    if kind.ssm:
        s_out, src["ssm_state"], src["ssm_conv"] = ssm.ssm_apply(
            bp["ssm"], h, cfg)
        a = 0.5 * (layers.rmsnorm(bp["attn_ln"], a)
                   + layers.rmsnorm(bp["ssm_ln"], s_out))
    if cfg.post_block_norms:
        a = layers.rmsnorm(bp["pln1"], a)
    x = x + a
    h2 = layers.rmsnorm(bp["ln2"], x)
    aux = None
    if kind.moe:
        m, aux = moe.moe_apply(bp["mlp"], h2, cfg, ep_groups=ep_groups,
                               rng=rng)
    else:
        m = layers.mlp_apply(bp["mlp"], h2, cfg)
    if cfg.post_block_norms:
        m = layers.rmsnorm(bp["pln2"], m)
    return x + m, src, aux


def _embed_tokens(params, cfg: ModelConfig, tok):
    x = params["embed"][tok.long()].to(cfg.cdtype)
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
    """Logits in the compute dtype, with the final softcap."""
    x = layers.rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
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
            collect_cache=False):
    """Full-sequence forward.  Returns (logits, aux[, cache_srcs]): aux is
    the JAX package's MoE counters summed over the layers (all zero for a
    stack without MoE layers); cache_srcs holds per pattern position the
    stacked ``(n, B, KV, S, Dh)`` k and v (with the stacked SSM states and
    conv carries of SSM heads), or the stacked RWKV states and tails."""
    kinds = pattern(cfg)
    keys = _layer_keys(rng, cfg)
    x = _embed_inputs(params, cfg, batch)
    n = cfg.n_layers // len(kinds)
    aux = _zero_aux(x.device)
    srcs = [[] for _ in kinds]
    for idx in range(n):
        for pidx, kind in enumerate(kinds):
            x, src, layer_aux = _apply_block(
                _index(params["streams"][pidx], idx), x, cfg, kind,
                keys[idx][pidx], ep_groups)
            if layer_aux is not None:
                aux = {k: aux[k] + layer_aux[k] for k in AUX_KEYS}
            if collect_cache:
                srcs[pidx].append(src)
    logits = _logits(params, cfg, x)
    if collect_cache:
        return logits, aux, tuple(
            {k: torch.stack([s[k] for s in per]) for k in per[0]}
            for per in srcs)
    return logits, aux


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
            ep_groups=16):
    """Run the full prompt, build the decode state.  Returns (logits of the
    last position, state)."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it does not decode")
    logits, _aux, srcs = forward(params, cfg, batch, rng,
                                 ep_groups=ep_groups, collect_cache=True)
    kinds = pattern(cfg)
    S = prompt_len(cfg, batch)
    caches = []
    for kind, src in zip(kinds, srcs):
        if kind.rwkv:
            caches.append(src)    # the states are already final
            continue
        per_layer = [layers.attn_cache_from_prefill(
            cfg, kind.attn, src["k"][i], src["v"][i], max_len)
            for i in range(src["k"].shape[0])]
        caches.append({f: torch.stack([getattr(c, f) for c in per_layer])
                       for f in CACHE_KEYS})
        for extra in ("ssm_state", "ssm_conv"):
            if extra in src:
                caches[-1][extra] = src[extra]
    B = logits.shape[0]
    state = DecodeState(caches=tuple(caches),
                        length=torch.full((B,), S, dtype=torch.int32,
                                          device=logits.device))
    return logits[:, -1], state


def _decode_block(bp, x, cfg: ModelConfig, kind: BlockKind, cache, length,
                  rng, ep_groups):
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
                                ep_groups=ep_groups, rng=rng)
        m = m[:, 0]
    else:
        m = layers.mlp_apply(bp["mlp"], h2, cfg)
    if cfg.post_block_norms:
        m = layers.rmsnorm(bp["pln2"], m)
    return x + m


def decode_step(params, cfg: ModelConfig, state: DecodeState, tokens,
                rng=None, *, ep_groups=16):
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
            x = _decode_block(_index(params["streams"][pidx], idx), x,
                              cfg, kind, _index(state.caches[pidx], idx),
                              state.length, keys[idx][pidx], ep_groups)
    logits = _logits(params, cfg, x)
    return logits, DecodeState(caches=state.caches,
                               length=state.length + 1)
