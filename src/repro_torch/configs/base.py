"""Model/architecture configuration schema and registry (the port's copy
of the JAX package's ``configs/base.py``; plain data, field for field).

One file per assigned architecture lives next to this module; each exposes
``CONFIG`` (the exact pool configuration) and registers itself.  The
package's ``__init__`` imports every one of them, so the registry is full
as soon as this module is imported.  Reduced "smoke" variants (same
family, tiny dims) are generated by ``smoke_config`` for CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert_ff: int
    interleave: int = 1          # MoE every Nth layer (1 = every layer)
    n_shared: int = 0            # always-on shared experts
    capacity_factor: float = 1.25
    strategy: str = "na_rp"      # core.balance routing strategy
    p_local: float = 0.9
    # confine routing sorts + dispatch/combine scatters to each data shard
    # via shard_map (beyond-paper optimization; see EXPERIMENTS.md #Perf)
    shard_routing: bool = False


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    # attention pattern, cycled over layers: "full" | "local" | "bidir"
    attn_pattern: Tuple[str, ...] = ("full",)
    window: int = 4096
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    mlp_act: str = "silu_glu"    # silu_glu | gelu_glu | sq_relu
    rope_theta: float = 10000.0
    qk_norm: bool = False
    post_block_norms: bool = False   # gemma2-style post-attn/post-mlp norms
    tie_embeddings: bool = False
    encoder_only: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    parallel_ssm: bool = False   # hymba: attention + SSM heads in parallel
    frontend: Optional[str] = None   # audio_frames | vit_patches
    frontend_dim: int = 0
    frontend_len: int = 256      # patches/frames prepended (vlm)
    # numerics / distribution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    # decode KV cache storage: "bfloat16" or "int8" (per-vector scales;
    # halves the decode memory term — see EXPERIMENTS.md #Perf extras)
    kv_cache_dtype: str = "bfloat16"
    fsdp: bool = False           # shard params over the data axis too
    remat: bool = True
    # sqrt(L) two-level remat: outer scan of layer groups (each checkpointed)
    # over inner scans; 0 = auto (largest divisor of the scan length <=
    # ceil(sqrt(n))), 1 = single-level
    remat_group: int = 0
    # long-context capability: set for sub-quadratic decoders only
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    def n_params(self) -> int:
        """Total parameter count (used for MODEL_FLOPS in the roofline)."""
        D, dh = self.d_model, self.head_dim
        H, KV, L = self.n_heads, self.n_kv_heads, self.n_layers
        p = self.vocab * D                       # embed
        if not self.tie_embeddings and not self.encoder_only:
            p += D * self.vocab                  # lm head
        if self.encoder_only:
            p += D * self.vocab
        per_attn = D * H * dh + 2 * D * KV * dh + H * dh * D
        mlps = 0
        for i in range(L):
            if self.family == "ssm":
                continue
            if self.moe and (i % self.moe.interleave == self.moe.interleave - 1):
                e = self.moe.n_experts + self.moe.n_shared
                mlps += e * 3 * D * self.moe.d_expert_ff
            else:
                nmat = 2 if self.mlp_act == "sq_relu" else 3
                mlps += nmat * D * self.d_ff
        if self.family == "ssm":                 # rwkv6
            per_l = 4 * D * D + D * D            # r,k,v,g,o (time mix)
            per_l += 2 * D * self.d_ff + D * D   # channel mix
            p += L * per_l
            return p + L * per_attn * 0
        attn_layers = L
        p += attn_layers * per_attn + mlps
        if self.ssm is not None:
            d_in = self.ssm.expand * D
            per_ssm = D * 2 * d_in + d_in * self.ssm.d_conv \
                + d_in * 2 * self.ssm.d_state + d_in + d_in * D
            p += L * per_ssm
        return p

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        full = self.n_params()
        D, L = self.d_model, self.n_layers
        n_moe_layers = sum(1 for i in range(L)
                           if i % self.moe.interleave == self.moe.interleave - 1)
        all_e = (self.moe.n_experts + self.moe.n_shared) * 3 * D * self.moe.d_expert_ff
        act_e = (self.moe.top_k + self.moe.n_shared) * 3 * D * self.moe.d_expert_ff
        return full - n_moe_layers * (all_e - act_e)


REGISTRY: dict[str, ModelConfig] = {}

ARCH_IDS = (
    "moonshot_v1_16b_a3b", "llama4_maverick_400b_a17b", "hubert_xlarge",
    "yi_9b", "gemma2_2b", "mistral_nemo_12b", "nemotron_4_340b",
    "rwkv6_1_6b", "pixtral_12b", "hymba_1_5b",
)


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name not in REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    for a in ARCH_IDS:
        get(a)
    return dict(REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests: few layers, narrow
    width, small vocab/experts — preserves every structural feature
    (pattern, MoE interleave, SSM, softcaps, frontend)."""
    cfg = get(name)
    pat = len(cfg.attn_pattern)
    moe = None
    if cfg.moe:
        moe = dataclasses.replace(
            cfg.moe, n_experts=8, d_expert_ff=64,
            top_k=min(cfg.moe.top_k, 2))
    ssm = dataclasses.replace(cfg.ssm, expand=2) if cfg.ssm else None
    n_heads = 4
    return dataclasses.replace(
        cfg, name=cfg.name + "_smoke",
        n_layers=max(2 * pat, cfg.moe.interleave * 2 if cfg.moe else 2),
        d_model=64, n_heads=n_heads,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128, vocab=256, d_head=16, window=32,
        frontend_dim=32 if cfg.frontend else 0, frontend_len=8,
        moe=moe, ssm=ssm, fsdp=False,
        param_dtype="float32", compute_dtype="float32",
        kv_cache_dtype="bfloat16",   # numeric formats reset for exactness
        remat_group=0,               # re-derive for the reduced depth
    )
