"""llama4-maverick-400b-a17b — MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-*; unverified]  48L d_model=5120 40H (kv=8)
d_ff=8192 vocab=202048.  Per the HF config, MoE layers interleave every 2nd
layer with one always-on shared expert (which also makes the total ~400B as
the name says; every-layer MoE would be ~773B).  Early-fusion vision frontend
is stubbed (text path exercised by the assigned shapes)."""

from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="llama4_maverick_400b_a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    rope_theta=500000.0,
    moe=MoECfg(n_experts=128, top_k=1, d_expert_ff=8192, interleave=2,
               n_shared=1, capacity_factor=1.5, strategy="na_rp",
               p_local=0.9, shard_routing=True),
    fsdp=True,
    opt_state_dtype="bfloat16",   # 400B: f32 m/v would not fit 256x16GB
    kv_cache_dtype="int8",   # decode_32k cache exceeds HBM in bf16
))
