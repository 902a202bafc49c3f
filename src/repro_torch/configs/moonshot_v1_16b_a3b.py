"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16 -> MHA)
d_ff(expert)=1408 vocab=163840.  Primary DLB target: BalancedMoE routing."""

from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(ModelConfig(
    name="moonshot_v1_16b_a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    rope_theta=50000.0,
    moe=MoECfg(n_experts=64, top_k=6, d_expert_ff=1408, interleave=1,
               capacity_factor=1.25, strategy="na_rp", p_local=0.9,
               shard_routing=True),
    kv_cache_dtype="int8",   # decode_32k cache exceeds HBM in bf16
))
