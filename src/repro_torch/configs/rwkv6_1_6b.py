"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536,
head_size 64 (32 heads).  Decode is O(1)-state -> runs long_500k.
The paper's attention-sharding-style techniques are inapplicable to this
family (DESIGN.md §Arch-applicability); runtime features (tree collectives,
locality sharding) still apply."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6_1_6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # rwkv head_size 64
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    d_head=64,
    subquadratic=True,
))
