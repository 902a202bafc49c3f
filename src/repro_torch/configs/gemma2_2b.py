"""gemma2-2b — local/global alternating attention + logit softcaps.
[arXiv:2408.00118; hf]  26L d_model=2304 8H (kv=4) d_ff=9216 vocab=256000,
head_dim=256, window=4096, attn softcap 50, final logit softcap 30, tied
embeddings, gemma-style post-block norms.  Alternating local layers make
long_500k decode runnable (global layers are linear-per-token at decode)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2_2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256000,
    d_head=256,
    attn_pattern=("local", "full"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    mlp_act="gelu_glu",
    post_block_norms=True,
    tie_embeddings=True,
    subquadratic=True,   # local layers windowed; decode is cache-linear
))
