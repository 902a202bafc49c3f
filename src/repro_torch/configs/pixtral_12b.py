"""pixtral-12b — pixtral-ViT frontend + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072, head_dim=128.  ViT patch embedder is a stub:
input_specs() provides precomputed patch embeddings prepended to the text
sequence (seq_len counts patches + text)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="pixtral_12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    d_head=128,
    rope_theta=1000000.0,
    frontend="vit_patches",
    frontend_dim=1024,
    frontend_len=256,
))
