"""hubert-xlarge — encoder-only audio transformer (w2v2 arch).
[arXiv:2106.07447; unverified]  48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (masked-unit prediction targets).  Modality frontend (CNN feature
extractor) is a stub: input_specs() provides precomputed frame embeddings.
No autoregressive decode -> decode/long shapes are skipped (DESIGN.md §4)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert_xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    attn_pattern=("bidir",),
    mlp_act="gelu_glu",
    encoder_only=True,
    frontend="audio_frames",
    frontend_dim=512,
))
