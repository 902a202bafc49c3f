"""mistral-nemo-12b — dense GQA, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]  40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072, head_dim=128 (explicit; not d_model/n_heads)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral_nemo_12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    d_head=128,
    rope_theta=1000000.0,
))
