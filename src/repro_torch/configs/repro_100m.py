"""repro-100m — in-house ~100M-param dense config for the end-to-end example
driver (examples/train_100m.py): llama-style GQA, small vocab, CPU-trainable."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="repro_100m",
    family="dense",
    n_layers=12,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    d_ff=2560,
    vocab=8192,
    d_head=64,
    param_dtype="float32",
    compute_dtype="float32",
))
