"""nemotron-4-340b — dense GQA with squared-ReLU MLP (no gate).
[arXiv:2402.16819; unverified]  96L d_model=18432 96H (kv=8) d_ff=73728
vocab=256000.  Largest assigned arch: requires FSDP (params over data axis)
and bf16 optimizer state to fit 256 x 16 GB HBM (see EXPERIMENTS §Dry-run)."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron_4_340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp_act="sq_relu",
    rope_theta=10000.0,
    fsdp=True,
    opt_state_dtype="bfloat16",
    remat_group=4,   # sqrt-remat grouping tuned in EXPERIMENTS.md #Perf
    kv_cache_dtype="int8",   # decode_32k cache exceeds HBM in bf16
))
