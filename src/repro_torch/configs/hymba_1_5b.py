"""hymba-1.5b — hybrid: parallel attention + Mamba heads per layer.
[arXiv:2411.13676; hf]  32L d_model=1600 25H (kv=5) d_ff=5504 ssm_state=16.
Attention is sliding-window except one global layer per 8-layer pattern
block (4 of 32; the released model keeps 3 full-attention layers; meta
tokens are omitted — noted in DESIGN.md).  The period-8 pattern also keeps
the scan body at 8 blocks, bounding rematerialization live-sets.  SWA + SSM state -> runs long_500k."""

from repro_torch.configs.base import ModelConfig, SSMCfg, register

CONFIG = register(ModelConfig(
    name="hymba_1_5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    d_head=64,
    attn_pattern=("full",) + ("local",) * 7,
    window=1024,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
    parallel_ssm=True,
    subquadratic=True,
))
