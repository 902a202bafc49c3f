"""Architecture configs (one file per assigned architecture).  Importing
the package registers all eleven; ``get`` never imports by name."""
from repro_torch.configs import (gemma2_2b, hubert_xlarge,  # noqa: F401
                                 hymba_1_5b, llama4_maverick_400b_a17b,
                                 mistral_nemo_12b, moonshot_v1_16b_a3b,
                                 nemotron_4_340b, pixtral_12b, repro_100m,
                                 rwkv6_1_6b, yi_9b)
from repro_torch.configs.base import (ARCH_IDS, REGISTRY, ModelConfig,
                                      MoECfg, SSMCfg, all_configs, get,
                                      smoke_config)

__all__ = ["ARCH_IDS", "REGISTRY", "ModelConfig", "MoECfg", "SSMCfg",
           "all_configs", "get", "smoke_config"]
