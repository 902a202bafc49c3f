"""The optimizer: AdamW with global-norm clipping and its cosine schedule
(the port of the JAX package's ``optim``; its compressed all-reduce
``grad_compress`` is distributed work, ROADMAP item 11)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
