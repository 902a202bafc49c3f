"""The optimizer: AdamW with global-norm clipping and its cosine schedule,
and int8 gradient compression with error feedback (the port of the JAX
package's ``optim``)."""

from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     cosine_schedule, global_norm)
from repro_torch.optim.grad_compress import (compress_decompress,
                                             ef_compress_grads, ef_init)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "compress_decompress",
           "cosine_schedule", "ef_compress_grads", "ef_init", "global_norm"]
