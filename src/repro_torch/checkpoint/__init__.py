"""Crash-safe checkpoints in the JAX package's on-disk format, and the
elastic restore onto a mesh."""

from repro_torch.checkpoint.checkpoint import (cleanup, latest_step,
                                               restore, restore_resharded,
                                               save, steps)

__all__ = ["cleanup", "latest_step", "restore", "restore_resharded", "save",
           "steps"]
