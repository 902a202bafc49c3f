"""Crash-safe checkpoints in the JAX package's on-disk format (its
``restore_resharded`` places arrays on a mesh: ROADMAP item 11d)."""

from repro_torch.checkpoint.checkpoint import (cleanup, latest_step,
                                               restore, save, steps)

__all__ = ["cleanup", "latest_step", "restore", "save", "steps"]
