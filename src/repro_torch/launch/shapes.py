"""Assigned input-shape cells and per-cell applicability: the port of the
JAX package's ``launch/shapes.py`` (pure Python over
:mod:`repro_torch.configs`)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether ``cfg`` runs the cell ``shape``, and why not when it does
    not."""
    cell = SHAPES[shape]
    if cfg.encoder_only and cell.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic attention (skip per DESIGN.md §4)")
    return True, ""


def all_cells():
    """Every ``(arch, shape)`` pair, archs in ``ARCH_IDS`` order."""
    from repro_torch.configs.base import ARCH_IDS
    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape
