"""Deterministic synthetic batches: the port of ``_hash_tokens`` and
``batch_for`` of the JAX package's ``data/pipeline.py``, in numpy, bit for
bit.

Tokens are a cheap hash of (step, row, position), so runs are reproducible
and every host can build its own slice of a global batch with no I/O.  The
prefetching ``SyntheticPipeline`` belongs to training and is not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _hash_tokens(step: int, lo: int, hi: int, seq: int, vocab: int,
                 seed: int) -> np.ndarray:
    """Deterministic (step, row) -> tokens; rows are global batch indices."""
    rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
    cols = np.arange(seq, dtype=np.uint64)[None, :]
    x = (rows * np.uint64(2654435761) ^ cols * np.uint64(40503)
         ^ np.uint64(step * 1000003 + seed * 7919 + 12345))
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x % np.uint64(vocab)).astype(np.int32)


def batch_for(cfg: ModelConfig, step: int, global_batch: int, seq: int,
              *, lo: Optional[int] = None, hi: Optional[int] = None,
              seed: int = 0) -> dict:
    """Build the host-local slice [lo, hi) of a global batch for `cfg`."""
    lo = 0 if lo is None else lo
    hi = global_batch if hi is None else hi
    n = hi - lo
    if cfg.frontend == "audio_frames":
        t = _hash_tokens(step, lo, hi, seq * cfg.frontend_dim, 1 << 16, seed)
        frames = (t.reshape(n, seq, cfg.frontend_dim).astype(np.float32)
                  / 32768.0 - 1.0)
        targets = _hash_tokens(step, lo, hi, seq, cfg.vocab, seed + 1)
        return {"frames": frames.astype(np.float32),
                "targets": targets}
    if cfg.frontend == "vit_patches":
        s_text = seq - cfg.frontend_len
        t = _hash_tokens(step, lo, hi, cfg.frontend_len * cfg.frontend_dim,
                         1 << 16, seed)
        patches = (t.reshape(n, cfg.frontend_len, cfg.frontend_dim)
                   .astype(np.float32) / 32768.0 - 1.0)
        return {"tokens": _hash_tokens(step, lo, hi, s_text, cfg.vocab, seed),
                "patches": patches}
    return {"tokens": _hash_tokens(step, lo, hi, seq, cfg.vocab, seed)}
