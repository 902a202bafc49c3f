"""Deterministic synthetic data pipeline: the port of the JAX package's
``data/pipeline.py`` (``_hash_tokens``, ``batch_for`` and
``SyntheticPipeline``), in numpy, bit for bit.

Tokens are a cheap hash of (step, row, position), so every process builds
its own disjoint slice of a global batch with no I/O, and runs are
reproducible across restarts and across *different* process counts (the
global batch is defined logically; processes slice it by index).  A
background thread keeps a double-buffered prefetch queue, so host-side
generation overlaps device steps.  ``batch_specs`` gives the global
batch's shapes and types as meta tensors (the JAX package's
``ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

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


def batch_specs(cfg: ModelConfig, global_batch: int, seq: int) -> dict:
    """The *global* batch as meta tensors: shapes and types, no data."""
    import torch

    B = global_batch

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.frontend == "audio_frames":
        return {"frames": spec((B, seq, cfg.frontend_dim), torch.float32),
                "targets": spec((B, seq), torch.int32)}
    if cfg.frontend == "vit_patches":
        return {"tokens": spec((B, seq - cfg.frontend_len), torch.int32),
                "patches": spec((B, cfg.frontend_len, cfg.frontend_dim),
                                torch.float32)}
    return {"tokens": spec((B, seq), torch.int32)}


def _process_slot() -> tuple[int, int]:
    """This process's (index, count): ``torch.distributed``'s rank and
    world size once a process group is up, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticPipeline:
    """Double-buffered prefetching iterator over process-local batches:
    each ``next`` gives ``(step, batch)``, from ``start_step`` on; rows
    ``[lo, hi)`` of the global batch are this process's.  ``close()`` stops
    the thread."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq: int,
                 *, start_step: int = 0, seed: int = 0, prefetch: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq = seq
        self.seed = seed
        index, count = _process_slot()
        pi = index if process_index is None else process_index
        pc = count if process_count is None else process_count
        per = global_batch // pc
        self.lo, self.hi = pi * per, (pi + 1) * per
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            b = batch_for(self.cfg, step, self.global_batch, self.seq,
                          lo=self.lo, hi=self.hi, seed=self.seed)
            while not self._stop.is_set():
                try:
                    self._q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
