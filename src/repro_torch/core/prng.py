"""The pieces of ``jax.random`` that MoE routing draws from, bit for bit.

The JAX package's routing (``core/balance.py``) samples Gumbel noise with
``jax.random.gumbel(jax.random.fold_in(key, r), (N, E))``, its keys made by
``jax.random.PRNGKey`` and ``fold_in``.  The default implementation is
threefry-2x32 with ``jax_threefry_partitionable`` on (the default of the
installed jax), so:

* a key is two uint32 words; ``PRNGKey(seed)`` is ``(seed >> 32, seed &
  0xFFFFFFFF)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key;
* the 32-bit draw of a shape hashes, under the key, the pair ``(i >> 32,
  i & 0xFFFFFFFF)`` of every flat index ``i`` and XORs the two words;
* ``uniform`` keeps the top 23 bits of each word as the mantissa of a
  float32 in ``[1, 2)``, subtracts 1 and scales to ``[minval, maxval)``;
  ``gumbel`` (its "low" mode) is ``-log(-log(uniform(tiny, 1)))``.

Key derivation is scalar work and runs on the host: a key is a pair of
Python ints and :func:`threefry2x32` works on ints as well as on tensors.
Only the draws of a shape run on the device, as int64 tensors masked to 32
bits (PyTorch on the CPU has no uint32 shifts).  The bits are equal to
``jax.random``'s; the Gumbel floats go through PyTorch's ``log`` and may
differ from XLA's in the last place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
#: the rotation schedule of threefry-2x32, alternating by block of 4 rounds
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number, ``jnp.finfo(float32).tiny``
TINY = 2.0 ** -126


def threefry2x32(key, x0, x1):
    """The threefry-2x32 hash of the counter pair ``(x0, x1)`` under
    ``key`` (two uint32 words).  The counters are Python ints or int64
    tensors holding uint32 values; the pair comes back in the same form."""
    k0, k1 = (int(k) & MASK for k in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(5):
        for rot in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in ``[0, 2**32)``, as a pair
    of ints."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed {seed} is not in [0, 2**32)")
    return (seed >> 32) & MASK, seed & MASK


def as_key(key) -> tuple[int, int]:
    """A key given as a pair of ints, or as a ``(2,)`` uint32 array (a JAX
    key passed through ``numpy.asarray``), as a pair of ints."""
    k0, k1 = (int(k) for k in key)
    return k0 & MASK, k1 & MASK


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: the key with the 32-bit integer
    ``data`` folded in."""
    return threefry2x32(as_key(key), 0, int(data) & MASK)


def random_bits(key, shape, device) -> torch.Tensor:
    """The 32-bit draw of ``jax.random.bits(key, shape)`` as int64 holding
    uint32 values."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(as_key(key), idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their difference rounded to float32, as in JAX; kept
    # as Python floats (exact in float32), so nothing is copied to the card
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(f * scale + lo, min=lo)


def gumbel(key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, "low" mode)."""
    return -torch.log(-torch.log(uniform(key, shape, device, minval=TINY)))
