"""Int8 gradient compression with error feedback (1-bit-Adam-style residual
accumulation): the port of the JAX package's ``optim/grad_compress.py``.
In a multi-pod deployment the int8 tensor and its per-block scale are what
cross the inter-pod links (4x fewer bytes); here, as in the JAX package,
the round trip is fake quantization, so a step sees the numerics the
compressed collective would produce.

The steps and their dtypes are the JAX package's, so the results are
bitwise equal to it on the CPU: the flat tensor padded with zeros to a
multiple of ``BLOCK``, ``scale = max |block| / 127`` floored at 1e-12,
``q = clamp(round(block / scale), -127, 127)`` (half to even in both) as
int8, dequantized as ``q * scale`` in float32.  The scale divides by a
127 that lies on the tensor's device: CUDA's division by a Python scalar
multiplies by its reciprocal, which may differ in the last bit.

Trees are the port's parameter trees (``ParamTree``, dicts, or a list of
leaves in :func:`repro_torch.models.transformer.tree_leaves` order, as the
train step's gradients are); results keep the gradients' structure.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.transformer import (tree_leaves, tree_map,
                                            tree_unflatten)

BLOCK = 256


def _quant(x: torch.Tensor):
    """Per-block symmetric int8 quantization of float32 ``x`` (any shape,
    flattened): ``(q, scale, pad)``."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    peak = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / peak
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _dequant(q, scale, pad: int, shape) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def compress_decompress(x: torch.Tensor):
    """Round-trip int8 fake quantization (the wire format of the compressed
    all-reduce).  Returns ``(x_hat, residual)``, both in ``x.dtype``."""
    xf = x.to(torch.float32)
    q, scale, pad = _quant(xf)
    x_hat = _dequant(q, scale, pad, xf.shape)
    return x_hat.to(x.dtype), (xf - x_hat).to(x.dtype)


def ef_init(params):
    """A float32 zero residual beside each parameter, in the parameters'
    structure."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return tree_map(zeros, params)


@torch.no_grad()
def ef_compress_grads(grads, ef_state):
    """Error-feedback compression: ``g_hat = Q(g + e)`` in ``g``'s dtype,
    ``e' = g + e - g_hat`` in float32.  Returns ``(g_hat, e')`` in the
    gradients' structure."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        g_hat, resid = compress_decompress(corrected)
        return g_hat.to(g.dtype), resid.to(torch.float32)

    flat_g, flat_e = tree_leaves(grads), tree_leaves(ef_state)
    if len(flat_g) != len(flat_e):
        raise ValueError(f"{len(flat_g)} gradients, {len(flat_e)} residuals")
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))
