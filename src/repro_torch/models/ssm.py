"""Mamba-style selective SSM head used by hymba's parallel attention + SSM
blocks.  The port of the JAX package's ``models/ssm.py``.

Plain functions on tensors; parameters are nested mappings as in
:mod:`repro_torch.models.layers`, weights ``(in, out)``.  What the JAX
package does and the port keeps:

* the depthwise causal conv sums its K taps left to right in the compute
  dtype, as Python's ``sum`` does (``0 + a0 + a1 + ...``), and its carry is
  the last K - 1 rows of the padded input;
* ``dt = softplus(dt_in @ dt_w + dt_bias)``: ``dt_in @ dt_w`` is an outer
  product (K = 1), ``dt_bias`` is float32, so ``dt`` is float32;
  ``softplus`` is ``jax.nn.softplus``'s ``logaddexp(v, 0)``;
* ``A = -exp(A_log)`` in float32; the scan and the step are
  :func:`repro_torch.kernels.ops.ssm_scan` / ``ssm_decode`` (no kernel in
  either package).  The scan is differentiable in every input
  (``ref.SSMScan``), so the hybrid block trains.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def ssm_init(cfg: ModelConfig, generator, device, lead=()):
    """The JAX package's leaves, shapes and dtypes: ``dt_bias``, ``A_log``
    and ``D`` stay float32 whatever ``param_dtype`` is.  ``lead`` prepends
    stacked layer dims."""
    s = cfg.ssm
    D = cfg.d_model
    Di = s.expand * D
    lead = tuple(lead)

    def w(shape):
        return layers._dense_init(shape, cfg.pdtype, generator, device,
                                  lead=lead)

    in_proj = w((D, 2 * Di))
    conv = (torch.randn(lead + (s.d_conv, Di), generator=generator,
                        device=device, dtype=torch.float32)
            * 0.1).to(cfg.pdtype)
    x_proj = w((Di, 2 * s.d_state + 1))
    dt_w = w((1, Di))
    out_proj = w((Di, D))
    a_log = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                   device=device)).repeat(Di, 1)
    return {
        "in_proj": in_proj,
        "conv": conv,
        "x_proj": x_proj,
        "dt_bias": torch.zeros(lead + (Di,), dtype=torch.float32,
                               device=device),
        "dt_w": dt_w,
        "A_log": a_log.expand(lead + a_log.shape).clone(),
        "D": torch.ones(lead + (Di,), dtype=torch.float32, device=device),
        "out_proj": out_proj,
    }


def _conv(x, w, carry=None):
    """Depthwise causal conv along time.  x: (B, S, Di); w: (K, Di);
    carry: (B, K - 1, Di), the previous tail (decode), or None (zeros).
    Returns (out, the new carry)."""
    K = w.shape[0]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if carry is None else carry)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0][None, None]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i][None, None]
    return out, xp[:, -(K - 1):]


def _softplus(v):
    """``jax.nn.softplus``: ``logaddexp(v, 0)``, that is ``max(v, 0) +
    log1p(exp(-|v|))``."""
    return torch.clamp_min(v, 0) + torch.log1p(torch.exp(-torch.abs(v)))


def _ssm_inner(p, x, cfg: ModelConfig, state, conv_carry, decode: bool):
    s = cfg.ssm
    xz = x @ p["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)
    if decode:
        xc, conv_carry = _conv(xin[:, None], p["conv"], conv_carry)
        xc = xc[:, 0]
    else:
        xc, conv_carry = _conv(xin, p["conv"], conv_carry)
    xc = F.silu(xc)
    proj = xc @ p["x_proj"]
    dt_in, Bm, Cm = torch.split(proj, [1, s.d_state, s.d_state], dim=-1)
    dt = _softplus(dt_in @ p["dt_w"] + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if decode:
        y, state = ops.ssm_decode(xc, dt, A, Bm, Cm, p["D"], state)
    else:
        y, state = ops.ssm_scan(xc, dt, A, Bm, Cm, p["D"], state)
    y = y * F.silu(z)
    return y @ p["out_proj"], state, conv_carry


def ssm_apply(p, x, cfg: ModelConfig, state=None, conv_carry=None):
    """x: (B, S, D).  Returns (out, state, conv_carry)."""
    if state is None:
        Di = cfg.ssm.expand * cfg.d_model
        state = torch.zeros((x.shape[0], Di, cfg.ssm.d_state),
                            dtype=torch.float32, device=x.device)
    return _ssm_inner(p, x, cfg, state, conv_carry, decode=False)


def ssm_decode_step(p, x, cfg: ModelConfig, state, conv_carry):
    """x: (B, D), one token.  Returns (out, state, conv_carry)."""
    return _ssm_inner(p, x, cfg, state, conv_carry, decode=True)


def ssm_state_init(cfg: ModelConfig, batch: int, device="cpu"):
    """Zero SSM state (float32) and conv carry (compute dtype)."""
    s = cfg.ssm
    Di = s.expand * cfg.d_model
    return (torch.zeros((batch, Di, s.d_state), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, s.d_conv - 1, Di), dtype=cfg.cdtype,
                        device=device))
