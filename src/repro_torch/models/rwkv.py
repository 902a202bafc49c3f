"""RWKV6 (Finch) block: time-mix with data-dependent per-channel decay and
channel-mix.  The port of the JAX package's ``models/rwkv.py``
(arXiv:2404.05892; head layout ``(H, Dh)`` with ``Dh = cfg.head_dim``).

Plain functions on tensors; parameters are nested mappings as in
:mod:`repro_torch.models.layers`, weights ``(in, out)``.  What the JAX
package does and the port keeps:

* the decay ``w = exp(-exp(w_base + (x_w @ w_a) @ w_b))`` is computed in
  float32, then rounded to the compute dtype before the recurrence;
* ``ln_x`` is one rmsnorm over the whole ``H * Dh`` width, and the
  time-mix output is gated by ``silu(g)``;
* the channel mix's receptance reads the *shifted* input;
* the token-shift tails are the last rows of the normed inputs, in the
  compute dtype; at t = 0 the shift pads with zeros (prefill) or with the
  tail (decode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

#: rank of the decay's low-rank projection
LORA = 64


def rwkv_init(cfg: ModelConfig, generator, device, lead=()):
    """The JAX package's leaves, shapes and dtypes: ``w_base`` and ``u``
    stay float32 whatever ``param_dtype`` is.  ``lead`` prepends stacked
    layer dims."""
    D = cfg.d_model
    H, dh = cfg.n_heads, cfg.head_dim
    lead = tuple(lead)

    def w(shape):
        return layers._dense_init(shape, cfg.pdtype, generator, device,
                                  lead=lead)

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=cfg.pdtype, device=device)

    u = torch.randn(lead + (H, dh), generator=generator, device=device,
                    dtype=torch.float32) * 0.1
    return {
        # time-mix interpolation factors (token shift)
        "mu_r": zeros(D), "mu_k": zeros(D), "mu_v": zeros(D),
        "mu_w": zeros(D), "mu_g": zeros(D),
        "wr": w((D, H * dh)), "wk": w((D, H * dh)), "wv": w((D, H * dh)),
        "wg": w((D, H * dh)), "wo": w((H * dh, D)),
        # data-dependent decay: w_t = exp(-exp(base + lora(x)))
        "w_base": torch.full(lead + (H * dh,), -2.0, dtype=torch.float32,
                             device=device),
        "w_a": w((D, LORA)), "w_b": w((LORA, H * dh)),
        "u": u,
        "ln_x": zeros(H * dh),
        # channel mix
        "cm_mu": zeros(D),
        "cm_k": w((D, cfg.d_ff)), "cm_v": w((cfg.d_ff, D)), "cm_r": w((D, D)),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros or ``last`` at t=0).  x: (B, S, D)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _decay(p, xw):
    """``exp(-exp(w_base + (xw @ w_a) @ w_b))`` in float32."""
    w_log = p["w_base"] + (xw.float() @ p["w_a"].float()) @ p["w_b"].float()
    return torch.exp(-torch.exp(w_log))


def _gate_out(p, out, g):
    return (layers.rmsnorm(p["ln_x"], out) * F.silu(g)) @ p["wo"]


def time_mix(p, x, cfg: ModelConfig, state, x_last=None):
    """x: (B, S, D); state: (B, H, Dh, Dh) float32.  Returns (out,
    new_state, x_tail)."""
    B, S, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    xs = _shift(x, x_last)
    r = _mix(x, xs, p["mu_r"]) @ p["wr"]
    k = _mix(x, xs, p["mu_k"]) @ p["wk"]
    v = _mix(x, xs, p["mu_v"]) @ p["wv"]
    g = _mix(x, xs, p["mu_g"]) @ p["wg"]
    w = _decay(p, _mix(x, xs, p["mu_w"]))               # (B, S, H*dh)

    def heads(t):  # (B, S, H*dh) -> a (B, H, S, dh) view, no copy
        return t.view(B, S, H, dh).transpose(1, 2)

    out, new_state = ops.rwkv6(heads(r), heads(k), heads(v),
                               heads(w.to(x.dtype)), p["u"], state)
    out = out.transpose(1, 2).reshape(B, S, H * dh)
    return _gate_out(p, out, g), new_state, x[:, -1]


def channel_mix(p, x, x_last=None):
    xs = _shift(x, x_last)
    xk = _mix(x, xs, p["cm_mu"])
    h = torch.square(torch.relu(xk @ p["cm_k"]))
    r = torch.sigmoid(xs @ p["cm_r"])
    return r * (h @ p["cm_v"]), x[:, -1]


def time_mix_decode(p, x, cfg: ModelConfig, state, x_last):
    """One token: x (B, D); x_last (B, D) the previous token's input.
    Returns (out, new_state, x)."""
    B, D = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    r = (_mix(x, x_last, p["mu_r"]) @ p["wr"]).reshape(B, H, dh)
    k = (_mix(x, x_last, p["mu_k"]) @ p["wk"]).reshape(B, H, dh)
    v = (_mix(x, x_last, p["mu_v"]) @ p["wv"]).reshape(B, H, dh)
    g = _mix(x, x_last, p["mu_g"]) @ p["wg"]
    w = _decay(p, _mix(x, x_last, p["mu_w"])).reshape(B, H, dh)
    out, new_state = ops.rwkv6_decode(r, k, v, w.to(x.dtype), p["u"], state)
    return _gate_out(p, out.reshape(B, H * dh), g), new_state, x


def channel_mix_decode(p, x, x_last):
    xk = _mix(x, x_last, p["cm_mu"])
    h = torch.square(torch.relu(xk @ p["cm_k"]))
    r = torch.sigmoid(x_last @ p["cm_r"])
    return r * (h @ p["cm_v"]), x
