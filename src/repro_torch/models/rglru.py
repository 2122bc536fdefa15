"""RecurrentGemma blocks: RG-LRU recurrence + short conv (arXiv:2402.19427).

Port of `repro.models.rglru`.  Recurrent block: x -> (linear branch with
GeLU gate) x (conv1d(4) -> RG-LRU) -> out projection.  RG-LRU per channel:

    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_i x_t)
    a_t = a^(c * r_t)                 (a = sigmoid(Lambda), c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The diagonal recurrence runs through `kernels.ops.linear_scan` (the CUDA
kernel on the card) or the plain chunked scan.  Decode carries (conv
window, h) per layer.  `conv_w`, `conv_b`, `w_a`, `w_i` and `lam` are read
in float32, as the reference reads them; `transformer.cast_params` leaves
them in the parameter dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import dense
from .layers import _init_dense, _normal

_C = 8.0


def init_rglru_block(g, cfg, device):
    d = cfg.d_model
    ds = cfg.rglru_d_state or d
    dt = cfg.p_dtype
    return {
        "w_x": _init_dense(g, d, ds, dt, device),
        "w_gate_rec": _init_dense(g, d, ds, dt, device),
        "conv_w": _normal(g, (cfg.conv_width, ds), 0.1, dt, device),
        "conv_b": torch.zeros((ds,), dtype=dt, device=device),
        "w_a": _init_dense(g, ds, ds, dt, device, scale=0.01),
        "w_i": _init_dense(g, ds, ds, dt, device, scale=0.01),
        "lam": torch.as_tensor(np.linspace(2.0, 5.0, ds), dtype=dt).to(device),
        "w_out": _init_dense(g, ds, d, dt, device),
    }


def _conv1d(w, b, x, state=None):
    """Causal depthwise conv, width W.  x [B,T,C]; state [B,W-1,C] (the
    last W-1 inputs before x).  -> (out [B,T,C] in x's dtype, new state)."""
    wdt = x.dtype
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=wdt,
                          device=x.device)
    else:
        pad = state.to(wdt)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1]].float() * w[i].float()
    new_state = xp[:, -(width - 1):].contiguous() if width > 1 else pad
    return (out + b.float()).to(wdt), new_state


def rglru_block(p, cfg, x, state=None, use_kernel=False):
    """x [B,T,D]; state = {'conv': [B,W-1,S], 'h': [B,S] float32}."""
    from ..kernels import ops as kops
    from ..kernels import ref

    dt = x.dtype
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(dense(x, p["w_gate_rec"].to(dt)).float(),
                  approximate="tanh")
    u = dense(x, p["w_x"].to(dt))
    conv_state = state["conv"] if state is not None else None
    u, new_conv = _conv1d(p["conv_w"], p["conv_b"], u, conv_state)

    uf = u.float()
    r = torch.sigmoid(dense(uf, p["w_a"].float()))
    i = torch.sigmoid(dense(uf, p["w_i"].float()))
    log_a = -_C * r * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)

    h0 = state["h"] if state is not None else None
    if use_kernel:
        # without h0 the reference's kernel path; with it (prefill) the
        # reference runs `ref.linear_scan_chunked(h0=)`, the same function,
        # which the CUDA kernel computes with h0 folded into the first step
        h = kops.linear_scan(a, gated, h0=h0)
    else:
        h = ref.linear_scan_chunked(a, gated, h0=h0)
    new_h = h[:, -1, :].contiguous()
    out = dense((h.float() * gate).to(dt), p["w_out"].to(dt))
    return out, {"conv": new_conv, "h": new_h}


def init_rglru_state(cfg, batch: int, device):
    ds = cfg.rglru_d_state or cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, ds),
                            dtype=cfg.act_dtype, device=device),
        "h": torch.zeros((batch, ds), dtype=torch.float32, device=device),
    }
