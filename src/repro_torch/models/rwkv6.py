"""RWKV-6 (Finch) blocks: time-mix with data-dependent decay + channel-mix.

Port of `repro.models.rwkv6` (arXiv:2404.05892): per-layer token-shift
"ddlerp" interpolations with low-rank data-dependence, decay w_t from a
LoRA head squashed with exp(-exp(.)), bonus u, the per-head WKV recurrence
(`kernels.ops.rwkv6` / `kernels.ref`), SiLU output gating and the per-head
norm stand-in.  Decode carries (shift states, wkv state) per layer.

The time-mix parameters `mix_*`, `decay_*` and `bonus_u` are read in
float32, as the reference reads them; `transformer.cast_params` leaves
them in the parameter dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import dense, merge_heads, split_dim
from .layers import _init_dense, _normal, init_rmsnorm, rmsnorm

_MIXES = ("w", "k", "v", "r", "g")


def init_time_mix(g, cfg, device):
    d = cfg.d_model
    h = cfg.rwkv_n_heads
    dh = cfg.rwkv_head_dim
    lo, ld = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    dt = cfg.p_dtype
    return {
        "mix_base": torch.zeros((5, d), dtype=dt, device=device),
        "mix_lora_a": _normal(g, (5, d, lo), 0.01, dt, device),
        "mix_lora_b": torch.zeros((5, lo, d), dtype=dt, device=device),
        "w_r": _init_dense(g, d, d, dt, device),
        "w_kk": _init_dense(g, d, d, dt, device),
        "w_vv": _init_dense(g, d, d, dt, device),
        "w_g": _init_dense(g, d, d, dt, device),
        "w_o": _init_dense(g, d, d, dt, device),
        "decay_base": torch.as_tensor(
            np.tile(np.linspace(-6.0, -0.5, dh), h), dtype=dt).to(device),
        "decay_lora_a": _normal(g, (d, ld), 0.01, dt, device),
        "decay_lora_b": torch.zeros((ld, d), dtype=dt, device=device),
        "bonus_u": _normal(g, (h, dh), 0.1, dt, device),
        "ln_x": init_rmsnorm(d, dt, device),             # per-head norm
    }


def _shifted(x, shift_state):
    """x_{t-1} for each t: zeros (or the carried last token) first."""
    if shift_state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _last(x):
    """The last token [B,D], the next call's shift state: a copy of its own
    after a prompt, so the state does not keep the prompt's [B,T,D] alive."""
    return x[:, -1, :].contiguous()


def _ddlerp(p, x, xx):
    """Data-dependent lerp between x_t and shifted x (all 5 mixes at once).
    x, xx: [B,T,D] -> dict of 5 mixed tensors in x's dtype."""
    dt = x.dtype
    base = p["mix_base"].float()                           # [5, D]
    delta = (xx - x).float()                               # [B,T,D]
    lo = torch.einsum("btd,mdl->mbtl", delta, p["mix_lora_a"].float())
    dyn = torch.einsum("mbtl,mld->mbtd", torch.tanh(lo),
                       p["mix_lora_b"].float())
    mix = base[:, None, None, :] + dyn                     # [5,B,T,D]
    out = x.float()[None] + delta[None] * mix
    return {m: out[i].to(dt) for i, m in enumerate(_MIXES)}


def _heads(x, b, t, h, dh):
    """[B,T,H·dh] -> contiguous [B,H,T,dh] (the kernel's layout)."""
    return split_dim(x, -1, h, dh).transpose(1, 2).contiguous()


def time_mix(p, cfg, x, shift_state=None, wkv_state=None, use_kernel=False):
    """x [B,T,D]; states for decode: shift [B,D], wkv [B,H,dh,dh] float32.
    -> (out [B,T,D], new shift state, new wkv state)."""
    from ..kernels import ops as kops
    from ..kernels import ref

    b, t, d = x.shape
    h, dh = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    dt = x.dtype
    m = _ddlerp(p, x, _shifted(x, shift_state))

    r = _heads(dense(m["r"], p["w_r"].to(dt)), b, t, h, dh)
    k = _heads(dense(m["k"], p["w_kk"].to(dt)), b, t, h, dh)
    v = _heads(dense(m["v"], p["w_vv"].to(dt)), b, t, h, dh)
    gate = F.silu(dense(m["g"], p["w_g"].to(dt)).float())

    dec = p["decay_base"].float() + (
        dense(dense(m["w"].float(), p["decay_lora_a"].float()),
              p["decay_lora_b"].float()))
    w = _heads(torch.exp(-torch.exp(dec)), b, t, h, dh)
    u = p["bonus_u"]

    if use_kernel and wkv_state is None:
        # the reference's kernel path: w and u rounded to r's dtype
        out = kops.rwkv6(r, k, v, w.to(r.dtype), u.to(r.dtype))
        new_state = None
    elif use_kernel:
        # the reference runs its kernel (no state), drops the output and
        # recomputes with `ref.rwkv6(state=, return_state=True)` on w in
        # float32 and u in the parameter dtype; the CUDA kernel takes the
        # state, so one launch gives that same function
        out, new_state = kops.rwkv6(r, k, v, w, u, state=wkv_state,
                                    return_state=True)
    elif t >= 32 and t % 32 == 0:
        out, new_state = ref.rwkv6_chunked(r, k, v, w, u, chunk=32,
                                           state=wkv_state, return_state=True)
    else:
        out, new_state = ref.rwkv6(r, k, v, w, u, state=wkv_state,
                                   return_state=True)

    o = merge_heads(out)
    o = rmsnorm(p["ln_x"], o, cfg.norm_eps)   # stand-in for per-head groupnorm
    o = (o.float() * gate).to(dt)
    o = dense(o, p["w_o"].to(dt))
    return o, _last(x), new_state


def init_channel_mix(g, cfg, device):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.p_dtype
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "w_ck": _init_dense(g, d, f, dt, device),
        "w_cv": _init_dense(g, f, d, dt, device),
        "w_cr": _init_dense(g, d, d, dt, device),
    }


def channel_mix(p, cfg, x, shift_state=None):
    dt = x.dtype
    prev = _shifted(x, shift_state)
    mk = p["mix_k"].to(dt)
    mr = p["mix_r"].to(dt)
    xk = x * mk + prev * (1 - mk)
    xr = x * mr + prev * (1 - mr)
    kk = torch.square(torch.relu(dense(xk, p["w_ck"].to(dt)).float())).to(dt)
    rr = torch.sigmoid(dense(xr, p["w_cr"].to(dt)).float())
    return (rr * dense(kk, p["w_cv"].to(dt)).float()).to(dt), _last(x)


def init_rwkv_layer(g, cfg, device):
    return {
        "ln1": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "ln2": init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
        "tm": init_time_mix(g, cfg, device),
        "cm": init_channel_mix(g, cfg, device),
    }


def rwkv_layer(p, cfg, x, state=None, use_kernel=False):
    """state = {'tm_shift': [B,D], 'cm_shift': [B,D], 'wkv': [B,H,dh,dh]}."""
    tm_shift = cm_shift = wkv = None
    if state is not None:
        tm_shift, cm_shift, wkv = state["tm_shift"], state["cm_shift"], \
            state["wkv"]
    h, tm_shift2, wkv2 = time_mix(p["tm"], cfg,
                                  rmsnorm(p["ln1"], x, cfg.norm_eps),
                                  tm_shift, wkv, use_kernel)
    x = x + h
    h, cm_shift2 = channel_mix(p["cm"], cfg,
                               rmsnorm(p["ln2"], x, cfg.norm_eps), cm_shift)
    x = x + h
    return x, {"tm_shift": tm_shift2, "cm_shift": cm_shift2, "wkv": wkv2}


def init_rwkv_state(cfg, batch: int, device):
    h, dh = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    return {
        "tm_shift": torch.zeros((batch, cfg.d_model), dtype=cfg.act_dtype,
                                device=device),
        "cm_shift": torch.zeros((batch, cfg.d_model), dtype=cfg.act_dtype,
                                device=device),
        "wkv": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                           device=device),
    }
