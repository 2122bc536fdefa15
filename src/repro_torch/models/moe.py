"""Mixture-of-Experts block: top-k router + capacity-based expert dispatch.

Port of `repro.models.moe`.  Tokens pick their top-k experts from a
float32 softmax router and are packed into per-expert capacity slots
([E, cap, D] buffers, gathered by index with a zero pad row for empty
slots); the stacked SwiGLU experts run as three batched products; each
(token, k) pair's expert output is weighted and summed back in float32.
Capacity is the reference's `ceil(n·k/e · capacity_factor / 256) · 256`:
pairs ranked past it in their expert's queue are dropped, the ranking
being the order of a stable sort of the flat (token, k) expert ids, so
the same pairs drop in both packages (the Engine's left-pad tokens take
capacity like any other token).  Supports shared experts (qwen2-moe: 4
shared + 60 routed top-4) and returns the Switch load-balancing aux loss.

The expert products are plain large matmuls that the reference computes
outside any Pallas kernel; here they are `torch.bmm` calls.  The combine
sums each token's k contributions over a [n, k, d] tensor, not with an
atomic scatter-add, so the result is deterministic on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import (full_tensor, gather_rows, grad_as_value,
                                 logical_constraint, replicated)
from . import layers as L


def init_moe(g, cfg, device):
    d = cfg.d_model
    fe = cfg.d_expert_ff or cfg.d_ff
    e = cfg.n_experts
    p = {
        # float32 whatever param_dtype is, as the reference makes it
        "router": L._init_dense(g, d, e, torch.float32, device, scale=0.02),
        "we_gate": _stack_init(g, e, d, fe, cfg.p_dtype, device),
        "we_up": _stack_init(g, e, d, fe, cfg.p_dtype, device),
        "we_down": _stack_init(g, e, fe, d, cfg.p_dtype, device),
    }
    if cfg.n_shared_experts:
        fs = fe * cfg.n_shared_experts
        p["shared"] = L.init_swiglu(g, d, fs, cfg.p_dtype, device)
    return p


def _stack_init(g, e, d_in, d_out, dtype, device):
    return L._normal(g, (e, d_in, d_out), d_in ** -0.5, dtype, device)


def capacity(cfg, n: int) -> int:
    """Slots per expert for n tokens, rounded up to 256 as the reference's
    (which shards the capacity dim over its mesh)."""
    return int(math.ceil(n * cfg.top_k / cfg.n_experts * cfg.capacity_factor
                         / 256) * 256)


def route(p, cfg, xf):
    """xf [n, D] -> (probs [n, E] float32, top-k weights [n, k] renormalised,
    top-k expert ids [n, k]).  Ties go to the lower expert id, as
    `jax.lax.top_k` breaks them: a stable descending sort keeps index order
    among equal probabilities, where `torch.topk` promises no order."""
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return probs, topw, topi


def moe_block(p, cfg, x):
    """x [B, T, D] -> ([B, T, D], aux_loss scalar)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    cap = capacity(cfg, n)
    # the tokens' gradient comes back laid out as they are (DTensor lays
    # the router's out over both mesh dims, which the reshape's backward
    # cannot split into [B, T])
    xf = grad_as_value(x.reshape(n, d))
    dev = x.device

    probs, topw, topi = route(p, cfg, xf)
    # the dispatch's integer bookkeeping runs on every (token, k) pair of
    # the batch: on a mesh, each rank holds all of them
    flat_e = full_tensor(topi.reshape(-1))                        # [n*k]
    # Switch-style load-balance aux loss
    me = probs.mean(0)
    # the pairs each expert got, counted by a scatter (bincount's counts;
    # it has no meta kernel)
    ce = torch.zeros(e, dtype=flat_e.dtype, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e)).float() / (n * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    # slot of each (token, k) pair: its rank in its expert's queue
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    start = torch.searchsorted(sorted_e, experts)                 # [e]
    end = torch.searchsorted(sorted_e, experts, right=True)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(n * k, device=dev) - start[sorted_e]
    keep = slot < cap                                             # overflow

    # slot grid -> source token (gather indices; n = the zero pad row)
    pos = start[:, None] + torch.arange(cap, device=dev)[None, :]  # [e, cap]
    live = pos < end[:, None]
    src = order[torch.where(live, pos.clamp(0, n * k - 1), 0)]
    tok_for_slot = torch.where(live, src // k, n)
    buf = gather_rows(torch.cat([xf, xf.new_zeros((1, d))]),
                      tok_for_slot)                               # [e, cap, d]
    buf = logical_constraint(buf, (None, "batch", None))
    dst = torch.where(keep, flat_e * cap + slot, e * cap)         # combine idx

    # stacked expert SwiGLU
    dt = x.dtype
    gate = F.silu(torch.bmm(buf, p["we_gate"].to(dt)).float())
    up = torch.bmm(buf, p["we_up"].to(dt)).float()
    h = logical_constraint((gate * up).to(dt), (None, "batch", "mlp"))
    eo = torch.bmm(h, p["we_down"].to(dt))                        # [e, cap, d]
    eo = logical_constraint(eo, (None, "batch", None))

    # gather back, weight, and sum each token's k pairs in float32
    eo_flat = replicated(eo).reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           gather_rows(eo_flat, dst.clamp(0, e * cap - 1)),
                           0).float()
    out = (gathered * topw.reshape(-1, 1)).reshape(n, k, d).sum(1)
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], xf).float()
    return out.reshape(b, t, d).to(dt), aux
