"""Shared model-plane layers: norms, RoPE, GQA attention (+cache), MLPs.

Port of `repro.models.layers`.  Functional, as the reference: params are
plain dicts of tensors, `init_*` build them from a `torch.Generator` (or
note their draws in a `Draws`, for a model to fill in place), and the
apply functions take (params, inputs).  Every matmul weight is read as
`p[name].to(x.dtype)`, as the reference casts it at each use; a tree whose
weights were cast once beforehand (`transformer.cast_params`) makes those
casts free and gives the same bits.  The reference's sharding hints
(`parallel.sharding.logical_constraint`) stand at its places: they
redistribute DTensor activations on a mesh and return plain tensors as
they are.

KV caches are updated in place (the reference returns updated copies):
prefill writes its slice and decode one slot, instead of rewriting the
whole cache every step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import (dense, gather_rows, heads_local,
                                 logical_constraint, merge_heads,
                                 split_dim)


class Draws(list):
    """The normal draws a parameter tree asks for, in order.  An init
    function given a `Draws` in place of a generator leaves each drawn leaf
    uninitialised and notes it with its scale; `fill` then draws the leaves
    from a generator one at a time, straight into place, with the numbers
    the generator itself would have given the init function."""

    @torch.no_grad()
    def fill(self, g: torch.Generator) -> None:
        for out, scale in self:
            out.copy_(_draw(g, out.shape, scale))


def _draw(g: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device,
                       dtype=torch.float32) * scale


def _normal(g, shape, scale: float, dtype, device) -> torch.Tensor:
    """float32 normal * scale drawn from the generator `g`, cast to
    `dtype`; uninitialised, and noted in `g`, when `g` is a `Draws`."""
    if isinstance(g, Draws):
        out = torch.empty(shape, dtype=dtype, device=device)
        g.append((out, scale))
        return out
    return _draw(g, shape, scale).to(dtype=dtype, device=device)


def _init_dense(g, d_in, d_out, dtype, device, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return _normal(g, (d_in, d_out), scale, dtype, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def init_layernorm(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., T, D] with D even; positions [T].  Half-split rotation."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., :, None] * freqs  # [T, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + optional qk-norm / bias / sliding window / cache)
# ---------------------------------------------------------------------------
def init_attention(g, cfg, device):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dt = cfg.p_dtype
    p = {
        "wq": _init_dense(g, d, hq * dh, dt, device),
        "wk": _init_dense(g, d, hkv * dh, dt, device),
        "wv": _init_dense(g, d, hkv * dh, dt, device),
        "wo": _init_dense(g, hq * dh, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dt, device=device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, dt, device)
        p["k_norm"] = init_rmsnorm(dh, dt, device)
    return p


def _project_qkv(p, cfg, x, positions, use_rope=True):
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dt = x.dtype
    q = dense(x, p["wq"].to(dt))
    k = dense(x, p["wk"].to(dt))
    v = dense(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = split_dim(q, -1, hq, dh).transpose(1, 2)
    k = split_dim(k, -1, hkv, dh).transpose(1, 2)
    v = split_dim(v, -1, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = logical_constraint(q, ("batch", "heads", None, None))
    k = logical_constraint(k, ("batch", "kv_heads", None, None))
    return q, k, v


def _attention(cfg, q, k, v, causal, window):
    if cfg.attn_impl == "flash":
        # the hand-written CUDA kernel on the card (its plain version on
        # CPU tensors); it reads the projections' [B, T, H, D] memory
        # through strides and writes o as [B, T, H, D] memory, so neither
        # side copies
        from ..kernels import ops as kops

        return kops.flash_attention(q, k, v, causal=causal, window=window)
    from ..kernels import ref

    fn = ref.blocked_attention if cfg.attn_impl == "blocked" \
        else ref.attention
    # on a mesh, each rank's own batch rows and heads
    return heads_local(fn, q, k, v, causal=causal, window=window)


def attention_block(p, cfg, x, positions, causal=True, window=None,
                    use_rope=True, kv_override=None):
    """Full-sequence attention (training / forward / cross-attention).
    `kv_override` = (k, v) [B,Hkv,S,D] attends to those keys and values
    (the encoder's, for cross-attention) in place of x's own; x's k and v
    projections are still computed, as the reference computes them."""
    b, t, d = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, use_rope)
    if kv_override is not None:
        k, v = kv_override
    o = _attention(cfg, q, k, v, causal, window)
    o = merge_heads(o)
    return logical_constraint(dense(o, p["wo"].to(x.dtype)),
                              ("batch", None, None))


def attention_prefill(p, cfg, x, positions, cache, window=None,
                      use_rope=True):
    """Full-sequence attention + KV-cache fill (the fused prefill path).

    Writes the last s positions at slots [0, s) of the cache in place; for
    windowed (ring-buffer) caches this needs t % s == 0 or t <= s so the
    ring layout matches `attention_decode`'s slot arithmetic."""
    b, t, d = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, use_rope)
    s = cache["k"].shape[2]
    if not (t % s == 0 or t <= s):
        raise ValueError(f"prefill of {t} tokens into a cache of {s} slots "
                         f"needs t % s == 0 or t <= s")
    n = min(t, s)
    cache["k"][:, :, :n] = k[:, :, t - n:]
    cache["v"][:, :, :n] = v[:, :, t - n:]
    cache["pos"] = t
    o = _attention(cfg, q, k, v, True, window)
    o = merge_heads(o)
    return dense(o, p["wo"].to(x.dtype)), cache


def attention_decode(p, cfg, x, cache, window=None, use_rope=True):
    """Single-token decode against a ring/linear KV cache, updated in place.

    cache = {"k": [B,Hkv,S,D], "v": [B,Hkv,S,D], "pos": int}.  For
    sliding-window configs the cache is a ring buffer of size window.  The
    query-key and weight-value products take the cache's dtype into float32
    and accumulate there, as the reference's `preferred_element_type=f32`
    contraction does; the port makes a float32 copy of the layer's cache
    for each product (bf16 products are exact in float32, so the result is
    the same up to summation order).
    """
    b, t, d = x.shape
    if t != 1:
        raise ValueError("decode step takes one new token")
    pos = int(cache["pos"])
    positions = torch.tensor([pos], device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, use_rope)
    ck, cv = cache["k"], cache["v"]
    s = ck.shape[2]
    slot = pos % s if window is not None else pos
    ck[:, :, slot] = k[:, :, 0]
    cv[:, :, slot] = v[:, :, 0]

    kpos = torch.arange(s, device=x.device)
    if window is not None:  # ring buffer: absolute position of each slot
        wrap = (pos // s) * s
        abs_pos = torch.where(kpos <= pos % s, wrap + kpos, wrap - s + kpos)
        live = (abs_pos >= 0) & (abs_pos > pos - window) & (abs_pos <= pos)
    else:
        live = kpos <= pos

    hq, hkv, dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    group = hq // hkv
    qf = q.to(ck.dtype) * dh ** -0.5
    qg = split_dim(qf[:, :, 0], 1, hkv, group).float()
    logits = qg @ ck.float().transpose(-1, -2)          # [b, hkv, g, s]
    logits = logits.masked_fill(~live, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    o = w.to(cv.dtype).float() @ cv.float()             # [b, hkv, g, dh]
    o = merge_heads(o.reshape(b, hq, 1, dh).to(x.dtype))
    cache["pos"] = pos + 1
    return dense(o, p["wo"].to(x.dtype)), cache


def init_kv_cache(cfg, batch: int, seq: int, device, window=None,
                  dtype=None):
    s = min(seq, window) if window else seq
    dt = dtype or cfg.act_dtype
    shape = (batch, cfg.kv_heads, s, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": 0}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_swiglu(g, d, f, dtype, device):
    return {"w_gate": _init_dense(g, d, f, dtype, device),
            "w_up": _init_dense(g, d, f, dtype, device),
            "w_down": _init_dense(g, f, d, dtype, device)}


def swiglu(p, x):
    dt = x.dtype
    gate = F.silu(dense(x, p["w_gate"].to(dt)).float())
    up = dense(x, p["w_up"].to(dt)).float()
    h = logical_constraint((gate * up).to(dt), ("batch", None, "mlp"))
    return dense(h, p["w_down"].to(dt))


def init_gelu_mlp(g, d, f, dtype, device):
    return {"w_up": _init_dense(g, d, f, dtype, device),
            "b_up": torch.zeros((f,), dtype=dtype, device=device),
            "w_down": _init_dense(g, f, d, dtype, device),
            "b_down": torch.zeros((d,), dtype=dtype, device=device)}


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    dt = x.dtype
    h = F.gelu((dense(x, p["w_up"].to(dt)) + p["b_up"].to(dt)).float(),
               approximate="tanh").to(dt)
    return dense(h, p["w_down"].to(dt)) + p["b_down"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def init_embedding(g, vocab, d, dtype, device):
    return {"table": _normal(g, (vocab, d), 0.02, dtype, device)}


def embed(p, tokens, dtype):
    return gather_rows(p["table"].to(dtype), tokens)


def unembed(p, x):
    """Logits in float32."""
    return logical_constraint(dense(x.float(), p["table"].float().T),
                              ("batch", None, "vocab"))
