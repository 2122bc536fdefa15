"""Model assembly for the dense family: init, forward, prefill and the
decode step.

Port of the dense-family paths of `repro.models.transformer`.  Parameters
are a dict tree as in the reference, but layers are a list of per-layer
trees (the reference stacks them on a leading axis for `lax.scan`), and a
decode state is a list of per-layer caches.  Every other family raises
`NotImplementedError`: moe, rwkv6, hybrid, encdec and vlm are still to be
ported (ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import layers as L
from .config import ModelConfig


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port has the dense family only (ROADMAP.md, Queue 1 item 9)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _init_mlp(g, cfg: ModelConfig, device):
    if cfg.mlp_type == "gelu":
        return L.init_gelu_mlp(g, cfg.d_model, cfg.d_ff, cfg.p_dtype, device)
    return L.init_swiglu(g, cfg.d_model, cfg.d_ff, cfg.p_dtype, device)


def _mlp(p, cfg: ModelConfig, x):
    return L.gelu_mlp(p, x) if cfg.mlp_type == "gelu" else L.swiglu(p, x)


def init_dense_layer(g, cfg: ModelConfig, device):
    return {"ln1": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
            "attn": L.init_attention(g, cfg, device),
            "ln2": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
            "mlp": _init_mlp(g, cfg, device)}


def init_params(g: Optional[torch.Generator], cfg: ModelConfig,
                device) -> dict:
    """The parameter tree, drawn from `g` (uninitialised weights when `g`
    is None).  Same distributions as the reference, other numbers: a
    `torch.Generator` is not a JAX key."""
    check_family(cfg)
    p: dict = {"embed": L.init_embedding(g, cfg.padded_vocab, cfg.d_model,
                                         cfg.p_dtype, device),
               "final_norm": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device)}
    if not cfg.tied_embeddings:
        p["unembed"] = L.init_embedding(g, cfg.padded_vocab, cfg.d_model,
                                        cfg.p_dtype, device)
    p["layers"] = [init_dense_layer(g, cfg, device)
                   for _ in range(cfg.n_layers)]
    return p


_KEEP = ("scale",)  # norm scales are read in float32: never cast


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """The tree the forward passes read: matmul weights, biases and the
    embedding table cast once to the activation dtype (the reference casts
    them at every use, which gives the same bits); norm scales as they are.
    `unembed` is always present and stays in the parameter dtype: it is the
    embedding table itself under tied embeddings."""
    dt = cfg.act_dtype

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict)
                else (v if k in _KEEP else v.to(dt)) for k, v in tree.items()}

    out = {k: cast(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [cast(lp) for lp in params["layers"]]
    out["unembed"] = params["embed" if cfg.tied_embeddings else "unembed"]
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def dense_layer(p, cfg: ModelConfig, x, positions, window=None):
    h = L.attention_block(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                          positions, causal=True, window=window)
    x = x + h
    h = _mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h


def dense_layer_prefill(p, cfg: ModelConfig, x, positions, cache,
                        window=None):
    h, cache = L.attention_prefill(p["attn"], cfg,
                                   L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                   positions, cache, window=window)
    x = x + h
    h = _mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, cache


def dense_layer_decode(p, cfg: ModelConfig, x, cache, window=None):
    h, cache = L.attention_decode(p["attn"], cfg,
                                  L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                  cache, window=window)
    x = x + h
    h = _mlp(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, cache


def _logits(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["unembed"], x)


# ---------------------------------------------------------------------------
# Forward passes (params from `cast_params`)
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens):
    """tokens [B, T] -> (logits [B, T, V], aux loss 0)."""
    x = L.embed(params["embed"], tokens, cfg.act_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in params["layers"]:
        x = dense_layer(lp, cfg, x, positions, window=cfg.window)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, batch: dict, state: list):
    """batch['tokens'] [B, T] + a fresh decode state -> (last-token logits
    [B, 1, V], the filled state).  One fused pass, no token-by-token
    replay."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg.act_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        x, state[i] = dense_layer_prefill(lp, cfg, x, positions, state[i],
                                          window=cfg.window)
    return _logits(params, cfg, x[:, -1:]), state


def init_decode_state(cfg: ModelConfig, batch: int, seq: int,
                      device) -> list:
    check_family(cfg)
    return [L.init_kv_cache(cfg, batch, seq, device, window=cfg.window)
            for _ in range(cfg.n_layers)]


def decode_step(params, cfg: ModelConfig, token, state: list):
    """token [B, 1] -> (logits [B, 1, V], the advanced state)."""
    x = L.embed(params["embed"], token, cfg.act_dtype)
    for i, lp in enumerate(params["layers"]):
        x, state[i] = dense_layer_decode(lp, cfg, x, state[i],
                                         window=cfg.window)
    return _logits(params, cfg, x), state
