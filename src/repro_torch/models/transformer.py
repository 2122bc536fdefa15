"""Model assembly for the dense, rwkv6 and hybrid families: init, forward,
prefill and the decode step.

Port of those families' paths of `repro.models.transformer`.  Parameters
are a dict tree as in the reference, but layers are a list of per-layer
trees (the reference stacks them on a leading axis for `lax.scan`; its
hybrid tree stacks each kind of a super-block and keeps the tail apart),
and a decode state is a list of per-layer states: a KV cache for an
attention layer, `{tm_shift, cm_shift, wkv}` for an rwkv6 layer and
`{conv, h}` for an RG-LRU layer.  moe, encdec and vlm raise
`NotImplementedError`: they are still to be ported (ROADMAP.md, Queue 1
item 9).

`use_kernel` is the reference's switch: it sends the rwkv6 and RG-LRU
recurrences of `forward` and `prefill` to their kernels (`kernels.ops`);
the decode step keeps the plain one-token recurrence, as the reference
does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import layers as L
from . import rglru as RG
from . import rwkv6 as RW
from .config import ModelConfig

FAMILIES = ("dense", "rwkv6", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            f"port has the {', '.join(FAMILIES)} families (ROADMAP.md, "
            f"Queue 1 item 9)")


def layer_kinds(cfg: ModelConfig) -> list:
    """Each layer's kind in layer order: "dense", "rwkv6", or the hybrid's
    `block_pattern[i % len]` ("rglru" / "attn")."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    return [cfg.family] * cfg.n_layers


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


def init_hybrid_layer(g, cfg: ModelConfig, kind: str, device):
    """One layer of the hybrid: RG-LRU or local attention, then swiglu."""
    base = {"ln1": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
            "ln2": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device)}
    if kind == "attn":
        base["attn"] = L.init_attention(g, cfg, device)
    else:
        base["rec"] = RG.init_rglru_block(g, cfg, device)
    base["mlp"] = L.init_swiglu(g, cfg.d_model, cfg.d_ff, cfg.p_dtype, device)
    return base


def init_layer(g, cfg: ModelConfig, kind: str, device):
    if kind == "dense":
        return init_dense_layer(g, cfg, device)
    if kind == "rwkv6":
        return RW.init_rwkv_layer(g, cfg, device)
    return init_hybrid_layer(g, cfg, kind, device)


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
    p["layers"] = [init_layer(g, cfg, kind, device)
                   for kind in layer_kinds(cfg)]
    return p


# leaves the reference reads in float32, never cast: norm scales, the
# rwkv6 time-mix's token-shift and decay LoRAs and bonus, and the RG-LRU's
# conv and gate weights and Lambda
_KEEP = frozenset({"scale", "mix_base", "mix_lora_a", "mix_lora_b",
                   "decay_base", "decay_lora_a", "decay_lora_b", "bonus_u",
                   "conv_w", "conv_b", "w_a", "w_i", "lam"})


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """The tree the forward passes read: matmul weights, biases and the
    embedding table cast once to the activation dtype (the reference casts
    them at every use, which gives the same bits); the leaves in `_KEEP`
    as they are (the reference reads them in float32, and casts `bonus_u`
    to the activation dtype only at its point of use on the kernel path,
    where the port casts it too).  `unembed` is always present and stays
    in the parameter dtype: it is the embedding table itself under tied
    embeddings."""
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


def _hybrid_one(p, cfg: ModelConfig, kind: str, x, positions, state=None,
                mode="train", use_kernel=False):
    """One hybrid layer; mode: train (no state) | prefill (fill the state) |
    decode (step the state).  Attention is local (`cfg.local_window`) over
    a ring-buffer cache; the MLP is always swiglu, as in the reference."""
    xn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        if mode == "decode":
            h, state = L.attention_decode(p["attn"], cfg, xn, state,
                                          window=cfg.local_window)
        elif mode == "prefill":
            h, state = L.attention_prefill(p["attn"], cfg, xn, positions,
                                           state, window=cfg.local_window)
        else:
            h = L.attention_block(p["attn"], cfg, xn, positions, causal=True,
                                  window=cfg.local_window)
    else:
        h, state = RG.rglru_block(p["rec"], cfg, xn,
                                  state if mode != "train" else None,
                                  use_kernel=use_kernel)
    x = x + h
    h = L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, state


def _logits(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["unembed"], x)


# ---------------------------------------------------------------------------
# Forward passes (params from `cast_params`)
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens, use_kernel=False):
    """tokens [B, T] -> (logits [B, T, V], aux loss 0)."""
    x = L.embed(params["embed"], tokens, cfg.act_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for kind, lp in zip(layer_kinds(cfg), params["layers"]):
        if kind == "dense":
            x = dense_layer(lp, cfg, x, positions, window=cfg.window)
        elif kind == "rwkv6":
            x, _ = RW.rwkv_layer(lp, cfg, x, use_kernel=use_kernel)
        else:
            x, _ = _hybrid_one(lp, cfg, kind, x, positions,
                               use_kernel=use_kernel)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, batch: dict, state: list,
            use_kernel=False):
    """batch['tokens'] [B, T] + a fresh decode state -> (last-token logits
    [B, 1, V], the filled state).  One fused pass, no token-by-token
    replay."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, cfg.act_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        if kind == "dense":
            x, state[i] = dense_layer_prefill(lp, cfg, x, positions, state[i],
                                              window=cfg.window)
        elif kind == "rwkv6":
            x, state[i] = RW.rwkv_layer(lp, cfg, x, state=state[i],
                                        use_kernel=use_kernel)
        else:
            x, state[i] = _hybrid_one(lp, cfg, kind, x, positions, state[i],
                                      mode="prefill", use_kernel=use_kernel)
    return _logits(params, cfg, x[:, -1:]), state


def init_layer_state(cfg: ModelConfig, kind: str, batch: int, seq: int,
                     device):
    if kind == "dense":
        return L.init_kv_cache(cfg, batch, seq, device, window=cfg.window)
    if kind == "rwkv6":
        return RW.init_rwkv_state(cfg, batch, device)
    if kind == "attn":
        return L.init_kv_cache(cfg, batch, seq, device,
                               window=cfg.local_window)
    return RG.init_rglru_state(cfg, batch, device)


def init_decode_state(cfg: ModelConfig, batch: int, seq: int,
                      device) -> list:
    check_family(cfg)
    return [init_layer_state(cfg, kind, batch, seq, device)
            for kind in layer_kinds(cfg)]


def decode_step(params, cfg: ModelConfig, token, state: list):
    """token [B, 1] -> (logits [B, 1, V], the advanced state)."""
    x = L.embed(params["embed"], token, cfg.act_dtype)
    for i, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        if kind == "dense":
            x, state[i] = dense_layer_decode(lp, cfg, x, state[i],
                                             window=cfg.window)
        elif kind == "rwkv6":
            x, state[i] = RW.rwkv_layer(lp, cfg, x, state=state[i])
        else:
            x, state[i] = _hybrid_one(lp, cfg, kind, x, None, state[i],
                                      mode="decode")
    return _logits(params, cfg, x), state
