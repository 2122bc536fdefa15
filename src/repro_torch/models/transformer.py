"""Model assembly for every family — dense, moe, rwkv6, hybrid, encdec and
vlm: init, forward, prefill and the decode step.

Port of `repro.models.transformer`.  Parameters are a dict tree as in the
reference, but layers are a list of per-layer trees (the reference stacks
them on a leading axis for `lax.scan`; its hybrid tree stacks each kind of
a super-block and keeps the tail apart), and a decode state is a list of
per-layer states: a KV cache for an attention layer, `{tm_shift,
cm_shift, wkv}` for an rwkv6 layer and `{conv, h}` for an RG-LRU layer.
The encdec (whisper) tree keeps two lists, `enc_layers` and `dec_layers`,
and the top-level position tables `enc_pos` / `dec_pos`; its state is
`{"self": [per-layer caches], "enc": the encoder output}`.  The vlm
(phi-3-vision) tree is the dense one plus the top-level `img_proj`, which
projects `img_embeds` over the first tokens of the sequence.

`use_kernel` is the reference's switch: it sends the rwkv6 and RG-LRU
recurrences of `forward` and `prefill` to their kernels (`kernels.ops`);
the decode step keeps the plain one-token recurrence, as the reference
does.  While autograd records, `forward` runs each decoder layer under
`cfg.remat` (`_remat`: "full" or "dots", as the reference's
`jax.checkpoint` policies).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..parallel.sharding import (dense, gather_fsdp, gather_rows,
                                 grad_as_value, logical_constraint,
                                 split_dim)
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import rwkv6 as RW
from .config import ModelConfig

FAMILIES = ("dense", "moe", "rwkv6", "hybrid", "encdec", "vlm")


def layer_kinds(cfg: ModelConfig) -> list:
    """Each (decoder) layer's kind in layer order: "dense" (also the vlm's
    layers), "moe", "rwkv6", "encdec", or the hybrid's
    `block_pattern[i % len]` ("rglru" / "attn")."""
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    if cfg.family == "vlm":
        return ["dense"] * cfg.n_layers
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


def init_moe_layer(g, cfg: ModelConfig, device):
    return {"ln1": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
            "attn": L.init_attention(g, cfg, device),
            "ln2": L.init_rmsnorm(cfg.d_model, cfg.p_dtype, device),
            "moe": MOE.init_moe(g, cfg, device)}


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


# -- enc-dec layers (whisper: layernorm + gelu mlp, no rope) -----------------
def init_enc_layer(g, cfg: ModelConfig, device):
    return {"ln1": L.init_layernorm(cfg.d_model, cfg.p_dtype, device),
            "attn": L.init_attention(g, cfg, device),
            "ln2": L.init_layernorm(cfg.d_model, cfg.p_dtype, device),
            "mlp": L.init_gelu_mlp(g, cfg.d_model, cfg.d_ff, cfg.p_dtype,
                                   device)}


def init_dec_layer(g, cfg: ModelConfig, device):
    return {"ln1": L.init_layernorm(cfg.d_model, cfg.p_dtype, device),
            "self_attn": L.init_attention(g, cfg, device),
            "ln_x": L.init_layernorm(cfg.d_model, cfg.p_dtype, device),
            "cross_attn": L.init_attention(g, cfg, device),
            "ln2": L.init_layernorm(cfg.d_model, cfg.p_dtype, device),
            "mlp": L.init_gelu_mlp(g, cfg.d_model, cfg.d_ff, cfg.p_dtype,
                                   device)}


def init_layer(g, cfg: ModelConfig, kind: str, device):
    if kind == "dense":
        return init_dense_layer(g, cfg, device)
    if kind == "moe":
        return init_moe_layer(g, cfg, device)
    if kind == "rwkv6":
        return RW.init_rwkv_layer(g, cfg, device)
    if kind == "encdec":
        return init_dec_layer(g, cfg, device)
    return init_hybrid_layer(g, cfg, kind, device)


def init_params(g, cfg: ModelConfig, device) -> dict:
    """The parameter tree, drawn from the generator `g`, or left
    uninitialised with every draw noted in order when `g` is a
    `layers.Draws`.  Same distributions as the reference, other numbers: a
    `torch.Generator` is not a JAX key."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
    d, pdt = cfg.d_model, cfg.p_dtype
    norm = L.init_layernorm if cfg.family == "encdec" else L.init_rmsnorm
    p: dict = {"embed": L.init_embedding(g, cfg.padded_vocab, d, pdt, device),
               "final_norm": norm(d, pdt, device)}
    if not cfg.tied_embeddings:
        p["unembed"] = L.init_embedding(g, cfg.padded_vocab, d, pdt, device)
    if cfg.family == "encdec":
        p["enc_pos"] = L._normal(g, (cfg.n_audio_frames, d), 0.02, pdt,
                                 device)
        p["dec_pos"] = L._normal(g, (cfg.max_positions, d), 0.02, pdt,
                                 device)
        p["enc_layers"] = [init_enc_layer(g, cfg, device)
                           for _ in range(cfg.n_enc_layers)]
        p["dec_layers"] = [init_dec_layer(g, cfg, device)
                           for _ in range(cfg.n_layers)]
        return p
    p["layers"] = [init_layer(g, cfg, kind, device)
                   for kind in layer_kinds(cfg)]
    if cfg.family == "vlm":
        p["img_proj"] = L._init_dense(g, d, d, pdt, device)
    return p


# leaves the reference reads in float32, never cast: norm scales and the
# LayerNorm's bias, the MoE router (made in float32 whatever param_dtype
# is), the rwkv6 time-mix's token-shift and decay LoRAs and bonus, and the
# RG-LRU's conv and gate weights and Lambda
_KEEP = frozenset({"scale", "bias", "router", "mix_base", "mix_lora_a",
                   "mix_lora_b", "decay_base", "decay_lora_a",
                   "decay_lora_b", "bonus_u", "conv_w", "conv_b", "w_a",
                   "w_i", "lam"})


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

    def cast(k, v):
        if isinstance(v, dict):
            return {kk: cast(kk, vv) for kk, vv in v.items()}
        if isinstance(v, list):
            return [cast(k, x) for x in v]
        return v if k in _KEEP else v.to(dt)

    out = cast(None, params)
    out["unembed"] = params["embed" if cfg.tied_embeddings else "unembed"]
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def _ffn(p, cfg: ModelConfig, x):
    """The second half of a dense or moe layer: (output, the MoE block's
    aux loss, or None for an MLP)."""
    if "moe" in p:
        return MOE.moe_block(p["moe"], cfg, x)
    return _mlp(p["mlp"], cfg, x), None


def dense_layer(p, cfg: ModelConfig, x, positions, window=None):
    """A dense or moe layer: (output, aux loss or None)."""
    h = L.attention_block(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                          positions, causal=True, window=window)
    x = x + h
    h, aux = _ffn(p, cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, aux


def dense_layer_prefill(p, cfg: ModelConfig, x, positions, cache,
                        window=None):
    h, cache = L.attention_prefill(p["attn"], cfg,
                                   L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                   positions, cache, window=window)
    x = x + h
    h, _ = _ffn(p, cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + h, cache


def dense_layer_decode(p, cfg: ModelConfig, x, cache, window=None):
    h, cache = L.attention_decode(p["attn"], cfg,
                                  L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                                  cache, window=window)
    x = x + h
    h, _ = _ffn(p, cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
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


def _dec_layer(p, cfg: ModelConfig, x, positions, enc, cache=None,
               mode="train"):
    """One whisper decoder layer: causal self-attention (no rope), then
    cross-attention over the encoder output `enc`, then the gelu MLP.
    mode: train (no cache) | prefill (fill it) | decode (step it)."""
    xn = L.layernorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        h, cache = L.attention_decode(p["self_attn"], cfg, xn, cache,
                                      use_rope=False)
    elif mode == "prefill":
        h, cache = L.attention_prefill(p["self_attn"], cfg, xn, positions,
                                       cache, use_rope=False)
    else:
        h = L.attention_block(p["self_attn"], cfg, xn, positions,
                              causal=True, use_rope=False)
    x = x + h
    xn = L.layernorm(p["ln_x"], x, cfg.norm_eps)
    h = L.attention_block(p["cross_attn"], cfg, xn, positions, causal=False,
                          use_rope=False,
                          kv_override=_cross_kv(p["cross_attn"], cfg, enc))
    x = x + h
    h = L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], x, cfg.norm_eps))
    return x + h, cache


def _cross_kv(p, cfg: ModelConfig, enc):
    """Project the encoder output to cross-attention K/V heads."""
    hkv, dh = cfg.kv_heads, cfg.head_dim
    dt = enc.dtype
    k = split_dim(dense(enc, p["wk"].to(dt)), -1, hkv, dh).transpose(1, 2)
    v = split_dim(dense(enc, p["wv"].to(dt)), -1, hkv, dh).transpose(1, 2)
    return k, v


def encode(params, cfg: ModelConfig, audio_frames):
    """The whisper encoder over precomputed frame embeddings [B, F, D] (the
    conv frontend is a stub, as in the reference): non-causal
    self-attention without rope, layernorm and the gelu MLP."""
    dt = cfg.act_dtype
    x = audio_frames.to(dt) + params["enc_pos"].to(dt)[None]
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in params["enc_layers"]:
        lp = gather_fsdp(lp)
        h = L.attention_block(lp["attn"], cfg,
                              L.layernorm(lp["ln1"], x, cfg.norm_eps),
                              positions, causal=False, use_rope=False)
        x = x + h
        x = _residual(x + L.gelu_mlp(lp["mlp"],
                                     L.layernorm(lp["ln2"], x, cfg.norm_eps)))
    return x


def _image_prefix(params, cfg: ModelConfig, x, img_embeds=None):
    """The token embeddings x; for the vlm with `img_embeds` [B, N, D],
    their projection replaces the first N positions (the reference's
    prefix)."""
    dt = cfg.act_dtype
    if cfg.family == "vlm" and img_embeds is not None:
        img = dense(img_embeds.to(dt), params["img_proj"].to(dt))
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    return x


def _audio(cfg: ModelConfig, audio_frames):
    if audio_frames is None:
        raise ValueError(f"{cfg.name} is an encdec model: it needs the "
                         f"input audio_frames [B, {cfg.n_audio_frames}, "
                         f"{cfg.d_model}] (the Engine sends tokens only)")
    return audio_frames


def _logits(params, cfg: ModelConfig, x):
    norm = L.layernorm if cfg.family == "encdec" else L.rmsnorm
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["unembed"], x)


# ---------------------------------------------------------------------------
# Rematerialisation (training)
# ---------------------------------------------------------------------------
# the matmuls without batch dims: the projections `x @ W` (a 3-d `x` folds
# into one 2-d product); attention's and the experts' products are `bmm`
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """A decoder layer `fn` under `cfg.remat` while autograd records, as
    the reference's `_remat`: "full" keeps each layer's inputs and
    recomputes the layer in the backward; "dots" also keeps the outputs of
    the matmuls without batch dims (`checkpoint_dots_with_no_batch_dims`)
    and recomputes the rest.  Any other value, or no autograd, runs `fn`
    as it is.  The forward draws no random numbers, so no RNG state is
    kept."""
    if not torch.is_grad_enabled() or cfg.remat not in ("full", "dots"):
        return fn
    ctx = dict(context_fn=functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)) \
        if cfg.remat == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **ctx)


_LAYER_LISTS = ("layers", "enc_layers", "dec_layers")


def _gather_top(params):
    """The tree with its leaves outside the layer lists gathered over the
    batch mesh axes (`gather_fsdp`); the layers are gathered one at a
    time, where they run."""
    return {k: v if k in _LAYER_LISTS else gather_fsdp(v)
            for k, v in params.items()}


def _gathered(fn):
    """A layer function that first gathers its layer's parameters over
    the batch mesh axes (inside `_remat`, the backward gathers them again
    rather than keeping every layer's whole weights) and hands on its
    output `_residual`."""
    @functools.wraps(fn)
    def run(lp, *args, **kw):
        x, extra = fn(gather_fsdp(lp), *args, **kw)
        return _residual(x), extra

    return run


def _residual(x):
    """The residual stream between layers, split over the batch only: on
    a mesh the products that contract a `model`-split dim leave partial
    sums, reduced here once a layer, and the gradient that comes back is
    laid out so too (`grad_as_value`; DTensor may otherwise split it over
    rows that the batch does not divide).  A plain tensor is returned as
    it is."""
    return grad_as_value(logical_constraint(x, ("batch", None, None)))


# ---------------------------------------------------------------------------
# Forward passes (params from `cast_params`)
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens, img_embeds=None,
            audio_frames=None, use_kernel=False):
    """tokens [B, T] -> (logits [B, T, V], aux loss: the MoE blocks' summed
    over layers, else 0)."""
    params = _gather_top(params)
    x = L.embed(params["embed"], tokens, cfg.act_dtype)
    x = _image_prefix(params, cfg, logical_constraint(x, ("batch", None, None)),
                      img_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family == "encdec":
        enc = encode(params, cfg, _audio(cfg, audio_frames))
        x = x + gather_rows(params["dec_pos"], positions).to(x.dtype)[None]
        for lp in params["dec_layers"]:
            x, _ = _remat(_gathered(_dec_layer), cfg)(lp, cfg, x, positions,
                                                      enc)
        return _logits(params, cfg, x), aux
    for kind, lp in zip(layer_kinds(cfg), params["layers"]):
        if kind in ("dense", "moe"):
            x, a = _remat(_gathered(dense_layer), cfg)(
                lp, cfg, x, positions, window=cfg.window)
            if a is not None:
                aux = aux + a
        elif kind == "rwkv6":
            x, _ = _remat(_gathered(RW.rwkv_layer), cfg)(
                lp, cfg, x, use_kernel=use_kernel)
        else:
            x, _ = _remat(_gathered(_hybrid_one), cfg)(
                lp, cfg, kind, x, positions, use_kernel=use_kernel)
    return _logits(params, cfg, x), aux


def prefill(params, cfg: ModelConfig, batch: dict, state, use_kernel=False):
    """batch['tokens'] [B, T] (+ 'img_embeds' for the vlm, 'audio_frames'
    for the encdec) and a fresh decode state -> (last-token logits
    [B, 1, V], the filled state).  One fused pass, no token-by-token
    replay."""
    params = _gather_top(params)
    tokens = batch["tokens"]
    x = _image_prefix(params, cfg,
                      L.embed(params["embed"], tokens, cfg.act_dtype),
                      batch.get("img_embeds"))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    if cfg.family == "encdec":
        enc = encode(params, cfg, _audio(cfg, batch.get("audio_frames")))
        x = x + gather_rows(params["dec_pos"], positions).to(x.dtype)[None]
        caches = state["self"]
        for i, lp in enumerate(params["dec_layers"]):
            x, caches[i] = _dec_layer(gather_fsdp(lp), cfg, x, positions,
                                      enc, caches[i], mode="prefill")
            x = _residual(x)
        state["enc"] = enc
        return _logits(params, cfg, x[:, -1:]), state
    for i, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        lp = gather_fsdp(lp)
        if kind in ("dense", "moe"):
            x, state[i] = dense_layer_prefill(lp, cfg, x, positions, state[i],
                                              window=cfg.window)
        elif kind == "rwkv6":
            x, state[i] = RW.rwkv_layer(lp, cfg, x, state=state[i],
                                        use_kernel=use_kernel)
        else:
            x, state[i] = _hybrid_one(lp, cfg, kind, x, positions, state[i],
                                      mode="prefill", use_kernel=use_kernel)
        x = _residual(x)
    return _logits(params, cfg, x[:, -1:]), state


def init_layer_state(cfg: ModelConfig, kind: str, batch: int, seq: int,
                     device):
    if kind in ("dense", "moe", "encdec"):
        return L.init_kv_cache(cfg, batch, seq, device, window=cfg.window)
    if kind == "rwkv6":
        return RW.init_rwkv_state(cfg, batch, device)
    if kind == "attn":
        return L.init_kv_cache(cfg, batch, seq, device,
                               window=cfg.local_window)
    return RG.init_rglru_state(cfg, batch, device)


def init_decode_state(cfg: ModelConfig, batch: int, seq: int, device):
    caches = [init_layer_state(cfg, kind, batch, seq, device)
              for kind in layer_kinds(cfg)]
    if cfg.family == "encdec":
        return {"self": caches,
                "enc": torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                                   dtype=cfg.act_dtype, device=device)}
    return caches


def decode_step(params, cfg: ModelConfig, token, state):
    """token [B, 1] -> (logits [B, 1, V], the advanced state)."""
    params = _gather_top(params)
    x = L.embed(params["embed"], token, cfg.act_dtype)
    if cfg.family == "encdec":
        caches, enc = state["self"], state["enc"].to(x.dtype)
        # the decoder position: the first layer's cache position
        x = x + params["dec_pos"][caches[0]["pos"]].to(x.dtype)
        zero = torch.zeros((1,), dtype=torch.long, device=x.device)
        for i, lp in enumerate(params["dec_layers"]):
            x, caches[i] = _dec_layer(gather_fsdp(lp), cfg, x, zero, enc,
                                      caches[i], mode="decode")
            x = _residual(x)
        return _logits(params, cfg, x), state
    for i, (kind, lp) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        lp = gather_fsdp(lp)
        if kind in ("dense", "moe"):
            x, state[i] = dense_layer_decode(lp, cfg, x, state[i],
                                             window=cfg.window)
        elif kind == "rwkv6":
            x, state[i] = RW.rwkv_layer(lp, cfg, x, state=state[i])
        else:
            x, state[i] = _hybrid_one(lp, cfg, kind, x, None, state[i],
                                      mode="decode")
        x = _residual(x)
    return _logits(params, cfg, x), state
