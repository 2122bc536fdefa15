"""Model configuration — one dataclass covering all assigned families.

Port of `repro.models.config`: the same fields and defaults, so every
registered architecture constructs; `act_dtype` / `p_dtype` are torch
dtypes.  `attn_impl="flash"` runs the hand-written CUDA attention kernel
(`kernels.ops.flash_attention`) on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv6 | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: Optional[int] = None        # GQA (None -> MHA)
    d_head: Optional[int] = None            # None -> d_model // n_heads

    # dense-family options
    qkv_bias: bool = False                  # qwen2.5
    qk_norm: bool = False                   # qwen3
    mlp_type: str = "swiglu"                # swiglu | gelu (granite/GPT-BigCode)
    window: Optional[int] = None            # sliding-window attention (mixtral)
    rope_theta: float = 1e4
    tied_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert_ff: Optional[int] = None       # qwen2-moe: expert ff != dense ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # hybrid (recurrentgemma): layer pattern, e.g. ("rglru", "rglru", "attn")
    block_pattern: Tuple[str, ...] = ()
    local_window: Optional[int] = None      # local attention window
    rglru_d_state: Optional[int] = None     # recurrence width (lru_width)
    conv_width: int = 4

    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # enc-dec (whisper): encoder layers + frontend stub length
    n_enc_layers: int = 0
    n_audio_frames: int = 1500              # precomputed frame embeddings
    max_positions: int = 32768              # learned pos-emb capacity

    # vlm (phi-3-vision): stub patch embeddings prepended to the sequence
    n_img_tokens: int = 0

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"                 # activation dtype
    param_dtype: str = "float32"
    # embedding/logit tables padded to this multiple so the vocab dim shards
    # over the 16-wide `model` axis (whisper's 51865 is odd — unsharded
    # logits blew the train-cell memory 4x; padding is standard practice)
    vocab_pad_to: int = 128

    # implementation knobs (perf hillclimbing surface)
    attn_impl: str = "xla"                  # xla | blocked | flash (CUDA)
    scan_layers: bool = True                # reference knob; the port loops
    remat: str = "none"                     # none | full | dots  (see train)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def p_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter count (used for MODEL_FLOPS = 6 N D in the roofline)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hq, hkv, dh = self.n_heads, self.kv_heads, self.head_dim
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        dense_mlp = (3 if self.mlp_type == "swiglu" else 2) * d * f
        per_layer = 0
        n_dense_layers = self.n_layers
        if self.family == "moe":
            fe = self.d_expert_ff or f
            moe_mlp = self.n_experts * 3 * d * fe \
                + self.n_shared_experts * 3 * d * fe + d * self.n_experts
            per_layer = attn + moe_mlp + 2 * d
            total = self.n_layers * per_layer
        elif self.family == "rwkv6":
            # time-mix: r,k,v,w,g projections + output; channel-mix ~ 3 d f
            tm = 5 * d * d + d * d + 2 * self.rwkv_decay_lora * d \
                + 5 * 2 * self.rwkv_mix_lora * d
            cm = 2 * d * f + d * d
            total = self.n_layers * (tm + cm + 2 * d)
        elif self.family == "hybrid":
            ds = self.rglru_d_state or d
            rec = 2 * d * ds + ds * d + self.conv_width * ds + 2 * ds \
                + ds * ds // 8
            att = attn
            n_rec = sum(1 for i in range(self.n_layers)
                        if self.block_pattern[i % len(self.block_pattern)] != "attn")
            n_att = self.n_layers - n_rec
            total = n_rec * (rec + dense_mlp + 2 * d) \
                + n_att * (att + dense_mlp + 2 * d)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn + dense_mlp + 2 * d)
            dec = self.n_layers * (2 * attn + dense_mlp + 3 * d)
            total = enc + dec
        else:  # dense, vlm
            per_layer = attn + dense_mlp + 2 * d
            total = n_dense_layers * per_layer
        total += v * d * (1 if self.tied_embeddings else 2) + d
        return int(total)

    def active_param_count(self) -> int:
        """MoE: params touched per token (routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, v = self.d_model, self.vocab
        fe = self.d_expert_ff or self.d_ff
        hq, hkv, dh = self.n_heads, self.kv_heads, self.head_dim
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        mlp_active = (self.top_k + self.n_shared_experts) * 3 * d * fe
        per_layer = attn + mlp_active + d * self.n_experts + 2 * d
        return int(self.n_layers * per_layer
                   + v * d * (1 if self.tied_embeddings else 2) + d)
