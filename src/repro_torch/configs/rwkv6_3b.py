"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560, n_heads=40,  # heads = d_model / rwkv_head_dim
    d_ff=8960, vocab=65536,
    rwkv_head_dim=64, rwkv_decay_lora=64, rwkv_mix_lora=32,
    tied_embeddings=False,
)

REDUCED = FULL.with_(
    name="rwkv6-3b-smoke", n_layers=2, d_model=128, n_heads=4, d_ff=256,
    vocab=512, rwkv_head_dim=32, rwkv_decay_lora=8, rwkv_mix_lora=8,
    dtype="float32")
