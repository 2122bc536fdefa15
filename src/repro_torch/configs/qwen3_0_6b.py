"""qwen3-0.6b — qk_norm, GQA(kv=8), tied embeddings [hf:Qwen/Qwen3-*]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936,
    qk_norm=True, rope_theta=1e6, tied_embeddings=True,
)

REDUCED = FULL.with_(
    name="qwen3-0.6b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_head=32, d_ff=256, vocab=512, dtype="float32")
