"""qwen2.5-14b — dense, GQA(kv=8), QKV bias [hf:Qwen/Qwen2.5-*]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=13824, vocab=152064,
    qkv_bias=True, rope_theta=1e6, tied_embeddings=False,
)

REDUCED = FULL.with_(
    name="qwen2.5-14b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_head=32, d_ff=256, vocab=512, dtype="float32")
