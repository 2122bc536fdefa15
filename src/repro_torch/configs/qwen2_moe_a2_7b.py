"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=5632, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4, d_expert_ff=1408,
    qkv_bias=True, rope_theta=1e6, tied_embeddings=False,
)

REDUCED = FULL.with_(
    name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_head=32, d_ff=256, vocab=512, n_experts=8, top_k=4,
    n_shared_experts=2, d_expert_ff=64, dtype="float32")
