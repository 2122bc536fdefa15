"""mixtral-8x22b — 8 experts top-2, GQA(kv=8), SWA [arXiv:2401.04088]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, window=4096,
    rope_theta=1e6, tied_embeddings=False,
)

REDUCED = FULL.with_(
    name="mixtral-8x22b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_head=32, d_ff=256, vocab=512, n_experts=4, top_k=2,
    window=16, dtype="float32")
