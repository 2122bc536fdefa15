"""llama3.2-1b — small llama3, GQA(kv=8), tied embeddings [hf:meta-llama]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=128256,
    rope_theta=5e5, tied_embeddings=True,
)

REDUCED = FULL.with_(
    name="llama3.2-1b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_head=32, d_ff=256, vocab=512, dtype="float32")
