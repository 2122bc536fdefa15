"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend STUB (precomputed
patch embeddings prepended to the token sequence) [hf:microsoft/Phi-3-vision]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064,
    n_img_tokens=144, rope_theta=1e4, tied_embeddings=False,
)

REDUCED = FULL.with_(
    name="phi-3-vision-4.2b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_head=32, d_ff=256, vocab=512, n_img_tokens=8,
    dtype="float32")
