"""granite-20b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab=49152, mlp_type="gelu",
    rope_theta=1e4, tied_embeddings=False,
)

REDUCED = FULL.with_(
    name="granite-20b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=1, d_head=32, d_ff=256, vocab=512, dtype="float32")
