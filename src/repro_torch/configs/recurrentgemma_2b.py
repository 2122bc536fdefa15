"""recurrentgemma-2b — RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427]."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "attn"), local_window=2048,
    rglru_d_state=2560, conv_width=4,
    tied_embeddings=True,
)

REDUCED = FULL.with_(
    name="recurrentgemma-2b-smoke", n_layers=3, d_model=128, n_heads=4,
    n_kv_heads=1, d_head=32, d_ff=256, vocab=512, local_window=16,
    rglru_d_state=128, dtype="float32")
