"""whisper-tiny — enc-dec, conv frontend STUB (precomputed frame embeddings)
[arXiv:2212.04356].  Decode shapes use the text decoder; the assigned 32k
decode positions exceed Whisper's real 448-token window and are lowered as
specified (synthetic long-position table)."""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, n_enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_head=64, d_ff=1536, vocab=51865,
    n_audio_frames=1500, max_positions=524288,
    norm_eps=1e-5, tied_embeddings=True,
)

REDUCED = FULL.with_(
    name="whisper-tiny-smoke", n_layers=2, n_enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=512,
    n_audio_frames=16, max_positions=256, dtype="float32")
