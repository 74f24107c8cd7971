"""whisper-base — [audio] 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865,
enc-dec with conv frontend STUB (``input_specs`` supplies precomputed frame
embeddings).  [arXiv:2212.04356; unverified]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    tie_embeddings=True,
    act="gelu",
    norm="layernorm",
    pos="sinusoidal",
    frontend="audio_stub",
    notes="conv frontend stubbed; decode cells exercise a 32k self-KV shape",
)
