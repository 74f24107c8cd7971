"""qwen1.5-0.5b — [dense] 24L d_model=1024 16H (GQA kv=16, i.e. MHA)
d_ff=2816 vocab=151936, QKV bias, tied embeddings.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    act="silu_glu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=1e6,
)
