"""hymba-1.5b — [hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per block,
sliding-window attention (2048).  [arXiv:2411.13676; hf]

SSM head-dim chosen as 100 so the 3200-wide inner dim splits into 32 heads
(divisible by the 16-way tensor axis).  Sub-quadratic (SWA + SSM) -> runs
``long_500k``.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    act="silu_glu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=1e4,
    attn_window=2048,
    ssm_state=16,
    ssm_headdim=100,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    ssm_chunk=256,
)
