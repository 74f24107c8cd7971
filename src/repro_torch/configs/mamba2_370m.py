"""mamba2-370m — [ssm] 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Constant-size recurrent state -> runs the ``long_500k`` shape.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    pos="none",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    ssm_chunk=256,
)
