"""llava-next-34b — [vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The Yi-34B-style language backbone; the anyres vision tower is a STUB per
the assignment: ``input_specs`` supplies precomputed patch embeddings
(2880 tokens ~ base tile + 4 anyres tiles x 576 patches).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    act="silu_glu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=5e6,
    frontend="vision_stub",
    n_frontend_tokens=2880,
    notes="anyres vision frontend stubbed (precomputed patch embeddings)",
)
