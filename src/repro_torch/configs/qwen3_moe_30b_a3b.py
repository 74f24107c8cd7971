"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8, QK-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    act="silu_glu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=1e6,
    n_experts=128,
    experts_per_token=8,
    capacity_factor=1.25,
    router_aux_weight=0.001,
)
