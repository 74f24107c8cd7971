"""kimi-k2-1t-a32b — [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared) — trillion-param MoE
(paper-table).  [arXiv:2501.kimi2; unverified]

Routed experts alone: 61 x 384 x 3 x 7168 x 2048 ~ 1.03e12 params.
The ZeRO-3 / expert-parallel stress case of the suite.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    act="silu_glu",
    norm="rmsnorm",
    pos="rope",
    rope_theta=5e7,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    capacity_factor=1.25,
    router_aux_weight=0.001,
)
