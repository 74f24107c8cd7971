"""Architecture config schema and shape suite.

The counterpart of ``repro.models.common``, copied (the reference module
imports JAX only for its input specs).  Every architecture is an
:class:`ArchConfig`; ``configs/<id>.py`` holds the published dims.
``reduced()`` shrinks a config to a CPU-testable size of the same family.
``input_specs`` (the dry run's stand-ins) waits for the dry-run slice.
"""
from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 for pure ssm)
    n_kv_heads: int
    d_ff: int                   # dense MLP width, or per-expert width for moe
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    act: str = "silu_glu"       # silu_glu | gelu | relu2
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    pos: str = "rope"           # rope | sinusoidal
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_chunk: int = 256
    # --- hybrid / attention variants ---
    attn_window: int = 0        # 0 = full causal; >0 = sliding window
    # --- encoder-decoder / modality frontends (STUBS per assignment) ---
    n_encoder_layers: int = 0
    frontend: str = "none"      # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0  # patch/frame embeddings prepended (vlm)
    # --- numerics / padding ---
    vocab_pad_multiple: int = 2048
    notes: str = ""

    # ----- derived -----
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:   # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def conv_dim(self) -> int:
        # mamba2 conv covers x + B + C streams
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def attn_dim(self) -> int:  # hybrid splits d_model work between mixers
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D roofline checks)."""
        D, V = self.d_model, self.padded_vocab
        n = V * D  # embed
        if not self.tie_embeddings:
            n += V * D
        per_layer = 0
        if self.n_heads:
            q = D * self.n_heads * self.head_dim
            kv = 2 * D * self.n_kv_heads * self.head_dim
            o = self.n_heads * self.head_dim * D
            per_layer += q + kv + o
            if self.qkv_bias:
                per_layer += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
        if self.family == "moe":
            glu = 3 if self.act == "silu_glu" else 2
            per_layer += self.n_experts * glu * D * self.d_ff
            per_layer += self.n_shared_experts * glu * D * self.d_ff
            per_layer += D * self.n_experts  # router
        elif self.d_ff:
            glu = 3 if self.act == "silu_glu" else 2
            per_layer += glu * D * self.d_ff
        if self.ssm_state:
            di, G, N, H = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            per_layer += D * (2 * di + 2 * G * N + H)   # in_proj
            per_layer += self.ssm_conv * self.conv_dim  # conv
            per_layer += 2 * H + di                     # A_log, D, dt_bias-ish
            per_layer += di * D                         # out_proj
        per_layer += 2 * D  # norms
        layers = self.n_layers + self.n_encoder_layers
        n += layers * per_layer
        if self.n_encoder_layers:  # cross-attention in decoder layers
            n += self.n_layers * (2 * D * self.n_kv_heads * self.head_dim
                                  + 2 * D * self.n_heads * self.head_dim)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        glu = 3 if self.act == "silu_glu" else 2
        routed_all = self.n_layers * self.n_experts * glu * self.d_model * self.d_ff
        routed_active = self.n_layers * self.experts_per_token * glu * \
            self.d_model * self.d_ff
        return self.param_count() - routed_all + routed_active

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            vocab_pad_multiple=64,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32,
            attn_window=min(self.attn_window, 64) if self.attn_window else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
        )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}


def supports_shape(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(supported, reason-if-not). long_500k needs sub-quadratic attention."""
    sc = SHAPES[shape]
    if sc.name == "long_500k":
        subq = cfg.family == "ssm" or (cfg.ssm_state and cfg.attn_window) \
            or (cfg.attn_window and cfg.family != "encdec")
        if not subq:
            return False, ("pure full-attention arch: 512k dense KV decode is "
                           "quadratic-cost; skipped per assignment")
    return True, ""
