"""Architecture config schema and shape suite.

The counterpart of ``repro.models.common``, copied (the reference module
imports JAX only for its input specs).  Every architecture is an
:class:`ArchConfig`; ``configs/<id>.py`` holds the published dims.
``reduced()`` shrinks a config to a CPU-testable size of the same family.
``input_specs`` gives the model inputs of one (arch x shape) cell as
shapes and dtypes (:class:`TensorSpec`, allocating nothing) for the
train, prefill and decode kinds.  ``materialize`` builds real tensors of
those specs on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

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


# ---------------------------------------------------------------------------
# Input specs (shapes and dtypes; nothing is allocated).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: str | ShapeCfg,
                scale_batch: int = 1) -> dict[str, TensorSpec]:
    """Model inputs for one (arch x shape) cell, in the reference's keys
    and order.

    ``train``  : a token and label batch (the stub frontends supply
                 precomputed embeddings: for the vision stub the first
                 ``n_frontend_tokens`` of the ``seq`` positions are patch
                 embeddings; an encdec model's encoder reads ``seq`` frame
                 embeddings).
    ``prefill``: a request batch of ``seq`` positions (for the vision stub
                 ``n_frontend_tokens`` of them are patch embeddings; an
                 encdec model's encoder reads ``seq`` frame embeddings).
    ``decode`` : one new token against a ``seq``-long cache.
    ``scale_batch`` divides the global batch (for reduced smoke runs).
    """
    sc = SHAPES[shape] if isinstance(shape, str) else shape
    B = max(sc.batch // scale_batch, 1)
    S = sc.seq
    D = cfg.d_model
    i32, bf16 = torch.int32, torch.bfloat16
    if sc.kind == "train":
        if cfg.frontend == "vision_stub":
            P = cfg.n_frontend_tokens
            return {"patch_embeds": TensorSpec((B, P, D), bf16),
                    "tokens": TensorSpec((B, S - P), i32),
                    "labels": TensorSpec((B, S - P), i32)}
        specs = {}
        if cfg.family == "encdec":
            specs["frame_embeds"] = TensorSpec((B, S, D), bf16)
        return {**specs, "tokens": TensorSpec((B, S), i32),
                "labels": TensorSpec((B, S), i32)}
    if sc.kind == "prefill":
        if cfg.frontend == "vision_stub":
            P = cfg.n_frontend_tokens
            return {"patch_embeds": TensorSpec((B, P, D), bf16),
                    "tokens": TensorSpec((B, S - P), i32)}
        if cfg.family == "encdec":
            return {"frame_embeds": TensorSpec((B, S, D), bf16),
                    "tokens": TensorSpec((B, S), i32)}
        return {"tokens": TensorSpec((B, S), i32)}

    # decode: one-step serve with caches sized for S.
    specs = {"token": TensorSpec((B, 1), i32), "pos": TensorSpec((), i32)}
    L = cfg.n_layers
    if cfg.n_heads and cfg.n_kv_heads:
        W = min(cfg.attn_window or S, S)
        kv = (L, B, W, cfg.n_kv_heads, cfg.head_dim)
        specs["k_cache"] = TensorSpec(kv, bf16)
        specs["v_cache"] = TensorSpec(kv, bf16)
    if cfg.ssm_state:
        H, P_, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        specs["ssm_state"] = TensorSpec((L, B, H, P_, N), torch.float32)
        specs["conv_state"] = TensorSpec((L, B, cfg.ssm_conv - 1,
                                          cfg.conv_dim), bf16)
    if cfg.family == "encdec":
        enc = (L, B, S, cfg.n_kv_heads, cfg.head_dim)
        specs["enc_out"] = TensorSpec(enc, bf16)
        specs["enc_out_v"] = TensorSpec(enc, bf16)
    return specs


def materialize(cfg: ArchConfig, shape_name: str, seq: int = 64,
                batch: int = 2, seed: int = 0,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> dict[str, torch.Tensor]:
    """Real inputs of ``input_specs(cfg, (shape_name's kind, seq, batch))``
    on ``device``, drawn from ``numpy.random.default_rng(seed)`` in the
    specs' order as the reference's tests draw them: integer ids in
    ``[0, vocab_size)`` (a scalar ``pos`` is ``seq // 2``), float inputs
    ``0.02 x N(0, 1)`` rounded to their dtype."""
    device = resolve_device(device)
    sc = ShapeCfg(shape_name, SHAPES[shape_name].kind, seq, batch)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, sc).items():
        if s.dtype == torch.int32:
            a = (np.int32(seq // 2) if s.shape == () else
                 rng.integers(0, cfg.vocab_size, s.shape).astype(np.int32))
            out[k] = torch.as_tensor(a, device=device)
        else:
            out[k] = torch.as_tensor(0.02 * rng.standard_normal(s.shape),
                                     dtype=s.dtype, device=device)
    return out
