"""Mamba2 (state-space duality / SSD) mixer: chunked prefill + decode.

The counterpart of ``repro.models.ssm``.  The SSD algorithm (Dao & Gu,
arXiv:2405.21060) splits the sequence into chunks of ``Q`` steps: within a
chunk the recurrence is a masked quadratic form, and a scan over chunk
*states* [H, P, N] carries information between chunks.

:func:`ssd_chunked` is the plain version of the ``ssd_scan`` kernel: the
CPU runs it, the card runs the kernel (``kernels.ops.ssd_scan`` picks by
the tensor's device).  The train mode's gradient is autograd through it,
recomputed in the backward (``kernels.ops.ssd_scan_trainable``), as the
reference's is XLA's autodiff of it.  :func:`ssd_ref` is the sequential oracle.  The
depthwise conv is K shifted multiplies, and the decode conv keeps the
reference's ordered shift-sum, so the prefill-to-decode conv handoff
rounds identically.

On a mesh whose rules shard ``ssm_inner`` and ``ssm_heads`` over
``model`` (:func:`ssm_blocks`), each rank holds its block of ``wz``,
``wx``, ``conv_x``, ``norm``, ``out`` (inner channels) and of ``wdt``,
``A_log``, ``Dskip``, ``dt_bias`` (heads), runs ``ssd_scan`` on its heads
and sums the row-parallel ``out`` projection over ``model``.  The B/C
stream (``wbc``, ``conv_bc``) is replicated: every rank computes it
whole, and its gradient, which each rank's heads feed a part of, is
summed over the model ranks (``copy_to_model``).  The gated norm takes
the mean of ``g*g`` over the whole ``d_inner``, so its sum of squares is
summed over the model ranks before the ``rsqrt`` (a per-rank group norm
would be another model).  A decode state holds the rank's heads; its
conv state the rank's inner channels and the B/C channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import cast, row_parallel, silu
from repro_torch.models.params import ParamDef
from repro_torch.models.parallel import (ParallelCfg, batch_spec, constrain,
                                         copy_to_model, sum_over_model)


def ssm_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    return {
        "wz": ParamDef((D, di), ("embed", "ssm_inner"), init="scaled"),
        "wx": ParamDef((D, di), ("embed", "ssm_inner"), init="scaled"),
        "wbc": ParamDef((D, 2 * G * N), ("embed", None), init="scaled"),
        "wdt": ParamDef((D, H), ("embed", "ssm_heads"), init="scaled"),
        "conv_x": ParamDef((K, di), ("conv", "ssm_inner"), init="scaled"),
        "conv_bc": ParamDef((K, 2 * G * N), ("conv", None), init="scaled"),
        "conv_bias_x": ParamDef((di,), ("ssm_inner",), init="zeros"),
        "conv_bias_bc": ParamDef((2 * G * N,), (None,), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "Dskip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones"),
        "out": ParamDef((di, D), ("ssm_inner", "embed"), init="scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv as K shifted multiplies. x [B,S,C], w [K,C]."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    wc = cast(w)
    out = pad[:, 0:S] * wc[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * wc[i]
    return out + cast(b)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA [..., Q] -> L [..., Q, Q]: L[i,j] = sum_{j<t<=i} dA[t], -inf i<j."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None):
    """Chunked SSD. x [B,S,H,P]; dt [B,S,H] (post-softplus); A [H] (<0);
    Bm, Cm [B,S,G,N]. Returns (y [B,S,H,P], h_final [B,H,P,N] f32).

    A ragged last chunk is padded with dt = 0 steps, which are the
    identity on the state.  Works in f32 throughout: a bf16 ``M`` puts
    prefill's last output a bf16 ulp away from the decode continuation of
    its own state (the reference's note).
    """
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    if S % Q:                       # pad: dt=0 steps are identity on state
        pad = Q - S % Q

        def padf(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        y, h = ssd_chunked(padf(x), padf(dt), A, padf(Bm), padf(Cm), Q, h0)
        return y[:, :S], h
    nc = S // Q
    rep = H // G

    def chunkify(a):
        return a.reshape((Bsz, nc, Q) + a.shape[2:])

    xc, dtc = chunkify(x), chunkify(dt.float())
    Bc, Cc = chunkify(Bm), chunkify(Cm)
    dA = dtc * A.float()                                   # [B,nc,Q,H]
    dAh = dA.permute(0, 1, 3, 2)                           # [B,nc,H,Q]
    cum = torch.cumsum(dAh, dim=-1)                        # [B,nc,H,Q]

    # --- intra-chunk (quadratic) term ---
    L = torch.exp(_segsum(dAh))                            # [B,nc,H,Q,Q]
    Bh = torch.repeat_interleave(Bc, rep, dim=3).float()   # [B,nc,Q,H,N]
    Ch = torch.repeat_interleave(Cc, rep, dim=3).float()
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    M = scores * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xc.float())

    # --- chunk states ---
    decay_to_end = torch.exp(cum[..., -1:] - cum)          # [B,nc,H,Q]
    wgt = (decay_to_end * dtc.permute(0, 1, 3, 2)).permute(0, 1, 3, 2)
    states = torch.einsum("bcjhn,bcjh,bcjhp->bchpn", Bh, wgt,
                          xc.float())                      # [B,nc,H,P,N]

    # --- inter-chunk scan over states ---
    chunk_decay = torch.exp(cum[..., -1])                  # [B,nc,H]
    h = (torch.zeros((Bsz, H, Pd, N), device=x.device) if h0 is None
         else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)                                     # state *entering*
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, 1)                            # [B,nc,H,P,N]

    # --- inter-chunk contribution: y += C_i . (decay_i * h_in) ---
    in_decay = torch.exp(cum).permute(0, 1, 3, 2)          # [B,nc,Q,H]
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Ch, h_in)
    y = y_intra + y_inter * in_decay[..., None]
    return y.reshape(Bsz, S, H, Pd).to(x.dtype), h


def ssd_ref(x, dt, A, Bm, Cm, h0=None):
    """Sequential recurrence oracle: step-by-step state update."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    h = (torch.zeros((Bsz, H, Pd, N), device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t].float() * A.float())      # [B,H]
        Bt = torch.repeat_interleave(Bm[:, t], rep, dim=1).float()  # [B,H,N]
        Ct = torch.repeat_interleave(Cm[:, t], rep, dim=1).float()
        upd = (dt[:, t, :, None, None].float()
               * x[:, t, :, :, None].float() * Bt[:, :, None, :])
        h = h * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ct))
    return torch.stack(ys, 1).to(x.dtype), h


def ssm_blocks(cfg: ArchConfig, par: ParallelCfg
               ) -> tuple[int, int, int, int]:
    """``(c0, c1, h0, h1)``: the inner channels and the SSM heads this
    rank holds (all of them unless the rules shard them)."""
    di, H = cfg.d_inner, cfg.ssm_heads
    inner, heads = par.tp_sharded("ssm_inner"), par.tp_sharded("ssm_heads")
    if inner != heads:
        raise ValueError("ssm_inner and ssm_heads must shard together: a "
                         "rank's inner channels are its heads' channels")
    if not inner:
        return 0, di, 0, H
    n, m = par.model_axis_size, par.model_index
    return m * di // n, (m + 1) * di // n, m * H // n, (m + 1) * H // n


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float, par: ParallelCfg | None = None,
                width: int | None = None) -> torch.Tensor:
    """RMS norm of ``y * silu(z)`` over the inner width; on a mesh ``y``
    holds ``width / model`` of its channels and the sum of squares is
    summed over the model ranks."""
    g = y.float() * silu(z.float())
    if width is None or width == g.shape[-1]:
        ms = torch.mean(g * g, -1, keepdim=True)
    else:
        ms = sum_over_model(torch.sum(g * g, -1, keepdim=True), par) / width
    g = g * torch.rsqrt(ms + eps)
    return (g * scale.float()).to(y.dtype)


def ssm_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, par: ParallelCfg,
              *, mode: str = "prefill", state: dict | None = None):
    """Mamba2 mixer. x [B,S,D]. mode prefill: full-sequence chunked SSD
    through ``ops.ssd_scan``; train: the same through
    ``ops.ssd_scan_trainable``, with no state emitted; decode: one step
    against ``state`` = {"h": [B,H,P,N] f32, "conv": [B,K-1, di+2GN]}.
    Returns (y, new_state), new_state ``{}`` in train mode."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"ssm_apply: unknown mode {mode!r}")
    Bsz, S, D = x.shape
    c0, c1, h0, h1 = ssm_blocks(cfg, par)
    tp = c1 - c0 != cfg.d_inner
    di, G, N, H = c1 - c0, cfg.ssm_groups, cfg.ssm_state, h1 - h0
    Pd, K = cfg.ssm_headdim, cfg.ssm_conv

    bc = x @ cast(p["wbc"])
    if tp:
        x = copy_to_model(x, par)
    z = x @ cast(p["wz"])
    xin = x @ cast(p["wx"])
    dt = x @ cast(p["wdt"])
    ispec = batch_spec(par, None, "model")
    z, xin = constrain(z, par, ispec), constrain(xin, par, ispec)

    if mode == "decode":
        conv_st = state["conv"]                            # [B, K-1, C]
        full = torch.cat([conv_st, torch.cat([xin, bc], -1)], 1)
        w = cast(torch.cat([p["conv_x"], p["conv_bc"]], 1))
        b = torch.cat([p["conv_bias_x"], p["conv_bias_bc"]], 0)
        # Ordered shift-sum, as the prefill pass sums: the conv handoff
        # rounds identically.
        conv_out = full[:, 0] * w[0]
        for i in range(1, K):
            conv_out = conv_out + full[:, i] * w[i]
        conv_out = silu(conv_out + cast(b))[:, None]     # [B,1,C]
        xin, bc = conv_out[..., :di], conv_out[..., di:]
        new_conv = full[:, 1:]
    else:
        if mode == "prefill":                    # pre-conv tail for decode
            new_conv = torch.cat([xin, bc], -1)[:, S - K + 1:]
        xin = silu(_causal_conv(xin, p["conv_x"], p["conv_bias_x"]))
        bc = silu(_causal_conv(bc, p["conv_bc"], p["conv_bias_bc"]))
    if tp:
        bc = copy_to_model(bc, par)

    Bm = bc[..., :G * N].reshape(Bsz, S, G, N)
    Cm = bc[..., G * N:].reshape(Bsz, S, G, N)
    xh = xin.reshape(Bsz, S, H, Pd)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if mode == "decode":
        da = torch.exp(dt[:, 0] * A)                       # [B,H]
        rep = H // G
        Bt = torch.repeat_interleave(Bm[:, 0], rep, dim=1).float()
        Ct = torch.repeat_interleave(Cm[:, 0], rep, dim=1).float()
        upd = (dt[:, 0, :, None, None] * xh[:, 0, :, :, None].float()
               * Bt[:, :, None, :])
        h = state["h"] * da[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", h, Ct)
        y = y[:, None].to(x.dtype)                         # [B,1,H,P]
    else:
        scan = ops.ssd_scan_trainable if mode == "train" else ops.ssd_scan
        y, h = scan(xh.contiguous(), dt.contiguous(), A, Bm.contiguous(),
                    Cm.contiguous(), chunk=cfg.ssm_chunk)
    new_state = {} if mode == "train" else {"h": h, "conv": new_conv}

    y = y + xh * cast(p["Dskip"])[:, None]
    y = y.reshape(Bsz, S, di)
    if tp:
        y = _gated_norm(y, z, p["norm"], cfg.norm_eps, par, cfg.d_inner)
        return row_parallel(y, cast(p["out"]), par), new_state
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return y @ cast(p["out"]), new_state
