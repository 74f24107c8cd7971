"""Plain PyTorch versions of the port's kernels.

The counterpart of ``repro.kernels.ref``.  The scheduling kernels' plain
versions are deliberately naive: each is the straightforward formulation
of what its kernel computes, run on the CPU by the tests and held bitwise
against the kernel on the card.  The model kernels' plain versions are
the model's own blockwise paths, held to the kernel by a tolerance: the
attention's here, in the kernel's layout (``flash_unrolled``, imported
when called: the models import the kernels), beside the naive oracle
``attention_ref``; the SSD's are ``repro_torch.models.ssm.ssd_chunked``
and its sequential oracle ``ssd_ref``, whose layout is the kernel's.
"""
from __future__ import annotations

import torch


def schedule_delta_ref(start: torch.Tensor, dur: torch.Tensor,
                       cum: torch.Tensor) -> torch.Tensor:
    """Per-task trace deltas ``cum[clip(s+d, 0, H)] - cum[clip(s, 0, H)]``.

    start/dur ``[B, Pop, T]`` int32; cum ``[B, H+1]`` float32 ->
    ``[B, Pop, T]`` float32.  Both epochs are clamped before the gather, so
    a candidate that overruns the trace integrates to its edge.
    """
    e = cum.shape[-1] - 1
    s0 = start.clamp(0, e).long()
    s1 = (start + dur).clamp(0, e).long()
    c = cum.unsqueeze(-2).expand(*start.shape[:-1], cum.shape[-1])
    return torch.gather(c, -1, s1) - torch.gather(c, -1, s0)


def schedule_carbon_ref(start: torch.Tensor, dur: torch.Tensor,
                        power: torch.Tensor, cum: torch.Tensor
                        ) -> torch.Tensor:
    """start/dur ``[B, Pop, T]`` int32; power ``[B, Pop, T]`` float32 (zero on
    padded tasks); cum ``[B, H+1]`` -> carbon ``[B, Pop]``."""
    return (power * schedule_delta_ref(start, dur, cum)).sum(-1)


def _sorted_gate_windows(intensity: torch.Tensor, window: torch.Tensor,
                         max_window: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked, sorted windows ``[R, E, max_window]`` and valid counts
    ``[R, E]`` int32; invalid slots are ``+inf`` and sort last (a stable
    sort, so equal values keep their window order)."""
    R, E = intensity.shape
    dev = intensity.device
    off = torch.arange(max_window, device=dev)
    idx = torch.arange(E, device=dev)[:, None] + off[None, :]      # [E, W]
    valid = ((off[None, None, :] < window[:, None, None])
             & (idx < E)[None])                                    # [R, E, W]
    vals = intensity[:, idx.clamp_max(E - 1)]                      # [R, E, W]
    vals = torch.where(valid, vals, float("inf"))
    return (torch.sort(vals, dim=-1, stable=True).values,
            valid.sum(-1, dtype=torch.int32))


def gate_quantile_stats_ref(intensity: torch.Tensor, theta: torch.Tensor,
                            window: torch.Tensor, max_window: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The two order statistics of each epoch's window, and its size.

    intensity, theta ``[R, E]`` float32; window ``[R]`` int32; the window
    of epoch ``t`` is ``intensity[t : t + min(window, max_window)]``,
    truncated at E, with ``n`` valid slots.  Returns ``(a, b, n)``, each
    ``[R, E]``: the values at sorted positions ``lo = floor(theta * (n-1))``
    and ``min(lo + 1, n - 1)`` (``+inf`` where ``n == 0``) and ``n`` int32.
    """
    sv, n = _sorted_gate_windows(intensity, window, max_window)
    vi = theta * (n - 1).to(torch.float32)
    lo = torch.floor(vi).to(torch.int64)
    hi = torch.minimum(lo + 1, (n - 1).to(torch.int64))
    top = max(max_window - 1, 0)
    a = torch.gather(sv, -1, lo.clamp(0, top).unsqueeze(-1)).squeeze(-1)
    b = torch.gather(sv, -1, hi.clamp(0, top).unsqueeze(-1)).squeeze(-1)
    return a, b, n


def gate_threshold_ref(intensity: torch.Tensor, theta: torch.Tensor,
                       window: torch.Tensor, max_window: int
                       ) -> torch.Tensor:
    """Per-epoch window quantile via a full sort — the naive gate.

    ``np.quantile``'s linear interpolation over the masked sorted windows,
    written out here (the counterpart of ``repro.kernels.ref``'s) so that
    the kernel's test target shares no code with ``ops.gate_threshold``.
    Shapes as in :func:`gate_quantile_stats_ref`; returns ``[R, E]``.
    """
    sv, n = _sorted_gate_windows(intensity, window, max_window)
    vi = theta * (n - 1).to(torch.float32)
    lo = torch.floor(vi)
    gamma = vi - lo
    lo_i = lo.to(torch.int64)
    hi_i = torch.minimum(lo_i + 1, (n - 1).to(torch.int64))
    a = torch.gather(sv, -1, lo_i.unsqueeze(-1)).squeeze(-1)
    b = torch.gather(sv, -1, hi_i.unsqueeze(-1)).squeeze(-1)
    diff = b - a
    return torch.where(gamma >= 0.5, b - diff * (1.0 - gamma),
                       a + diff * gamma)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          block: int = 2048) -> torch.Tensor:
    """The ``flash_attention`` kernel's plain version, in its layout.

    q ``[B, H, Sq, dh]``; k, v ``[B, KVH, Skv, dh]`` -> ``[B, H, Sq, dh]``:
    the model's blockwise online softmax, so that the CPU model computes
    what the JAX model does: causal (or windowed) inputs through
    :func:`repro_torch.models.attention.flash_unrolled` (blocks of
    ``block``), non-causal
    ones through :func:`~repro_torch.models.attention.flash_scan` (q
    blocks of ``block // 2``, kv blocks of ``block``, as the reference's
    model calls it).  Both are imported when called: the models import
    the kernels.
    """
    from repro_torch.models.attention import flash_scan, flash_unrolled
    B, H, Sq, dh = q.shape
    KVH = k.shape[1]
    qg = q.transpose(1, 2).reshape(B, Sq, KVH, H // KVH, dh)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if causal or window:
        out = flash_unrolled(qg, kt, vt, block=block, window=window,
                             causal=causal)
    else:
        out = flash_scan(qg, kt, vt, block_q=max(block // 2, 1),
                         block_k=block)
    return out.reshape(B, Sq, H, dh).transpose(1, 2)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,S,dh]; k,v [B,KVH,Skv,dh]. Full-matrix softmax attention —
    the naive oracle, sharing no code with the blockwise path."""
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    rep = H // KVH
    kk = torch.repeat_interleave(k, rep, dim=1).float()
    vv = torch.repeat_interleave(v, rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / (dh ** 0.5)
    if causal or window:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = kpos <= qpos if causal else torch.ones(
            (Sq, Skv), dtype=torch.bool, device=q.device)
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
