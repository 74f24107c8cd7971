"""Plain PyTorch versions of the port's kernels.

The counterpart of ``repro.kernels.ref``.  Deliberately naive: each is
the straightforward formulation of what its kernel computes, run on the
CPU by the tests and held bitwise against the kernel on the card.
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
