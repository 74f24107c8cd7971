"""Int8 gradient compression with error feedback.

The counterpart of ``repro.optim.compress``, over the port's flat dicts of
tensors.  Each gradient plus its carried residual is quantised per tensor
(symmetric, max-abs scale / 127, round half to even, clipped to +-127,
int8) and dequantised at once; what the quantisation lost is carried to
the next step in :class:`CompressState`, so the error is delayed, not
dropped.  On a multi-pod mesh the int8 payload is what would cross the pod
boundary; on one card the step only carries the numerics.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CompressState(NamedTuple):
    residual: dict       # error-feedback accumulator, keyed as the grads


def compress_init(params: dict) -> CompressState:
    return CompressState({k: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for k, p in params.items()})


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(int8 codes, float32 scale)`` of ``x``, as the reference's
    ``_q8``: ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compressed_grads(grads: dict, state: CompressState
                     ) -> tuple[dict, CompressState, dict]:
    """Returns (dequantised grads, new state, metrics): each grad in its
    own dtype, the residuals float32, ``compress_residual_sq`` the sum of
    the squared residuals."""
    deq, res = {}, {}
    for k, g in grads.items():
        x = g.to(torch.float32) + state.residual[k]
        q, scale = _q8(x)
        d = q.to(torch.float32) * scale
        deq[k] = d.to(g.dtype)
        res[k] = x - d
    err = sum(torch.sum(torch.square(r)) for r in res.values())
    return deq, CompressState(res), {"compress_residual_sq": err}
