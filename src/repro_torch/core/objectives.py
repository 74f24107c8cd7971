"""Schedule objectives (paper Definitions 2.1-2.3).

The counterpart of ``repro.core.objectives``.  Evaluators take a schedule
as ``(start, assign)`` int32 tensors of shape ``[*lead, T]``, the
:class:`~repro_torch.core.instance.PackedInstance` (whose own leading axes
are a prefix of ``lead``) and, for carbon, the cumulative carbon trace
``cum`` of shape ``[*instance_lead, H+1]``.  They return one value per
schedule, of shape ``lead``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.instance import (EPOCH_HOURS, PackedInstance, aligned,
                                       bcast_lead)
from repro_torch.core.validate import task_durations


class Objectives(NamedTuple):
    makespan: torch.Tensor   # int32 (epochs)
    energy: torch.Tensor     # float32 (kWh)
    carbon: torch.Tensor     # float32 (gCO2)


def makespan(inst: PackedInstance, start: torch.Tensor,
             assign: torch.Tensor) -> torch.Tensor:
    """Def 2.1 — max completion over (real) tasks."""
    comp = start + task_durations(inst, assign)
    mask = bcast_lead(inst.task_mask, start.shape[:-1], 1)
    return torch.where(mask, comp, 0).amax(-1).to(torch.int32)


def _task_power(inst: PackedInstance, assign: torch.Tensor) -> torch.Tensor:
    """power[assign[..., t]] -> float32 ``[*lead, T]``."""
    power = bcast_lead(inst.power, assign.shape[:-1], 1)
    return torch.gather(power, -1, assign.long())


def energy(inst: PackedInstance, assign: torch.Tensor) -> torch.Tensor:
    """Def 2.2 — sum of P_m * p_{t,m} (kWh). Start-time independent."""
    d = task_durations(inst, assign).to(torch.float32)
    p = _task_power(inst, assign)
    mask = bcast_lead(inst.task_mask, assign.shape[:-1], 1)
    return torch.where(mask, p * d * EPOCH_HOURS, 0.0).sum(-1)


def carbon_from_delta(inst: PackedInstance, assign: torch.Tensor,
                      delta: torch.Tensor) -> torch.Tensor:
    """sum over real tasks of ``P_m * delta`` — the combine step of Def 2.3.

    :func:`carbon` and the kernel wrapper
    :func:`repro_torch.kernels.ops.population_carbon` both end here, so
    the two agree bitwise whenever their per-task deltas do.
    """
    mask = bcast_lead(inst.task_mask, assign.shape[:-1], 1)
    g = _task_power(inst, assign) * delta
    return torch.where(mask, g, 0.0).sum(-1)


def carbon(inst: PackedInstance, start: torch.Tensor, assign: torch.Tensor,
           cum: torch.Tensor) -> torch.Tensor:
    """Def 2.3 — sum of P_m * (cum[s+d] - cum[s]) (gCO2).

    Starts/completions beyond the trace are clipped into ``[0, H]``.
    """
    d = task_durations(inst, assign)
    e = cum.shape[-1] - 1
    s0 = start.clamp(0, e).long()
    s1 = (start + d).clamp(0, e).long()
    c = bcast_lead(cum, start.shape[:-1], 1)
    delta = torch.gather(c, -1, s1) - torch.gather(c, -1, s0)
    return carbon_from_delta(inst, assign, delta)


def evaluate(inst: PackedInstance, start: torch.Tensor, assign: torch.Tensor,
             cum: torch.Tensor) -> Objectives:
    return Objectives(makespan(inst, start, assign),
                      energy(inst, assign),
                      carbon(inst, start, assign, cum))


# ---------------------------------------------------------------------------
# Differentiable (fractional-start) terms: the gate-policy learner
# (repro_torch.learn) optimizes these.  At integer starts they equal
# makespan / carbon above.
# ---------------------------------------------------------------------------

def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` with its gradient: ``torch.clamp`` passes the whole
    gradient at a tie with a bound, ``jnp.clip`` (``lax.max`` then
    ``lax.min``) half of it, as ``torch.maximum``/``torch.minimum`` do."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` row by row, in its formula.

    ``xp`` ``[N]`` sorted; ``fp`` ``[*lead, N]``; ``x`` ``[*lead, K]`` ->
    ``[*lead, K]``.  ``i = clip(searchsorted(xp, x, right), 1, N-1)`` and
    ``f = fp[i-1] + (delta / dx) * df``, with ``fp[0]`` / ``fp[-1]`` where
    ``x`` lies strictly left / right of the ends, so at a knot the gradient
    is the slope of the segment to its right, as ``jax.grad`` gives it.
    """
    n = xp.shape[0]
    i = torch.searchsorted(xp, x.detach().contiguous(), right=True) \
        .clamp(1, n - 1)
    f0 = torch.gather(fp, -1, i - 1)
    df = torch.gather(fp, -1, i) - f0
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # jnp's guard against a zero-width segment: np.spacing(eps), which
    # for a binary float type is eps squared.
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def soft_makespan(inst: PackedInstance, start: torch.Tensor,
                  assign: torch.Tensor) -> torch.Tensor:
    """Def 2.1 over fractional float32 starts ``[*lead, T]`` (``amax``
    splits the gradient among ties, as ``jnp.max`` does).  Equals
    :func:`makespan` at integer starts."""
    comp = start.to(torch.float32) \
        + task_durations(inst, assign).to(torch.float32)
    mask = bcast_lead(inst.task_mask, start.shape[:-1], 1)
    return torch.where(mask, comp, 0.0).amax(-1)


def soft_carbon(inst: PackedInstance, start: torch.Tensor,
                assign: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Def 2.3 over fractional starts: ``cum`` interpolated linearly.

    ``d/ds = P_m * (intensity[s + d] - intensity[s])``, the marginal
    carbon of a delay.  At integer starts the interpolation hits the knots
    and the value equals :func:`carbon`.
    """
    ftype = cum.dtype
    d = task_durations(inst, assign).to(ftype)
    e = cum.shape[-1] - 1
    grid = torch.arange(cum.shape[-1], dtype=ftype, device=cum.device)
    c = bcast_lead(cum, start.shape[:-1], 1)
    s = start.to(ftype)
    c0 = interp(clip(s, 0.0, e), grid, c)
    c1 = interp(clip(s + d, 0.0, e), grid, c)
    mask = bcast_lead(inst.task_mask, assign.shape[:-1], 1)
    g = _task_power(inst, assign) * (c1 - c0)
    return torch.where(mask, g, 0.0).sum(-1)


def utilization(inst: PackedInstance, start: torch.Tensor,
                assign: torch.Tensor) -> torch.Tensor:
    """Busy machine-epochs / (usable machines * makespan).

    The denominator counts machines usable by at least one real task, so
    machine padding leaves the metric unchanged.
    """
    lead = start.shape[:-1]
    a = aligned(inst, lead)
    d = task_durations(inst, assign).to(torch.float32)
    busy = torch.where(a.task_mask, d, 0.0).sum(-1)
    ms = makespan(inst, start, assign).to(torch.float32)
    usable = (inst.allowed & inst.task_mask[..., None]).any(-2) \
        .to(torch.float32).sum(-1)
    usable = bcast_lead(usable, lead)
    return busy / (usable.clamp_min(1.0) * ms.clamp_min(1.0))
