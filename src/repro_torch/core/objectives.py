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
