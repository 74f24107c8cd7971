"""Carbon-under-makespan-budget loss for gate-policy learning.

The counterpart of ``repro.learn.loss``, held against it by
``tests/test_torch_learn.py``.  One objective per (instance, theta):
the carbon of the gated dispatch plus a budget-violation penalty, so that

* **forward values are honest** — with ``straight_through=True`` (the
  training default) the carbon is the *hard* dispatch's, at its integer
  starts, and the penalty is the validator's integer violation mass
  (:func:`repro_torch.core.validate.total_violations` with the stretch
  budget as deadline);
* **gradients are useful** — both terms take their ``theta`` gradient
  through the soft relaxation (:mod:`repro_torch.learn.relax`): carbon
  through :func:`~repro_torch.core.objectives.soft_carbon`'s interpolated
  trace, the penalty through the soft starts' overshoot
  ``relu(comp - budget)``.

The straight-through splice is at the value level,
``c_soft + (c_hard - c_soft).detach()``, as in the reference.  With
``straight_through=False`` the loss is the soft terms alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import validate
from repro_torch.core.instance import PackedInstance, bcast_lead
from repro_torch.core.objectives import soft_carbon
from repro_torch.learn.relax import gated_relaxation


class GateLossTerms(NamedTuple):
    """Per-instance loss pieces, float32 ``[*lead]`` (starts ``[*lead, T]``)."""

    carbon: torch.Tensor      # gCO2 of the gated dispatch (grad via relaxation)
    penalty: torch.Tensor     # budget-violation mass (grad via soft overshoot)
    soft_start: torch.Tensor  # the relaxed starts (diagnostics)


def gate_loss(inst: PackedInstance, cum: torch.Tensor,
              intensity: torch.Tensor, theta: torch.Tensor, window,
              max_window: int, budget: torch.Tensor, temp: torch.Tensor,
              n_epochs: int, straight_through: bool = True,
              machine_rule: str = "earliest_finish") -> GateLossTerms:
    """Loss terms of every row at its (possibly per-epoch) ``theta``.

    ``intensity`` ``[*lead, E]``, ``cum`` ``[*lead, E+1]``; ``theta``
    broadcasts to ``intensity``; ``window`` and the integer stretch
    ``budget`` to ``lead``.  The gate threshold is one ``gate_quantile``
    launch for all rows (the reference sorts the windows once and reuses
    them; here the kernel selects afresh at every ``theta``).
    """
    r = gated_relaxation(inst, intensity, theta, window, max_window, budget,
                         temp, n_epochs, machine_rule)
    hard, dur, s_soft = r.hard, r.dur, r.start

    bud = budget.to(torch.float32)[..., None]
    over = s_soft + dur.to(torch.float32) - bud
    mask = bcast_lead(inst.task_mask, s_soft.shape[:-1], 1)
    pen_soft = torch.where(mask, torch.maximum(over, over.new_zeros(())),
                           0.0).sum(-1)

    c_soft = soft_carbon(inst, s_soft, hard.assign, cum)
    if not straight_through:
        return GateLossTerms(carbon=c_soft, penalty=pen_soft,
                             soft_start=s_soft)
    # Value-level straight-through: forward values from the hard dispatch
    # (exact carbon at integer starts, the validator's budget mass),
    # gradients from the soft terms.
    c_hard = soft_carbon(inst, hard.start.to(torch.float32), hard.assign,
                         cum)                    # == objectives.carbon
    pen_hard = validate.total_violations(
        inst, hard.start, hard.assign, deadline=budget).to(torch.float32)
    return GateLossTerms(carbon=c_soft + (c_hard - c_soft).detach(),
                         penalty=pen_soft + (pen_hard - pen_soft).detach(),
                         soft_start=s_soft)
