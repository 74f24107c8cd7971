"""Differentiable relaxation of the gated online dispatcher.

The counterpart of ``repro.learn.relax``, held against it by
``tests/test_torch_learn.py``.  The hard gate
(:mod:`repro_torch.core.solvers.online_torch`) is a step function of
``theta``; this module relaxes its two discrete pieces and nothing else:

* **gate** — :func:`soft_gate` replaces the ``intensity > thresh`` step
  with ``sigmoid((intensity - thresh - GATE_EPS) / (temp * std))``.  The
  threshold is :func:`repro_torch.kernels.ops.gate_threshold`: one
  ``gate_quantile`` launch for all rows on the card, whose selection is
  piecewise constant in ``theta``; the gradient ``diff * (n - 1)`` flows
  through the lerp the wrapper keeps in torch, the expression whose
  gradient the reference takes;
* **waiting** — :func:`expected_wait` treats the soft mask as per-epoch
  waiting probabilities (``W[e] = dirty[e] * (1 + W[e+1])``) and
  :func:`soft_starts` propagates fractional starts through the DAG with
  the budget cap the hard dispatcher enforces.

Machine contention is not relaxed: :mod:`repro_torch.learn.loss` takes
forward values from the hard dispatch and gradients from the soft starts.
Where the reference ``vmap``s over instances, every function here takes
the instances' leading axes (``[B, E]`` intensities, ``[B, T]`` starts).
The reference's scans become Python loops that build new tensors (the
columns of a reverse scan are stacked; a start is placed with
``torch.where``): an in-place write would break autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.instance import PackedInstance, aligned, bcast_lead
from repro_torch.core.objectives import clip, interp, makespan
from repro_torch.core.solvers.online_torch import (GATE_EPS, OnlineSchedule,
                                                   downstream_critical_path,
                                                   online_greedy_torch,
                                                   simulate_online,
                                                   stretch_budget)
from repro_torch.core.validate import task_durations
from repro_torch.kernels import ops


class SoftDispatch(NamedTuple):
    """Hard forward schedule + differentiable relaxation around it."""

    hard: OnlineSchedule     # exact gated dispatch (forward values)
    greedy: OnlineSchedule   # carbon-agnostic baseline (budget reference)
    start: torch.Tensor      # float32 [*lead, T] soft starts (differentiable)
    dirty: torch.Tensor      # float32 [*lead, E] sigmoid-relaxed dirty mask
    budget: torch.Tensor     # int32 [*lead] = int(stretch * greedy makespan)


def soft_gate(intensity: torch.Tensor, theta: torch.Tensor, window,
              max_window: int, temp: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid-relaxed dirty mask ``[*lead, E]`` and the exact boolean gate.

    ``intensity`` ``[*lead, E]``; ``theta`` broadcasts to it (scalar, per
    row or per epoch) and may require grad; ``window`` broadcasts to
    ``lead``.  The margin is scaled by each row's trace std (detached,
    ``correction=0``; the reference's ``jnp.std`` runs per instance), so
    ``temp`` is scale-free.  ``soft > 0.5`` equals the hard gate, which is
    ``online_torch.dirty_mask`` on the same threshold.
    """
    thresh = ops.gate_threshold(intensity, theta, window, max_window)
    margin = intensity - thresh - GATE_EPS
    scale = torch.clamp_min(torch.std(intensity, dim=-1, correction=0,
                                      keepdim=True), 1e-6).detach()
    soft = torch.sigmoid(margin / torch.clamp_min(temp * scale, 1e-8))
    return soft, margin > 0


def expected_wait(soft_dirty: torch.Tensor) -> torch.Tensor:
    """Expected gate-waiting epochs from each epoch, float32 ``[*lead, E]``.

    ``W[e] = dirty[e] * (1 + W[e+1])``, a reverse loop over epochs: on 0/1
    masks it counts the run of dirty epochs starting at ``e``; on soft
    masks it is the expectation under independent waiting probabilities.
    """
    w = torch.zeros_like(soft_dirty[..., 0])
    cols = []
    for a in reversed(soft_dirty.unbind(-1)):
        w = a * (1.0 + w)
        cols.append(w)
    return torch.stack(cols[::-1], dim=-1)


def soft_starts(inst: PackedInstance, wait: torch.Tensor, dur: torch.Tensor,
                cp: torch.Tensor, budget: torch.Tensor) -> torch.Tensor:
    """Fractional start times through the DAG, float32 ``[*lead, T]``.

    Tasks are topologically indexed, so one pass over them suffices: a
    task is ready at ``r = max(arrival, max over preds of soft
    completion)``, then waits the expected gate delay ``wait`` interpolated
    at ``r``, capped by the budget rule of the hard dispatcher (waiting
    only while ``t + 1 + cp <= budget``: an allowance of
    ``max(budget - cp - r, 0)``).  ``wait`` is ``[*lead, E]``, ``dur`` the
    hard dispatch's durations ``[*lead, T]``, ``cp`` the downstream
    critical path, ``budget`` ``[*lead]``.  Machine contention is not
    modelled.
    """
    lead = tuple(wait.shape[:-1])
    E = wait.shape[-1]
    T = inst.T
    ftype = wait.dtype
    dev = wait.device
    a = aligned(inst, lead)
    grid = torch.arange(E, dtype=ftype, device=dev)
    dreal = dur.to(ftype)
    allow_from = budget.to(ftype)[..., None] \
        - bcast_lead(cp, lead, 1).to(ftype)
    preds = a.pred & a.task_mask[..., None, :]
    arrival = a.arrival.to(ftype)
    zero = torch.zeros((), dtype=ftype, device=dev)
    tix = torch.arange(T, device=dev)
    s = torch.zeros(lead + (T,), dtype=ftype, device=dev)
    for t in range(T):
        comp = s + dreal
        r = torch.maximum(arrival[..., t],
                          torch.where(preds[..., t, :], comp, 0.0).amax(-1))
        w = interp(clip(r, 0.0, E - 1)[..., None], grid, wait)[..., 0]
        st = r + torch.minimum(w, torch.maximum(allow_from[..., t] - r,
                                                zero))
        st = torch.where(a.task_mask[..., t], st, 0.0)
        s = torch.where(tix == t, st[..., None], s)
    return s


class GatedRelaxation(NamedTuple):
    """The hard gated dispatch under a budget and its relaxation."""

    dirty: torch.Tensor      # float32 [*lead, E] sigmoid-relaxed dirty mask
    hard: OnlineSchedule     # exact gated dispatch
    dur: torch.Tensor        # int32 [*lead, T] durations of hard.assign
    start: torch.Tensor      # float32 [*lead, T] soft starts


def gated_relaxation(inst: PackedInstance, intensity: torch.Tensor, theta,
                     window, max_window: int, budget: torch.Tensor,
                     temp: torch.Tensor, n_epochs: int,
                     machine_rule: str = "earliest_finish"
                     ) -> GatedRelaxation:
    """The one copy of the relaxation pipeline: :func:`soft_gate`, the
    hard dispatch of its exact mask under ``budget``, and the soft starts
    through :func:`expected_wait` on the hard assignment's durations."""
    soft, hard_mask = soft_gate(intensity, theta, window, max_window, temp)
    hard = simulate_online(inst, hard_mask, budget, n_epochs,
                           machine_rule=machine_rule)
    dur = task_durations(inst, hard.assign)
    start = soft_starts(inst, expected_wait(soft), dur,
                        downstream_critical_path(inst), budget)
    return GatedRelaxation(dirty=soft, hard=hard, dur=dur, start=start)


def soft_dispatch(inst: PackedInstance, intensity: torch.Tensor, theta,
                  window, stretch, max_window: int, temp: float = 0.05,
                  machine_rule: str = "earliest_finish") -> SoftDispatch:
    """Gated dispatch with a differentiable relaxation attached.

    Forward semantics are ``online_carbon_gated_torch``'s, bit for bit:
    the greedy baseline fixes ``budget = int(stretch * makespan)``, the
    hard quantile gate masks epochs, ``simulate_online`` dispatches.  On
    top, ``start``/``dirty`` carry the temperature-``temp`` relaxation,
    differentiable in ``theta`` (scalar, per row or per epoch).  Tensors
    lie on ``inst``'s device; ``intensity`` is ``[*instance_lead, E]``.
    """
    intensity = torch.as_tensor(intensity, dtype=torch.float32)
    dev = intensity.device
    n_epochs = int(intensity.shape[-1])
    g = online_greedy_torch(inst, n_epochs, machine_rule=machine_rule,
                            device=dev)
    budget = stretch_budget(stretch, makespan(inst, g.start, g.assign))
    r = gated_relaxation(inst, intensity, theta, window, max_window, budget,
                         torch.as_tensor(temp, dtype=torch.float32,
                                         device=dev),
                         n_epochs, machine_rule)
    return SoftDispatch(hard=r.hard, greedy=g, start=r.start, dirty=r.dirty,
                        budget=budget)
