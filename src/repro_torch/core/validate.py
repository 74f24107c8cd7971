"""Shared schedule-feasibility validator — one source of truth for Eqs. 4-8.

The counterpart of ``repro.core.validate``.  Every check of the paper's
Appendix A MILP constraints on a schedule ``(start[T], assign[T])``:

  Eq. 4  arrivals          start[t] >= a_{j(t)}
  Eq. 5  DAG precedence    start[v] >= start[u] + p_{u,assign[u]} on edges u->v
  Eq. 6  machine validity  assign[t] in allowed[t]
  Eq. 8  no-overlap        intervals on one machine are pairwise disjoint
  budget (deadline)        completion[t] <= deadline

Two paths over the same semantics:

* :func:`violation_report` / :func:`total_violations` — torch, over any
  leading axes: ``start``/``assign`` are ``[*lead, T]`` and the
  instance's own leading axes are a prefix of ``lead`` (see
  :func:`repro_torch.core.instance.aligned`).  They return int32
  violation masses (0 == feasible).
* :func:`check_feasible_np` / :func:`assert_feasible_np` — numpy/Python,
  return human-readable problem strings (a copy of the reference's).

Padded tasks (``task_mask == False``) are ignored by every check.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.instance import PackedInstance, aligned, bcast_lead

_MACHINE_WEIGHT = 10**6  # one disallowed assignment >> any epoch mass


class ViolationReport(NamedTuple):
    """Per-constraint violation masses (int32; all-zero == feasible)."""

    arrival: torch.Tensor     # Eq. 4: epochs started before arrival
    precedence: torch.Tensor  # Eq. 5: epochs a task overlaps a predecessor
    machine: torch.Tensor     # Eq. 6: count of disallowed assignments
    overlap: torch.Tensor     # Eq. 8: overlap epochs on shared machines
    budget: torch.Tensor      # deadline: epochs of completion past it


def task_durations(inst: PackedInstance, assign: torch.Tensor) -> torch.Tensor:
    """dur[..., t, assign[..., t]] -> int32 ``[*lead, T]``."""
    dur = bcast_lead(inst.dur, assign.shape[:-1], 2)
    return torch.gather(dur, -1, assign.long().unsqueeze(-1)).squeeze(-1)


def _masked_sum(cond: torch.Tensor, x: torch.Tensor, dims) -> torch.Tensor:
    """sum(where(cond, max(x, 0), 0)) over ``dims`` as int32.

    Summed in int64 and cast back: the same residue mod 2**32 as the
    reference's int32 sums.
    """
    x = torch.where(cond, x.clamp_min(0), 0)
    return x.sum(dims, dtype=torch.int64).to(torch.int32)


def violation_report(inst: PackedInstance, start: torch.Tensor,
                     assign: torch.Tensor,
                     deadline: torch.Tensor | int | None = None
                     ) -> ViolationReport:
    """Per-constraint violation masses of shape ``start.shape[:-1]``.

    ``deadline`` (optional, epochs) lines up with the leading axes like
    the instance; completions past it count as budget violations.
    """
    lead = tuple(start.shape[:-1])
    T = inst.T
    mask = inst.task_mask
    # Pair masks at the instance's own shape, expanded (as views) after.
    both = mask[..., :, None] & mask[..., None, :]
    dep = bcast_lead(inst.pred & both, lead, 2)
    iu = torch.ones((T, T), dtype=torch.bool, device=start.device).triu(1)
    pairs = bcast_lead(both & iu, lead, 2)
    a = aligned(inst, lead)
    d = task_durations(inst, assign)
    comp = start + d

    # Eq. 4: start >= arrival.
    v_arr = _masked_sum(a.task_mask, a.arrival - start, -1)

    # Eq. 5: for every edge (u -> t): start[t] >= comp[u].
    gap = comp[..., None, :] - start[..., :, None]      # [t, u]
    v_dep = _masked_sum(dep, gap, (-2, -1))

    # Eq. 6: assigned machine must be allowed.
    ok = torch.gather(a.allowed, -1, assign.long().unsqueeze(-1)).squeeze(-1)
    v_mach = (a.task_mask & ~ok).sum(-1, dtype=torch.int64).to(torch.int32)

    # Eq. 8: no-overlap — each unordered pair on one machine once.
    same_m = assign[..., :, None] == assign[..., None, :]
    ov = (torch.minimum(comp[..., :, None], comp[..., None, :])
          - torch.maximum(start[..., :, None], start[..., None, :]))
    v_olap = _masked_sum(same_m & pairs, ov, (-2, -1))

    if deadline is None:
        v_bud = torch.zeros(lead, dtype=torch.int32, device=start.device)
    else:
        dl = torch.as_tensor(deadline, device=start.device).to(torch.int32)
        over = comp - bcast_lead(dl, lead).unsqueeze(-1)
        v_bud = _masked_sum(a.task_mask, over, -1)
    return ViolationReport(v_arr, v_dep, v_mach, v_olap, v_bud)


def total_violations(inst: PackedInstance, start: torch.Tensor,
                     assign: torch.Tensor,
                     deadline: torch.Tensor | int | None = None
                     ) -> torch.Tensor:
    """Violation mass (0 == feasible); machine violations weighted so a
    single disallowed assignment dominates any epoch-mass term."""
    with obs.span("repro_torch.total_violations"):
        r = violation_report(inst, start, assign, deadline)
        return (r.arrival + r.precedence + r.machine * _MACHINE_WEIGHT
                + r.overlap + r.budget)


def total_violations_batch(insts: PackedInstance, start, assign,
                           deadline=None) -> torch.Tensor:
    """Batched feasibility over stacked (padded) instances.

    ``insts`` carries a leading instance axis ``[B, ...]``;
    ``start``/``assign`` are ``[B, *extra, T]``; ``deadline`` (optional)
    lines up with ``[B, *extra]`` from the left.  Returns int32 masses of
    shape ``[B, *extra]``.
    """
    if start.ndim < 2:
        raise ValueError(f"start must be at least [B, T], got "
                         f"{tuple(start.shape)}")
    return total_violations(insts, start, assign, deadline)


# ---------------------------------------------------------------------------
# numpy / Python path — human-readable reports for tests and oracles.
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_feasible_np(inst: PackedInstance, start, assign,
                      deadline: int | None = None) -> list[str]:
    """Python-level feasibility report of one schedule: one string per
    violation, [] if feasible (independent of :func:`violation_report`)."""
    start = _np(start)
    assign = _np(assign)
    dur = _np(inst.dur)
    mask = _np(inst.task_mask)
    pred = _np(inst.pred)
    arr = _np(inst.arrival)
    allowed = _np(inst.allowed)
    probs = []
    T = dur.shape[0]
    comp = start + dur[np.arange(T), assign]
    for t in range(T):
        if not mask[t]:
            continue
        if not allowed[t, assign[t]]:
            probs.append(f"task {t}: machine {assign[t]} not allowed")
        if start[t] < arr[t]:
            probs.append(f"task {t}: starts {start[t]} before arrival {arr[t]}")
        if deadline is not None and comp[t] > deadline:
            probs.append(f"task {t}: ends {comp[t]} past deadline {deadline}")
        for u in range(T):
            if pred[t, u] and mask[u] and start[t] < comp[u]:
                probs.append(f"task {t}: starts {start[t]} before pred {u} ends {comp[u]}")
        for u in range(t + 1, T):
            if mask[u] and assign[u] == assign[t]:
                if max(start[t], start[u]) < min(comp[t], comp[u]):
                    probs.append(f"tasks {t},{u} overlap on machine {assign[t]}")
    return probs


def assert_feasible_np(inst: PackedInstance, start, assign,
                       deadline: int | None = None, ctx: str = "") -> None:
    """Raise ``AssertionError`` with the full problem list if infeasible."""
    probs = check_feasible_np(inst, start, assign, deadline)
    if probs:
        head = f"infeasible schedule{f' ({ctx})' if ctx else ''}:"
        raise AssertionError("\n  ".join([head] + probs))
