"""Schedule-generation-scheme (SGS) decoders.

The counterpart of ``repro.core.decoder``.  A candidate is a priority
vector ``prio[T]`` plus, optionally, a machine assignment ``assign[T]``.
:func:`sgs` turns candidates into feasible schedules; :func:`timing_sweep`
then shifts tasks later inside their slack windows to chase low-carbon
periods.  Where the reference runs a ``lax.scan`` over tasks per candidate
under ``vmap``, these functions loop over the T task steps in Python and
advance every candidate row ``[*lead]`` (e.g. ``[B, Pop]``) together; on
CUDA tensors the timing sweep is instead one launch of a hand-written
kernel that runs every step of every row.

Exactness against the reference: the first-index tie rule of
``argmax``/``argmin`` holds in torch too, and the sweep order uses a
stable sort, so equal inputs give equal integer schedules.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.instance import PackedInstance, aligned, bcast_lead
from repro_torch.core.objectives import task_durations
from repro_torch.kernels import timing_sweep as sweep_kernel

BIG = 1 << 28

MACHINE_RULES = ("fixed", "earliest_finish", "min_energy")


class DecodedSchedule(NamedTuple):
    start: torch.Tensor    # int32 [*lead, T]
    assign: torch.Tensor   # int32 [*lead, T]
    seq_key: torch.Tensor  # int32 [*lead, T] placement order


def take_at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[..., i] for a per-row index ``i`` of shape ``x.shape[:-1]``."""
    return torch.gather(x, -1, i.unsqueeze(-1)).squeeze(-1)


def take_row(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x[..., t, :] for ``x`` ``[*lead, T, K]`` and ``t`` ``[*lead]``."""
    idx = t[..., None, None].expand(*t.shape, 1, x.shape[-1])
    return torch.gather(x, -2, idx).squeeze(-2)


def take_col(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x[..., :, t] for ``x`` ``[*lead, K, T]`` and ``t`` ``[*lead]``."""
    idx = t[..., None, None].expand(*t.shape, x.shape[-2], 1)
    return torch.gather(x, -1, idx).squeeze(-1)


def _put(x: torch.Tensor, i: torch.Tensor, v) -> None:
    """In place: x[..., i] = v."""
    if isinstance(v, torch.Tensor):
        x.scatter_(-1, i.unsqueeze(-1), v.unsqueeze(-1).to(x.dtype))
    else:
        x.scatter_(-1, i.unsqueeze(-1), v)


def sgs(inst: PackedInstance, prio: torch.Tensor,
        assign: torch.Tensor | None = None,
        machine_rule: str = "earliest_finish") -> DecodedSchedule:
    """Serial SGS: place the highest-priority *ready* task at its earliest
    feasible start, T times.  ``prio`` is ``[*lead, T]`` float32.

    machine_rule:
      * ``"fixed"``           — use ``assign`` verbatim (must be allowed).
      * ``"earliest_finish"`` — greedy: machine minimizing completion time.
      * ``"min_energy"``      — greedy: machine minimizing P_m * p_{t,m},
                                finish time as tie-break.

    Readiness is tracked as a count of unscheduled predecessors per task,
    decremented as tasks are placed — the same set as the reference's
    ``any(pred & ~scheduled)`` without its ``[T, T]`` pass per step.
    """
    if machine_rule not in MACHINE_RULES:
        raise ValueError(f"unknown machine_rule {machine_rule!r}")
    with obs.span("repro_torch.sgs", steps=inst.T, rule=machine_rule):
        lead = tuple(prio.shape[:-1])
        T, M = inst.T, inst.M
        dev = prio.device
        pred_real = inst.pred & inst.task_mask[..., None, :]
        remaining = bcast_lead(pred_real.sum(-1, dtype=torch.int32),
                               lead, 1).clone()
        pred_real = bcast_lead(pred_real, lead, 2)
        a = aligned(inst, lead)
        if assign is None:
            assign = torch.zeros(lead + (T,), dtype=torch.int32, device=dev)

        scheduled = torch.zeros(lead + (T,), dtype=torch.bool, device=dev)
        comp = torch.zeros(lead + (T,), dtype=torch.int32, device=dev)
        mfree = torch.zeros(lead + (M,), dtype=torch.int32, device=dev)
        start = torch.zeros_like(comp)
        aout = torch.zeros_like(comp)
        seq = torch.zeros_like(comp)
        for i in range(T):
            ready = ~scheduled & (remaining == 0)
            t = torch.where(ready, prio, float("-inf")).argmax(-1)
            pred_comp = torch.where(take_row(pred_real, t), comp,
                                    0).amax(-1)
            base = torch.maximum(take_at(a.arrival, t), pred_comp)
            est_m = torch.maximum(base.unsqueeze(-1), mfree)   # [*lead, M]
            dur_t = take_row(a.dur, t)                           # [*lead, M]
            fin_m = est_m + dur_t
            ok = take_row(a.allowed, t)
            if machine_rule == "fixed":
                m = take_at(assign, t).long()
            elif machine_rule == "earliest_finish":
                m = torch.where(ok, fin_m, BIG).argmin(-1)
            else:  # min_energy
                cost = a.power * dur_t.to(torch.float32)
                key = torch.where(ok, cost * 65536.0
                                  + fin_m.to(torch.float32), 3e38)
                m = key.argmin(-1)
            s = take_at(est_m, m)
            c = s + take_at(dur_t, m)
            _put(scheduled, t, True)
            _put(comp, t, c)
            _put(mfree, m, torch.maximum(take_at(mfree, m), c))
            _put(start, t, s)
            _put(aout, t, m)
            _put(seq, t, i)
            remaining -= take_col(pred_real, t).to(torch.int32)
        return DecodedSchedule(start, aout, seq)


def timing_sweep(inst: PackedInstance, start: torch.Tensor,
                 assign: torch.Tensor, cum: torch.Tensor,
                 deadline: torch.Tensor | int, sweeps: int = 2,
                 frozen: torch.Tensor | None = None) -> torch.Tensor:
    """Carbon-greedy timing pass; returns the new starts ``[*lead, T]``.

    Keeps sequencing (per-machine order and DAG order) fixed and pushes each
    task *later* into its slack window to the start minimizing its own
    emissions ``cum[s+d] - cum[s]``, never exceeding ``deadline``.  Tasks
    are taken in descending start order, so each task's successors are
    final before it moves and a sweep preserves feasibility.

    ``frozen`` (optional bool ``[*instance_lead, T]``) pins tasks in place.
    On CUDA tensors one launch of the ``timing_sweep`` kernel
    (:mod:`repro_torch.kernels.timing_sweep`) runs every sweep of every
    row, scanning only each task's slack window; on CPU tensors the plain
    version :func:`timing_sweep_plain` runs; on ``meta`` tensors the
    output's shape and dtype come back.  The starts are equal bit for bit.
    """
    with obs.span("repro_torch.timing_sweep", steps=sweeps * inst.T):
        if start.device.type == "cpu":
            return timing_sweep_plain(inst, start, assign, cum, deadline,
                                      sweeps, frozen)
        return sweep_kernel.timing_sweep(inst, start, assign, cum, deadline,
                                         sweeps, frozen)


def timing_sweep_plain(inst: PackedInstance, start: torch.Tensor,
                       assign: torch.Tensor, cum: torch.Tensor,
                       deadline: torch.Tensor | int, sweeps: int = 2,
                       frozen: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`timing_sweep`'s plain version, on any device: ``T x sweeps``
    steps, each scoring every start ``s`` in ``[0, H]`` for every row — a
    ``[*lead, H+1]`` pass, as in the reference."""
    lead = tuple(start.shape[:-1])
    T = inst.T
    H = cum.shape[-1] - 1
    dev = start.device
    a = aligned(inst, lead)
    d = task_durations(inst, assign)
    real = a.task_mask
    sweepable = real if frozen is None else \
        real & ~bcast_lead(frozen, lead, 1)
    svec = torch.arange(H + 1, device=dev)
    same_m = ((assign[..., :, None] == assign[..., None, :])
              & real[..., None, :])
    succ = bcast_lead(inst.pred.transpose(-1, -2)
                      & inst.task_mask[..., None, :], lead, 2)
    c = bcast_lead(cum, lead, 1)
    dl = bcast_lead(torch.as_tensor(deadline, device=dev)
                    .to(torch.int32), lead)
    tix = torch.arange(T, dtype=torch.int32, device=dev)

    for _ in range(sweeps):
        # Freeze the sequence key for this sweep: (start, idx) descending.
        key = start * T + tix
        order = torch.argsort(-torch.where(real, key, -BIG), dim=-1,
                              stable=True)                  # pads last
        start = start.clone()
        for j in range(T):
            t = order[..., j]
            dt = take_at(d, t)
            succ_cap = torch.where(take_row(succ, t), start,
                                   BIG).amin(-1)
            after = (take_row(same_m, t)
                     & (key > take_at(key, t).unsqueeze(-1)))
            mnext_cap = torch.where(after, start, BIG).amin(-1)
            hi = torch.minimum(torch.minimum(succ_cap, mnext_cap), dl) - dt
            lo = take_at(start, t)
            idx = (svec + dt.unsqueeze(-1)).clamp_max(H)
            cost = torch.gather(c, -1, idx) - c
            window = ((svec >= lo.unsqueeze(-1))
                      & (svec <= hi.unsqueeze(-1)))
            s_star = torch.where(window, cost, float("inf")).argmin(-1)
            movable = take_at(sweepable, t) & (hi >= lo)
            _put(start, t,
                 torch.where(movable, s_star.to(torch.int32), lo))
    return start


def upward_rank(inst: PackedInstance) -> torch.Tensor:
    """HEFT-style upward rank: mean duration + longest path to a sink.

    Used as the priority initialization (critical-path-first).  Tasks are
    topologically indexed, so one reverse pass suffices.  Returns float32
    ``[*instance_lead, T]``.
    """
    T = inst.T
    mdur = (torch.where(inst.allowed, inst.dur, 0).sum(-1).to(torch.float32)
            / inst.allowed.sum(-1).clamp_min(1).to(torch.float32))
    succ = inst.pred.transpose(-1, -2) & inst.task_mask[..., None, :]
    rank = torch.zeros(inst.lead + (T,), dtype=torch.float32,
                       device=inst.device)
    for t in range(T - 1, -1, -1):
        best_succ = torch.where(succ[..., t, :], rank, 0.0).amax(-1)
        rank[..., t] = mdur[..., t] + best_succ
    return torch.where(inst.task_mask, rank, -1e9)
