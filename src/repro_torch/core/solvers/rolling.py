"""Rolling-horizon (MPC-style) replanning over the batched solvers.

The counterpart of ``repro.core.solvers.rolling``, held against it by
``tests/test_torch_rolling.py``.  The bi-level solver plans once against a
perfect trace.  This module re-plans: at every boundary ``r_k = k * every``
it re-issues the carbon forecast for the remaining horizon
(:func:`repro_torch.forecast.models.issue` at ``t0 = r_k``), freezes every
task that has already *started* under the incumbent plan, and re-runs the
SA search on the rest against the updated forecast: model predictive
control with the paper's phase-2 search as the per-step controller.

Where the reference runs the replans as one ``lax.scan`` and ``vmap``s it
over instances x forecast seeds, the port loops over the replans in
Python (:func:`replan_step` is one of them) and writes the axes out: a
replan's candidates are ``[B, S, Pop, T]`` and each of its SA iterations
scores all of them in one fitness call.

Freezing without changing the SGS decoder
-----------------------------------------
A started task cannot move nor migrate.  Both are enforced by an
*instance transform* plus a *candidate projection*, so the stock SGS/SA
machinery is reused unchanged:

* ``arrival``: frozen tasks get ``arrival = start``, free tasks
  ``arrival = max(arrival, r_k)`` (nothing can start in the past);
* ``allowed``: frozen tasks shrink to the one machine they run on;
* priorities: frozen tasks are projected into a high band
  (``FROZEN_BAND - start``) so SGS places them first, in executed-start
  order, which reproduces the executed prefix exactly;
* the timing sweep gets the ``frozen`` mask and never shifts a frozen
  task.

Every replan keeps the incumbent plan as a warm start *and* as a
fallback, so the planned carbon under the current forecast never rises
across a replan; with a perfect forecast (``scale = 0``) realized carbon
can only improve on the day-ahead plan.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.instance import EPOCH_HOURS, PackedInstance, aligned, \
    bcast_lead
from repro_torch.core.objectives import evaluate, utilization
from repro_torch.core.solvers import common
from repro_torch.core.solvers.annealing import SAConfig, solve_sa
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.forecast import models as fmodels

NO_DEADLINE = 1 << 27

# Frozen tasks live this far above any free candidate priority (free prios
# are clamped to FREE_CEIL), so SGS always places the executed prefix
# first, in executed-start order.  Both bounds are small powers of two:
# every integer in [FROZEN_BAND - 2^20, FROZEN_BAND] is exactly
# representable in float32, so ``FROZEN_BAND - start`` keeps *distinct*
# priorities for distinct starts (a 1e9-style band would collapse them,
# ulp(1e9) = 64, and place frozen tasks in index order).
FROZEN_BAND = float(2 ** 21)
FREE_CEIL = float(2 ** 19)


class MPCConfig(NamedTuple):
    """Knobs of the rolling replanner (the reference's defaults)."""

    every: int = 48                  # replan interval (epochs)
    n_replans: int = 4               # boundaries 0, every, ..., (n-1)*every
    stretch: float = 1.5             # deadline = floor(stretch * OPT)
    model: str = "oracle_ar1"        # forecast model (forecast.models)
    rho: float = fmodels.AR1_RHO
    sa: SAConfig = SAConfig(pop=32, iters=40, sweeps=1)       # per replan
    sa_phase1: SAConfig = SAConfig(pop=48, iters=80)          # OPT makespan


class MPCResult(NamedTuple):
    """Leading axes ``[B, S]`` from :func:`solve_mpc_batch`, none from
    :func:`solve_mpc`."""

    start: torch.Tensor            # int32 [T] final executed plan
    assign: torch.Tensor           # int32 [T]
    opt_makespan: torch.Tensor     # phase-1 OPT (epochs)
    deadline: torch.Tensor         # floor(stretch * OPT)
    baseline: common.ScheduleResult   # carbon-agnostic plan, true-trace eval
    realized: common.ScheduleResult   # final plan evaluated on the true trace
    plans_start: torch.Tensor      # int32 [K, T] incumbent after each replan
    plans_assign: torch.Tensor     # int32 [K, T]
    frozen_counts: torch.Tensor    # int32 [K] tasks frozen at each boundary
    planned_carbon: torch.Tensor   # float32 [K] plan's carbon under its forecast


class SeedShared:
    """:class:`~repro_torch.core.solvers.common.Draws` for candidates
    ``[*inst_lead, *seed_lead, ...]`` whose draws are shared across the
    seed axes: each draw is made at ``[*inst_lead, 1, ..., 1, ...]`` and
    expanded, so forecast seeds differ only in their forecasts (the
    reference's per-instance search keys)."""

    def __init__(self, draws: common.Draws, inst_lead: Sequence[int],
                 seed_lead: Sequence[int]):
        self.draws = draws
        self.n_inst = len(inst_lead)
        self.n_seed = len(seed_lead)

    def _small(self, shape) -> tuple[int, ...]:
        shape = tuple(shape)
        i, j = self.n_inst, self.n_inst + self.n_seed
        return shape[:i] + (1,) * self.n_seed + shape[j:]

    def normal(self, shape):
        return self.draws.normal(self._small(shape)).expand(tuple(shape))

    def uniform(self, shape):
        return self.draws.uniform(self._small(shape)).expand(tuple(shape))

    def bernoulli(self, p, shape):
        return self.draws.bernoulli(p, self._small(shape)) \
            .expand(tuple(shape))

    def randint(self, low, high, shape):
        return self.draws.randint(low, high, self._small(shape)) \
            .expand(tuple(shape))

    def gumbel(self, shape):
        return self.draws.gumbel(self._small(shape)).expand(tuple(shape))


def forecast_cum(point: torch.Tensor) -> torch.Tensor:
    """Cumulative carbon-energy of a (forecast) intensity ``[..., E]``;
    float32 ``[..., E+1]``.

    The float32 prefix sum cannot equal the reference's bit for bit: XLA's
    ``cumsum`` associates in its own order, which no torch scan reproduces.
    """
    point = point.to(torch.float32)
    zero = torch.zeros(point.shape[:-1] + (1,), dtype=torch.float32,
                       device=point.device)
    return torch.cat([zero, torch.cumsum(point * EPOCH_HOURS, dim=-1)], -1)


def _project(prio, assign, frozen, start_inc, assign_inc):
    """Clamp a candidate onto the frozen prefix (see module docstring)."""
    prio = prio.clamp_max(FREE_CEIL)
    prio = torch.where(frozen, FROZEN_BAND - start_inc.to(torch.float32),
                       prio)
    assign = torch.where(frozen, assign_inc, assign).to(torch.int32)
    return prio, assign


def _frozen_instance(inst: PackedInstance, frozen: torch.Tensor,
                     start: torch.Tensor, assign: torch.Tensor,
                     r) -> PackedInstance:
    """Pin frozen tasks at (start, machine); bar free tasks from the past.

    ``frozen``/``start``/``assign`` are ``[*lead, T]`` with the instance's
    own leading axes a prefix of ``lead``; the result has ``lead``.
    """
    a = aligned(inst, frozen.shape[:-1])
    onehot = (torch.arange(inst.M, dtype=torch.int32, device=start.device)
              == assign[..., None])
    allowed = torch.where(frozen[..., None], onehot, a.allowed)
    arrival = torch.where(frozen, start,
                          a.arrival.clamp_min(r)).to(torch.int32)
    return a._replace(allowed=allowed, arrival=arrival)


def replan_step(inst: PackedInstance, start: torch.Tensor,
                assign: torch.Tensor, r: int, cum_k: torch.Tensor,
                draws: common.Draws, deadline: torch.Tensor,
                objective: str = "carbon", cfg: MPCConfig = MPCConfig()
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One replan at boundary ``r`` against the forecast ``cum_k``.

    ``inst`` has leading axes ``L``; the incumbent ``start``/``assign``
    and ``cum_k`` (``[*lead, E+1]``) have ``lead``, of which ``L`` is a
    prefix; ``deadline`` broadcasts from ``L``.  The SA search draws from
    ``draws`` at ``lead``.  Returns the new incumbent ``(start, assign)``,
    the count of frozen tasks and the plan's carbon under ``cum_k``.
    """
    sweeps = max(cfg.sa.sweeps, 1)
    lead = tuple(start.shape[:-1])
    frozen = bcast_lead(inst.task_mask, lead, 1) & (start < r)
    inst_k = _frozen_instance(inst, frozen, start, assign, r)

    prio0, assign0 = _project(-start.to(torch.float32), assign, frozen,
                              start, assign)
    out = solve_sa(inst_k, cum_k, deadline, draws, objective=objective,
                   machine_rule="fixed", cfg=cfg.sa, prio_init=prio0,
                   assign_init=assign0, frozen=frozen)
    prio_f, assign_f = _project(out.prio, out.assign, frozen, start, assign)
    cand = common.decode_full(inst_k, cum_k, deadline, prio_f, assign_f,
                              objective=objective, machine_rule="fixed",
                              sweeps=sweeps, frozen=frozen)
    inc = common.decode_full(inst_k, cum_k, deadline, prio0, assign0,
                             objective=objective, machine_rule="fixed",
                             sweeps=sweeps, frozen=frozen)
    # Keep whichever plan the *current* forecast scores better (the
    # incumbent decode is feasible by construction).
    better = (common.fitness_of(inst_k, cand, deadline, objective)
              < common.fitness_of(inst_k, inc, deadline, objective))
    b = better[..., None]
    return (torch.where(b, cand.start, inc.start),
            torch.where(b, cand.assign, inc.assign),
            frozen.sum(-1, dtype=torch.int32),
            torch.where(better, cand.carbon, inc.carbon))


def _solve(inst: PackedInstance, truth: torch.Tensor, cum_true: torch.Tensor,
           draws: common.Draws, xi: torch.Tensor | None, scale,
           objective: str, cfg: MPCConfig) -> MPCResult:
    """Instances with leading axes ``L`` (``inst``, ``truth [*L, E]``,
    ``cum_true [*L, E+1]``) x forecast seeds ``S`` (``xi [*S, K, E]``)."""
    L = inst.lead
    S = tuple(xi.shape[:-2]) if xi is not None else ()
    LS = L + S
    E = truth.shape[-1]

    # ---- Phase 1: carbon-agnostic OPT fixes the deadline and the initial
    # incumbent.  It does not depend on the forecast, so it runs once per
    # instance, before the seed axes.
    p1 = solve_sa(inst, cum_true, NO_DEADLINE, draws, objective="makespan",
                  machine_rule="earliest_finish", cfg=cfg.sa_phase1)
    baseline = common.decode_full(
        inst, cum_true, NO_DEADLINE, p1.prio, p1.assign,
        objective="makespan", machine_rule="earliest_finish", sweeps=0)
    opt_ms = baseline.makespan
    deadline = torch.floor(cfg.stretch * opt_ms.to(torch.float32) + 1e-6) \
        .to(torch.int32)

    search = SeedShared(draws, L, S) if S else draws
    truth_s = truth.reshape(L + (1,) * len(S) + (E,))
    start = bcast_lead(baseline.start, LS, 1)
    assign = bcast_lead(baseline.assign, LS, 1)
    plans_s, plans_a, frozen_counts, planned = [], [], [], []
    for k in range(cfg.n_replans):
        r = k * cfg.every
        fc = fmodels.issue(truth_s, r,
                           None if xi is None else xi[..., k, :],
                           model=cfg.model, scale=scale, rho=cfg.rho)
        cum_k = bcast_lead(forecast_cum(fc.point), LS, 1)
        start, assign, n_frozen, plan_c = replan_step(
            inst, start, assign, r, cum_k, search, deadline, objective, cfg)
        plans_s.append(start)
        plans_a.append(assign)
        frozen_counts.append(n_frozen)
        planned.append(plan_c)

    obj = evaluate(inst, start, assign, cum_true)
    realized = common.ScheduleResult(
        start, assign, obj.makespan, obj.energy, obj.carbon,
        utilization(inst, start, assign))
    return MPCResult(
        start=start, assign=assign,
        opt_makespan=bcast_lead(opt_ms, LS),
        deadline=bcast_lead(deadline, LS),
        baseline=common.ScheduleResult(*(
            bcast_lead(x, LS, x.ndim - len(L)) for x in baseline)),
        realized=realized,
        plans_start=torch.stack(plans_s, -2),
        plans_assign=torch.stack(plans_a, -2),
        frozen_counts=torch.stack(frozen_counts, -1),
        planned_carbon=torch.stack(planned, -1))


def _on(dev, *xs):
    return [None if x is None else torch.as_tensor(x).to(dev) for x in xs]


def solve_mpc(inst: PackedInstance, truth, cum_true, draws: common.Draws,
              xi, scale, objective: str = "carbon",
              cfg: MPCConfig = MPCConfig(),
              device: str | torch.device = DEFAULT_DEVICE) -> MPCResult:
    """Rolling-horizon replanning of one instance, on ``device``.

    ``truth``: realized intensity ``[E]``, the forecasts' ground truth.
    ``cum_true``: cumulative carbon-energy ``[E+1]`` for the *realized*
    evaluation.  ``xi`` ``[K, E]``: the forecast's standard-normal draws,
    row ``k`` for replan ``k`` (``K >= cfg.n_replans``).  ``draws`` feeds
    the searches: phase 1, then each replan's SA in turn.
    """
    dev = resolve_device(device)
    inst = PackedInstance(*(f.to(dev) for f in inst))
    truth, cum_true, xi = _on(dev, truth, cum_true, xi)
    return _solve(inst, truth, cum_true, draws, xi, scale, objective, cfg)


def solve_mpc_batch(insts: PackedInstance, truths, cums_true,
                    draws: common.Draws, xi, scale,
                    objective: str = "carbon", cfg: MPCConfig = MPCConfig(),
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> MPCResult:
    """:func:`solve_mpc` over ``[B]`` instances x ``[S]`` forecast seeds,
    on ``device``.

    ``insts``/``truths``/``cums_true``: leading ``[B]``; ``xi``
    ``[S, K, E]``, shared across instances; ``scale`` shared.  The search
    draws are per instance and shared across the seeds (drawn at
    ``[B, 1, ...]`` and expanded), so seed-to-seed differences come only
    from the forecast, as in the reference.  Result axes ``[B, S, ...]``.
    """
    if len(insts.lead) != 1:
        raise ValueError("solve_mpc_batch: instances need one leading "
                         f"batch axis, got {insts.lead}")
    if xi is None or xi.ndim != 3:
        raise ValueError("solve_mpc_batch: xi must be [S, K, E]")
    dev = resolve_device(device)
    insts = PackedInstance(*(f.to(dev) for f in insts))
    truths, cums_true, xi = _on(dev, truths, cums_true, xi)
    return _solve(insts, truths.to(torch.float32), cums_true, draws, xi,
                  scale, objective, cfg)
