"""The paper's bi-level protocol (Section 2/3.1), end to end in PyTorch.

The counterpart of ``repro.core.solvers.bilevel``.

Phase 1  — classic FJSP: minimize makespan, carbon-agnostic.  The result is
           both the baseline schedule and the constraint OPT.
Phase 2  — minimize carbon (Def 2.3) or energy (Def 2.2) subject to
           makespan <= floor(S * OPT), warm-started from the phase-1
           schedule (feasible for S >= 1, so savings are never negative).

Where the reference ``vmap``s :func:`solve_bilevel` over instances, the
port runs every instance of a batch in lockstep: one fitness call per
solver step scores all ``B * Pop`` candidates.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from repro_torch import obs
from repro_torch.core.instance import PackedInstance, bcast_lead
from repro_torch.core.solvers import common
from repro_torch.core.solvers.annealing import SAConfig, solve_sa
from repro_torch.core.solvers.genetic import GAConfig, solve_ga

NO_DEADLINE = 1 << 27


class BilevelResult(NamedTuple):
    opt_makespan: torch.Tensor        # phase-1 OPT (epochs)
    deadline: torch.Tensor            # floor(S * OPT)
    baseline: common.ScheduleResult   # carbon-agnostic, makespan-optimal
    optimized: common.ScheduleResult
    carbon_savings: torch.Tensor      # 1 - opt.carbon / baseline.carbon
    energy_savings: torch.Tensor      # 1 - opt.energy / baseline.energy


def solve_bilevel(inst: PackedInstance, cum: torch.Tensor,
                  draws: common.Draws, objective: str = "carbon",
                  stretch: float = 1.0, solver: str = "sa",
                  cfg1: SAConfig | GAConfig | None = None,
                  cfg2: SAConfig | GAConfig | None = None) -> BilevelResult:
    """Both phases for one instance or a batch (``[B, ...]`` instance, cum
    ``[B, H+1]``); phase 1 draws first, then phase 2, from ``draws``."""
    with obs.span("repro_torch.solve_bilevel", B=math.prod(inst.lead),
                  objective=objective, stretch=stretch):
        if solver == "sa":
            solve = solve_sa
            cfg1 = cfg1 or SAConfig()
        elif solver == "ga":
            solve = solve_ga
            cfg1 = cfg1 or GAConfig()
        else:
            raise ValueError(f"unknown solver {solver!r}")
        cfg2 = cfg2 or cfg1
        if objective not in ("carbon", "energy"):
            raise ValueError(f"unknown phase-2 objective {objective!r}")
        sweeps = max(getattr(cfg2, "sweeps", 2), 1)

        # ---- Phase 1: makespan-only (the carbon-agnostic baseline). ------
        with obs.span("repro_torch.phase1"):
            p1 = solve(inst, cum, NO_DEADLINE, draws, objective="makespan",
                       machine_rule="earliest_finish", cfg=cfg1)
            baseline = common.decode_full(
                inst, cum, NO_DEADLINE, p1.prio, p1.assign,
                objective="makespan", machine_rule="earliest_finish",
                sweeps=0)
        opt_ms = baseline.makespan
        deadline = torch.floor(stretch * opt_ms.to(torch.float32) + 1e-6) \
            .to(torch.int32)

        # ---- Phase 2: carbon/energy under makespan <= S * OPT. -----------
        with obs.span("repro_torch.phase2"):
            # Warm start: the baseline's own (sequence, assignment) is
            # feasible.
            warm = -baseline.start.to(torch.float32)
            p2 = solve(inst, cum, deadline, draws, objective=objective,
                       machine_rule="fixed", cfg=cfg2, prio_init=warm,
                       assign_init=baseline.assign)
            optimized = common.decode_full(
                inst, cum, deadline, p2.prio, p2.assign, objective=objective,
                machine_rule="fixed", sweeps=sweeps)

            # Guard: fall back to the timing-swept baseline (feasible by
            # construction) if phase 2 ended worse or past the deadline.
            fallback = common.decode_full(
                inst, cum, deadline, warm, baseline.assign,
                objective=objective, machine_rule="fixed", sweeps=sweeps)
            use_fb = ((getattr(optimized, objective)
                       > getattr(fallback, objective))
                      | (optimized.makespan > deadline))
            optimized = common.ScheduleResult(*(
                torch.where(bcast_lead(use_fb, a.shape), b, a)
                for a, b in zip(optimized, fallback)))

        return BilevelResult(
            opt_makespan=opt_ms,
            deadline=deadline,
            baseline=baseline,
            optimized=optimized,
            carbon_savings=1.0 - optimized.carbon
            / baseline.carbon.clamp_min(1e-9),
            energy_savings=1.0 - optimized.energy
            / baseline.energy.clamp_min(1e-9),
        )


def solve_bilevel_batch(insts: PackedInstance, cums: torch.Tensor,
                        draws: common.Draws, **kw) -> BilevelResult:
    """:func:`solve_bilevel` over a leading instance axis ``[B, ...]``."""
    if not insts.lead:
        raise ValueError("solve_bilevel_batch: instances need a leading "
                         "batch axis (stack_packed)")
    return solve_bilevel(insts, cums, draws, **kw)
