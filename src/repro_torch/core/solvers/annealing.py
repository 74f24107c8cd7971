"""Massively-parallel simulated annealing over SGS encodings.

The counterpart of ``repro.core.solvers.annealing``.  ``pop`` Metropolis
chains per instance run in lockstep, and so do all instances of a batch:
the candidates are ``[*instance_lead, pop, T]`` tensors and each
iteration scores all of them in one
:func:`~repro_torch.core.solvers.common.population_fitness` call.  Every
``migrate_every`` iterations the worst quartile of chains is re-seeded
from the instance's best.

Draw order (what a replayed :class:`~repro_torch.core.solvers.common.Draws`
must yield), shapes ``L = instance_lead + (pop,)``: ``normal(L+(T,))`` for
the init, ``gumbel(L+(T,M))`` unless ``assign_init`` is given; then per
iteration ``bernoulli(2/T, L+(T,))``, ``normal(L+(T,))``,
``bernoulli(p_machine_move, L)``, ``randint(0, T, L)``,
``gumbel(L+(T,M))``, ``uniform(L)``, and on a migration iteration
``normal(L+(T,))``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.decoder import take_at, take_row, upward_rank
from repro_torch.core.instance import PackedInstance, bcast_lead
from repro_torch.core.solvers import common


class SAConfig(NamedTuple):
    pop: int = 128
    iters: int = 200
    sweeps: int = 2            # carbon timing sweeps inside the decode
    sigma: float = 3.0         # priority-noise scale (epochs of rank)
    p_machine_move: float = 0.35
    migrate_every: int = 25
    t0_frac: float = 0.3       # initial temperature = frac * fitness IQR
    t_decay: float = 0.97


class SolveOut(NamedTuple):
    prio: torch.Tensor     # best candidate found, [*instance_lead, T]
    assign: torch.Tensor
    fitness: torch.Tensor  # its fitness, [*instance_lead]


def _f32(x: float) -> float:
    return float(np.float32(x))


def solve_sa(inst: PackedInstance, cum: torch.Tensor,
             deadline: torch.Tensor | int, draws: common.Draws,
             objective: str = "carbon", machine_rule: str = "fixed",
             cfg: SAConfig = SAConfig(),
             prio_init: torch.Tensor | None = None,
             assign_init: torch.Tensor | None = None,
             frozen: torch.Tensor | None = None) -> SolveOut:
    """Minimize ``objective`` (see solvers.common) over SGS candidates.

    ``inst`` may be one instance or a batch (``[B, ...]``); ``cum``,
    ``deadline``, ``prio_init``/``assign_init`` (``[*instance_lead, T]``)
    and ``frozen`` line up with it.  ``frozen`` (bool ``[..., T]``) marks
    tasks whose priorities are never perturbed.
    """
    with obs.span("repro_torch.solve_sa"):
        lead = inst.lead
        T, pop = inst.T, cfg.pop
        L = lead + (pop,)
        dev = inst.device
        free = (torch.ones((T,), dtype=torch.bool, device=dev)
                if frozen is None else ~frozen)
        free = bcast_lead(free, lead, 1).unsqueeze(-2)        # [*lead, 1, T]
        sweeps = 0 if objective == "makespan" else cfg.sweeps

        def fit_v(p, a):
            return common.population_fitness(
                inst, cum, deadline, p, a, objective, machine_rule, sweeps,
                frozen=frozen)

        if prio_init is None:
            prio_init = upward_rank(inst)
        prio = (prio_init.unsqueeze(-2)
                + cfg.sigma * draws.normal(L + (T,)) * free)
        # Keep one undisturbed copy of the init (chain 0).
        prio[..., 0, :] = prio_init
        if assign_init is None:
            assign = common.random_allowed_assign(draws, inst, (pop,))
        else:
            assign = assign_init.unsqueeze(-2).expand(L + (T,)) \
                .to(torch.int32).clone()
        fit = fit_v(prio, assign)

        spread = (torch.quantile(fit, 0.75, dim=-1)
                  - torch.quantile(fit, 0.25, dim=-1))
        t0 = cfg.t0_frac * spread.clamp_min(1e-3)

        b0 = fit.argmin(-1)
        best_p, best_a, best_f = (take_row(prio, b0), take_row(assign, b0),
                                  take_at(fit, b0))
        decay = _f32(cfg.t_decay)
        tix = torch.arange(T, device=dev)

        for it in range(cfg.iters):
            # The reference's f32 pow(t_decay, it), correctly rounded.
            temp = t0 * _f32(decay ** it)

            # Priority proposal: gaussian noise on a random ~2-task subset.
            mask = draws.bernoulli(2.0 / T, L + (T,)) & free
            dp = cfg.sigma * draws.normal(L + (T,)) * mask
            new_prio = prio + dp
            # Machine proposal: with prob p, reassign one random task.
            do_m = draws.bernoulli(cfg.p_machine_move, L)
            t_idx = draws.randint(0, T, L).long()
            new_m = common.random_allowed_assign(draws, inst, (pop,))
            picked = take_at(new_m, t_idx)
            new_assign = torch.where(
                (tix == t_idx.unsqueeze(-1)) & do_m.unsqueeze(-1),
                picked.unsqueeze(-1), assign)

            new_fit = fit_v(new_prio, new_assign)
            u = draws.uniform(L)
            accept = (new_fit < fit) | (u < torch.exp(
                -(new_fit - fit) / temp.clamp_min(1e-6).unsqueeze(-1)))
            prio = torch.where(accept.unsqueeze(-1), new_prio, prio)
            assign = torch.where(accept.unsqueeze(-1), new_assign, assign)
            fit = torch.where(accept, new_fit, fit)

            # Track each instance's best.
            i = fit.argmin(-1)
            fi = take_at(fit, i)
            better = fi < best_f
            best_p = torch.where(better.unsqueeze(-1), take_row(prio, i),
                                 best_p)
            best_a = torch.where(better.unsqueeze(-1), take_row(assign, i),
                                 best_a)
            best_f = torch.where(better, fi, best_f)

            # Migration: worst quartile <- best + fresh noise.
            if it % cfg.migrate_every == cfg.migrate_every - 1:
                thresh = torch.quantile(fit, 0.75, dim=-1)
                worst = fit >= thresh.unsqueeze(-1)
                mp = (best_p.unsqueeze(-2)
                      + cfg.sigma * draws.normal(L + (T,)) * free)
                prio = torch.where(worst.unsqueeze(-1), mp, prio)
                assign = torch.where(worst.unsqueeze(-1),
                                     best_a.unsqueeze(-2), assign)
                fit = torch.where(worst, fit_v(prio, assign), fit)
        return SolveOut(best_p, best_a, best_f)
