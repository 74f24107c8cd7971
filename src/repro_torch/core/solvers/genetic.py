"""Genetic-algorithm solver over SGS encodings (ablation partner to SA).

The counterpart of ``repro.core.solvers.genetic``: tournament selection,
uniform crossover, mutation and elitism, on ``[*instance_lead, pop, T]``
candidates that advance in lockstep across a batch.

Draw order per generation, shapes ``L = instance_lead + (pop,)``:
``randint(0, pop, instance_lead+(2, pop, tourn))``,
``bernoulli(p_cross, L+(1,))``, ``bernoulli(0.5, L+(T,))``,
``bernoulli(p_mut_prio, L+(1,))``, ``bernoulli(2/T, L+(T,))``,
``normal(L+(T,))``, ``bernoulli(p_mut_mach, L+(1,))``,
``randint(0, T, L+(1,))``, ``gumbel(L+(T,M))`` — after the init's
``normal(L+(T,))`` and, unless ``assign_init`` is given, ``gumbel(L+(T,M))``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.decoder import take_at, take_row, upward_rank
from repro_torch.core.instance import PackedInstance, bcast_lead
from repro_torch.core.solvers import common
from repro_torch.core.solvers.annealing import SolveOut


class GAConfig(NamedTuple):
    pop: int = 128
    gens: int = 120
    sweeps: int = 2
    sigma: float = 3.0
    tourn: int = 4           # tournament size
    p_cross: float = 0.7
    p_mut_prio: float = 0.25
    p_mut_mach: float = 0.25
    elite: int = 4


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :] for ``x`` ``[*lead, pop, T]``, ``idx`` ``[*lead, K]``."""
    return torch.gather(x, -2, idx.unsqueeze(-1).expand(
        *idx.shape, x.shape[-1]))


def solve_ga(inst: PackedInstance, cum: torch.Tensor,
             deadline: torch.Tensor | int, draws: common.Draws,
             objective: str = "carbon", machine_rule: str = "fixed",
             cfg: GAConfig = GAConfig(),
             prio_init: torch.Tensor | None = None,
             assign_init: torch.Tensor | None = None,
             frozen: torch.Tensor | None = None) -> SolveOut:
    """Arguments as :func:`repro_torch.core.solvers.annealing.solve_sa`."""
    lead = inst.lead
    T, pop = inst.T, cfg.pop
    L = lead + (pop,)
    dev = inst.device
    # Frozen tasks keep their exact priorities: init noise and mutations
    # are masked, and crossover mixes identical frozen genes.
    free = (torch.ones((T,), dtype=torch.bool, device=dev)
            if frozen is None else ~frozen)
    free = bcast_lead(free, lead, 1).unsqueeze(-2)
    sweeps = 0 if objective == "makespan" else cfg.sweeps

    def fit_v(p, a):
        return common.population_fitness(
            inst, cum, deadline, p, a, objective, machine_rule, sweeps,
            frozen=frozen)

    base = upward_rank(inst) if prio_init is None else prio_init
    prio = base.unsqueeze(-2) + cfg.sigma * draws.normal(L + (T,)) * free
    prio[..., 0, :] = base
    if assign_init is None:
        assign = common.random_allowed_assign(draws, inst, (pop,))
    else:
        assign = assign_init.unsqueeze(-2).expand(L + (T,)) \
            .to(torch.int32).clone()
    fit = fit_v(prio, assign)
    tix = torch.arange(T, device=dev)
    elite_slots = torch.arange(pop, device=dev) < cfg.elite

    for _ in range(cfg.gens):
        # Tournament selection of two parent pools.
        idx = draws.randint(0, pop, lead + (2, pop, cfg.tourn)).long()
        tf = torch.gather(fit, -1, idx.reshape(lead + (-1,))) \
            .reshape(idx.shape)                           # [*lead, 2, pop, k]
        winners = torch.gather(idx, -1, tf.argmin(-1, keepdim=True)) \
            .squeeze(-1)                                  # [*lead, 2, pop]
        pa, pb = winners[..., 0, :], winners[..., 1, :]

        # Uniform crossover on priorities and machines.
        do_c = draws.bernoulli(cfg.p_cross, L + (1,))
        gene = draws.bernoulli(0.5, L + (T,))
        cross = gene & do_c
        child_p = torch.where(cross, _rows(prio, pb), _rows(prio, pa))
        child_a = torch.where(cross, _rows(assign, pb), _rows(assign, pa))

        # Mutation.
        mut_p = (draws.bernoulli(cfg.p_mut_prio, L + (1,))
                 & draws.bernoulli(2.0 / T, L + (T,)) & free)
        child_p = child_p + mut_p * cfg.sigma * draws.normal(L + (T,))
        mut_m = (draws.bernoulli(cfg.p_mut_mach, L + (1,))
                 & (draws.randint(0, T, L + (1,)) == tix))
        rnd_m = common.random_allowed_assign(draws, inst, (pop,))
        child_a = torch.where(mut_m, rnd_m, child_a)

        child_f = fit_v(child_p, child_a)

        # Elitism: keep the cfg.elite best of the old population.
        order = torch.argsort(fit, dim=-1, stable=True)
        prio = torch.where(elite_slots.unsqueeze(-1), _rows(prio, order),
                           child_p)
        assign = torch.where(elite_slots.unsqueeze(-1), _rows(assign, order),
                             child_a)
        fit = torch.where(elite_slots, torch.gather(fit, -1, order), child_f)
    i = fit.argmin(-1)
    return SolveOut(take_row(prio, i), take_row(assign, i), take_at(fit, i))
