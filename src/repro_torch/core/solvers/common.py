"""Shared pieces for the population solvers: draws, decoding and fitness.

The counterpart of ``repro.core.solvers.common``.  A candidate is
``(prio[T] float32, assign[T] int32)``.  Decoding = SGS (+ carbon timing
sweep for the carbon/energy objectives); fitness = the objective plus a
penalty proportional to the shared validator's violation mass.  Every
function here takes candidates of shape ``[*instance_lead, Pop, T]`` and
scores all of them at once: one call covers every instance of a batch.

Random draws go through a *draws* object (:class:`TorchDraws` by default,
a ``torch.Generator`` on the device).  The solvers ask it for their
normals, Bernoulli masks, integers, Gumbel noise and uniforms in a fixed
order, so a test can hand them the very arrays another implementation
drew instead.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import torch

from repro_torch.core.decoder import sgs, timing_sweep
from repro_torch.core.instance import PackedInstance, bcast_lead
from repro_torch.core.objectives import (Objectives, energy, evaluate,
                                         makespan, utilization)
from repro_torch.core.validate import total_violations
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops

OBJECTIVES = ("makespan", "carbon", "energy")
VIOLATION_PENALTY = 1e5      # fitness units per unit of validator mass
ENERGY_CARBON_TIEBREAK = 1e-6


class Draws(Protocol):
    """The random draws the solvers make; shapes are full tensor shapes."""

    def normal(self, shape: Sequence[int]) -> torch.Tensor: ...
    def uniform(self, shape: Sequence[int]) -> torch.Tensor: ...
    def bernoulli(self, p: float, shape: Sequence[int]) -> torch.Tensor: ...
    def randint(self, low: int, high: int,
                shape: Sequence[int]) -> torch.Tensor: ...
    def gumbel(self, shape: Sequence[int]) -> torch.Tensor: ...


class TorchDraws:
    """:class:`Draws` from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def bernoulli(self, p, shape):
        return self.uniform(shape) < p

    def randint(self, low, high, shape):
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator, device=self.device)

    def gumbel(self, shape):
        e = torch.empty(tuple(shape), device=self.device)
        return -e.exponential_(generator=self.generator).log()


class HostDraws(TorchDraws):
    """:class:`TorchDraws` from a generator on the CPU, handed over on
    ``device``: one seed gives the same draws on every device, so a solve
    on the card can be held against the same solve on the CPU."""

    def __init__(self, seed: int,
                 device: str | torch.device = DEFAULT_DEVICE):
        super().__init__(seed, "cpu")
        self.target = resolve_device(device)

    def normal(self, shape):
        return super().normal(shape).to(self.target)

    def uniform(self, shape):
        return super().uniform(shape).to(self.target)

    def randint(self, low, high, shape):
        return super().randint(low, high, shape).to(self.target)

    def gumbel(self, shape):
        return super().gumbel(shape).to(self.target)


class ScheduleResult(NamedTuple):
    start: torch.Tensor
    assign: torch.Tensor
    makespan: torch.Tensor
    energy: torch.Tensor
    carbon: torch.Tensor
    utilization: torch.Tensor


def decode_full(inst: PackedInstance, cum: torch.Tensor,
                deadline: torch.Tensor | int, prio: torch.Tensor,
                assign: torch.Tensor, objective: str = "carbon",
                machine_rule: str = "fixed", sweeps: int = 2,
                frozen: torch.Tensor | None = None) -> ScheduleResult:
    """Candidates ``[*lead, T]`` -> feasible schedules + objective values."""
    dec = sgs(inst, prio, assign, machine_rule=machine_rule)
    start = dec.start
    if objective != "makespan" and sweeps > 0:
        start = timing_sweep(inst, start, dec.assign, cum, deadline, sweeps,
                             frozen=frozen)
    obj: Objectives = evaluate(inst, start, dec.assign, cum)
    return ScheduleResult(start, dec.assign, obj.makespan, obj.energy,
                          obj.carbon, utilization(inst, start, dec.assign))


def fitness_of(inst: PackedInstance, res: ScheduleResult,
               deadline: torch.Tensor | int, objective: str) -> torch.Tensor:
    """Objective value + validator-priced infeasibility penalty."""
    if objective == "makespan":
        return res.makespan.to(torch.float32)
    pen = VIOLATION_PENALTY * total_violations(
        inst, res.start, res.assign, deadline).to(torch.float32)
    if objective == "carbon":
        return res.carbon + pen
    if objective == "energy":
        return res.energy + ENERGY_CARBON_TIEBREAK * res.carbon + pen
    raise ValueError(f"unknown objective {objective!r}")


def population_fitness(inst: PackedInstance, cum: torch.Tensor,
                       deadline: torch.Tensor | int, prio: torch.Tensor,
                       assign: torch.Tensor, objective: str,
                       machine_rule: str, sweeps: int,
                       frozen: torch.Tensor | None = None) -> torch.Tensor:
    """Fitness of candidate populations: ``[*instance_lead, Pop, T]`` ->
    ``[*instance_lead, Pop]``.

    The SA/GA hot loop: every proposal, init and migration evaluation goes
    through here.  Decode (SGS + timing sweep) runs on all rows together;
    the carbon trace integral runs once for the whole batch in the
    ``schedule_eval`` kernel
    (:func:`repro_torch.kernels.ops.population_carbon`) on CUDA tensors, in
    its plain version on CPU tensors.  The makespan objective never touches
    the trace.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    with torch.profiler.record_function("repro_torch.population_fitness"):
        dec = sgs(inst, prio, assign, machine_rule=machine_rule)
        if objective == "makespan":
            return makespan(inst, dec.start, dec.assign).to(torch.float32)
        start = dec.start
        if sweeps > 0:
            start = timing_sweep(inst, start, dec.assign, cum, deadline,
                                 sweeps, frozen=frozen)
        carb = ops.population_carbon(inst, start, dec.assign, cum)
        with torch.profiler.record_function("repro_torch.total_violations"):
            pen = VIOLATION_PENALTY * total_violations(
                inst, start, dec.assign, deadline).to(torch.float32)
        if objective == "carbon":
            return carb + pen
        return energy(inst, dec.assign) + ENERGY_CARBON_TIEBREAK * carb + pen


def random_allowed_assign(draws: Draws, inst: PackedInstance,
                          shape: tuple[int, ...] = ()) -> torch.Tensor:
    """Uniform random machine among each task's allowed set, for
    ``inst.lead + shape`` candidates (one Gumbel draw of that shape
    ``+ (T, M)``)."""
    full = inst.lead + tuple(shape)
    g = draws.gumbel(full + (inst.T, inst.M))
    allowed = bcast_lead(inst.allowed, full, 2)
    return torch.where(allowed, g, float("-inf")).argmax(-1).to(torch.int32)
