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
drew instead.  :class:`RowDraws` keys every draw by its row, so a row
solved alone draws what it draws inside any batch: the property the
sharded solvers (:mod:`repro_torch.shard`) rest on.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Protocol, Sequence

import numpy as np
import torch

from repro_torch import obs
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


M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# Pairs of words a row's draw is laid out in, rounded up to this: the
# float transforms then see every row at a stride of a multiple of 64
# elements, so ATen's vectorised CPU loops treat an element alike at
# every row position (their scalar tail may round a log or cos apart).
_ROW_ALIGN = 64


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: JAX's ``threefry_2x32`` block cipher.

    The key ``(k0, k1)`` and counter ``(x0, x1)`` are 32-bit words held in
    int64 tensors (or ints) that broadcast together; returns the two
    output words, int64 in ``[0, 2**32)``.  Only add, xor and rotate: an
    int64 add of two words cannot overflow, and ``x0`` may carry bits
    above 32 between key injections because the low 32 bits of a sum or
    xor never depend on them (``x1`` is masked before every rotation).
    """
    k2 = k0 ^ k1 ^ _KS_PARITY
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & M32
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & M32
    return x0, x1


def row_seeds(seed: int, rows: int) -> np.ndarray:
    """``rows`` 64-bit row seeds from one integer, uint64 ``[rows]``: the
    counterpart of ``jax.random.split(jax.random.key(seed), rows)``."""
    return np.random.SeedSequence(seed).generate_state(rows, np.uint64)


class RowDraws:
    """:class:`Draws` keyed by row, counter-based (threefry-2x32).

    ``seeds``: one 64-bit seed per row, ``[B]``; every draw's leading axis
    must be those ``B`` rows.  Element ``j`` of row ``b`` in the ``c``-th
    draw depends only on ``(seeds[b], c, j)``: it is word ``j % 2`` of
    threefry under key ``seeds[b]`` at counter ``(c, j // 2)``.  So a row
    draws the same whatever batch it sits in and at whatever position,
    and on every device.  Uniforms are ``(bits >> 8) * 2**-24`` (exact);
    Bernoulli masks and integers come from them in integer or exact float
    arithmetic, so those three and :meth:`bits` are bitwise equal on every
    device.  Normals (Box-Muller over a word pair) and Gumbels
    (``-log(-log u)``, ``u`` from 23 bits on the open interval) are equal
    wherever the device's ``log``/``cos``/``sin`` round alike.
    """

    def __init__(self, seeds, device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        s = np.asarray(seeds, dtype=np.uint64).reshape(-1)
        self.rows = int(s.shape[0])
        hi = (s >> np.uint64(32)).astype(np.int64)
        lo = (s & np.uint64(M32)).astype(np.int64)
        self._k0 = torch.as_tensor(hi, device=self.device)[:, None]
        self._k1 = torch.as_tensor(lo, device=self.device)[:, None]
        self.calls = 0

    def _pairs(self, shape) -> tuple[torch.Tensor, torch.Tensor, int]:
        """This call's two words per pair, ``[B, pairs]`` each (``pairs``
        a multiple of ``_ROW_ALIGN``), and the elements a row needs."""
        shape = tuple(int(d) for d in shape)
        if not shape or shape[0] != self.rows:
            raise ValueError(f"RowDraws: a draw's leading axis must be the "
                             f"{self.rows} rows, got shape {shape}")
        n = math.prod(shape[1:])
        pairs = _ROW_ALIGN * max(1, -(-n // (2 * _ROW_ALIGN)))
        counter = torch.arange(pairs, dtype=torch.int64, device=self.device)
        w0, w1 = threefry2x32(self._k0, self._k1, self.calls, counter)
        self.calls += 1
        return w0, w1, n

    def _rows(self, w0: torch.Tensor, w1: torch.Tensor, n: int,
              shape) -> torch.Tensor:
        """Interleave a pair layout into elements and cut each row to
        ``n``: ``[B, *shape[1:]]``."""
        flat = torch.stack((w0, w1), -1).reshape(self.rows, -1)
        return flat[:, :n].reshape(tuple(shape))

    @staticmethod
    def _unit(w: torch.Tensor) -> torch.Tensor:
        return (w >> 8).to(torch.float32) * 2.0 ** -24

    @staticmethod
    def _open_unit(w: torch.Tensor) -> torch.Tensor:
        """Uniform on (0, 1): ``(2k + 1) * 2**-24`` for 23-bit ``k``."""
        return ((w >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24

    def bits(self, shape) -> torch.Tensor:
        """Raw 32-bit words, int64 ``shape``."""
        w0, w1, n = self._pairs(shape)
        return self._rows(w0, w1, n, shape)

    def uniform(self, shape):
        w0, w1, n = self._pairs(shape)
        return self._rows(self._unit(w0), self._unit(w1), n, shape)

    def bernoulli(self, p, shape):
        return self.uniform(shape) < p

    def randint(self, low, high, shape):
        """``low + floor(u * (high - low))`` in integers, int64."""
        w0, w1, n = self._pairs(shape)
        span = int(high) - int(low)
        pick = [low + (((w >> 8) * span) >> 24) for w in (w0, w1)]
        return self._rows(*pick, n, shape)

    def normal(self, shape):
        """Box-Muller: a pair's two words give its two normals."""
        w0, w1, n = self._pairs(shape)
        r = torch.sqrt(-2.0 * torch.log(self._open_unit(w0)))
        t = self._unit(w1) * (2.0 * math.pi)
        return self._rows(r * torch.cos(t), r * torch.sin(t), n, shape)

    def gumbel(self, shape):
        w0, w1, n = self._pairs(shape)
        g0, g1 = (-torch.log(-torch.log(self._open_unit(w)))
                  for w in (w0, w1))
        return self._rows(g0, g1, n, shape)


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
    with obs.span("repro_torch.decode_full"):
        dec = sgs(inst, prio, assign, machine_rule=machine_rule)
        start = dec.start
        if objective != "makespan" and sweeps > 0:
            start = timing_sweep(inst, start, dec.assign, cum, deadline,
                                 sweeps, frozen=frozen)
        obj: Objectives = evaluate(inst, start, dec.assign, cum)
        return ScheduleResult(start, dec.assign, obj.makespan, obj.energy,
                              obj.carbon, utilization(inst, start,
                                                      dec.assign))


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
    with obs.span("repro_torch.population_fitness", objective=objective,
                  rows=math.prod(prio.shape[:-1])):
        dec = sgs(inst, prio, assign, machine_rule=machine_rule)
        if objective == "makespan":
            return makespan(inst, dec.start, dec.assign).to(torch.float32)
        start = dec.start
        if sweeps > 0:
            start = timing_sweep(inst, start, dec.assign, cum, deadline,
                                 sweeps, frozen=frozen)
        carb = ops.population_carbon(inst, start, dec.assign, cum)
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
