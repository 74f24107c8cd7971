"""Simulated cluster executor: faults, stragglers, elastic re-solve.

The counterpart of ``repro.cluster.executor``.  Runs a solved schedule
epoch by epoch and exercises the fault-tolerance story the 1000-node
posture requires:

* **Machine failure** — at a configured epoch a machine dies.  Tasks
  running there lose progress since their last checkpoint; the executor
  *re-solves* the remaining DAG from the current epoch on the surviving
  machines (elastic scaling) using the same bi-level carbon solver that
  produced the original plan — the paper's scheduler doubles as the
  recovery planner.
* **Checkpoint/restart** — ML tasks checkpoint every ``ckpt_epochs``; a
  restarted task re-runs only the un-checkpointed suffix.
* **Stragglers** — a task exceeding ``straggler_threshold`` x its expected
  duration is duplicate-issued on the earliest-free machine; the first
  copy to finish wins (speculative execution).

The report compares planned vs. achieved makespan/carbon/energy, so tests
can assert recovery overhead bounds.

The plan and every re-solve run :func:`solve_bilevel` on the executor's
device (on the card, every phase-2 fitness goes through the
``schedule_eval`` kernel); the epoch loop is the reference's host numpy
loop.  Draws: :meth:`ClusterExecutor.plan` draws afresh from a stream
derived from ``seed`` on every call, so it gives the same plan twice (the
reference never splits the plan's key); the re-solves draw from one
advancing stream, also derived from ``seed`` and distinct from the plan's,
so re-solves in later :meth:`~ClusterExecutor.execute` calls draw fresh
noise (the reference splits its key at each).  ``draws``, when given,
replaces both: it is called once per solve with ``"plan"`` or
``"resolve"`` and returns that solve's :class:`Draws`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import validate
from repro_torch.core.instance import EPOCH_HOURS, PackedInstance
from repro_torch.core.solvers.annealing import SAConfig
from repro_torch.core.solvers.bilevel import BilevelResult, solve_bilevel
from repro_torch.core.solvers.common import Draws, TorchDraws
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize

# The reference's fixed solver sizes: a day's plan, and a recovery re-plan.
PLAN_SA = SAConfig(pop=64, iters=60)
RESOLVE_SA = SAConfig(pop=32, iters=40)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    fail_machine: int = -1          # -1: no failure
    fail_epoch: int = 0
    straggle_task: int = -1         # task index that runs slow
    straggle_factor: float = 1.0    # its actual/expected duration ratio


@dataclasses.dataclass
class ExecutionReport:
    planned_makespan: int
    achieved_makespan: int
    planned_carbon: float
    achieved_carbon: float
    achieved_energy: float
    n_resolves: int
    n_restarts: int
    n_speculative: int

    @property
    def recovery_overhead(self) -> float:
        return (self.achieved_makespan / max(self.planned_makespan, 1)) - 1.0


class ClusterExecutor:
    """``inst`` (one packed instance) and ``cum`` (its cumulative carbon
    trace ``[H+1]``) move to ``device``; ``cum`` is rounded to float32
    (the solver's dtype, as at the reference's boundary) and widened to
    float64 for the host simulation.  ``resolve_seconds`` collects each
    re-solve's wall (synchronised), validation included."""

    def __init__(self, inst: PackedInstance, cum, ckpt_epochs: int = 4,
                 straggler_threshold: float = 1.5, stretch: float = 1.5,
                 seed: int = 0,
                 draws: Callable[[str], Draws] | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.inst = PackedInstance(*(f.to(self.device) for f in inst))
        self._host = {f: getattr(inst, f).cpu().numpy()
                      for f in PackedInstance._fields}
        cum32 = torch.as_tensor(cum).to(torch.float32)
        self._cum = cum32.to(self.device)
        self.cum = cum32.cpu().numpy().astype(np.float64)
        self.ckpt_epochs = ckpt_epochs
        self.straggler_threshold = straggler_threshold
        self.stretch = stretch
        plan_ss, resolve_ss = np.random.SeedSequence(seed).spawn(2)
        self._plan_seed = int(plan_ss.generate_state(1)[0])
        self._resolve_draws = TorchDraws(int(resolve_ss.generate_state(1)[0]),
                                         self.device)
        self._draws = draws
        self.resolve_seconds: list[float] = []

    def _solve(self, inst: PackedInstance, kind: str,
               cfg: SAConfig) -> BilevelResult:
        if self._draws is not None:
            draws = self._draws(kind)
        elif kind == "plan":
            draws = TorchDraws(self._plan_seed, self.device)
        else:
            draws = self._resolve_draws
        return solve_bilevel(inst, self._cum, draws, objective="carbon",
                             stretch=self.stretch, cfg1=cfg, cfg2=cfg)

    # -- planning ------------------------------------------------------------
    def plan(self) -> dict:
        opt = self._solve(self.inst, "plan", PLAN_SA).optimized
        return {"start": opt.start.cpu().numpy(),
                "assign": opt.assign.cpu().numpy(),
                "makespan": int(opt.makespan),
                "carbon": float(opt.carbon)}

    # -- simulation ----------------------------------------------------------
    def execute(self, plan: dict, fault: FaultPlan = FaultPlan()
                ) -> ExecutionReport:
        T = self.inst.T
        dur = self._host["dur"]
        power = self._host["power"]
        mask = self._host["task_mask"]
        pred = self._host["pred"]
        arrival = self._host["arrival"]
        M = dur.shape[1]

        start = plan["start"].copy().astype(np.int64)
        assign = plan["assign"].copy().astype(np.int64)
        exp_dur = dur[np.arange(T), assign].astype(np.int64)
        act_dur = exp_dur.copy()
        if fault.straggle_task >= 0:
            act_dur[fault.straggle_task] = int(np.ceil(
                exp_dur[fault.straggle_task] * fault.straggle_factor))

        done = np.zeros(T, bool)
        done[~mask] = True
        progress = np.zeros(T, np.int64)     # epochs completed (checkpointed)
        running: dict[int, tuple[int, int]] = {}   # task -> (machine, since)
        spec_copy: dict[int, tuple[int, int]] = {}  # speculative duplicates
        alive = np.ones(M, bool)
        carbon = 0.0
        energy = 0.0
        n_resolves = n_restarts = n_spec = 0
        t = 0
        horizon = len(self.cum) - 1

        def ready(tk: int) -> bool:
            return (mask[tk] and not done[tk] and tk not in running
                    and arrival[tk] <= t
                    and all(done[u] for u in range(T) if pred[tk, u]))

        while not done[mask].all() and t < horizon - 1:
            # 1. machine failure event
            if fault.fail_machine >= 0 and t == fault.fail_epoch and \
                    alive[fault.fail_machine]:
                alive[fault.fail_machine] = False
                lost = [tk for tk, (m, _) in running.items()
                        if m == fault.fail_machine]
                for tk in lost:
                    del running[tk]
                    # restart from last checkpoint
                    progress[tk] = (progress[tk] // self.ckpt_epochs) \
                        * self.ckpt_epochs
                    n_restarts += 1
                # elastic re-solve of the remaining DAG on survivors
                start, assign = self._resolve(t, done, progress, alive,
                                              assign)
                n_resolves += 1

            # 2. start tasks scheduled for <= t
            for tk in range(T):
                if ready(tk) and start[tk] <= t and alive[assign[tk]] and \
                        not any(m == assign[tk] for m, _ in running.values()):
                    running[tk] = (int(assign[tk]), t)

            # 3. advance one epoch: accrue energy/carbon, progress
            inten = self.cum[min(t + 1, horizon)] - self.cum[min(t, horizon)]
            for tk, (m, _) in list(running.items()):
                energy += power[m] * EPOCH_HOURS
                carbon += power[m] * inten
                progress[tk] += 1
                need = act_dur[tk] if tk not in spec_copy else exp_dur[tk]
                if progress[tk] >= need:
                    done[tk] = True
                    del running[tk]
                    spec_copy.pop(tk, None)
                elif (tk not in spec_copy
                      and progress[tk] > self.straggler_threshold
                      * exp_dur[tk]):
                    free = [mm for mm in range(M) if alive[mm]
                            and mm != m and not any(
                                rm == mm for rm, _ in running.values())]
                    if free:
                        spec_copy[tk] = (free[0], t)   # duplicate-issue
                        act_dur[tk] = progress[tk] + exp_dur[tk] // 2
                        n_spec += 1
            t += 1

        return ExecutionReport(
            planned_makespan=plan["makespan"],
            achieved_makespan=t,
            planned_carbon=plan["carbon"],
            achieved_carbon=float(carbon),
            achieved_energy=float(energy),
            n_resolves=n_resolves, n_restarts=n_restarts,
            n_speculative=n_spec)

    # -- elastic re-solve ------------------------------------------------------
    def _resolve(self, t: int, done: np.ndarray, progress: np.ndarray,
                 alive: np.ndarray, assign: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Re-plan the unfinished tasks from epoch ``t`` on live machines:
        completed work is modeled by shrinking remaining durations; dead
        machines are disallowed.

        The durations are rescaled in float64 numpy and truncated, as the
        reference does; the new instance keeps ``pred``, ``job``,
        ``task_mask`` and ``power`` as they are.  Every re-solve is
        validated in-line on the device (:func:`validate.total_violations`,
        Eqs. 4-8 on the transformed instance) before the executor trusts
        it — a recovery plan that silently violated precedence or placed
        work on a dead machine would corrupt the rest of the simulation.
        """
        synchronize(self.device)
        t0 = time.perf_counter()
        host = self._host
        dur = host["dur"].copy()
        mask = host["task_mask"]
        T = self.inst.T
        rem = np.maximum(
            dur[np.arange(T), assign] - progress, 1)
        scale = rem / np.maximum(dur[np.arange(T), assign], 1)
        dur = np.maximum((dur * scale[:, None]).astype(np.int32), 1)
        dur[done & mask] = 1
        allowed = host["allowed"] & alive[None, :]
        arrival = np.maximum(host["arrival"], t)
        arrival[done & mask] = t
        dev = self.device
        new_inst = self.inst._replace(
            dur=torch.tensor(dur, dtype=torch.int32, device=dev),
            allowed=torch.tensor(allowed, dtype=torch.bool, device=dev),
            arrival=torch.tensor(arrival.astype(np.int32), device=dev))
        opt = self._solve(new_inst, "resolve", RESOLVE_SA).optimized
        v = int(validate.total_violations(new_inst, opt.start, opt.assign))
        if v != 0:
            raise RuntimeError(
                f"elastic re-solve at epoch {t} produced an infeasible "
                f"schedule (violation mass {v}) — refusing to execute it")
        start = opt.start.cpu().numpy().astype(np.int64)
        new_assign = opt.assign.cpu().numpy().astype(np.int64)
        self.resolve_seconds.append(time.perf_counter() - t0)
        return start, new_assign
