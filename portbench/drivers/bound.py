"""The bound driver: one client computing the bi-level carbon bound of job
after job through ``repro_torch``'s ``solve_bilevel_batch``.

A mix file that names ``"driver": "bound"`` gives:

* ``pool_instances``: instances drawn from the seed and packed in set-up
  (``harness.gen.paper_draw``, the paper batch's draw), a multiple of the
  configuration's ``batch_instances``;
* ``stretch_cycle``, ``objective_cycle``: job ``k``'s stretch ``S`` and
  phase-2 objective are entry ``k mod len`` of each;
* ``trace_job``, ``span_job``: the job a traced run profiles, and the one
  whose host walls it records without the profiler.

The configuration gives the fleet (``instance``), the trace and horizon
(``trace``), the SA budget of both phases (``solver``) and the instances
a job bounds together (``batch_instances``).  Job ``k`` takes pool slice
``k mod (pool / batch)``, and carbon windows of its own, drawn from
``(seed, k)``.

Besides its result, each job hands the reference one phase-2 fitness call
of the population (``population_fitness``): its candidates and the
fitness values the program gave them, taken by a :class:`CallTap` at a
call drawn from ``(seed, k)``, and a sample of its instances, drawn the
same way, on which the reference scores the candidates again.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import gen
from portbench.harness.trace import CallTap
from portbench.reference import bilevel as ref

# The program: nothing else of it is used.
from repro_torch.core.instance import Instance, Job, pack, stack_packed
from repro_torch.core.instance import PackedInstance
from repro_torch.core.solvers import SAConfig, TorchDraws
from repro_torch.core.solvers import solve_bilevel_batch

# The spans of a traced job: the program functions that bound its layers.
SPANS = {
    "repro_torch.solve_bilevel": "repro_torch.core.solvers.bilevel:solve_bilevel",
    "repro_torch.solve_sa": "repro_torch.core.solvers.annealing:solve_sa",
    "repro_torch.population_fitness":
        "repro_torch.core.solvers.common:population_fitness",
    "repro_torch.decode_full": "repro_torch.core.solvers.common:decode_full",
    "repro_torch.sgs": "repro_torch.core.decoder:sgs",
    "repro_torch.timing_sweep": "repro_torch.core.decoder:timing_sweep",
    "repro_torch.population_carbon":
        "repro_torch.kernels.ops:population_carbon",
    "repro_torch.total_violations":
        "repro_torch.core.validate:total_violations",
}

RESULT_FIELDS = ("opt_makespan", "deadline", "carbon_savings",
                 "energy_savings")

FITNESS = "repro_torch.core.solvers.common:population_fitness"
FITNESS_ARGS = ("prio", "assign", "objective", "machine_rule", "sweeps",
                "frozen")
# Instances of a job whose tapped fitness call the reference scores again
# (all of each one's population).
FITNESS_SAMPLE = 8
# The SA budget of the set-up's warm-up solves (a migration on each
# iteration), one solve for each objective of the mix.
WARMUP_ITERS = 2


def _seed(*parts: int) -> int:
    """A 63-bit seed of ``parts``."""
    return int(np.random.SeedSequence(list(parts)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class Bound:
    """Set-up (pool, pack, warm-up) in the constructor; :meth:`run_job`
    for each job of the window."""

    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device):
        self.mix, self.seed, self.device = mix, seed, device
        fleet, trace = cfg["instance"], cfg["trace"]
        self.horizon = trace["horizon"]
        self.pad = fleet["n_jobs"] * fleet["k_tasks"]
        self.solver = SAConfig(**cfg["solver"])
        self.job_n = cfg["batch_instances"]
        self.slices, rest = divmod(mix["pool_instances"], self.job_n)
        if rest or not self.slices:
            raise ValueError(f"pool_instances {mix['pool_instances']} is "
                             f"not a multiple of batch_instances "
                             f"{self.job_n}")
        t = [time.perf_counter()]
        self.year = gen.year_trace(trace)
        insts, _ = gen.paper_draw(np.random.default_rng(seed),
                                  mix["pool_instances"], fleet, self.year,
                                  self.horizon)
        self.insts = insts
        t.append(time.perf_counter())
        packed = stack_packed([pack(_program_instance(i),
                                    pad_tasks=self.pad, device="cpu")
                               for i in insts])
        self.batch = PackedInstance(*(f.to(device) for f in packed))
        t.append(time.perf_counter())
        self._warm_up()
        t.append(time.perf_counter())
        # Seconds of set-up by part, for the run's standard error.
        self.setup_parts = dict(zip(("draw", "pack", "warm-up"),
                                    np.diff(t).round(3).tolist()))

    # -- shapes, for the metric readers ------------------------------------
    def context(self) -> dict:
        return {"B": self.job_n, "Pop": self.solver.pop, "T": self.pad,
                "H": self.horizon}

    def job_plan(self, k: int) -> dict:
        m = self.mix
        return {"stretch": float(m["stretch_cycle"][k % len(
                    m["stretch_cycle"])]),
                "objective": m["objective_cycle"][k % len(
                    m["objective_cycle"])],
                "slice": k % self.slices}

    def _job_inputs(self, k: int) -> dict:
        plan = self.job_plan(k)
        rows = slice(plan["slice"] * self.job_n,
                     (plan["slice"] + 1) * self.job_n)
        starts = gen.window_starts(np.random.default_rng([self.seed, k]),
                                   self.job_n, self.year, self.horizon)
        intensity, cum = gen.windows(self.year, starts, self.horizon)
        draw = np.random.default_rng([self.seed, k, 1])
        return {**plan, "rows": rows, "insts": self.insts[rows],
                "pad_tasks": self.pad, "intensity": intensity, "cum": cum,
                "fit_call": int(draw.integers(0, self.solver.iters)),
                "fit_rows": np.sort(draw.choice(
                    self.job_n, min(FITNESS_SAMPLE, self.job_n),
                    replace=False))}

    def _solve(self, job: dict, cfg: SAConfig, seed: int):
        inst = PackedInstance(*(f[job["rows"]] for f in self.batch))
        cum = torch.as_tensor(job["cum"], device=self.device)
        return solve_bilevel_batch(
            inst, cum, TorchDraws(seed, self.device),
            objective=job["objective"], stretch=job["stretch"],
            cfg1=cfg, cfg2=cfg)

    def _warm_up(self) -> None:
        """Every shape and path a job runs, at a budget of a few
        iterations (migration on each), once for each objective."""
        cfg = self.solver._replace(iters=WARMUP_ITERS, migrate_every=1)
        for obj in dict.fromkeys(self.mix["objective_cycle"]):
            job = {**self._job_inputs(0), "objective": obj}
            self._solve(job, cfg, _seed(self.seed, 1 << 20))

    # -- the window --------------------------------------------------------
    def run_job(self, k: int) -> dict:
        """Job ``k``, to its end: its inputs and the program's results
        (on the host), with its tapped phase-2 fitness call."""
        job = self._job_inputs(k)
        tap = CallTap(FITNESS, job["fit_call"],
                      keep=lambda a: a.get("objective") != "makespan",
                      copy=_copy)
        with tap:
            res = self._solve(job, self.solver, _seed(self.seed, k))
        out = {f: getattr(res, f) for f in RESULT_FIELDS}
        for side, r in (("base", res.baseline), ("opt", res.optimized)):
            for f in ("start", "assign", "carbon", "energy"):
                out[f"{side}_{f}"] = getattr(r, f)
        out = {f: v.cpu().numpy() for f, v in out.items()}
        if tap.value is not None:
            out["fit"] = {**{a: _host(v) for a, v in tap.args.items()},
                          "value": _host(tap.value)}
        del job["cum"]
        return {"job": job, "out": out, "units": self.job_n}

    @staticmethod
    def end_to_end(records: list[dict], window_s: float) -> dict:
        return {"bound_instances_per_s":
                sum(r["units"] for r in records) / window_s}

    def release(self) -> None:
        del self.batch

    def judge(self, record: dict) -> dict:
        """The reference's numbers of one job's record."""
        return ref.judge_job(record["job"], record["out"], self.solver.sweeps)

    aggregate = staticmethod(ref.aggregate)


def _copy(x):
    """A copy of a tapped fitness call's arguments (those the reference
    reads) or value, on the device, that later steps cannot change."""
    if isinstance(x, dict):
        return {a: _copy(x.get(a)) for a in FITNESS_ARGS}
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _program_instance(inst: gen.Instance) -> Instance:
    """The harness's instance as the program's own dataclass."""
    return Instance(
        jobs=tuple(Job(arrival=j.arrival, base_durations=j.base_durations,
                       edges=j.edges) for j in inst.jobs),
        powers_kw=inst.powers_kw, speeds=inst.speeds)
