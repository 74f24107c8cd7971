"""The plain reference: it catches planted violations and a wrong carbon
value, its serial SGS and timing sweep are the program's, it scores a
population's candidates as the program's fitness does, and its bfloat16
rounding is torch's."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import gen
from portbench.reference import bilevel as ref

FLEET = {"n_jobs": 4, "k_tasks": 3, "mean_dur": 7.0, "arrival_horizon": 24,
         "powers_kw": [0.25, 0.5, 1.0], "speeds": [1 / 3, 0.5, 1.0]}
H = 160


def _job(seed: int = 5, n: int = 6, stretch: float = 1.5,
         objective: str = "carbon"):
    rng = np.random.default_rng(seed)
    year = gen.synthesize("AU-SA", 30, 2024)
    insts, starts = gen.paper_draw(rng, n, FLEET, year, H)
    intensity, _ = gen.windows(year, starts, H)
    return {"insts": insts, "pad_tasks": 12, "intensity": intensity,
            "stretch": stretch, "objective": objective}


def _feasible(job):
    """A feasible schedule by the reference's own SGS, and what a sound
    program would report of it (as its baseline and optimized)."""
    a = ref.task_arrays(job["insts"], job["pad_tasks"])
    B, T = a["mask"].shape
    assign = np.tile(np.arange(T) % a["dur"].shape[-1], (B, 1))
    start = ref.sgs_fixed(a, -np.arange(T, dtype=np.float64)[None]
                          .repeat(B, 0), assign)
    ms = ref.makespan(a, start, assign)
    cum = ref.cumulative(job["intensity"])
    c = ref.carbon(a, start, assign, cum).astype(np.float32)
    e = ref.energy(a, assign).astype(np.float32)
    out = {"opt_makespan": ms,
           "deadline": np.floor(job["stretch"] * ms + 1e-6).astype(int),
           "base_start": start, "base_assign": assign, "base_carbon": c,
           "base_energy": e, "opt_start": start.copy(),
           "opt_assign": assign.copy(), "opt_carbon": c.copy(),
           "opt_energy": e.copy(), "carbon_savings": np.zeros(B, np.float32),
           "energy_savings": np.zeros(B, np.float32)}
    return a, out


def test_feasible_schedule_passes():
    job = _job()
    _, out = _feasible(job)
    nums = ref.judge_job(job, out, sweeps=2)
    assert nums["violations"] == 0 and nums["opt_mismatch"] == 0
    assert nums["carbon_rel_gap"] < 1e-6 and nums["energy_rel_gap"] < 1e-6
    assert nums["savings_gap"] < 1e-6


def test_planted_precedence_violation():
    job = _job()
    a, out = _feasible(job)
    b, (v, u) = 0, np.argwhere(a["pred"][0])[0]
    out["opt_start"][b, v] = out["opt_start"][b, u]      # before u ends
    assert ref.violations(a, out["opt_start"], out["opt_assign"])[b] > 0
    assert ref.judge_job(job, out, sweeps=2)["violations"] > 0


def test_planted_machine_overlap():
    job = _job()
    a, out = _feasible(job)
    s, m = out["opt_start"][0], out["opt_assign"][0]
    t, u = [i for i in range(len(m)) if m[i] == m[0]][:2]
    s[u] = s[t]                                           # same server
    nums = ref.judge_job(job, out, sweeps=2)
    assert nums["violations"] > 0


def test_planted_deadline_violation():
    job = _job(stretch=1.0)
    a, out = _feasible(job)
    late = np.argmax(out["opt_start"][0] + ref.durations(
        a, out["opt_assign"])[0])
    out["opt_start"][0, late] += 1                        # past S * OPT
    assert ref.judge_job(job, out, sweeps=2)["violations"] > 0


def test_wrong_carbon_value():
    job = _job()
    _, out = _feasible(job)
    out["opt_carbon"][3] *= 1.001
    nums = ref.judge_job(job, out, sweeps=2)
    assert nums["carbon_rel_gap"] == pytest.approx(1e-3, rel=1e-3)


def test_control_reads_far_from_the_float32_values():
    job = _job()
    _, out = _feasible(job)
    ctl = ref.control_out(job, out, sweeps=2)
    nums = ref.judge_job(job, ctl, sweeps=2)
    assert nums["carbon_rel_gap"] > 1e-3


@pytest.mark.parametrize("seed", (1, 2**31 + 3))
def test_sgs_and_sweep_are_the_programs(seed):
    from repro_torch.core.decoder import sgs, timing_sweep
    from repro_torch.core.instance import (Instance, Job, pack,
                                           stack_packed)
    job = _job(seed, n=5)
    a = ref.task_arrays(job["insts"], job["pad_tasks"])
    B, T = a["mask"].shape
    rng = np.random.default_rng(seed)
    prio = rng.normal(size=(B, T)).astype(np.float32)
    assign = rng.integers(0, 3, size=(B, T))
    cum32 = ref.cumulative(job["intensity"], np.float32)
    start = ref.sgs_fixed(a, prio, assign)
    ms = ref.makespan(a, start, assign)
    dl = np.floor(1.5 * ms + 1e-6).astype(np.int64)
    swept = ref.timing_sweep(a, start, assign, cum32, dl, sweeps=2)

    inst = stack_packed([pack(Instance(
        jobs=tuple(Job(j.arrival, j.base_durations, j.edges)
                   for j in i.jobs),
        powers_kw=i.powers_kw, speeds=i.speeds), pad_tasks=T, device="cpu")
        for i in job["insts"]])
    dec = sgs(inst, torch.as_tensor(prio),
              torch.as_tensor(assign, dtype=torch.int32), "fixed")
    np.testing.assert_array_equal(dec.start.numpy(), start)
    got = timing_sweep(inst, dec.start, dec.assign, torch.as_tensor(cum32),
                       torch.as_tensor(dl, dtype=torch.int32), 2)
    np.testing.assert_array_equal(got.numpy(), swept)
    assert (swept != start).any()


def _program_fitness(job, out, objective, pop=5, seed=3):
    """A population's candidates, and the fitness the program's
    ``population_fitness`` gives them on the CPU, as a tapped call."""
    from repro_torch.core.instance import (Instance, Job, pack,
                                           stack_packed)
    from repro_torch.core.solvers.common import population_fitness
    a = ref.task_arrays(job["insts"], job["pad_tasks"])
    B, T = a["mask"].shape
    rng = np.random.default_rng(seed)
    prio = rng.normal(size=(B, pop, T)).astype(np.float32)
    assign = rng.integers(0, a["dur"].shape[-1], size=(B, pop, T)) \
        .astype(np.int32)
    inst = stack_packed([pack(Instance(
        jobs=tuple(Job(j.arrival, j.base_durations, j.edges)
                   for j in i.jobs),
        powers_kw=i.powers_kw, speeds=i.speeds), pad_tasks=T, device="cpu")
        for i in job["insts"]])
    dl = np.floor(job["stretch"] * out["opt_makespan"] + 1e-6)
    value = population_fitness(
        inst, torch.as_tensor(ref.cumulative(job["intensity"], np.float32)),
        torch.as_tensor(dl, dtype=torch.int32), torch.as_tensor(prio),
        torch.as_tensor(assign), objective, "fixed", 2)
    return {"prio": prio, "assign": assign, "objective": objective,
            "machine_rule": "fixed", "sweeps": 2, "frozen": None,
            "value": value.numpy()}


@pytest.mark.parametrize("objective", ("carbon", "energy"))
def test_fitness_is_the_programs(objective):
    job = {**_job(stretch=1.0, objective=objective), "fit_rows": [0, 2, 5]}
    _, out = _feasible(job)
    out["fit"] = _program_fitness(job, out, objective)
    # Some candidates pass the deadline and carry the validator's penalty.
    assert (out["fit"]["value"] >= ref.VIOLATION_PENALTY).any()
    assert ref.judge_job(job, out, sweeps=2)["fitness_rel_gap"] < 1e-6
    wrong = out["fit"]["value"].copy()
    wrong[2, 1] *= 1.001
    nums = ref.judge_job(job, {**out, "fit": {**out["fit"], "value": wrong}},
                         sweeps=2)
    assert nums["fitness_rel_gap"] == pytest.approx(1e-3, rel=1e-2)
    ctl = ref.control_out(job, out, sweeps=2)
    assert ref.judge_job(job, ctl, sweeps=2)["fitness_rel_gap"] > 1e-4


@pytest.mark.parametrize("bad", ("missing", "objective", "rule", "frozen",
                                 "half"))
def test_fitness_not_scored_is_not_passed(bad):
    job = {**_job(), "fit_rows": [1]}
    _, out = _feasible(job)
    fit = _program_fitness(job, out, "carbon")
    fit = {"missing": None,
           "objective": {**fit, "objective": "energy"},
           "rule": {**fit, "machine_rule": "earliest_finish"},
           "frozen": {**fit, "frozen": np.zeros(12, bool)},
           "half": {**fit, **{k: fit[k][:3] for k in
                              ("prio", "assign", "value")}}}[bad]
    out = {**out, "fit": fit} if fit else out
    assert ref.judge_job(job, out, sweeps=2)["fitness_rel_gap"] \
        == float("inf")


def test_bf16_rounds_as_torch():
    x = np.random.default_rng(0).normal(scale=1e3, size=4096) \
        .astype(np.float32)
    want = torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(ref.bf16(x), want)
