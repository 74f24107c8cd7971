"""The paper benchmark on the port: Figs. 4-7, Tables 1a/1b, and online.

The counterpart of ``benchmarks/common.py``'s ``run_batch``/``summarize``
and of the per-figure modules beside it.  Each paper cell solves a batch
of paper instances with the bi-level protocol (phase 1 optimal makespan,
phase 2 carbon/energy under ``makespan <= S x OPT``); the ``online`` cell
(``benchmarks/online_vs_offline.py``) sweeps the online carbon-gated
dispatcher over a gate-policy grid and sets it beside the S=1.5 bound.
The ``forecast`` cell (``benchmarks/forecast_robustness.py``) sets the
day-ahead gate, the rolling re-quantile gate and the MPC replanner under
forecast error beside the perfect gate and the offline bound; the
``structure`` cell (``benchmarks/structure_sweep.py``) sweeps DAG family x
size x server count x fleet; the ``learned_gate`` cell
(``benchmarks/learned_gate.py``) learns the gate's theta per structure
cell and stretch by gradient and sets it beside the fixed grid; the
``stream`` cell
(``benchmarks/stream_serve.py``) streams arriving DAG jobs through the
lane-pool engine at calibrated loads, in both fleet modes; the
``cluster`` cell runs the reference's flagship scenario
(``examples/cluster_sim.py``): a day of ML batch jobs planned by the
bi-level carbon solver, then executed clean, through a machine failure
(elastic re-solve) and with a straggler (speculative copy).  The same
seeds give the same instances and carbon windows as the reference's
harness.

    python -m repro_torch.bench --only fig5 --instances 1000 [--device cuda]
    python -m repro_torch.bench --only online --instances 1000
    python -m repro_torch.bench --only forecast,structure
    python -m repro_torch.bench --only stream        # FULL, both fleet modes
    python -m repro_torch.bench --only learned_gate  # FULL, 150 steps
    python -m repro_torch.bench --only cluster       # 8 days, seeds 3-10
    python -m repro_torch.bench --only structure,learned_gate --devices 2

``--devices N`` / ``--processes P`` shard the structure and learned_gate
cells over the instance axis (:mod:`repro_torch.shard`): N cards (with
``--device cpu``, N shards on the CPU), per process in a fleet of P
processes that each run this command under the ``REPRO_*`` env
(``python -m tests.harness --processes P --devices 1 -- python -m
repro_torch.bench ...`` spawns them).  The numbers do not change.

Prints one row per result and writes ``experiments/torch_bench/<cell>.csv``,
each row stamped with the device name, its power limit and the torch and
CUDA versions.  Wall time is taken with ``torch.cuda.synchronize()``
inside the timed window.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.cluster.executor import ClusterExecutor, FaultPlan
from repro_torch.cluster.workloads import (make_cluster_instance,
                                           sample_daily_batch)
from repro_torch.core.carbon import sample_window, synthesize
from repro_torch.core.instance import (Instance, PackedInstance,
                                       generate_instance, pack, stack_packed)
from repro_torch.core.objectives import evaluate, makespan
from repro_torch.core.solvers import SAConfig, TorchDraws, solve_bilevel_batch
from repro_torch.core.solvers.online_torch import (dirty_mask,
                                                   online_greedy_torch,
                                                   policy_grid,
                                                   simulate_online,
                                                   sweep_policies)
from repro_torch.core.solvers.rolling import MPCConfig, solve_mpc_batch
from repro_torch.core.validate import assert_feasible_np, total_violations
from repro_torch.device import (DEFAULT_DEVICE, Stages, resolve_device,
                                synchronize)
from repro_torch.forecast import (day_ahead_dirty_mask, n_replans,
                                  rolling_dirty_mask)
from repro_torch.learn import LearnConfig, evaluate_theta, train_gate
from repro_torch.scenarios import (ScenarioConfig, SweepSpec, build_fleet,
                                   learned_summary, pack_aligned,
                                   sample_batch, sample_job,
                                   structure_cells, sweep_structure,
                                   trend_summary)
from repro_torch import shard
from repro_torch.shard.batch import call_devices
from repro_torch.stream import StreamConfig, simulate_stream

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         ".."))
OUT_DIR = os.path.join(REPO_ROOT, "experiments", "torch_bench")

# Solver budget per phase (the reference harness's).
SA_FAST = SAConfig(pop=96, iters=150, sweeps=2)

DEF_HORIZON = 1500     # epochs of carbon trace per instance window


@dataclasses.dataclass(frozen=True)
class BenchSetup:
    n_jobs: int = 10
    k_tasks: int = 4
    n_machines: int = 5
    heterogeneous: bool = False
    region: str = "AU-SA"
    stretch: float = 1.0
    objective: str = "carbon"
    instances: int = 24
    seed: int = 2024


def power_limit(device: torch.device) -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or "n/a"."""
    if device.type != "cuda":
        return "n/a"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "n/a"
    return out.stdout.strip()


def device_stamp(device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Device name, power limit and torch/CUDA versions for every result."""
    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"device": name, "power_limit": power_limit(dev),
            "torch": torch.__version__, "cuda": torch.version.cuda or "none"}


def paper_batch(setup: BenchSetup, device: str | torch.device = DEFAULT_DEVICE
                ) -> tuple[PackedInstance, torch.Tensor]:
    """The setup's instances and carbon windows: ``[B, ...]`` on ``device``.

    Drawn from the same numpy streams, in the same order, as the
    reference harness's ``run_batch``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(setup.seed)
    year = synthesize(setup.region, days=366, seed=2024)
    packs, cums = [], []
    pad = setup.n_jobs * setup.k_tasks
    for _ in range(setup.instances):
        inst = generate_instance(
            rng, n_jobs=setup.n_jobs, k_tasks=setup.k_tasks,
            n_machines=setup.n_machines, heterogeneous=setup.heterogeneous)
        packs.append(pack(inst, pad_tasks=pad, device="cpu"))
        start = int(rng.integers(0, year.n_epochs - DEF_HORIZON))
        cums.append(year.window(start, DEF_HORIZON).cumulative())
    batch = PackedInstance(*(f.to(dev) for f in stack_packed(packs)))
    return batch, torch.as_tensor(np.stack(cums), device=dev)


def run_batch(setup: BenchSetup,
              device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Solve ``setup.instances`` instances with :data:`SA_FAST` in both
    phases; returns aggregate metrics.

    ``seconds`` is the solve alone, synchronised; instance generation and
    the validator check after it are outside the window.
    """
    dev = resolve_device(device)
    batch, cum = paper_batch(setup, dev)
    draws = TorchDraws(setup.seed, dev)
    cfg = SA_FAST

    synchronize(dev)
    t0 = time.perf_counter()
    res = solve_bilevel_batch(batch, cum, draws, objective=setup.objective,
                              stretch=setup.stretch, cfg1=cfg, cfg2=cfg)
    synchronize(dev)
    dt = time.perf_counter() - t0

    def host(x):
        return x.cpu().numpy()

    return {
        "setup": setup,
        "seconds": dt,
        "opt_makespan": host(res.opt_makespan),
        "carbon_savings": host(res.carbon_savings),
        "energy_savings": host(res.energy_savings),
        "utilization": host(res.baseline.utilization),
        "baseline_carbon": host(res.baseline.carbon),
        "optimized_carbon": host(res.optimized.carbon),
        "baseline_energy": host(res.baseline.energy),
        "optimized_energy": host(res.optimized.energy),
        "baseline_violations": host(total_violations(
            batch, res.baseline.start, res.baseline.assign)),
        "optimized_violations": host(total_violations(
            batch, res.optimized.start, res.optimized.assign, res.deadline)),
    }


def summarize(r: dict) -> dict:
    return {
        "mean_carbon_savings_pct": 100 * float(r["carbon_savings"].mean()),
        "p10_carbon_savings_pct": 100 * float(
            np.percentile(r["carbon_savings"], 10)),
        "p90_carbon_savings_pct": 100 * float(
            np.percentile(r["carbon_savings"], 90)),
        "mean_energy_savings_pct": 100 * float(r["energy_savings"].mean()),
        "mean_opt_makespan": float(r["opt_makespan"].mean()),
        "mean_utilization_pct": 100 * float(r["utilization"].mean()),
        "seconds": round(r["seconds"], 1),
    }


SAVINGS_QUANTILES = (10, 25, 50, 75, 90)


def savings_distribution(savings) -> dict:
    """Mean, spread and quantiles of per-instance savings, in %: how two
    runs on different random streams are compared."""
    s = 100.0 * np.asarray(savings, np.float64)
    return {"instances": int(s.size), "mean_pct": float(s.mean()),
            "std_pct": float(s.std()), "min_pct": float(s.min()),
            "max_pct": float(s.max()),
            "quantiles_pct": {f"p{q}": float(np.percentile(s, q))
                              for q in SAVINGS_QUANTILES}}


def write_csv(name: str, rows: list[dict], stamp: dict) -> str:
    path = os.path.join(OUT_DIR, f"{name}.csv")
    os.makedirs(OUT_DIR, exist_ok=True)
    if rows:
        rows = [{**row, **stamp} for row in rows]
        keys = list(rows[0])
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for row in rows:
                f.write(",".join(str(row[k]) for k in keys) + "\n")
    return path


# ---------------------------------------------------------------------------
# The paper's cells (benchmarks/fig*.py, table1*.py).
# ---------------------------------------------------------------------------

STRETCHES = (1.0, 1.5, 2.0)
REGIONS = ("AU-SA", "CAL", "TEX", "CA-ON")


def fig4(instances, device):
    """Optimal-makespan distribution, homogeneous vs heterogeneous."""
    rows = []
    for hetero in (False, True):
        r = run_batch(BenchSetup(heterogeneous=hetero, instances=instances),
                      device=device)
        ms = r["opt_makespan"]
        rows.append({"bench": "fig4", "setup": "hetero" if hetero else "homo",
                     "mean_makespan": float(ms.mean()),
                     "p10": float(np.percentile(ms, 10)),
                     "median": float(np.median(ms)),
                     "p90": float(np.percentile(ms, 90)),
                     "seconds": round(r["seconds"], 1)})
    return rows


def fig5(instances, device):
    """Carbon savings vs stretch factor S, AU-SA, homo + hetero."""
    return [{"bench": "fig5", "setup": "hetero" if h else "homo",
             "stretch": s,
             **summarize(run_batch(BenchSetup(heterogeneous=h, stretch=s,
                                              instances=instances),
                                   device=device))}
            for h in (False, True) for s in STRETCHES]


def fig6(instances, device):
    """Carbon savings at S=1 across grid regions."""
    return [{"bench": "fig6", "setup": "hetero" if h else "homo",
             "region": region,
             **summarize(run_batch(BenchSetup(heterogeneous=h, region=region,
                                              instances=instances),
                                   device=device))}
            for h in (False, True) for region in REGIONS]


def fig7(instances, device):
    """Carbon-objective vs energy-objective solvers (heterogeneous)."""
    return [{"bench": "fig7", "objective": obj, "stretch": s,
             **summarize(run_batch(BenchSetup(heterogeneous=True, stretch=s,
                                              objective=obj,
                                              instances=instances),
                                   device=device))}
            for obj in ("carbon", "energy") for s in STRETCHES]


def table1a(instances, device):
    """Server count M in {2, 5, 10} (homogeneous, S=1)."""
    return [{"bench": "table1a", "n_machines": m,
             **summarize(run_batch(BenchSetup(n_machines=m,
                                              instances=instances),
                                   device=device))}
            for m in (2, 5, 10)]


def table1b(instances, device):
    """Tasks per job k in {3, 4, 5} (homogeneous, S=1)."""
    return [{"bench": "table1b", "k_tasks": k,
             **summarize(run_batch(BenchSetup(k_tasks=k, instances=instances),
                                   device=device))}
            for k in (3, 4, 5)]


# ---------------------------------------------------------------------------
# The online cell (benchmarks/online_vs_offline.py): the price of online.
# ---------------------------------------------------------------------------

# Gate-policy grid: 3 x 2 x 2 = 12 combinations per instance.
ONLINE_THETAS = (0.3, 0.4, 0.5)
ONLINE_WINDOWS = (48, 96)
ONLINE_STRETCHES = (1.25, 1.5)

# Forecast/simulation horizon (epochs), generously above any greedy online
# makespan at this instance size, so every dispatch completes (checked).
SIM_HORIZON = 768


def online_batch(setup: BenchSetup,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> tuple[list[PackedInstance], PackedInstance,
                            torch.Tensor, torch.Tensor]:
    """The online cell's instances and ``SIM_HORIZON``-epoch windows.

    Drawn from the same numpy stream, in the same order, as the
    reference's ``online_vs_offline.run``.  Returns the single instances
    (on the CPU, for the numpy oracle), their batch, intensity ``[B, E]``
    and cumulative traces ``[B, E+1]``, the last three on ``device``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(setup.seed)
    year = synthesize(setup.region, days=366, seed=2024)
    pad = setup.n_jobs * setup.k_tasks
    packs, intens, cums = [], [], []
    for _ in range(setup.instances):
        inst = generate_instance(rng, n_jobs=setup.n_jobs,
                                 k_tasks=setup.k_tasks,
                                 n_machines=setup.n_machines)
        packs.append(pack(inst, pad_tasks=pad, device="cpu"))
        w = year.window(int(rng.integers(0, year.n_epochs - SIM_HORIZON)),
                        SIM_HORIZON)
        intens.append(w.intensity)
        cums.append(w.cumulative())
    batch = PackedInstance(*(f.to(dev) for f in stack_packed(packs)))
    return (packs, batch, torch.as_tensor(np.stack(intens), device=dev),
            torch.as_tensor(np.stack(cums), device=dev))


def run_online(setup: BenchSetup,
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The online cell without the bound: instances -> sweep -> validator
    -> savings of every policy against the greedy baseline.

    ``seconds`` is the sweep alone, synchronised.  Savings are
    ``1 - carbon(gated) / carbon(greedy)`` per (instance, policy).  The
    inputs come back too: the single instances (CPU), the batch and its
    intensity and cumulative traces (on ``device``).
    """
    dev = resolve_device(device)
    packs, batch, inten, cum = online_batch(setup, dev)
    synchronize(dev)
    t0 = time.perf_counter()
    res = sweep_policies(batch, inten, ONLINE_THETAS, ONLINE_WINDOWS,
                         ONLINE_STRETCHES, device=dev)
    synchronize(dev)
    dt = time.perf_counter() - t0

    def host(x):
        return x.cpu().numpy()

    real = batch.task_mask
    base = evaluate(batch, res.greedy.start, res.greedy.assign, cum)
    gated = evaluate(batch, res.gated.start, res.gated.assign, cum)
    return {
        "setup": setup,
        "seconds": dt,
        "packs": packs,
        "batch": batch,
        "intensity": inten,
        "cum": cum,
        "result": res,
        "policies": policy_grid(ONLINE_THETAS, ONLINE_WINDOWS,
                                ONLINE_STRETCHES),
        "unscheduled_greedy": int((~res.greedy.scheduled & real).sum()),
        "unscheduled_gated": int((~res.gated.scheduled
                                  & real[:, None, :]).sum()),
        "greedy_violations": host(total_violations(
            batch, res.greedy.start, res.greedy.assign)),
        "gated_violations": host(total_violations(
            batch, res.gated.start, res.gated.assign)),
        "savings": host(1.0 - gated.carbon / base.carbon[:, None]),
        "makespan_ratio": host(gated.makespan.to(torch.float64)
                               / base.makespan.to(torch.float64)[:, None]),
    }


def online_summary(r: dict) -> list[dict]:
    """One row per policy, best mean savings first."""
    th, wi, sx = r["policies"]
    rows = [{"bench": "online_vs_offline", "theta": round(float(th[j]), 4),
             "window": int(wi[j]), "stretch": float(sx[j]),
             "online_gated_savings_pct": 100 * float(r["savings"][:, j].mean()),
             "online_makespan_ratio": float(r["makespan_ratio"][:, j].mean()),
             "instances": r["setup"].instances,
             "sweep_seconds": r["seconds"]}
            for j in range(th.shape[0])]
    rows.sort(key=lambda row: -row["online_gated_savings_pct"])
    return rows


def online_vs_offline(instances, device):
    """Online gated savings per policy beside the S=1.5 bi-level bound."""
    setup = BenchSetup(stretch=1.5, instances=max(instances, 8))
    r = run_online(setup, device)
    bad = (r["unscheduled_greedy"], r["unscheduled_gated"],
           int(r["greedy_violations"].sum()), int(r["gated_violations"].sum()))
    if any(bad):
        raise RuntimeError(f"online sweep: unscheduled greedy/gated tasks and "
                           f"violation masses {bad}, expected all 0")
    dev = resolve_device(device)
    bound = solve_bilevel_batch(r["batch"], r["cum"],
                                TorchDraws(setup.seed, dev),
                                objective="carbon", stretch=setup.stretch,
                                cfg1=SA_FAST, cfg2=SA_FAST)
    off = float(bound.carbon_savings.mean())
    rows = online_summary(r)
    for row in rows:
        row["offline_bound_savings_pct"] = 100 * off
        row["online_fraction_of_bound"] = (
            row["online_gated_savings_pct"] / 100 / max(off, 1e-9))
    return rows


# ---------------------------------------------------------------------------
# The forecast-robustness cell (benchmarks/forecast_robustness.py): how much
# of the offline bound survives an imperfect forecast.
# ---------------------------------------------------------------------------

FC_SCALES = (0.0, 0.5, 1.0)   # forecast error at day-ahead leads, trace-stds
FC_EVERYS = (24, 48, 96)      # replan interval (epochs; 96 = daily)
# theta/window: the best cell of the reference's online sweep.
FC_THETA, FC_WINDOW, FC_STRETCH = 0.3, 96, 1.5


@dataclasses.dataclass(frozen=True)
class ForecastSetup:
    """The reference harness's grid and budgets; ``instances`` is the
    paper's batch size (the reference harness defaults to 8)."""

    instances: int = 1000
    seeds: int = 3              # forecast error seeds of the gates
    horizon: int = 512
    n_jobs: int = 6
    k_tasks: int = 3
    mpc_seeds: int = 2          # forecast error seeds of the MPC
    sa_pop: int = 24            # SA per replan
    sa_iters: int = 24
    seed: int = 2024


def forecast_batch(setup: ForecastSetup,
                   device: str | torch.device = DEFAULT_DEVICE
                   ) -> tuple[PackedInstance, torch.Tensor, torch.Tensor]:
    """The cell's instances ``[B, ...]``, true intensity ``[B, E]`` and
    cumulative traces ``[B, E+1]`` on ``device``, from the same numpy
    stream as the reference's ``forecast_robustness.run``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(setup.seed)
    year = synthesize("AU-SA", days=366, seed=2024)
    pad = setup.n_jobs * setup.k_tasks
    packs, truths, cums = [], [], []
    for _ in range(setup.instances):
        inst = generate_instance(rng, n_jobs=setup.n_jobs,
                                 k_tasks=setup.k_tasks, n_machines=5)
        packs.append(pack(inst, pad_tasks=pad, device="cpu"))
        w = year.window(int(rng.integers(0, year.n_epochs - setup.horizon)),
                        setup.horizon)
        truths.append(w.intensity)
        cums.append(w.cumulative())
    batch = PackedInstance(*(f.to(dev) for f in stack_packed(packs)))
    return (batch, torch.as_tensor(np.stack(truths), device=dev),
            torch.as_tensor(np.stack(cums), device=dev))


def mpc_config(setup: ForecastSetup, every: int) -> MPCConfig:
    """The reference harness's MPC at one replan interval: replans cover
    the first 240 epochs."""
    return MPCConfig(every=every,
                     n_replans=n_replans(min(setup.horizon, 240), every),
                     stretch=FC_STRETCH,
                     sa=SAConfig(pop=setup.sa_pop, iters=setup.sa_iters,
                                 sweeps=1),
                     sa_phase1=SAConfig(pop=max(setup.sa_pop, 32),
                                        iters=max(setup.sa_iters, 40)))


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"forecast cell: {msg}")


def run_forecast(setup: ForecastSetup = ForecastSetup(),
                 device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The forecast-robustness cell, on ``device``.

    Realized carbon (always on the true trace) of the day-ahead gate, the
    rolling gate and the MPC replanner at every (scale, every) of the
    grid, beside the perfect-forecast gate and the offline bound; savings
    against the greedy online dispatch.  One ``xi [S, Kmax, E]`` of
    forecast draws serves the whole run: the day-ahead gate uses issue 0,
    the rolling gate issues ``0..K-1``, the MPC replans
    ``0..n_replans-1`` (seeds ``0..mpc_seeds-1``), as the reference's
    shared forecast keys do.  All modes and seeds of one scale go through
    one ``simulate_online`` call.  Every dispatched schedule must be
    complete and every schedule validator-clean (else ``RuntimeError``).

    Returns ``{"record": <the reference's fields, plus the stages' wall
    seconds and the validator masses>, ...}`` and the run's tensors for
    checks: the batch, ``truths``, ``cums``, ``xi``, the perfect gate's
    mask ``perfect_dirty [B, E]``, the scale-0 masks ``masks0``
    (``"day_ahead"`` and each ``every``, ``[B, S, E]``) and the MPC
    results ``mpc[(scale, every)]``.
    """
    dev = resolve_device(device)
    st = Stages(dev)
    with st("setup"):
        batch, truths, cums = forecast_batch(setup, dev)
        B, E = truths.shape
        S = setup.seeds
        k_max = max(n_replans(E, every) for every in FC_EVERYS)
        xi = TorchDraws(setup.seed + 1, dev).normal((S, k_max, E))
    mask = batch.task_mask
    violations: dict[str, int] = {}

    def clean(name, start, assign, deadline=None, scheduled=None):
        if scheduled is not None:
            m = mask.reshape(mask.shape[:1] + (1,) * (scheduled.ndim - 2)
                             + mask.shape[1:])
            _require(bool((scheduled | ~m).all()),
                     f"{name}: dispatch did not complete within the horizon")
        v = int(total_violations(batch, start, assign, deadline).sum())
        violations[name] = violations.get(name, 0) + v
        _require(v == 0, f"{name}: validator mass {v}")

    # ---- baselines: greedy, perfect-forecast gate, offline bound. --------
    with st("greedy"):
        greedy = simulate_online(
            batch, torch.zeros((B, E), dtype=torch.bool, device=dev), 0, E)
        ms0 = makespan(batch, greedy.start, greedy.assign)
        budgets = (torch.tensor(FC_STRETCH, device=dev)
                   * ms0.to(torch.float32)).to(torch.int32)
    clean("greedy", greedy.start, greedy.assign, scheduled=greedy.scheduled)
    greedy_carbon = evaluate(batch, greedy.start, greedy.assign,
                             cums).carbon.cpu().numpy()            # [B]
    with st("perfect_gate"):
        perfect_dirty = dirty_mask(truths, FC_THETA, FC_WINDOW, FC_WINDOW)
        perfect = simulate_online(batch, perfect_dirty, budgets, E)
    clean("perfect", perfect.start, perfect.assign,
          scheduled=perfect.scheduled)
    perfect_carbon = evaluate(batch, perfect.start, perfect.assign,
                              cums).carbon.cpu().numpy()           # [B]
    sa_off = SAConfig(pop=max(setup.sa_pop, 48),
                      iters=max(setup.sa_iters, 60), sweeps=2)
    with st("offline_bound"):
        bires = solve_bilevel_batch(batch, cums, TorchDraws(setup.seed, dev),
                                    objective="carbon", stretch=FC_STRETCH,
                                    cfg1=sa_off, cfg2=sa_off)
    clean("offline", bires.optimized.start, bires.optimized.assign,
          bires.deadline)
    offline_carbon = bires.optimized.carbon.cpu().numpy()         # [B]

    def savings(carbon):        # vs the greedy online dispatch, in %
        return 100.0 * float(np.mean(1.0 - carbon / greedy_carbon))

    mpc_xi = xi[:max(1, setup.mpc_seeds)]
    truth_s = truths[:, None, :]                                   # [B,1,E]
    cells, masks0, mpcs, all_ok = [], {}, {}, True
    for scale in FC_SCALES:
        with st("gates"):
            dirty = [day_ahead_dirty_mask(truth_s, FC_THETA, FC_WINDOW, xi,
                                          scale, FC_WINDOW)]
            dirty += [rolling_dirty_mask(truth_s, FC_THETA, FC_WINDOW, xi,
                                         scale, every=every,
                                         max_window=FC_WINDOW)
                      for every in FC_EVERYS]                  # [B, S, E]
        if scale == 0.0:
            masks0 = {"day_ahead": dirty[0],
                      **{every: d for every, d in zip(FC_EVERYS, dirty[1:])}}
        with st("dispatch"):
            sched = simulate_online(batch, torch.cat(dirty, 1), budgets, E)
        clean("gated", sched.start, sched.assign, scheduled=sched.scheduled)
        carbon = evaluate(batch, sched.start, sched.assign,
                          cums).carbon.cpu().numpy()        # [B, S*(1+3)]
        da_carbon = carbon[:, :S]
        for i, every in enumerate(FC_EVERYS):
            ro_carbon = carbon[:, S * (i + 1):S * (i + 2)]
            with st("mpc"):
                # A fresh stream per cell: every cell searches from the
                # same draws, as the reference's shared mpc_keys do.
                mpc = solve_mpc_batch(batch, truths, cums,
                                      TorchDraws(setup.seed + 2, dev), mpc_xi,
                                      scale, objective="carbon",
                                      cfg=mpc_config(setup, every),
                                      device=dev)
            clean("mpc", mpc.start, mpc.assign, mpc.deadline)
            mpcs[(scale, every)] = mpc
            mpc_carbon = mpc.realized.carbon.cpu().numpy()         # [B, S']

            da_sav = savings(da_carbon.mean(1))
            ro_sav = savings(ro_carbon.mean(1))
            ok = ro_sav >= da_sav - 1e-6
            all_ok &= ok
            cells.append({
                "scale": scale,
                "every": every,
                "day_ahead": {"carbon_mean": float(da_carbon.mean()),
                              "savings_vs_greedy_pct": da_sav},
                "rolling": {"carbon_mean": float(ro_carbon.mean()),
                            "savings_vs_greedy_pct": ro_sav},
                "mpc": {"carbon_mean": float(mpc_carbon.mean()),
                        "savings_vs_greedy_pct": savings(mpc_carbon.mean(1))},
                "rolling_ge_day_ahead": ok,
            })

    record = {
        "bench": "forecast_robustness",
        "grid": {"scales": list(FC_SCALES), "replan_every": list(FC_EVERYS)},
        "theta": FC_THETA, "window": FC_WINDOW, "stretch": FC_STRETCH,
        "instances": setup.instances, "seeds": S,
        "mpc_seeds": int(mpc_xi.shape[0]),
        "horizon": setup.horizon,
        "tasks_per_instance": setup.n_jobs * setup.k_tasks,
        "greedy_carbon_mean": float(greedy_carbon.mean()),
        "perfect_day_ahead_gate": {
            "carbon_mean": float(perfect_carbon.mean()),
            "savings_vs_greedy_pct": savings(perfect_carbon)},
        "offline_bound": {
            "carbon_mean": float(offline_carbon.mean()),
            "savings_vs_greedy_pct": savings(offline_carbon)},
        "cells": cells,
        "rolling_vs_day_ahead_ok": bool(all_ok),
        "seconds": sum(st.seconds.values()),
        "stage_seconds": st.seconds,
        "violations": violations,
    }
    return {"record": record, "batch": batch, "truths": truths, "cums": cums,
            "xi": xi, "perfect_dirty": perfect_dirty, "masks0": masks0,
            "mpc": mpcs}


def forecast_robustness(instances, device):
    """One row per (scale, every): day-ahead, rolling and MPC savings
    beside the perfect gate and the offline bound."""
    rec = run_forecast(ForecastSetup(instances=instances), device)["record"]
    return [{"bench": "forecast_robustness", "scale": c["scale"],
             "every": c["every"],
             "day_ahead_savings_pct":
                 c["day_ahead"]["savings_vs_greedy_pct"],
             "rolling_savings_pct": c["rolling"]["savings_vs_greedy_pct"],
             "mpc_savings_pct": c["mpc"]["savings_vs_greedy_pct"],
             "rolling_ge_day_ahead": c["rolling_ge_day_ahead"],
             "perfect_gate_savings_pct":
                 rec["perfect_day_ahead_gate"]["savings_vs_greedy_pct"],
             "offline_bound_savings_pct":
                 rec["offline_bound"]["savings_vs_greedy_pct"],
             "rolling_vs_day_ahead_ok": rec["rolling_vs_day_ahead_ok"],
             "instances": rec["instances"], "seconds": rec["seconds"]}
            for c in rec["cells"]]


# ---------------------------------------------------------------------------
# The structure cell (benchmarks/structure_sweep.py): savings vs job
# structure and server count.
# ---------------------------------------------------------------------------

STRUCTURE_FAMILIES = ("chain", "fanout", "diamond", "layered", "tpch")

# Copies of the reference harness's grids.  Sizes are per-family (width,
# depth) pairs with matched tasks per job.  Full: 5 families x 2 sizes (6
# and 10 tasks/job) x 3 server counts x 2 fleets = 60 cells.
STRUCTURE_FULL = dict(sizes={"chain": ((1, 6), (1, 10)),
                             "fanout": ((2, 2), (4, 2)),
                             "diamond": ((1, 2), (3, 2)),
                             "layered": ((3, 3), (4, 4)),
                             "tpch": ((3, 1), (4, 3))},
                      machine_counts=(2, 5, 8),
                      fleets=("homog", "tiered"), n_jobs=6,
                      instances_per_cell=4, horizon=2048,
                      sa=SAConfig(pop=24, iters=40, sweeps=1))

# Tiny (the grid tests/golden/structure_tiny.json locks): 5 x 1 size
# (4 tasks/job) x 2 x 2 = 20 cells, 2 instances each.
STRUCTURE_TINY = dict(sizes={"chain": ((1, 4),),
                             "fanout": ((2, 1),),
                             "diamond": ((2, 1),),
                             "layered": ((3, 2),),
                             "tpch": ((2, 1),)},
                      machine_counts=(2, 4),
                      fleets=("homog", "tiered"), n_jobs=4,
                      instances_per_cell=2, horizon=768,
                      sa=SAConfig(pop=16, iters=24, sweeps=1))


def structure_spec(tiny: bool = False,
                   instances_per_cell: int | None = None) -> SweepSpec:
    """The reference harness's ``make_spec``."""
    knobs = dict(STRUCTURE_TINY if tiny else STRUCTURE_FULL)
    sa = knobs.pop("sa")
    n_jobs = knobs.pop("n_jobs")
    ipc = knobs.pop("instances_per_cell")
    horizon = knobs.pop("horizon")
    cells = structure_cells(families=STRUCTURE_FAMILIES, n_jobs=n_jobs,
                            **knobs)
    return SweepSpec(cells=cells, instances_per_cell=instances_per_cell or ipc,
                     horizon=horizon, sa=sa)


def run_structure(spec: SweepSpec,
                  device: str | torch.device = DEFAULT_DEVICE,
                  devices=None, processes: int | None = None) -> dict:
    """The sweep on ``device`` (sharded with ``devices`` / ``processes``,
    as :func:`~repro_torch.scenarios.sweep.sweep_structure`): its rows,
    meta (with each stage's wall seconds), trend summary and synchronised
    wall seconds."""
    dev = call_devices(device, devices, processes)[0]
    synchronize(dev)
    t0 = time.perf_counter()
    rows, meta = sweep_structure(spec, device=dev, devices=devices,
                                 processes=processes)
    synchronize(dev)
    return {"rows": rows, "meta": meta, "trends": trend_summary(rows),
            "seconds": time.perf_counter() - t0}


def shard_devices(device, devices: int | None, processes: int | None):
    """The shard layer's ``devices`` for the command line's ``--device``,
    ``--devices N`` and ``--processes``: N cards (``None``: one card a
    process), or N shards on a non-CUDA ``device``."""
    if devices is None and processes is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        return devices
    return [dev] * (devices or 1)


def structure_sweep(instances, device, devices=None, processes=None):
    """The full grid at ``instances`` per cell: one row per cell (scalar
    fields), savings by policy and the offline bound."""
    r = run_structure(structure_spec(instances_per_cell=instances),
                      device=device, devices=devices, processes=processes)
    print(f"# structure: {r['meta']['instances']} instances, "
          f"{r['seconds']:.3f} s; stages " + " ".join(
              f"{k}={v:.3f}" for k, v in r["meta"]["seconds"].items()),
          flush=True)
    return [{"bench": "structure_sweep",
             **{k: v for k, v in row.items()
                if not isinstance(v, (list, dict))},
             "instances_per_cell": r["meta"]["instances_per_cell"],
             "devices": r["meta"]["devices"],
             "processes": r["meta"]["processes"],
             "seconds": r["seconds"]} for row in r["rows"]]


# ---------------------------------------------------------------------------
# The learned_gate cell (benchmarks/learned_gate.py): gate thetas learned
# by gradient vs the fixed policy grid, per family, at equal stretch.
# ---------------------------------------------------------------------------

FULL_LEARN = LearnConfig(steps=150)
LEARN_PER_CELL = 4              # FULL: 60 cells x 4 = 240 instances


def run_learned_gate(spec: SweepSpec | None = None,
                     steps: int = FULL_LEARN.steps,
                     device: str | torch.device = DEFAULT_DEVICE,
                     devices=None, processes: int | None = None) -> dict:
    """The structure grid with learned thetas, without the offline bound:
    per (cell, stretch) a theta trained for ``steps`` steps from the
    cell's best fixed policy (``FULL_LEARN`` otherwise), kept where its
    hard evaluation improves on it.  ``spec`` defaults to the FULL grid at
    ``LEARN_PER_CELL`` instances a cell.  Returns the reference harness's
    record (rows as ``cells``, the family x stretch summary, the
    acceptance flag) with the synchronised wall seconds and each training
    step's wall (``learn_step_seconds``, each step between two
    synchronisations).  ``devices`` / ``processes`` shard it as in
    :func:`run_structure`.  Raises if the learned savings fall below the
    fixed grid's anywhere."""
    dev = call_devices(device, devices, processes)[0]
    if spec is None:
        spec = structure_spec(instances_per_cell=LEARN_PER_CELL)
    cfg = FULL_LEARN._replace(steps=steps)
    synchronize(dev)
    t0 = time.perf_counter()
    rows, meta = sweep_structure(spec, offline=False, learn=cfg, device=dev,
                                 devices=devices, processes=processes)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    summary, ok = learned_summary(rows)
    if not ok:
        raise AssertionError("learned thetas fell below the fixed grid "
                             "somewhere: the init-fallback rule is broken")
    stage_seconds = meta.pop("seconds")
    return {"bench": "learned_gate", "seconds": seconds, "seconds_by_stage": stage_seconds, **meta,
            "summary_by_family": summary,
            "acceptance": {"learned_ge_fixed_everywhere": ok},
            "trends": trend_summary(rows), "cells": rows}


# tests/test_learn_golden.py's seed-pinned tiny run, which
# tests/golden/learn_tiny.json locks: chain and layered tiered cells, two
# instances each, 40 steps from theta 0.5.
LEARN_TINY = dict(seed=2024, families=("chain", "layered"), per_cell=2,
                  horizon=600, steps=40, stretch=1.5, window=48, theta0=0.5)


def learn_tiny_inputs(device: str | torch.device = DEFAULT_DEVICE) -> tuple:
    """The golden tiny run's inputs: the stacked batch on ``device``, and
    as numpy arrays the intensities ``[4, 600]``, cumulative traces, group
    of each instance and windows (the reference's seeded streams)."""
    k = LEARN_TINY
    rng = np.random.default_rng(k["seed"])
    year = synthesize("AU-SA", days=30, seed=k["seed"])
    insts, group = [], []
    for gi, fam in enumerate(k["families"]):
        cfg = ScenarioConfig(family=fam, fleet="tiered", n_jobs=3, width=2,
                             depth=2, n_machines=3)
        insts += sample_batch(rng, cfg, k["per_cell"])
        group += [gi] * k["per_cell"]
    batch = pack_aligned(insts, device=resolve_device(device))
    wins = [year.window(int(rng.integers(0, year.n_epochs - k["horizon"])),
                        k["horizon"]) for _ in insts]
    return (batch, np.stack([w.intensity for w in wins]),
            np.stack([w.cumulative() for w in wins]), np.asarray(group),
            np.full(len(insts), k["window"], np.int32))


def run_learn_tiny(device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The golden tiny run on ``device``: its loss curve, final thetas and
    the learned thetas' hard-dispatch savings per family, rounded as the
    golden stores them."""
    dev = resolve_device(device)
    k = LEARN_TINY
    batch, intens, cums, group, window = learn_tiny_inputs(dev)
    res = train_gate(batch, intens, cums, group, window, k["stretch"],
                     np.full(len(k["families"]), k["theta0"], np.float32),
                     LearnConfig(steps=k["steps"]), device=dev)
    sav = evaluate_theta(batch, intens, cums, res.theta[torch.as_tensor(
        group, device=dev)], window, k["stretch"], device=dev)[0]
    sav = sav.cpu().numpy()
    return {
        "families": list(k["families"]),
        "loss_curve": [round(float(v), 6) for v in res.loss_curve.cpu()],
        "final_theta": [round(float(v), 6) for v in res.theta.cpu()],
        "learned_savings_pct": [
            round(100 * float(sav[group == gi].mean()), 3)
            for gi in range(len(k["families"]))],
        "step_seconds": res.step_seconds,
    }


def learned_gate(instances, device, devices=None, processes=None):
    """The FULL grid at ``instances`` per cell, 150 steps a stretch: one
    row per cell, its learned fields flattened per stretch
    (``learned_S<stretch>_*``); prints the family x stretch summary and
    the step walls."""
    rec = run_learned_gate(structure_spec(instances_per_cell=instances),
                           device=device, devices=devices,
                           processes=processes)
    steps = [s for v in rec["learn_step_seconds"].values() for s in v]
    print(f"# learned_gate: {len(rec['cells'])} cells x "
          f"{rec['instances_per_cell']} instances, {rec['learn']['steps']} "
          f"steps a stretch, {rec['seconds']:.3f} s; a step "
          f"{np.mean(steps):.4f} s mean, {np.median(steps):.4f} median, "
          f"{max(steps):.4f} max; stages " + " ".join(
              f"{k}={v:.3f}" for k, v in rec["seconds_by_stage"].items()),
          flush=True)
    for fam, by_sx in rec["summary_by_family"].items():
        for sx, d in by_sx.items():
            print(f"#   {fam} S={sx}: learned {d['learned_savings_pct']}% "
                  f"vs fixed {d['fixed_best_savings_pct']}% "
                  f"({d['improved_cells']}/{d['cells']} cells improved)",
                  flush=True)
    out = []
    for r in rec["cells"]:
        row = {k: v for k, v in r.items() if not isinstance(v, (list, dict))}
        for sx, cell in r["learned"].items():
            for k in ("theta", "savings_pct", "fixed_best_savings_pct",
                      "improved"):
                row[f"learned_S{sx}_{k}"] = cell[k]
        out.append({"bench": "learned_gate", **row,
                    "steps": rec["learn"]["steps"],
                    "devices": rec["devices"],
                    "processes": rec["processes"],
                    "seconds": rec["seconds"]})
    return out


# ---------------------------------------------------------------------------
# The stream cell (benchmarks/stream_serve.py): the streaming dispatch
# service under load — throughput, queue delay and savings.
# ---------------------------------------------------------------------------

STREAM_SEED = 2024      # the arrivals, jobs, fleet and window of every cell

# Full grid: 3 arrival families x 4 load factors, day-scale stream.
STREAM_FULL = dict(horizon=1024, n_lanes=8, family="layered", width=3,
                   depth=3, n_machines=3, fleet="tiered", mean_dur=6.0,
                   loads=(0.3, 0.6, 0.9, 1.2),
                   families=("poisson", "bursty", "diurnal"))

# Tiny grid: 2 families x 3 loads, quarter-day stream.
STREAM_TINY = dict(horizon=256, n_lanes=4, family="layered", width=3,
                   depth=2, n_machines=3, fleet="tiered", mean_dur=5.0,
                   loads=(0.4, 0.8, 1.2), families=("poisson", "bursty"))


def stream_knobs(tiny: bool = False) -> tuple[dict, tuple, tuple]:
    """The grid's job/pool knobs, its loads and its arrival families."""
    knobs = dict(STREAM_TINY if tiny else STREAM_FULL)
    return knobs, knobs.pop("loads"), knobs.pop("families")


def probe_service_epochs(knobs: dict,
                         device: str | torch.device = DEFAULT_DEVICE
                         ) -> float:
    """Mean greedy makespan of 8 of the cell's jobs — the per-lane
    service time the load factor is calibrated against (the reference
    harness's probe, on ``device``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(STREAM_SEED)
    scen = ScenarioConfig(family=knobs["family"], n_jobs=1,
                          width=knobs["width"], depth=knobs["depth"],
                          n_machines=knobs["n_machines"],
                          fleet=knobs["fleet"],
                          mean_dur=knobs["mean_dur"]).validate()
    jobs = [dataclasses.replace(sample_job(rng, scen), arrival=0)
            for _ in range(8)]
    powers, speeds = build_fleet(knobs["fleet"], rng, knobs["n_machines"])
    T = max(j.n_tasks for j in jobs)
    ms = []
    for j in jobs:
        inst = pack(Instance(jobs=(j,), powers_kw=powers, speeds=speeds),
                    pad_tasks=T, device=dev)
        g = online_greedy_torch(inst, 512, device=dev)
        ms.append(int(makespan(inst, g.start, g.assign)))
    return float(np.mean(ms))


def _dist(xs: list[float]) -> dict:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {"mean": round(float(a.mean()), 3),
            "p50": round(float(np.percentile(a, 50)), 3),
            "p90": round(float(np.percentile(a, 90)), 3),
            "max": round(float(a.max()), 3)}


def _round_dist(d: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v
            for k, v in d.items()}


def stream_config(knobs: dict, family: str, rate: float,
                  shared_fleet: bool = False, **gate) -> StreamConfig:
    """One cell's :class:`StreamConfig`; ``gate`` sets the forecast-banded
    gate's fields (``forecast_every``, ``forecast_scale``)."""
    return StreamConfig(arrivals=family, rate=rate, horizon=knobs["horizon"],
                        n_lanes=knobs["n_lanes"], family=knobs["family"],
                        width=knobs["width"], depth=knobs["depth"],
                        n_machines=knobs["n_machines"], fleet=knobs["fleet"],
                        mean_dur=knobs["mean_dur"], seed=STREAM_SEED,
                        shared_fleet=shared_fleet, **gate)


def _warm_wall(wall: dict, name: str) -> dict:
    """Mean and p90 seconds of a call's warm samples, and their count
    (from ``summary()["wall"]``)."""
    d = wall.get(f"{name}_warm", {})
    return {"mean": d.get("mean", 0.0), "p90": d.get("p90", 0.0),
            "count": d.get("count", 0)}


def run_stream_cell(knobs: dict, family: str, load: float, rate: float,
                    shared_fleet: bool = False,
                    device: str | torch.device = DEFAULT_DEVICE,
                    **gate) -> dict:
    """One stream cell on ``device``: the reference harness's row, plus
    the warm admission and tick walls.  ``seconds`` is
    :func:`~repro_torch.stream.simulate_stream` between two
    synchronisations; ``jobs_per_sec`` is finished jobs per second of it.
    The result itself is under ``"result"``."""
    dev = resolve_device(device)
    cfg = stream_config(knobs, family, rate, shared_fleet, **gate)
    synchronize(dev)
    t0 = time.perf_counter()
    res = simulate_stream(cfg, device=dev)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    s = res.summary
    n_finished = s["jobs_completed"]
    finished = [sj for sj in res.jobs if sj.finished]
    return {
        "arrivals": family,
        "load": load,
        "shared_fleet": shared_fleet,
        "rate_jobs_per_epoch": round(rate, 5),
        "n_jobs": len(res.jobs),
        "n_admitted": s["jobs_admitted"],
        "n_rejected": s["jobs_rejected"],
        "n_finished": n_finished,
        "n_truncated": s["jobs_truncated"],
        "n_unfinished": len(res.jobs) - n_finished,
        "final_lane_occupancy": s["final_lane_occupancy"],
        "ticks": s["ticks"],
        "seconds": seconds,
        "jobs_per_sec": n_finished / max(seconds, 1e-9),
        "admission_wall_s": _warm_wall(s["wall"], "admission_wall_s"),
        "tick_wall_s": _warm_wall(s["wall"], "tick_wall_s"),
        "queue_delay_epochs": _round_dist(s["queue_delay_epochs"]),
        "carbon_savings_pct": _round_dist(s["carbon_savings_pct"]),
        "realized_stretch": _dist(
            [(sj.completed - sj.admitted)
             / max(1, sj.greedy_makespan - sj.admitted)
             for sj in finished]),
        "result": res,
    }


def fleet_deltas(rows: list[dict]) -> list[dict]:
    """Per-(family, load) shared-minus-partitioned deltas: the contention
    cost (queue delay up) and gate-interaction cost (savings down) of one
    common machine set vs disjoint per-lane partitions."""
    part = {(r["arrivals"], r["load"]): r for r in rows
            if not r["shared_fleet"]}
    out = []
    for r in rows:
        p = part.get((r["arrivals"], r["load"]))
        if not r["shared_fleet"] or p is None:
            continue
        out.append({
            "arrivals": r["arrivals"],
            "load": r["load"],
            "queue_delay_mean_delta": round(
                r["queue_delay_epochs"]["mean"]
                - p["queue_delay_epochs"]["mean"], 3),
            "queue_delay_p90_delta": round(
                r["queue_delay_epochs"]["p90"]
                - p["queue_delay_epochs"]["p90"], 3),
            "savings_mean_delta_pct": round(
                r["carbon_savings_pct"]["mean"]
                - p["carbon_savings_pct"]["mean"], 3),
            "finished_delta": r["n_finished"] - p["n_finished"],
        })
    return out


def run_stream(tiny: bool = False,
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The stream grid on ``device``: every (family x load) cell in both
    fleet modes (partitioned baseline first), at rates calibrated against
    the pool's greedy capacity (``load = rate / (n_lanes / mean greedy
    makespan)``).  One warm-up cell per fleet mode runs outside the clock.
    Returns the reference harness's ``shared_fleet=True`` record: ``cells``
    (rows without their results), ``fleet_deltas``, the service time, the
    capacity and the knobs."""
    dev = resolve_device(device)
    knobs, loads, families = stream_knobs(tiny)
    service = probe_service_epochs(knobs, device=dev)
    capacity = knobs["n_lanes"] / service      # jobs/epoch the pool clears
    for sf in (False, True):
        run_stream_cell(knobs, families[0], loads[0], loads[0] * capacity,
                        shared_fleet=sf, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    rows = [run_stream_cell(knobs, fam, load, load * capacity,
                            shared_fleet=sf, device=dev)
            for sf in (False, True) for fam in families for load in loads]
    seconds = time.perf_counter() - t0
    for r in rows:
        del r["result"]
    return {"bench": "stream_serve", "mode": "tiny" if tiny else "full",
            "shared_fleet_axis": True, "seconds": seconds,
            "seed": STREAM_SEED, "service_epochs": round(service, 3),
            "capacity_jobs_per_epoch": round(capacity, 5), **knobs,
            "cells": rows, "fleet_deltas": fleet_deltas(rows)}


def _flat(row: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in row.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}_"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def stream_serve(instances, device):
    """The stream grid in both fleet modes: FULL, or TINY when
    ``instances <= 16`` (the reference's ``run_harness``).  One row per
    cell, nested distributions flattened."""
    rec = run_stream(tiny=instances <= 16, device=device)
    return [{"bench": "stream_serve", "mode": rec["mode"], **_flat(r)}
            for r in rec["cells"]]


# ---------------------------------------------------------------------------
# The cluster cell (examples/cluster_sim.py): a day of ML batch jobs on the
# modeled fleet, planned, then executed clean, through a machine failure
# and with a straggler.
# ---------------------------------------------------------------------------

# The reference example's defaults, one day per seed.
CLUSTER = dict(n_jobs=6, region="AU-SA", days=30, horizon=2000,
               stretch=1.5, fail_machine=2, straggle_task=1,
               straggle_factor=3.0)
CLUSTER_FIRST_SEED = 3
CLUSTER_DAYS = 8


def _report(rep, seconds: float) -> dict:
    return {**dataclasses.asdict(rep),
            "recovery_overhead": rep.recovery_overhead, "seconds": seconds}


def cluster_inputs(seed: int, device: str | torch.device = DEFAULT_DEVICE
                   ) -> tuple[list, PackedInstance, np.ndarray]:
    """A day's batch, its packed instance on ``device`` and the carbon
    window's cumulative trace, from ``np.random.default_rng(seed)`` in the
    example's order."""
    k = CLUSTER
    rng = np.random.default_rng(seed)
    specs = sample_daily_batch(rng, n_jobs=k["n_jobs"])
    p = pack(make_cluster_instance(specs, seed=seed),
             device=resolve_device(device))
    trace = synthesize(k["region"], days=k["days"])
    return specs, p, sample_window(trace, rng, k["horizon"]).cumulative()


def cluster_day(seed: int, device: str | torch.device = DEFAULT_DEVICE,
                draws=None) -> dict:
    """One day of the flagship scenario on ``device``: the plan
    (validator-checked), then a clean execution, machine 2 failing at a
    third of the makespan and a 3x straggler on task 1, on one
    :class:`ClusterExecutor` (``draws`` is its seam).  Walls are
    synchronised; ``failure["resolve_seconds"]`` lists each re-solve's."""
    dev = resolve_device(device)
    k = CLUSTER
    specs, p, cum = cluster_inputs(seed, dev)
    ex = ClusterExecutor(p, cum, stretch=k["stretch"], seed=seed,
                         draws=draws, device=dev)

    def timed(fn, *args):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        synchronize(dev)
        return out, time.perf_counter() - t0

    plan, plan_s = timed(ex.plan)
    assert_feasible_np(p, plan["start"], plan["assign"], ctx="cluster plan")
    fault = FaultPlan(fail_machine=k["fail_machine"],
                      fail_epoch=plan["makespan"] // 3)
    out = {"seed": seed, "T": p.T, "M": p.M,
           "specs": [dataclasses.asdict(s) for s in specs],
           "plan": {"makespan": plan["makespan"], "carbon": plan["carbon"],
                    "seconds": plan_s},
           "start": plan["start"], "assign": plan["assign"]}
    out["clean"] = _report(*timed(ex.execute, plan))
    out["failure"] = {**_report(*timed(ex.execute, plan, fault)),
                      "fail_epoch": fault.fail_epoch,
                      "resolve_seconds": list(ex.resolve_seconds)}
    out["straggler"] = _report(*timed(
        ex.execute, plan, FaultPlan(straggle_task=k["straggle_task"],
                                    straggle_factor=k["straggle_factor"])))
    return out


def cluster_lines(day: dict) -> list[str]:
    """The reference example's printout for one day."""
    k = CLUSTER
    plan, clean, f, slow = (day["plan"], day["clean"], day["failure"],
                            day["straggler"])
    lines = ["today's batch:"] + [
        f"  {s['template']:18s} {s['arch']:14s} {s['n_steps']:4d} steps, "
        f"arrives epoch {s['arrival']}" for s in day["specs"]]
    lines += [
        f"carbon-aware plan (S={k['stretch']}): makespan "
        f"{plan['makespan']} epochs, carbon {plan['carbon']:,.0f} gCO2",
        f"clean execution : makespan {clean['achieved_makespan']}, carbon "
        f"{clean['achieved_carbon']:,.0f} gCO2 "
        f"(overhead {100 * clean['recovery_overhead']:.1f}%)",
        f"with machine-{k['fail_machine']} failure @ epoch "
        f"{f['fail_epoch']}: makespan {f['achieved_makespan']}, "
        f"carbon {f['achieved_carbon']:,.0f} gCO2, {f['n_resolves']} "
        f"re-solve(s), {f['n_restarts']} restart(s), overhead "
        f"{100 * f['recovery_overhead']:.1f}%",
        f"with a {k['straggle_factor']:g}x straggler on task "
        f"{k['straggle_task']}: makespan {slow['achieved_makespan']}, "
        f"{slow['n_speculative']} speculative cop(y/ies) issued"]
    return lines


def run_cluster(days: int = CLUSTER_DAYS,
                device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """:func:`cluster_day` for ``days`` seeds from 3 on ``device``, with
    the cell's wall and its split: plans, re-solves, and the host epoch
    loop (the executions' walls less their re-solves')."""
    dev = resolve_device(device)
    seeds = tuple(range(CLUSTER_FIRST_SEED, CLUSTER_FIRST_SEED + days))
    synchronize(dev)
    t0 = time.perf_counter()
    days = [cluster_day(s, dev) for s in seeds]
    seconds = time.perf_counter() - t0
    runs = ("clean", "failure", "straggler")
    plan_s = sum(d["plan"]["seconds"] for d in days)
    resolve_s = sum(sum(d["failure"]["resolve_seconds"]) for d in days)
    execute_s = sum(d[r]["seconds"] for d in days for r in runs)
    return {"bench": "cluster", "seconds": seconds, **CLUSTER,
            "seeds": list(seeds), "days": days,
            "seconds_by_stage": {"plan": plan_s, "resolve": resolve_s,
                                 "epoch_loop": execute_s - resolve_s,
                                 "other": seconds - plan_s - execute_s}}


def cluster_row(day: dict) -> dict:
    """One day's row: the plan and the three executions, flattened."""
    row = {"bench": "cluster", "seed": day["seed"], "T": day["T"],
           "plan_makespan": day["plan"]["makespan"],
           "plan_carbon_g": day["plan"]["carbon"],
           "plan_seconds": day["plan"]["seconds"]}
    for run in ("clean", "failure", "straggler"):
        for key, v in day[run].items():
            if key not in ("planned_makespan", "planned_carbon"):
                row[f"{run}_{key}"] = sum(v) if isinstance(v, list) else v
    return row


def cluster(instances, device):
    """The flagship scenario over ``instances`` days (seeds 3, 4, ...):
    prints the example's lines for the first day and the wall's split."""
    rec = run_cluster(instances, device)
    for line in cluster_lines(rec["days"][0]):
        print(f"# {line}", flush=True)
    print(f"# cluster: {len(rec['days'])} days in {rec['seconds']:.3f} s; "
          "stages " + " ".join(f"{k}={v:.3f}" for k, v in
                              rec["seconds_by_stage"].items()), flush=True)
    return [{**cluster_row(d), "seconds": rec["seconds"]}
            for d in rec["days"]]


CELLS = {"fig4": (fig4, "fig4_makespan"), "fig5": (fig5, "fig5_stretch"),
         "fig6": (fig6, "fig6_regions"),
         "fig7": (fig7, "fig7_carbon_vs_energy"),
         "table1a": (table1a, "table1a_servers"),
         "table1b": (table1b, "table1b_tasks"),
         "online": (online_vs_offline, "online_vs_offline"),
         "forecast": (forecast_robustness, "forecast_robustness"),
         "structure": (structure_sweep, "structure_sweep"),
         "stream": (stream_serve, "stream_serve"),
         "learned_gate": (learned_gate, "learned_gate"),
         "cluster": (cluster, "cluster")}

# Instances per cell when --instances is not given: the paper's batch for
# the forecast cell, 16 per grid cell for the structure sweep (960), 4 for
# the learned gate (240); the stream cell runs its FULL grid above 16,
# TINY at 16 or below; the cluster cell counts days.
DEFAULT_INSTANCES = {"forecast": 1000, "structure": 16, "stream": 1000,
                     "learned_gate": LEARN_PER_CELL,
                     "cluster": CLUSTER_DAYS}

# The cells --devices / --processes shard (the reference harness's).
SHARDED_CELLS = ("structure", "learned_gate")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", type=int, default=None,
                    help="instances per cell (structure: per grid cell; "
                    "stream: <= 16 runs the TINY grid; cluster: days); "
                    "default 16, forecast 1000, stream FULL, cluster 8")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. fig5,table1a")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the structure / learned_gate cells' "
                    "instances over N cards (N shards with --device cpu); "
                    "with --processes, per process (bit-exact)")
    ap.add_argument("--processes", type=int, default=None,
                    help="span the shards over a fleet of P processes, each "
                    "running this command under the REPRO_* env (python -m "
                    "tests.harness --processes P --devices 1 -- <command>)")
    args = ap.parse_args(argv)
    # Join the fleet the REPRO_* env names, if any, before any device work.
    shard.initialize_from_env()
    names = args.only.split(",") if args.only else list(CELLS)
    unknown = [n for n in names if n not in CELLS]
    if unknown:
        ap.error(f"unknown cells {unknown}; choose from {list(CELLS)}")
    kw = {}
    if args.devices is not None or args.processes is not None:
        unsharded = [n for n in names if n not in SHARDED_CELLS]
        if unsharded:
            ap.error(f"--devices/--processes shard only {SHARDED_CELLS}, "
                     f"not {unsharded}")
        kw = {"devices": shard_devices(args.device, args.devices,
                                       args.processes),
              "processes": args.processes}
    stamp = device_stamp(args.device)
    lead = shard.process_index() == 0     # one process of a fleet reports
    t0 = time.perf_counter()
    for name in names:
        fn, csv_name = CELLS[name]
        rows = fn(args.instances or DEFAULT_INSTANCES.get(name, 16),
                  args.device, **kw)
        if not lead:
            continue
        for row in rows:
            print(",".join(f"{k}={v}" for k, v in {**row, **stamp}.items()),
                  flush=True)
        write_csv(csv_name, rows, stamp)
    if lead:
        print(f"# total {time.perf_counter() - t0:.0f}s over {len(names)} "
              "cells", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
