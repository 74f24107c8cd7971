"""The paper benchmark on the port: Figs. 4-7, Tables 1a/1b, and online.

The counterpart of ``benchmarks/common.py``'s ``run_batch``/``summarize``
and of the per-figure modules beside it.  Each paper cell solves a batch
of paper instances with the bi-level protocol (phase 1 optimal makespan,
phase 2 carbon/energy under ``makespan <= S x OPT``); the ``online`` cell
(``benchmarks/online_vs_offline.py``) sweeps the online carbon-gated
dispatcher over a gate-policy grid and sets it beside the S=1.5 bound.
The same ``BenchSetup`` seed gives the same instances and carbon windows
as the reference's harness.

    python -m repro_torch.bench --only fig5 --instances 1000 [--device cuda]
    python -m repro_torch.bench --only online --instances 1000

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

from repro_torch.core.carbon import synthesize
from repro_torch.core.instance import (PackedInstance, generate_instance,
                                       pack, stack_packed)
from repro_torch.core.objectives import evaluate
from repro_torch.core.solvers import SAConfig, TorchDraws, solve_bilevel_batch
from repro_torch.core.solvers.online_torch import policy_grid, sweep_policies
from repro_torch.core.validate import total_violations
from repro_torch.device import DEFAULT_DEVICE, resolve_device

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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

    _sync(dev)
    t0 = time.perf_counter()
    res = solve_bilevel_batch(batch, cum, draws, objective=setup.objective,
                              stretch=setup.stretch, cfg1=cfg, cfg2=cfg)
    _sync(dev)
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
    _sync(dev)
    t0 = time.perf_counter()
    res = sweep_policies(batch, inten, ONLINE_THETAS, ONLINE_WINDOWS,
                         ONLINE_STRETCHES, device=dev)
    _sync(dev)
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


CELLS = {"fig4": (fig4, "fig4_makespan"), "fig5": (fig5, "fig5_stretch"),
         "fig6": (fig6, "fig6_regions"),
         "fig7": (fig7, "fig7_carbon_vs_energy"),
         "table1a": (table1a, "table1a_servers"),
         "table1b": (table1b, "table1b_tasks"),
         "online": (online_vs_offline, "online_vs_offline")}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instances", type=int, default=16)
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. fig5,table1a")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(CELLS)
    unknown = [n for n in names if n not in CELLS]
    if unknown:
        ap.error(f"unknown cells {unknown}; choose from {list(CELLS)}")
    stamp = device_stamp(args.device)
    t0 = time.perf_counter()
    for name in names:
        fn, csv_name = CELLS[name]
        rows = fn(args.instances, args.device)
        for row in rows:
            print(",".join(f"{k}={v}" for k, v in {**row, **stamp}.items()),
                  flush=True)
        write_csv(csv_name, rows, stamp)
    print(f"# total {time.perf_counter() - t0:.0f}s over {len(names)} cells, "
          f"{args.instances} instances each", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
