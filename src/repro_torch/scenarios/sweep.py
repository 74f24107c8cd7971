"""Batched structure sweep: family x shape x fleet grid as one batch.

The counterpart of ``repro.scenarios.sweep``, held against
``tests/golden/structure_tiny.json`` by ``tests/test_torch_scenarios.py``.
Every (family, width/depth, server-count, fleet) cell contributes
``instances_per_cell`` seeded instances, all cells are padded to one
``(T, M)`` by :func:`repro_torch.scenarios.batching.pack_aligned` (the
padding is inert) and the whole sweep runs as

* **one** :func:`~repro_torch.core.solvers.online_torch.sweep_policies`
  call a shard for the carbon-gated online dispatcher (all cells x
  instances x gate policies, one ``gate_quantile`` launch),
* **one** :func:`~repro_torch.core.solvers.bilevel.solve_bilevel_batch`
  call a shard for the offline SA bound (the paper's S-stretch bi-level
  protocol).

Every greedy and gated schedule is checked by the shared validator.
With ``learn=`` the sweep also trains a gate theta per cell and stretch
(:mod:`repro_torch.learn`) and keeps it where its hard evaluation beats
the best fixed policy (:func:`learned_summary` compares the two).  Every
one of those programs runs through :mod:`repro_torch.shard` over the
instance axis: unsharded is one shard on ``device``, and ``devices=`` /
``processes=`` split the rows further, bit-exact with one shard.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.carbon import synthesize
from repro_torch.core.instance import PackedInstance
from repro_torch.core.objectives import evaluate, utilization
from repro_torch.core.solvers.annealing import SAConfig
from repro_torch.core.solvers.common import row_seeds
from repro_torch.core.solvers.online_torch import policy_grid
from repro_torch.core.validate import total_violations_batch
from repro_torch.device import DEFAULT_DEVICE, Stages, resolve_device
from repro_torch.learn import LearnConfig
from repro_torch.scenarios.batching import pack_aligned
from repro_torch.scenarios.generator import ScenarioConfig, sample_batch


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The whole structure sweep: grid cells + shared knobs."""

    cells: tuple[ScenarioConfig, ...]
    instances_per_cell: int = 4
    seed: int = 2024
    region: str = "AU-SA"
    horizon: int = 768             # forecast/simulation epochs per instance
    thetas: tuple[float, ...] = (0.3, 0.5)
    windows: tuple[int, ...] = (48,)
    stretches: tuple[float, ...] = (1.5, 2.0)
    offline_stretch: float = 1.5   # S of the offline bi-level bound
    sa: SAConfig = SAConfig(pop=32, iters=60, sweeps=2)


def structure_cells(families: Sequence[str], sizes,
                    machine_counts: Sequence[int], fleets: Sequence[str],
                    n_jobs: int = 6) -> tuple[ScenarioConfig, ...]:
    """The full outer product family x (width, depth) x M x fleet.

    ``sizes`` is either one ``[(width, depth), ...]`` list shared by every
    family, or a ``{family: [(width, depth), ...]}`` mapping (how a sweep
    holds tasks per job fixed across families).
    """
    by_family = (sizes if isinstance(sizes, dict)
                 else {f: sizes for f in families})
    missing = set(families) - set(by_family)
    if missing:
        raise ValueError(f"sizes mapping missing families {sorted(missing)}")
    return tuple(
        ScenarioConfig(family=f, n_jobs=n_jobs, width=w, depth=d,
                       n_machines=m, fleet=fl).validate()
        for f in families for (w, d) in by_family[f]
        for m in machine_counts for fl in fleets)


class SweepBatch(NamedTuple):
    """All cells' instances stacked to one shape (cell_of maps rows back)."""

    batch: PackedInstance       # stacked [B, ...]
    intensity: torch.Tensor     # float32 [B, E]
    cum: torch.Tensor           # float32 [B, E+1]
    cell_of: np.ndarray         # int [B]: index into spec.cells


def build_batch(spec: SweepSpec,
                device: str | torch.device = DEFAULT_DEVICE) -> SweepBatch:
    """Generate + pad + stack every cell's instances, with per-instance
    carbon windows drawn from one synthesized year (seeded), on
    ``device``; the same numpy streams as the reference's."""
    dev = resolve_device(device)
    rng = np.random.default_rng(spec.seed)
    year = synthesize(spec.region, days=366, seed=spec.seed)
    instances, cell_of = [], []
    for ci, cell in enumerate(spec.cells):
        instances.extend(sample_batch(rng, cell, spec.instances_per_cell))
        cell_of.extend([ci] * spec.instances_per_cell)
    batch = pack_aligned(instances, device=dev)
    intens, cums = [], []
    for _ in instances:
        w = year.window(int(rng.integers(0, year.n_epochs - spec.horizon)),
                        spec.horizon)
        intens.append(w.intensity)
        cums.append(w.cumulative())
    return SweepBatch(batch, torch.as_tensor(np.stack(intens), device=dev),
                      torch.as_tensor(np.stack(cums), device=dev),
                      np.asarray(cell_of))


def sweep_structure(spec: SweepSpec, offline: bool = True,
                    learn: LearnConfig | None = None,
                    device: str | torch.device = DEFAULT_DEVICE,
                    devices: int | Sequence | None = None,
                    processes: int | None = None
                    ) -> tuple[list[dict], dict]:
    """Run the sweep on ``device``; returns (one aggregate row per cell,
    meta).

    Row fields (the reference's): the cell parameters; greedy-dispatch
    carbon/makespan/utilization means; per-policy mean online savings; the
    best policy and its savings; and (when ``offline``) the SA bi-level
    bound's savings.  ``offline=False`` skips the SA bound: the
    dispatch-only path draws nothing, which is what the golden locks.
    The offline bound's SA draws are keyed by row:
    ``RowDraws(row_seeds(spec.seed, B))``, so a row's bound does not
    depend on the rows beside it.

    ``learn``: train a gate theta per (cell, stretch), initialized from
    the cell's best fixed policy at that stretch, and add a ``"learned"``
    field per stretch; the learned theta is kept only where its hard
    evaluation improves on that fixed policy.  Only the
    ``earliest_finish`` rule of the fixed grid is comparable.
    ``meta["seconds"]`` holds the wall time of each stage, synchronised;
    with ``learn``, ``meta["learn_step_seconds"]`` each training step's.

    ``devices`` (an int, or a sequence of devices that may repeat one)
    shards the instance axis of every program in the sweep (the gated
    dispatch, the offline bound, the learner and its evaluation) over
    those devices through :mod:`repro_torch.shard`; ``processes=P`` spans
    the shards over a ``torch.distributed`` fleet of P processes, each
    running this same call (``devices`` then counts per process; ``None``
    is one card a process).  The batch is built on this process's first
    shard device and ``device`` is not used.  Sharded results are
    bit-exact with the single-device sweep: ``devices``/``processes``
    change the walls, never a number.
    """
    if learn is not None and learn.machine_rule != "earliest_finish":
        # The fixed grid and its greedy baseline are earliest_finish; a
        # differently-ruled learned policy would misreport savings.
        raise ValueError(
            "sweep_structure(learn=...) compares against the "
            "earliest_finish fixed grid; train other machine rules "
            "directly via repro_torch.learn.train_gate")
    # Imported here: repro_torch.shard pads with repro_torch.scenarios.
    from repro_torch import shard
    from repro_torch.shard.batch import call_devices
    # Unsharded is one shard on ``device``: the same programs either way.
    shard_devs = call_devices(device, devices, processes)
    dev = shard_devs[0]
    on = dict(devices=shard_devs, processes=processes)
    dispatch = functools.partial(shard.dispatch_sharded, **on)
    bound = functools.partial(shard.bilevel_sharded, **on)
    train = functools.partial(shard.train_sharded, **on)
    score = functools.partial(shard.eval_theta_sharded, **on)
    stages = Stages(dev)
    with stages("build"):
        sb = build_batch(spec, dev)
    B = int(sb.cell_of.shape[0])

    with stages("dispatch"):
        res = dispatch(sb.batch, sb.intensity, spec.thetas, spec.windows,
                       spec.stretches)
    mask = sb.batch.task_mask
    if not bool((res.greedy.scheduled | ~mask).all()):
        raise AssertionError("greedy dispatch incomplete: raise spec.horizon")
    if not bool((res.gated.scheduled | ~mask[:, None, :]).all()):
        raise AssertionError("gated dispatch incomplete: raise spec.horizon")
    with stages("validate"):
        for name, part in (("greedy", res.greedy), ("gated", res.gated)):
            v = total_violations_batch(sb.batch, part.start, part.assign)
            if bool(v.any()):
                raise AssertionError(f"{name} schedule infeasible")

    th, wi, sx = policy_grid(spec.thetas, spec.windows, spec.stretches)
    P = th.shape[0]
    base = evaluate(sb.batch, res.greedy.start, res.greedy.assign, sb.cum)
    base_carbon = base.carbon.cpu().numpy()                      # [B]
    base_ms = base.makespan.cpu().numpy().astype(float)          # [B]
    util = utilization(sb.batch, res.greedy.start,
                       res.greedy.assign).cpu().numpy()          # [B]
    gated = evaluate(sb.batch, res.gated.start, res.gated.assign, sb.cum)
    g_carbon = gated.carbon.cpu().numpy()                        # [B, P]
    g_ms = gated.makespan.cpu().numpy()                          # [B, P]
    sav = np.zeros((B, P))
    ms_ratio = np.zeros((B, P))
    for j in range(P):
        sav[:, j] = 1.0 - g_carbon[:, j] / base_carbon
        ms_ratio[:, j] = g_ms[:, j] / np.maximum(base_ms, 1.0)

    if offline:
        with stages("offline_bound"):
            bires = bound(sb.batch, sb.cum, row_seeds(spec.seed, B),
                          objective="carbon", stretch=spec.offline_stretch,
                          cfg1=spec.sa, cfg2=spec.sa)
        off_sav = bires.carbon_savings.cpu().numpy()              # [B]

    learned_by_cell: dict[int, dict] = {}
    step_seconds: dict[str, list] = {}
    if learn is not None:
        with stages("learn"):
            learned_by_cell, step_seconds = _learn_cells(
                spec, sb, res, base.carbon, sav, th, wi, sx, learn, train,
                score)

    mask = mask.cpu().numpy()
    rows = []
    for ci, cell in enumerate(spec.cells):
        sel = sb.cell_of == ci
        psav = sav[sel].mean(axis=0)                             # [P]
        best = int(psav.argmax())
        row = {
            "family": cell.family, "width": cell.width, "depth": cell.depth,
            "n_jobs": cell.n_jobs, "n_machines": cell.n_machines,
            "fleet": cell.fleet,
            "tasks_per_job": int(mask[sel].sum() // cell.n_jobs
                                 // int(sel.sum())),
            "greedy_carbon_g": round(float(base_carbon[sel].mean()), 3),
            "greedy_makespan": round(float(base_ms[sel].mean()), 3),
            "greedy_utilization_pct": round(100 * float(util[sel].mean()), 3),
            "online_savings_pct_by_policy": [
                round(100 * float(s), 3) for s in psav],
            "online_best_savings_pct": round(100 * float(psav[best]), 3),
            "online_best_policy": {"theta": round(float(th[best]), 4),
                                   "window": int(wi[best]),
                                   "stretch": round(float(sx[best]), 4)},
            "online_makespan_ratio": round(
                float(ms_ratio[sel, best].mean()), 3),
        }
        if offline:
            row["offline_bound_savings_pct"] = round(
                100 * float(off_sav[sel].mean()), 3)
        if learn is not None:
            row["learned"] = learned_by_cell[ci]
        rows.append(row)

    meta = {
        "instances": B,
        "instances_per_cell": spec.instances_per_cell,
        "cells": len(spec.cells),
        "policies": int(P),
        "grid": {"thetas": list(spec.thetas),
                 "windows": [int(w) for w in spec.windows],
                 "stretches": list(spec.stretches)},
        "horizon": spec.horizon,
        "region": spec.region,
        "seed": spec.seed,
        "pad_tasks": int(sb.batch.T),
        "pad_machines": int(sb.batch.M),
        "offline": bool(offline),
        "offline_stretch": spec.offline_stretch,
        "device": str(dev),
        "devices": len(shard_devs),
        "processes": int(processes) if processes is not None else 1,
        "seconds": stages.seconds,
    }
    if learn is not None:
        meta["learn"] = dict(learn._asdict())
        meta["learn_step_seconds"] = step_seconds
    return rows, meta


def _learn_cells(spec: SweepSpec, sb: SweepBatch, res, base_carbon, sav,
                 th, wi, sx, learn: LearnConfig, train, score
                 ) -> tuple[dict, dict]:
    """The ``learn=`` branch of :func:`sweep_structure`: per stretch, one
    training run (``train``: ``train_gate`` or its sharded twin) over
    every cell's group from the cells' best fixed policies, then one hard
    evaluation (``score``).  Returns the ``"learned"`` field of each cell
    and each stretch's training step walls."""
    n_cells = len(spec.cells)
    cell_idx = [np.where(sb.cell_of == ci)[0] for ci in range(n_cells)]
    # The greedy baseline was dispatched by the sweep: reuse it.
    greedy_ref = (res.greedy_makespan, base_carbon)
    learned: dict[int, dict] = {}
    step_seconds: dict[str, list] = {}
    for sx_val in spec.stretches:
        # Best fixed policy at this stretch per cell: the learner's init,
        # and the fallback where training does not improve on it.
        pol = np.where(np.isclose(sx, float(sx_val)))[0]
        theta0 = np.zeros(n_cells, np.float32)
        window0 = np.zeros(n_cells, np.int32)
        fixed_best = np.zeros(n_cells)
        for ci in range(n_cells):
            psav = sav[np.ix_(cell_idx[ci], pol)].mean(axis=0)
            j = pol[int(psav.argmax())]
            theta0[ci], window0[ci] = th[j], wi[j]
            fixed_best[ci] = psav.max()
        wins = window0[sb.cell_of]
        tr = train(sb.batch, sb.intensity, sb.cum, sb.cell_of, wins,
                   float(sx_val), theta0, cfg=learn, baseline=greedy_ref)
        step_seconds[str(float(sx_val))] = tr.step_seconds
        theta_l = tr.theta.cpu().numpy()
        s_l = score(sb.batch, sb.intensity, sb.cum, theta_l[sb.cell_of],
                    wins, float(sx_val), baseline=greedy_ref)[0]
        s_l = s_l.cpu().numpy()
        for ci in range(n_cells):
            lsav = float(s_l[cell_idx[ci]].mean())
            improved = lsav > float(fixed_best[ci]) + 1e-12
            learned.setdefault(ci, {})[str(float(sx_val))] = {
                "theta": round(float(theta_l[ci] if improved
                                     else theta0[ci]), 4),
                "init_theta": round(float(theta0[ci]), 4),
                "window": int(window0[ci]),
                "savings_pct": round(
                    100 * max(lsav, float(fixed_best[ci])), 3),
                "trained_savings_pct": round(100 * lsav, 3),
                "fixed_best_savings_pct": round(
                    100 * float(fixed_best[ci]), 3),
                "improved": bool(improved),
            }
    return learned, step_seconds


def learned_summary(rows: list[dict]) -> tuple[dict, bool]:
    """Learned vs best-fixed savings per family x stretch.

    Returns ``(summary, acceptance)``: per family and stretch the mean
    learned and mean best-fixed savings over cells (the same stretch
    budget for both), and whether the learned policy is ``>=`` the fixed
    grid everywhere.
    """
    fams: dict = {}
    for r in rows:
        for sx_key, cell in r.get("learned", {}).items():
            d = fams.setdefault(r["family"], {}).setdefault(
                sx_key, {"learned": [], "fixed": [], "improved": 0})
            d["learned"].append(cell["savings_pct"])
            d["fixed"].append(cell["fixed_best_savings_pct"])
            d["improved"] += int(cell["improved"])
    out: dict = {}
    ok = True
    for fam, by_sx in sorted(fams.items()):
        out[fam] = {}
        for sx_key, d in sorted(by_sx.items()):
            lm = float(np.mean(d["learned"]))
            fm = float(np.mean(d["fixed"]))
            ok = ok and lm >= fm - 1e-9
            out[fam][sx_key] = {
                "learned_savings_pct": round(lm, 3),
                "fixed_best_savings_pct": round(fm, 3),
                "improved_cells": int(d["improved"]),
                "cells": len(d["learned"]),
            }
    return out, bool(ok)


def trend_summary(rows: list[dict]) -> dict:
    """Savings vs structure / server count, averaged over the other axes:
    the qualitative shape the paper reports."""
    def mean_by(key, field):
        out: dict = {}
        for r in rows:
            if field in r:
                out.setdefault(r[key], []).append(r[field])
        return {k: round(float(np.mean(v)), 3) for k, v in sorted(out.items())}

    summary = {
        "online_best_savings_pct_by_family":
            mean_by("family", "online_best_savings_pct"),
        "online_best_savings_pct_by_machines":
            mean_by("n_machines", "online_best_savings_pct"),
        "online_best_savings_pct_by_fleet":
            mean_by("fleet", "online_best_savings_pct"),
    }
    if any("offline_bound_savings_pct" in r for r in rows):
        summary.update({
            "offline_bound_savings_pct_by_family":
                mean_by("family", "offline_bound_savings_pct"),
            "offline_bound_savings_pct_by_machines":
                mean_by("n_machines", "offline_bound_savings_pct"),
        })
    return summary
