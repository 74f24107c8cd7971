"""The bench's provenance, synced timing and pinned perf probes.

The counterpart of ``benchmarks/common.py``'s harness half (provenance,
``BenchTimer``, the probe cells), for the port on the card.

* **Provenance**: every record :func:`write_json` writes is stamped with
  the git SHA and dirty flag, torch, CUDA and python versions, the
  machine fingerprint (backend, device name and count, power limit, CPU
  count, machine) and a timestamp, so a number traces back to the code
  and hardware that produced it.
* **Timing**: :class:`BenchTimer` synchronises the device inside the
  timed region (kernel launches return before the card finishes), with
  an injectable clock; a cold call (kernel build or load, plus one
  execution) is kept apart from warm ones.
* **Probe cells**: four small seed-pinned calls (the reference's batch:
  seed 7, horizon 256, 4 instances) through the port's hot paths: the
  dispatch sweep, the gate learner's training, population fitness
  (``schedule_eval``) and the gate (``gate_quantile``).  Each is timed
  cold and warm, and counted once by ``launch.op_analysis`` for its
  achieved-vs-roofline columns at the card's constants.
  ``repro_torch.perf_gate`` compares fresh warm times against a stored
  baseline.

Every entry takes ``device`` (default ``"cuda"``) and raises without a
card unless asked for the CPU.
"""
from __future__ import annotations

import functools
import json
import os
import platform
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import generate_instance, pack, stack_packed, synthesize
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         ".."))


# ---------------------------------------------------------------------------
# Provenance.
# ---------------------------------------------------------------------------

def _git(*args: str) -> str:
    try:
        return subprocess.run(
            ["git", "-C", REPO_ROOT, *args], capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def machine_fingerprint(device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The fields that must match for wall-clock comparisons to mean
    anything: the perf gate refuses to compare across fingerprints."""
    from repro_torch.bench import power_limit
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    return {
        "backend": dev.type,
        "device_kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "power_limit": power_limit(dev),
        "cpu_count": os.cpu_count(),
        "machine": platform.machine(),
    }


def provenance(device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Git SHA and dirty flag, torch / CUDA / python versions, the machine
    fingerprint, the process count (a ``torch.distributed`` fleet's world
    size) and a UTC timestamp."""
    dist = torch.distributed
    return {
        "git_sha": _git("rev-parse", "HEAD") or "unknown",
        "git_dirty": bool(_git("status", "--porcelain")),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "python": platform.python_version(),
        **machine_fingerprint(device),
        "processes": (dist.get_world_size()
                      if dist.is_available() and dist.is_initialized()
                      else 1),
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


# ---------------------------------------------------------------------------
# Timing.
# ---------------------------------------------------------------------------

class BenchTimer:
    """Synced timing on ``device`` with an injectable clock (tests fake
    it)."""

    def __init__(self, device: str | torch.device = DEFAULT_DEVICE,
                 clock: Callable[[], float] = time.perf_counter):
        self.device = resolve_device(device)
        self.clock = clock

    def timed(self, fn: Callable, *args, **kwargs):
        """``(result, seconds)``, the device synchronised before the clock
        starts and before it stops: queued work neither leaks in nor
        out."""
        synchronize(self.device)
        t0 = self.clock()
        out = fn(*args, **kwargs)
        synchronize(self.device)
        return out, self.clock() - t0

    def cold_warm(self, fn: Callable, *args, warm_reps: int = 3, **kwargs):
        """One cold call (kernel build or load, plus one execution) then
        ``warm_reps`` warm calls: ``(result, {"compile_s",
        "warm_s_median", "warm_s_all"})``."""
        out, cold = self.timed(fn, *args, **kwargs)
        warms = [self.timed(fn, *args, **kwargs)[1]
                 for _ in range(warm_reps)]
        return out, {
            "compile_s": round(cold, 6),
            "warm_s_median": round(float(np.median(warms)), 6),
            "warm_s_all": [round(w, 6) for w in warms],
        }


# ---------------------------------------------------------------------------
# The pinned perf-probe cells.
# ---------------------------------------------------------------------------

PROBE_SEED = 7
PROBE_HORIZON = 256
PROBE_WARM_REPS = 7


def _probe_batch(device, n_instances: int = 4):
    """The reference's pinned instance batch and carbon windows."""
    rng = np.random.default_rng(PROBE_SEED)
    year = synthesize("AU-SA", days=30, seed=PROBE_SEED)
    packs, intens, cums = [], [], []
    for _ in range(n_instances):
        inst = generate_instance(rng, n_jobs=4, k_tasks=3, n_machines=3)
        packs.append(pack(inst, pad_tasks=12, device=device))
        w = year.window(int(rng.integers(0, year.n_epochs - PROBE_HORIZON)),
                        PROBE_HORIZON)
        intens.append(w.intensity)
        cums.append(w.cumulative())
    return (stack_packed(packs),
            torch.as_tensor(np.stack(intens), dtype=torch.float32,
                            device=device),
            torch.as_tensor(np.stack(cums), dtype=torch.float32,
                            device=device))


def _dispatch_probe(device):
    from repro_torch.core.solvers.online_torch import _sweep
    batch, inten, _ = _probe_batch(device)
    args = (batch, inten, torch.tensor([0.3, 0.5], device=device),
            torch.tensor([48], dtype=torch.int32, device=device),
            torch.tensor([1.25, 1.5], device=device))
    return functools.partial(_sweep, n_epochs=PROBE_HORIZON, max_window=48,
                             machine_rule="earliest_finish"), args


def _learn_probe(device):
    from repro_torch.learn import LearnConfig
    from repro_torch.learn.train import _train, greedy_reference
    batch, inten, cum = _probe_batch(device)
    B = int(inten.shape[0])
    ms0, base_c = greedy_reference(batch, cum, PROBE_HORIZON,
                                   "earliest_finish")
    budget = (1.5 * ms0.to(torch.float32)).to(torch.int32)
    theta0 = torch.tensor([0.5], device=device)
    raw0 = torch.stack([torch.log(theta0 / (1 - theta0)),
                        torch.zeros_like(theta0)], dim=1)
    args = (batch, inten, cum, torch.zeros((B,), dtype=torch.int32,
                                           device=device),
            torch.full((B,), 48, dtype=torch.int32, device=device), budget,
            base_c, ms0, torch.zeros(inten.shape, device=device), raw0)
    return functools.partial(_train, cfg=LearnConfig(steps=4),
                             max_window=48, n_epochs=PROBE_HORIZON), args


def _fitness_probe(device):
    from repro_torch.core.solvers.common import (TorchDraws,
                                                 population_fitness,
                                                 random_allowed_assign)
    batch, _, cums = _probe_batch(device)
    inst = type(batch)(*(f[0] for f in batch))
    draws = TorchDraws(PROBE_SEED, device)
    P = 64
    prio = draws.normal((P, inst.T))
    assign = random_allowed_assign(draws, inst, (P,))
    args = (inst, cums[0], PROBE_HORIZON, prio, assign)
    return functools.partial(population_fitness, objective="carbon",
                             machine_rule="fixed", sweeps=2), args


def _gate_probe(device):
    from repro_torch.core.solvers.online_torch import dirty_mask
    _, inten, _ = _probe_batch(device)
    return functools.partial(dirty_mask, max_window=48), (inten, 0.4, 48)


# name -> (entry, build).  ``entry`` is the dotted path of the function
# the cell times, stamped into every probe block so
# ``perf_gate --check-provenance`` can fail a record whose probes name an
# entry point that no longer exists.
PROBE_CELLS = {
    "dispatch_sweep": ("repro_torch.core.solvers.online_torch._sweep",
                       _dispatch_probe),
    "learn_step": ("repro_torch.learn.train._train", _learn_probe),
    "fitness": ("repro_torch.kernels.ops.population_carbon",
                _fitness_probe),
    "gate": ("repro_torch.kernels.ops.gate_threshold", _gate_probe),
}


def _probe_cell(build: Callable, timer: BenchTimer) -> dict:
    from repro_torch.launch.op_analysis import (count, cost_dict,
                                                memory_dict)
    from repro_torch.launch.roofline import achieved_vs_roofline
    fn, args = build(timer.device)
    _, timing = timer.cold_warm(fn, *args, warm_reps=PROBE_WARM_REPS)
    _, mode = count(fn, *args)
    return {
        **timing,
        # warm_s_min is the gate quantity (the best rep is the program's
        # floor; medians carry host jitter).
        "warm_s_min": min(timing["warm_s_all"]),
        "roofline": achieved_vs_roofline(cost_dict(mode),
                                         timing["warm_s_median"]),
        "memory": memory_dict(mode),
    }


@functools.lru_cache(maxsize=2)
def _cached_probe(device: str) -> dict:
    timer = BenchTimer(device)
    return {
        "cells": {name: {"entry": entry, **_probe_cell(build, timer)}
                  for name, (entry, build) in PROBE_CELLS.items()},
        "warm_reps": PROBE_WARM_REPS,
        "fingerprint": machine_fingerprint(device),
    }


def perf_probe(fresh: bool = False,
               device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Time the pinned probe cells on ``device`` (cached per process): the
    cold call apart from ``PROBE_WARM_REPS`` synced warm calls, and each
    cell's achieved-vs-roofline record.  This dict is what
    ``repro_torch.perf_gate`` compares against stored baselines."""
    dev = str(resolve_device(device))
    if fresh:
        _cached_probe.cache_clear()
    return json.loads(json.dumps(_cached_probe(dev)))   # defensive copy


def bench_timing(wall_s: float, probe: bool = True,
                 device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """The standard ``timing`` block of a record."""
    out = {"wall_s": round(float(wall_s), 3)}
    if probe:
        out["probe"] = perf_probe(device=device)
    return out


def write_json(path: str, record: dict,
               device: str | torch.device = DEFAULT_DEVICE) -> str:
    """Write a record as pretty JSON, stamped with :func:`provenance`
    unless the caller already gave one.  On a ``torch.distributed``
    fleet only rank 0 writes (results are replicated)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return path
    if "provenance" not in record:
        record = {**record, "provenance": provenance(device)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=2, sort_keys=True)
        f.write("\n")
    return path
