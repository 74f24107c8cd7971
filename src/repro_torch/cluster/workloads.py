"""ML batch workloads as FJSP instances (DAG templates over real archs).

The counterpart of ``repro.cluster.workloads``, copied (numpy only): the
same specs and seeds give the same :class:`Instance`, field for field, and
the rng is drawn in the reference's order.

Three job templates, mirroring both the paper's Fig. 3 structures and its
motivating examples (§2 "Example Job: Offline Inference"):

  offline_inference : load -> infer (xN shards, fan-out) -> store
  train_pipeline    : data_prep -> train -> eval  (chain; the train task is
                      `n_steps` of a real (arch x shape) cell)
  finetune_sweep    : prep -> {k parallel finetune branches} (branch)

Each task's per-machine duration/energy comes from the roofline energy
model, so the generated instances are paper-shaped (exponential-ish task
lengths, 15-min epochs) but grounded in the actual architectures this
framework trains/serves.  ``make_cluster_instance`` returns a standard
:class:`repro_torch.core.instance.Instance`, so every solver in
``repro_torch.core`` (and the executor's re-solve) consumes it unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster.energy_model import (MachineClass,
                                              TPU_V5E_CLASSES, task_profile)
from repro_torch.configs import ARCHS
from repro_torch.core.instance import Instance, Job
from repro_torch.models.common import ArchConfig

TEMPLATES = ("offline_inference", "train_pipeline", "finetune_sweep")


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    template: str
    arch: str
    shape: str
    n_steps: int              # steps of the core (train/infer) tasks
    arrival: int = 0          # epoch


def _template_tasks(spec: WorkloadSpec, rng: np.random.Generator
                    ) -> tuple[tuple[int, ...], tuple[tuple[int, int], ...],
                               list[float]]:
    """Returns (core_steps per task, edges, io_scale per task).

    io_scale < 1 marks light CPU-ish stages (load/store/eval) whose
    duration doesn't scale with the accelerator's speed tier.
    """
    if spec.template == "offline_inference":
        shards = int(rng.integers(2, 5))
        steps = [0] + [spec.n_steps] * shards + [0]
        edges = [(0, i) for i in range(1, shards + 1)] + \
                [(i, shards + 1) for i in range(1, shards + 1)]
        io = [0.3] + [1.0] * shards + [0.3]
        return tuple(steps), tuple(edges), io
    if spec.template == "train_pipeline":
        steps = [0, spec.n_steps, max(spec.n_steps // 8, 1)]
        return tuple(steps), ((0, 1), (1, 2)), [0.3, 1.0, 1.0]
    if spec.template == "finetune_sweep":
        k = int(rng.integers(2, 4))
        steps = [0] + [spec.n_steps] * k
        return tuple(steps), tuple((0, i) for i in range(1, k + 1)), \
            [0.3] + [1.0] * k
    raise ValueError(f"unknown template {spec.template!r}")


def make_cluster_instance(specs: list[WorkloadSpec],
                          classes: tuple[MachineClass, ...] = TPU_V5E_CLASSES,
                          seed: int = 0) -> Instance:
    """Build an FJSP Instance whose baseline durations are epochs on the
    *middle* class; the Instance speed table rescales per tier (the same
    mechanism as the paper's heterogeneous setup)."""
    rng = np.random.default_rng(seed)
    base = classes[len(classes) // 2]
    jobs = []
    for spec in specs:
        cfg: ArchConfig = ARCHS[spec.arch]
        core_epochs, _ = task_profile(cfg, spec.shape, spec.n_steps, base)
        steps, edges, io = _template_tasks(spec, rng)
        durs = []
        for s, scale in zip(steps, io):
            if s == 0:        # IO/prep stage: short, speed-independent-ish
                durs.append(max(1, int(round(core_epochs * scale * 0.2))))
            else:
                d = task_profile(cfg, spec.shape, s, base)[0]
                durs.append(max(1, d))
        jobs.append(Job(arrival=spec.arrival,
                        base_durations=tuple(durs), edges=edges))
    speeds = tuple(m.throughput / base.throughput for m in classes)
    powers = tuple(m.power_kw for m in classes)
    return Instance(jobs=tuple(jobs), powers_kw=powers, speeds=speeds)


def sample_daily_batch(rng: np.random.Generator, n_jobs: int = 8,
                       arrival_horizon: int = 96) -> list[WorkloadSpec]:
    """A day's batch: random mix of templates over the smaller archs."""
    small = ["qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b", "minitron-4b",
             "whisper-base"]
    out = []
    for _ in range(n_jobs):
        out.append(WorkloadSpec(
            template=TEMPLATES[rng.integers(len(TEMPLATES))],
            arch=small[rng.integers(len(small))],
            shape="train_4k",
            n_steps=int(rng.integers(50, 400)),
            arrival=int(rng.integers(0, arrival_horizon))))
    return out
