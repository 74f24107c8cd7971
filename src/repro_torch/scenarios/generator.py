"""Seeded scenario -> :class:`~repro_torch.core.instance.Instance` sampling.

A copy of ``repro.scenarios.generator`` (numpy only), held against it by
``tests/test_torch_scenarios.py``: the same seeds give the same instances.

A :class:`ScenarioConfig` names one *cell* of the structure space: a DAG
family with its ``(width, depth)`` shape knobs, a job count, a fleet (name +
machine count) and the duration/arrival distributions of the paper's
Section 3.1 (exp-distributed base durations, ceil to >= 1 epoch; arrivals
uniform over the next 24 h).  :func:`sample_instance` draws one instance
from a cell given an ``np.random.Generator``; determinism is entirely the
caller's rng seed, so equal seeds reproduce instances bit-for-bit across
processes (property-tested).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.instance import Instance, Job
from repro_torch.scenarios.families import FAMILY_NAMES, build_dag
from repro_torch.scenarios.fleets import FLEET_NAMES, build_fleet


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One cell of the scenario space (hashable, usable as a dict key)."""

    family: str = "layered"        # DAG family (see scenarios.families)
    n_jobs: int = 6                # jobs per instance
    width: int = 3                 # family width knob (parallelism)
    depth: int = 3                 # family depth knob (critical path)
    n_machines: int = 5            # fleet size
    fleet: str = "homog"           # fleet generator (see scenarios.fleets)
    mean_dur: float = 7.0          # exp mean of base durations (epochs)
    arrival_horizon: int = 96      # arrivals uniform in [0, horizon)

    def validate(self) -> "ScenarioConfig":
        if self.family not in FAMILY_NAMES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.fleet not in FLEET_NAMES:
            raise ValueError(f"unknown fleet {self.fleet!r}")
        if min(self.n_jobs, self.width, self.depth, self.n_machines) < 1:
            raise ValueError(f"non-positive scenario dimension in {self}")
        return self

    def label(self) -> str:
        return (f"{self.family}-w{self.width}d{self.depth}"
                f"-j{self.n_jobs}-m{self.n_machines}-{self.fleet}")


def sample_job(rng: np.random.Generator, cfg: ScenarioConfig) -> Job:
    """One job: a family DAG plus exp(mean_dur) durations and a uniform
    arrival epoch."""
    k, edges = build_dag(cfg.family, rng, cfg.width, cfg.depth)
    durs = np.maximum(1, np.ceil(rng.exponential(cfg.mean_dur, size=k)))
    arrival = int(rng.integers(0, cfg.arrival_horizon))
    return Job(arrival=arrival,
               base_durations=tuple(int(d) for d in durs),
               edges=edges)


def sample_instance(rng: np.random.Generator, cfg: ScenarioConfig) -> Instance:
    """Draw one instance from a scenario cell."""
    cfg.validate()
    jobs = tuple(sample_job(rng, cfg) for _ in range(cfg.n_jobs))
    powers, speeds = build_fleet(cfg.fleet, rng, cfg.n_machines)
    return Instance(jobs=jobs, powers_kw=powers, speeds=speeds)


def sample_batch(rng: np.random.Generator, cfg: ScenarioConfig,
                 n: int) -> list[Instance]:
    """Draw ``n`` independent instances from one cell."""
    return [sample_instance(rng, cfg) for _ in range(n)]
