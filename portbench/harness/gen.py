"""Instances and carbon windows from the seed: the benchmark's own copy.

Copied so that later changes to the program cannot move the yardstick:

* :func:`sample_job`, :func:`generate_instance` and the DAG shapes copy
  ``src/repro_torch/core/instance.py`` (itself a copy of the reference's);
* :func:`synthesize` and :class:`CarbonTrace` copy
  ``src/repro_torch/core/carbon.py``;
* :func:`paper_draw` copies the draw of ``repro_torch.bench.paper_batch``
  (an instance, then its window's start, per instance, from one
  ``default_rng``).

Everything here is NumPy; the program's ``pack`` turns an instance into
its tensors.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

EPOCH_HOURS = 0.25          # 15-minute epochs
EPOCHS_PER_HOUR = 4
DAG_SHAPES = ("chain", "branch", "fanout")


@dataclasses.dataclass(frozen=True)
class Job:
    arrival: int
    base_durations: tuple[int, ...]     # epochs on a speed-1 server
    edges: tuple[tuple[int, int], ...]  # (u, v): u before v, u < v


@dataclasses.dataclass(frozen=True)
class Instance:
    jobs: tuple[Job, ...]
    powers_kw: tuple[float, ...]
    speeds: tuple[float, ...]


def chain_edges(k: int) -> tuple[tuple[int, int], ...]:
    return tuple((i, i + 1) for i in range(k - 1))


def branch_edges(k: int) -> tuple[tuple[int, int], ...]:
    if k <= 2:
        return chain_edges(k)
    return ((0, 1), (0, 2)) + tuple((v - 2, v) for v in range(3, k))


def fanout_edges(k: int) -> tuple[tuple[int, int], ...]:
    return tuple((0, v) for v in range(1, k))


_EDGE_FNS = {"chain": chain_edges, "branch": branch_edges,
             "fanout": fanout_edges}


def sample_job(rng: np.random.Generator, k: int, mean_dur: float,
               arrival_horizon: int) -> Job:
    """Exponential durations (mean ``mean_dur`` epochs, ceil, >= 1), a
    uniform arrival in ``[0, arrival_horizon)``, a DAG of Fig. 3."""
    shape = DAG_SHAPES[rng.integers(len(DAG_SHAPES))]
    durs = np.maximum(1, np.ceil(rng.exponential(mean_dur, size=k))) \
        .astype(int)
    arrival = int(rng.integers(0, arrival_horizon))
    return Job(arrival=arrival, base_durations=tuple(int(d) for d in durs),
               edges=_EDGE_FNS[shape](k))


def generate_instance(rng: np.random.Generator, fleet: dict) -> Instance:
    """One instance of ``fleet`` (a configuration's ``instance`` group)."""
    jobs = tuple(sample_job(rng, fleet["k_tasks"], fleet["mean_dur"],
                            fleet["arrival_horizon"])
                 for _ in range(fleet["n_jobs"]))
    return Instance(jobs=jobs, powers_kw=tuple(fleet["powers_kw"]),
                    speeds=tuple(fleet["speeds"]))


@dataclasses.dataclass(frozen=True)
class CarbonTrace:
    name: str
    intensity: np.ndarray  # float32 [E], gCO2/kWh an epoch

    @property
    def n_epochs(self) -> int:
        return int(self.intensity.shape[0])

    def window(self, start_epoch: int, length: int) -> "CarbonTrace":
        idx = (start_epoch + np.arange(length)) % self.n_epochs
        return CarbonTrace(self.name, self.intensity[idx])


# name: (mean, diurnal_amp, solar_depth, noise_std, seasonal_amp); floor 5.
REGIONS = {
    "AU-SA": (170.0, 110.0, 120.0, 45.0, 25.0),
    "CAL": (240.0, 70.0, 140.0, 30.0, 30.0),
    "TEX": (420.0, 55.0, 45.0, 25.0, 20.0),
    "CA-ON": (45.0, 28.0, 10.0, 12.0, 8.0),
}
_FLOOR = 5.0


def synthesize(region: str, days: int, seed: int) -> CarbonTrace:
    """The deterministic synthetic year of ``region`` (hourly, repeated to
    15-minute epochs)."""
    mean, diurnal_amp, solar_depth, noise_std, seasonal_amp = REGIONS[region]
    rng = np.random.default_rng((seed, zlib.crc32(region.encode()) & 0xFFFF))
    hours = days * 24
    t = np.arange(hours, dtype=np.float64)
    hod = t % 24.0
    doy = t / 24.0
    diurnal = diurnal_amp * np.sin((hod - 9.0) / 24.0 * 2 * np.pi)
    season = 1.0 + 0.35 * np.sin((doy - 15.0) / 366.0 * 2 * np.pi)
    solar = -solar_depth * season * np.exp(-0.5 * ((hod - 12.5) / 2.6) ** 2)
    seasonal = seasonal_amp * np.sin((doy - 30.0) / 366.0 * 2 * np.pi)
    eps = rng.normal(0.0, noise_std, size=hours)
    noise = np.empty(hours)
    acc = 0.0
    for i in range(hours):
        acc = 0.82 * acc + eps[i]
        noise[i] = acc
    noise *= np.sqrt(1 - 0.82 ** 2)
    hourly = np.maximum(_FLOOR, mean + diurnal + solar + seasonal + noise)
    per_epoch = np.repeat(hourly, EPOCHS_PER_HOUR).astype(np.float32)
    return CarbonTrace(region, per_epoch)


def year_trace(trace_cfg: dict) -> CarbonTrace:
    """The year a configuration's windows are cut from."""
    return synthesize(trace_cfg["region"], trace_cfg["days"],
                      trace_cfg["seed"])


def paper_draw(rng: np.random.Generator, n: int, fleet: dict,
               year: CarbonTrace, horizon: int
               ) -> tuple[list[Instance], np.ndarray]:
    """``n`` instances and their windows' starts, in the order of
    ``repro_torch.bench.paper_batch``: an instance, then its start."""
    insts, starts = [], []
    for _ in range(n):
        insts.append(generate_instance(rng, fleet))
        starts.append(int(rng.integers(0, year.n_epochs - horizon)))
    return insts, np.asarray(starts, dtype=np.int64)


def window_starts(rng: np.random.Generator, n: int, year: CarbonTrace,
                  horizon: int) -> np.ndarray:
    """``n`` window starts, each with a whole window inside the year."""
    return rng.integers(0, year.n_epochs - horizon, size=n)


def windows(year: CarbonTrace, starts: np.ndarray, horizon: int
            ) -> tuple[np.ndarray, np.ndarray]:
    """The windows' intensities, float32 ``[n, horizon]``, and their
    cumulative traces ``cum[e] = sum_{e' < e} I[e'] * EPOCH_HOURS``,
    summed in float64 and held in float32, ``[n, horizon + 1]`` (the
    program's ``CarbonTrace.cumulative``)."""
    intens = np.stack([year.window(int(s), horizon).intensity
                       for s in starts])
    cum = np.zeros((len(starts), horizon + 1), dtype=np.float64)
    np.cumsum(intens.astype(np.float64) * EPOCH_HOURS, axis=1,
              out=cum[:, 1:])
    return intens, cum.astype(np.float32)
