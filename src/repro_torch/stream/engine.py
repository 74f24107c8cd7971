"""Streaming dispatch service: continuous DAG arrivals into a lane pool.

The counterpart of ``repro.stream.engine``, held against it and its two
goldens by ``tests/test_torch_stream.py`` and
``tests/test_torch_stream_shared.py``.  The shape is the serve engine's
continuous batching, reused for scheduling:

* a fixed pool of ``n_lanes`` slot lanes, each holding one admitted DAG job
  packed to a static ``(pad_tasks, n_machines)`` shape (free lanes carry
  :func:`repro_torch.scenarios.batching.padding_rows`-style inert padding,
  so the pool tensors never change shape);
* **one gate-and-dispatch step over the whole pool per tick** —
  :func:`~repro_torch.core.solvers.online_torch.dispatch_epoch_shared`
  over the lane axis (partitioned) or lane by lane in priority order
  (shared), gated by the carbon quantile threshold (day-ahead
  :func:`~repro_torch.core.solvers.online_torch.dirty_mask`, or
  forecast-banded via :func:`repro_torch.forecast.rolling.
  rolling_dirty_mask` when ``forecast_every`` is set), built once per
  engine in one ``gate_quantile`` launch;
* admission runs a greedy solve per job: it fixes the job's stretch budget
  and its carbon/energy baseline;
* completed jobs are evicted and their lanes refilled from the queue
  (:class:`repro_torch.serve.lanes.LanePool`) — FIFO by default, or
  shortest-critical-path-first under backlog (``admission="scpf"``).

Two fleet modes:

* ``shared_fleet=False`` (default) — each lane is an independent fleet
  partition, so gating couples jobs only through *lane occupancy*:
  delaying a job keeps its lane busy longer and later arrivals queue.
* ``shared_fleet=True`` — every lane contends for ONE pool-global machine
  set: the machine free-times ``mfree [M]`` are threaded through the lanes
  in deterministic priority order (earliest admission first, rid
  tie-break), so one lane's placements consume machine time that later
  lanes see *within the same epoch*.  Admission's greedy budget solve
  starts from the live shared free-times.

Where the reference jits its pool programs, the port runs them as plain
functions on tensors.  The host reads the device three times: once a tick
(the lanes' done flags and completion epochs), once an admission and once
an eviction, each one copy (:func:`_to_host`); the admission's greedy
solve also reads its early-exit flag every
:data:`~repro_torch.core.solvers.online_torch.EXIT_CHECK_EVERY` epochs.

Contracts: with every arrival at t=0 and enough lanes, each partitioned
job's schedule equals the batched
:func:`~repro_torch.core.solvers.online_torch.online_carbon_gated_torch`
(and the reference's ``online_carbon_gated_jax``); the whole run is a pure
function of the seed; the shared step depends only on the lanes' priority
order; every evicted schedule passes the validator, and shared-fleet
evictions are checked for cross-lane machine overlap.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import types
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import validate
from repro_torch.core.carbon import (EPOCHS_PER_DAY, CarbonTrace,
                                     sample_window, synthesize)
from repro_torch.core.instance import Instance, Job, PackedInstance, pack
from repro_torch.core.objectives import Objectives, evaluate
from repro_torch.core.solvers.common import Draws, TorchDraws
from repro_torch.core.solvers.online_torch import (LaneState, dirty_mask,
                                                   dispatch_epoch_shared,
                                                   downstream_critical_path,
                                                   init_lane_state,
                                                   simulate_online)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.forecast.rolling import n_replans, rolling_dirty_mask
from repro_torch.obs import MetricsRegistry, Tracer, get_tracer
from repro_torch.scenarios.batching import padding_rows
from repro_torch.scenarios.fleets import build_fleet
from repro_torch.scenarios.generator import ScenarioConfig, sample_job
from repro_torch.serve.lanes import LanePool
from repro_torch.stream.arrivals import ARRIVAL_NAMES, sample_arrivals


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """One streaming scenario: traffic shape x job shape x pool x gate.

    The reference's fields exactly; the device is an argument of
    :class:`StreamEngine` and :func:`simulate_stream`.
    """

    arrivals: str = "poisson"      # arrival family (stream.arrivals)
    rate: float = 0.05             # mean jobs per epoch
    horizon: int = 1024            # stream length (epochs)
    n_lanes: int = 8               # fixed lane-pool size
    family: str = "layered"        # DAG family of the arriving jobs
    width: int = 3
    depth: int = 2
    n_machines: int = 3            # machines per lane partition
    fleet: str = "homog"
    mean_dur: float = 5.0          # exp mean of base task durations
    theta: float = 0.5             # carbon-gate quantile
    window: int = 96               # gate look-ahead window (epochs)
    stretch: float = 1.5           # per-job stretch budget
    machine_rule: str = "earliest_finish"
    region: str = "AU-SA"
    seed: int = 0
    forecast_every: int | None = None   # None: exact day-ahead gate
    forecast_scale: float = 1.0
    forecast_model: str = "oracle_ar1"
    shared_fleet: bool = False     # lanes contend for one machine set
    admission: str = "fifo"        # lane-refill policy (ADMISSION_POLICIES)

    def validate(self) -> "StreamConfig":
        if self.arrivals not in ARRIVAL_NAMES:
            raise ValueError(f"unknown arrival family {self.arrivals!r}")
        if self.n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {self.n_lanes}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {self.admission!r}")
        return self


@dataclasses.dataclass
class StreamJob:
    """Host-side per-job record (the stream analogue of serve.Request)."""

    rid: int
    job: Job                        # job.arrival = stream arrival epoch
    inst: PackedInstance | None = None   # packed at admission (arrival = t)
    admitted: int = -1
    completed: int = -1             # absolute completion epoch
    budget: int = -1                # absolute stretch deadline
    greedy_makespan: int = -1       # absolute greedy completion (baseline)
    greedy_carbon: float = 0.0
    greedy_energy: float = 0.0
    carbon: float = 0.0
    energy: float = 0.0
    finished: bool = False
    truncated: bool = False         # fully placed, completes past the stream
    start: np.ndarray | None = None
    assign: np.ndarray | None = None

    @property
    def arrival(self) -> int:
        return self.job.arrival

    @property
    def queue_delay(self) -> int:
        """Epochs spent waiting for a free lane (-1 if never admitted)."""
        return self.admitted - self.job.arrival if self.admitted >= 0 else -1

    @property
    def carbon_savings(self) -> float:
        """1 - gated/greedy carbon (0 when unfinished or zero baseline)."""
        if not self.finished or self.greedy_carbon <= 0.0:
            return 0.0
        return 1.0 - self.carbon / self.greedy_carbon


# An un-observed histogram's snapshot (summary() placeholder).
_EMPTY_DIST = {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0, "max": 0.0}

# Admission-policy registry: "fifo" is queue order; "scpf" admits the
# shortest-critical-path job among those already arrived — both
# deterministic, rid tie-break.
ADMISSION_POLICIES = ("fifo", "scpf")


class StreamResult(NamedTuple):
    jobs: list[StreamJob]          # every stream job, rid order
    events: list[dict]             # serializable event log (golden-locked)
    meta: dict
    # StreamEngine.summary() of the run.  The default is an IMMUTABLE empty
    # mapping, so results built without a summary never share one mutable
    # dict; simulate_stream passes a fresh dict per result.
    summary: Mapping = types.MappingProxyType({})


# ---------------------------------------------------------------------------
# The pool programs: plain functions on tensors.
# ---------------------------------------------------------------------------

def _to_host(*xs: torch.Tensor) -> list[np.ndarray]:
    """Every tensor of ``xs`` on the host, in one device-to-host copy.

    Each is flattened into one float64 vector (exact for the int32, bool
    and float32 values read here) and split back; returns float64 numpy
    arrays in the tensors' shapes.
    """
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in xs]).cpu()
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].numpy().reshape(x.shape))
        i += x.numel()
    return out


def _admission_eval(inst: PackedInstance, cum: torch.Tensor,
                    stretch: torch.Tensor, admitted: int,
                    mfree0: torch.Tensor, n_epochs: int, machine_rule: str
                    ) -> tuple[torch.Tensor, torch.Tensor, Objectives,
                               torch.Tensor]:
    """Per-job admission solve (the scheduling analogue of serve prefill).

    Greedy-dispatches the job alone to fix the absolute stretch deadline
    ``admitted + int(stretch * greedy_relative)`` and the greedy
    carbon/energy baseline.  ``mfree0`` is the fleet the greedy starts on:
    zeros for a partitioned lane, the live shared free-times for a shared
    fleet.  The job arrives at ``admitted``, so the solve starts there.
    The budget's float32 cast chain (truncation toward zero) is the
    reference's, part of the closed-batch parity contract.
    """
    state0 = init_lane_state(inst.T, device=cum.device).merge(mfree0)
    g = simulate_online(inst, torch.zeros((n_epochs,), dtype=torch.bool,
                                          device=cum.device), 0, n_epochs,
                        machine_rule=machine_rule, state0=state0,
                        t0=admitted)
    obj = evaluate(inst, g.start, g.assign, cum)
    rel = (obj.makespan - admitted).to(torch.float32)
    budget = admitted + (stretch * rel).to(torch.int32)
    complete = (g.scheduled | ~inst.task_mask).all()
    return downstream_critical_path(inst), budget, obj, complete


def _lane_flags(pool: PackedInstance, lstate: LaneState
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-lane "all tasks placed" flags and completion epochs ``[L]``."""
    done = (lstate.scheduled | ~pool.task_mask).all(-1)
    comp = torch.where(pool.task_mask, lstate.comp, 0).amax(-1)
    return done, comp


def _pool_tick(pool: PackedInstance, cp: torch.Tensor, lstate: LaneState,
               mfree: torch.Tensor, dirty_t: torch.Tensor,
               budget: torch.Tensor, t: int, machine_rule: str):
    """ONE gate-and-dispatch step over the whole lane pool — epoch ``t``,
    partitioned fleets.

    One :func:`dispatch_epoch_shared` call over lead ``[L]``, each lane
    with its own machine row ``mfree[lane]`` (disjoint partitions: lanes
    cannot interact through machines), all under the gate bit ``dirty_t``.
    Returns the new pool state plus per-lane "all tasks placed" flags and
    completion epochs (the eviction signal).
    """
    lstate, mfree = dispatch_epoch_shared(pool, lstate, mfree, dirty_t,
                                          budget, t,
                                          machine_rule=machine_rule, cp=cp)
    return (lstate, mfree) + _lane_flags(pool, lstate)


def _pool_tick_shared(pool: PackedInstance, cp: torch.Tensor,
                      lstate: LaneState, mfree: torch.Tensor,
                      dirty_t: torch.Tensor, budget: torch.Tensor, t: int,
                      order: Sequence[int], machine_rule: str):
    """ONE gate-and-dispatch step over the lane pool — epoch ``t``, SHARED
    fleet.

    The lanes of ``order`` (the priority permutation) one after another,
    threading the single pool-global ``mfree [M]`` through every lane's
    :func:`dispatch_epoch_shared`, so a higher-priority lane's placements
    consume machine time that lower-priority lanes see within this same
    epoch.  Lanes are indexed by Python ints (views, no launch); each
    lane's new state goes back into its own row.  A lane left out of
    ``order`` keeps its state: free (padding) lanes place nothing and
    leave ``mfree`` untouched, so leaving them out is inert.  The result
    depends on ``order`` only through which *jobs* it ranks.
    """
    rows: dict[int, LaneState] = {}
    for lane in order:
        lane = int(lane)
        rows[lane], mfree = dispatch_epoch_shared(
            PackedInstance(*(f[lane] for f in pool)),
            LaneState(*(f[lane] for f in lstate)), mfree, dirty_t,
            budget[lane], t, machine_rule=machine_rule, cp=cp[lane])
    lstate = LaneState(*(
        torch.stack([rows[lane][i] if lane in rows else f[lane]
                     for lane in range(f.shape[0])])
        for i, f in enumerate(lstate)))
    return (lstate, mfree) + _lane_flags(pool, lstate)


def _insert_lane(pool: PackedInstance, cp: torch.Tensor, lstate: LaneState,
                 budget: torch.Tensor, lane: int, inst: PackedInstance,
                 job_cp: torch.Tensor, job_budget: torch.Tensor) -> None:
    """Insert one admitted job into ``lane``, in place: overwrite the
    lane's instance/cp/budget rows and zero its task-side progress.
    Machine free-times are NOT touched here — a partitioned lane's row is
    cleared separately, while a shared fleet's global ``mfree`` survives
    inserts unchanged (the machines stay busy whichever job a lane
    holds)."""
    for f, x in zip(pool, inst):
        f[lane] = x
    for f in lstate:
        f[lane] = 0
    cp[lane] = job_cp
    budget[lane] = job_budget


def _eval_schedule(inst: PackedInstance, start: torch.Tensor,
                   assign: torch.Tensor, cum: torch.Tensor
                   ) -> tuple[Objectives, torch.Tensor]:
    return (evaluate(inst, start, assign, cum),
            validate.total_violations(inst, start, assign))


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

class StreamEngine:
    """Long-running lane-pool dispatcher over one carbon trace, on
    ``device``.

    ``trace`` is the stream's global clock and carbon signal: epoch ``t`` of
    every lane is epoch ``t`` of the trace.  ``pad_tasks`` fixes the static
    task axis (jobs must fit); the fleet (``powers_kw``/``speeds``) is the
    per-lane machine partition.  The forecast-banded gate draws its noise
    ``xi [K, E]`` once, from ``draws`` (default ``TorchDraws(seed,
    "cpu")``, so that one seed gives one stream on every device); issue
    ``k`` reads row ``k``.  See the module docstring for
    semantics and contracts.
    """

    def __init__(self, trace: CarbonTrace, powers_kw: Sequence[float],
                 speeds: Sequence[float], n_lanes: int, pad_tasks: int, *,
                 theta: float = 0.5, window: int = 96, stretch: float = 1.5,
                 machine_rule: str = "earliest_finish",
                 forecast_every: int | None = None,
                 forecast_scale: float = 1.0,
                 forecast_model: str = "oracle_ar1", seed: int = 0,
                 validate_evictions: bool = True,
                 shared_fleet: bool = False, admission: str = "fifo",
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 draws: Draws | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        if machine_rule not in ("earliest_finish", "min_energy"):
            raise ValueError(f"unknown machine_rule {machine_rule!r}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {admission!r}")
        self.device = dev = resolve_device(device)
        # Telemetry is host-side only: the ambient tracer is a no-op unless
        # REPRO_TRACE=1 or a global tracer is installed; metrics are always
        # on (cheap Python around the host loop) and feed summary().
        self.tracer = tracer if tracer is not None else get_tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._wall_seen: set[str] = set()
        self.forecast_every = forecast_every
        self.trace = trace
        self.powers = tuple(float(p) for p in powers_kw)
        self.speeds = tuple(float(s) for s in speeds)
        self.T, self.M = int(pad_tasks), len(self.powers)
        self.E = trace.n_epochs
        self.stretch = float(stretch)
        self._stretch = torch.tensor(self.stretch, dtype=torch.float32,
                                     device=dev)
        self.machine_rule = machine_rule
        self.validate_evictions = bool(validate_evictions)
        self.shared_fleet = bool(shared_fleet)
        self.admission = admission
        self._cp_cache: dict[int, int] = {}   # rid -> critical path (scpf)
        intensity = torch.as_tensor(trace.intensity, dtype=torch.float32,
                                    device=dev)
        self.cum = torch.as_tensor(trace.cumulative(), device=dev)
        if forecast_every is None:
            # Exact day-ahead gate: identical thresholds to the batched path.
            self.dirty = dirty_mask(intensity, theta, window,
                                    max_window=int(window))
        else:
            # Forecast-banded gate: thresholds re-quantiled from rolling
            # imperfect forecasts (scale=0 reproduces the day-ahead gate),
            # all K issues in one gate_quantile launch.
            K = n_replans(self.E, int(forecast_every))
            draws = draws if draws is not None else TorchDraws(seed, "cpu")
            xi = draws.normal((K, self.E)).to(dev)
            self.dirty = rolling_dirty_mask(
                intensity, theta, window, xi, forecast_scale,
                every=int(forecast_every), max_window=int(window),
                model=forecast_model)
        # Host copies for telemetry reads.
        self._dirty_host = self.dirty.cpu().numpy()
        self._intensity_host = np.asarray(trace.intensity)
        self._idle_mfree = torch.zeros((self.M,), dtype=torch.int32,
                                       device=dev)
        self.pool = LanePool(n_lanes)
        self._reset_pool_state()

    def _reset_pool_state(self) -> None:
        L, T, M, dev = self.pool.n_lanes, self.T, self.M, self.device
        self.pool_inst = padding_rows(L, T, M, dev)      # inert free lanes
        self.lstate = init_lane_state(T, (L,), dev)
        # Machine free-times: pool-global [M] when the fleet is shared,
        # one disjoint partition row per lane [L, M] otherwise.
        self.mfree = torch.zeros((M,) if self.shared_fleet else (L, M),
                                 dtype=torch.int32, device=dev)
        self.cp = torch.zeros((L, T), dtype=torch.int32, device=dev)
        self.budget = torch.zeros((L,), dtype=torch.int32, device=dev)
        self._done = np.zeros(L, bool)
        self._comp = np.zeros(L, np.int64)
        # Shared-fleet eviction validation: per-machine (start, end, rid)
        # intervals of every schedule evicted this run.
        self._fleet_busy: list[list[tuple[int, int, int]]] = \
            [[] for _ in range(M)]

    # -- admission / eviction -------------------------------------------------

    def _admit_job(self, lane: int, sj: StreamJob, t: int) -> bool:
        job = dataclasses.replace(sj.job, arrival=t)   # can't start pre-lane
        inst = pack(Instance(jobs=(job,), powers_kw=self.powers,
                             speeds=self.speeds), pad_tasks=self.T,
                    device=self.device)
        # The greedy budget solve's starting fleet: idle for a partitioned
        # lane, the LIVE shared free-times otherwise.
        mfree0 = self.mfree if self.shared_fleet else self._idle_mfree
        t0 = time.perf_counter()
        cp, budget, obj, complete = _admission_eval(
            inst, self.cum, self._stretch, t, mfree0, n_epochs=self.E,
            machine_rule=self.machine_rule)
        # The one host read of the admission: the solve ran.
        complete_h, budget_h, ms_h, carbon_h, energy_h = _to_host(
            complete, budget, obj.makespan, obj.carbon, obj.energy)
        self._observe_wall("admission_wall_s", time.perf_counter() - t0)
        if not complete_h:
            # Too late even greedily: reject instead of wedging the lane.
            # The job surfaces with admitted == -1 / finished == False.
            self.metrics.counter("jobs_rejected").inc()
            self.tracer.instant("reject", t, rid=sj.rid,
                                arrival=int(sj.arrival))
            return False
        _insert_lane(self.pool_inst, self.cp, self.lstate, self.budget, lane,
                     inst, cp, budget)
        if not self.shared_fleet:
            # The previous occupant completed at or before t: its residual
            # free-times are stale by construction.
            self.mfree[lane] = 0
        sj.inst = inst
        sj.admitted = t
        sj.budget = int(budget_h)
        sj.greedy_makespan = int(ms_h)
        sj.greedy_carbon = float(carbon_h)
        sj.greedy_energy = float(energy_h)
        self.metrics.counter("jobs_admitted").inc()
        self.metrics.histogram("queue_delay_epochs").observe(sj.queue_delay)
        self.tracer.instant(
            "admit", t, rid=sj.rid, lane=lane, arrival=int(sj.arrival),
            queue_delay=int(sj.queue_delay), budget=int(sj.budget),
            carbon_gpkwh=round(float(self._intensity_host[t]), 3))
        return True

    def _finish(self, lane: int, sj: StreamJob,
                truncated: bool = False) -> None:
        self.pool.evict(lane)
        row = LaneState(*(f[lane] for f in self.lstate))
        obj, viol = _eval_schedule(sj.inst, row.start, row.assign, self.cum)
        # The one host read of the eviction.
        viol, carbon, energy, start, assign = _to_host(
            viol, obj.carbon, obj.energy, row.start, row.assign)
        start, assign = start.astype(np.int32), assign.astype(np.int32)
        if self.validate_evictions and int(viol) != 0:
            raise AssertionError(
                f"evicted job rid={sj.rid} has an infeasible schedule "
                f"(violation mass {int(viol)})")
        if self.shared_fleet and self.validate_evictions:
            self._check_fleet_overlap(sj, start, assign)
        sj.completed = int(self._comp[lane])
        sj.carbon = float(carbon)
        sj.energy = float(energy)
        sj.start = start
        sj.assign = assign
        sj.finished = True
        sj.truncated = bool(truncated)
        self.metrics.counter("jobs_completed").inc()
        if truncated:
            self.metrics.counter("jobs_truncated").inc()
        self.metrics.histogram("carbon_savings_pct").observe(
            100.0 * sj.carbon_savings)
        if self.tracer.enabled:
            self.tracer.span(f"job:{sj.rid}", sj.admitted, sj.completed,
                             lane=lane, rid=sj.rid,
                             carbon_g=round(sj.carbon, 3),
                             greedy_carbon_g=round(sj.greedy_carbon, 3),
                             savings_pct=round(100 * sj.carbon_savings, 2))
            self.tracer.instant("evict", sj.completed, rid=sj.rid, lane=lane,
                                truncated=sj.truncated)

    def _check_fleet_overlap(self, sj: StreamJob, start: np.ndarray,
                             assign: np.ndarray) -> None:
        """Shared-fleet eviction invariant: no task of this schedule may
        overlap, on its machine, any task of a schedule already evicted this
        run.  Per-lane validation can't see this (each lane's validator only
        knows its own job); the threaded ``mfree`` makes it hold by
        construction, and this check keeps it honest.  The durations come
        from the job on the host (its tasks are the packed rows
        ``0 .. n_tasks - 1``)."""
        dur = Instance(jobs=(sj.job,), powers_kw=self.powers,
                       speeds=self.speeds).durations_matrix()
        for ti in range(sj.job.n_tasks):
            m = int(assign[ti])
            s = int(start[ti])
            e = s + int(dur[ti, m])
            for (bs, be, brid) in self._fleet_busy[m]:
                if s < be and bs < e:
                    raise AssertionError(
                        f"shared-fleet overlap: rid={sj.rid} task {ti} "
                        f"[{s}, {e}) collides with rid={brid} "
                        f"[{bs}, {be}) on machine {m}")
            self._fleet_busy[m].append((s, e, sj.rid))

    # -- admission policy / lane priority -------------------------------------

    def _job_critical_path(self, sj: StreamJob) -> int:
        """Base-duration critical path of a job's DAG (machine-independent —
        the scpf admission key; cached per rid)."""
        got = self._cp_cache.get(sj.rid)
        if got is not None:
            return got
        job = sj.job
        cp = list(job.base_durations)
        succ: list[list[int]] = [[] for _ in range(job.n_tasks)]
        for u, v in job.edges:
            succ[u].append(v)
        for u in range(job.n_tasks - 1, -1, -1):
            if succ[u]:
                cp[u] = job.base_durations[u] + max(cp[v] for v in succ[u])
        val = max(cp, default=0)
        self._cp_cache[sj.rid] = val
        return val

    def _admission_select(self):
        """The LanePool ``select`` hook for the configured policy (None ==
        FIFO, the O(1) deque pop)."""
        if self.admission == "fifo":
            return None
        return lambda ready: min(
            range(len(ready)),
            key=lambda i: (self._job_critical_path(ready[i]), ready[i].rid))

    def _lane_order(self) -> list[int]:
        """Deterministic shared-fleet priority order for this tick: the
        occupied lanes by (admission epoch, rid) — earliest-admitted job
        wins machine contention.  Free lanes are inert and left out."""
        return [lane for _, _, lane in sorted(
            (sj.admitted, sj.rid, lane) for lane, sj in self.pool.active())]

    # -- telemetry ------------------------------------------------------------

    def _observe_wall(self, name: str, seconds: float) -> None:
        """Wall-clock split: the first call per name within a run lands in
        the ``*_first`` histogram (kernel builds and caches warming up),
        later calls in ``*_warm``."""
        first = name not in self._wall_seen
        self._wall_seen.add(name)
        suffix = "_first" if first else "_warm"
        self.metrics.histogram(name + suffix).observe(seconds)

    def _trace_tick(self, t: int, queue) -> None:
        """Per-tick trace samples (guarded: zero work when tracing is off)."""
        active = sum(1 for _ in self.pool.active())
        dirty = bool(self._dirty_host[t])
        self.tracer.counter("gate", t, 1.0 if dirty else 0.0)
        self.tracer.counter("carbon_gpkwh", t,
                            float(self._intensity_host[t]))
        self.tracer.counter("lanes_active", t, active)
        self.tracer.counter("queue_len", t, sum(
            1 for s in queue if s.job.arrival <= t))
        if dirty and any(not self._done[lane]
                         for lane, _ in self.pool.active()):
            # The gate is closed while admitted work is still unplaced —
            # this epoch's ready tasks are (budget permitting) deferred.
            self.tracer.instant("gate_defer", t)
        if self.forecast_every is not None and t % self.forecast_every == 0:
            # Forecast re-quantile boundary: the rolling gate's thresholds
            # from here on were re-solved with epoch-t information.
            self.tracer.instant("forecast_resolve", t)

    def summary(self) -> dict:
        """Aggregate view of the last ``run`` from the metrics registry:
        job counts, the queue-delay and savings distributions, final lane
        occupancy, and the first-call vs warm wall-clock split."""
        snap = self.metrics.snapshot()
        return {
            "jobs_admitted": snap.get("jobs_admitted", 0),
            "jobs_rejected": snap.get("jobs_rejected", 0),
            "jobs_completed": snap.get("jobs_completed", 0),
            "jobs_truncated": snap.get("jobs_truncated", 0),
            "queue_delay_epochs": snap.get(
                "queue_delay_epochs", dict(_EMPTY_DIST)),
            "carbon_savings_pct": snap.get(
                "carbon_savings_pct", dict(_EMPTY_DIST)),
            "final_lane_occupancy": snap.get("final_lane_occupancy", 0),
            "gate_closed_epochs": snap.get("gate_closed_epochs", 0),
            "ticks": snap.get("ticks", 0),
            "wall": {k: v for k, v in snap.items()
                     if k.startswith(("tick_wall_s", "admission_wall_s"))},
        }

    # -- main loop ------------------------------------------------------------

    def run(self, jobs: Sequence[Job]) -> list[StreamJob]:
        """Serve a finite stream of jobs; returns one StreamJob per input
        (rid = input index), finished or flagged ``finished=False``.

        The pool is drained before returning, so back-to-back ``run`` calls
        on one engine are independent.  Per-run telemetry accumulates in
        ``self.metrics`` (reset on entry; read it through :meth:`summary`)
        and, when tracing is enabled, in ``self.tracer``.
        """
        for j in jobs:
            if j.n_tasks > self.T:
                raise ValueError(f"job with {j.n_tasks} tasks exceeds "
                                 f"pad_tasks={self.T}")
        self.metrics.reset()
        self._wall_seen = set()
        sjobs = [StreamJob(rid=i, job=j) for i, j in enumerate(jobs)]
        # deque: the FIFO head pop in LanePool.admit is O(1).
        queue = collections.deque(
            sorted(sjobs, key=lambda s: (s.job.arrival, s.rid)))
        select = self._admission_select()
        t = 0
        while t < self.E - 1:
            # 1. evict lanes whose job finished executing by epoch t
            for lane, sj in list(self.pool.active()):
                if self._done[lane] and self._comp[lane] <= t:
                    self._finish(lane, sj)
            # 2. admit arrived jobs into the freed lanes (FIFO, or the
            #    configured policy over the ready prefix); jobs too close to
            #    the trace end to finish even greedily are rejected
            for lane, sj in self.pool.admit(
                    queue, ready=lambda s: s.job.arrival <= t,
                    select=select):
                if not self._admit_job(lane, sj, t):
                    self.pool.evict(lane)
                    sj.admitted = -1
            # 3. idle fast-forward: empty pool, next arrival in the future
            if not self.pool.any_active():
                if not queue:
                    break
                t = max(t + 1, int(queue[0].job.arrival))
                continue
            # 4. ONE gate-and-dispatch step over the whole pool
            if self.tracer.enabled:
                self._trace_tick(t, queue)
            t0 = time.perf_counter()
            if self.shared_fleet:
                self.lstate, self.mfree, done, comp = _pool_tick_shared(
                    self.pool_inst, self.cp, self.lstate, self.mfree,
                    self.dirty[t], self.budget, t, self._lane_order(),
                    machine_rule=self.machine_rule)
            else:
                self.lstate, self.mfree, done, comp = _pool_tick(
                    self.pool_inst, self.cp, self.lstate, self.mfree,
                    self.dirty[t], self.budget, t,
                    machine_rule=self.machine_rule)
            # The one host read of the tick.
            done, comp = _to_host(done, comp)
            self._done, self._comp = done.astype(bool), comp.astype(np.int64)
            self._observe_wall("tick_wall_s", time.perf_counter() - t0)
            self.metrics.counter("ticks").inc()
            if self._dirty_host[t]:
                self.metrics.counter("gate_closed_epochs").inc()
            t += 1
        # End-of-stream surfacing: any lane whose job is fully placed gets
        # its stats; those completing PAST the final tick evict with
        # truncated=True.
        for lane, sj in list(self.pool.active()):
            if self._done[lane]:
                self._finish(lane, sj,
                             truncated=bool(self._comp[lane] > t))
        self.metrics.gauge("final_lane_occupancy").set(
            sum(1 for _ in self.pool.active()))
        # drain: unfinished jobs surface flagged; the pool resets so the
        # engine is re-entrant (never re-dispatches stale lanes)
        self.pool.drain()
        self._reset_pool_state()
        return sjobs


# ---------------------------------------------------------------------------
# Scenario-level entry points.
# ---------------------------------------------------------------------------

def sample_stream_jobs(rng: np.random.Generator,
                       cfg: StreamConfig) -> list[Job]:
    """One DAG job per arrival: arrival epochs from the configured arrival
    family, DAG + durations from the scenario generator's job sampler."""
    cfg.validate()
    arrivals = sample_arrivals(cfg.arrivals, rng, cfg.rate, cfg.horizon)
    scen = ScenarioConfig(family=cfg.family, n_jobs=1, width=cfg.width,
                          depth=cfg.depth, n_machines=cfg.n_machines,
                          fleet=cfg.fleet, mean_dur=cfg.mean_dur).validate()
    return [dataclasses.replace(sample_job(rng, scen), arrival=int(a))
            for a in arrivals]


def event_log(jobs: Sequence[StreamJob]) -> list[dict]:
    """Serializable per-job event records, rid order — the replay artifact
    the goldens lock (same seed -> identical log)."""
    out = []
    for sj in sorted(jobs, key=lambda s: s.rid):
        ev = {
            "rid": sj.rid,
            "arrival": int(sj.arrival),
            "admitted": int(sj.admitted),
            "queue_delay": int(sj.queue_delay),
            "finished": bool(sj.finished),
        }
        if sj.admitted >= 0:
            ev.update({
                "budget": int(sj.budget),
                "greedy_makespan": int(sj.greedy_makespan),
                "greedy_carbon_g": round(float(sj.greedy_carbon), 3),
            })
        if sj.finished:
            ev.update({
                "completed": int(sj.completed),
                "carbon_g": round(float(sj.carbon), 3),
                "energy_kwh": round(float(sj.energy), 4),
                "carbon_savings_pct": round(100 * sj.carbon_savings, 3),
            })
        if sj.truncated:
            ev["truncated"] = True
        out.append(ev)
    return out


def stream_setup(cfg: StreamConfig, jobs: Sequence[Job] | None = None
                 ) -> tuple[list[Job], tuple, tuple, CarbonTrace]:
    """The scenario :func:`simulate_stream` runs: the jobs (``jobs``
    overrides the sampled stream), the fleet's powers and speeds, and the
    carbon window, all from ``cfg.seed``'s numpy stream."""
    cfg.validate()
    rng = np.random.default_rng(cfg.seed)
    if jobs is None:
        jobs = sample_stream_jobs(rng, cfg)
    powers, speeds = build_fleet(cfg.fleet, rng, cfg.n_machines)
    # Arrivals land in [0, horizon); the trace runs two days past it so
    # late arrivals (and stretch-delayed tails) have room to finish.
    n_epochs = cfg.horizon + 2 * EPOCHS_PER_DAY
    days = -(-n_epochs // EPOCHS_PER_DAY) + 2
    year = synthesize(cfg.region, days=days, seed=cfg.seed)
    return list(jobs), powers, speeds, sample_window(year, rng, n_epochs)


def simulate_stream(cfg: StreamConfig,
                    jobs: Sequence[Job] | None = None,
                    tracer: Tracer | None = None, *,
                    draws: Draws | None = None,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> StreamResult:
    """Run one streaming scenario end to end, deterministically, on
    ``device``.

    Everything derives from ``cfg.seed``: the arrival times, the job DAGs
    and durations, the fleet, and the carbon window (drawn from a
    synthesized year through :func:`repro_torch.core.carbon.
    sample_window`), from the same numpy streams as the reference.
    ``jobs`` overrides the sampled stream.  ``tracer`` (or
    ``REPRO_TRACE=1``) captures the run's event timeline.  ``draws`` feeds
    the forecast-banded gate's noise (default ``TorchDraws(cfg.seed,
    "cpu")``: the same noise whatever ``device``).
    """
    dev = resolve_device(device)
    jobs, powers, speeds, trace = stream_setup(cfg, jobs)
    pad_tasks = max((j.n_tasks for j in jobs), default=1)
    eng = StreamEngine(trace, powers, speeds, cfg.n_lanes, pad_tasks,
                       theta=cfg.theta, window=cfg.window,
                       stretch=cfg.stretch, machine_rule=cfg.machine_rule,
                       forecast_every=cfg.forecast_every,
                       forecast_scale=cfg.forecast_scale,
                       forecast_model=cfg.forecast_model, seed=cfg.seed,
                       shared_fleet=cfg.shared_fleet,
                       admission=cfg.admission, tracer=tracer, draws=draws,
                       device=dev)
    sjobs = eng.run(jobs)
    meta = {
        "config": {k: (v if v is None or isinstance(v, (int, float, str,
                                                        bool)) else str(v))
                   for k, v in dataclasses.asdict(cfg).items()},
        "n_jobs": len(sjobs),
        "n_finished": sum(sj.finished for sj in sjobs),
        "pad_tasks": pad_tasks,
        "n_epochs": trace.n_epochs,
    }
    return StreamResult(sjobs, event_log(sjobs), meta, eng.summary())
