"""Structured event tracing with a Chrome-trace/Perfetto exporter.

The counterpart of ``repro.obs.trace``: the same :class:`Tracer`, null
tracer and global switch (``REPRO_TRACE=1``), and the same constraints:

1. **Telemetry never changes results.**  Every record call happens on the
   host, around the engine's steps, reading values computed anyway.
2. **Zero overhead when off.**  The default is :data:`NULL_TRACER`, whose
   record methods are empty; per-tick loops of record calls guard on
   ``tracer.enabled``.
3. **Two clocks.**  Engine events are stamped in ticks (the simulation
   clock); host wall-clock spans use an injectable ``clock``.

:meth:`Tracer.timed` and :func:`traced_call` are the counterparts of the
reference's ``Tracer.timed`` and ``traced_xla_call``: a wall-clock span
around one call, ended after the card has finished the call's work
(``torch.cuda.synchronize`` where the reference has
``jax.block_until_ready``).

Event vocabulary (the schema ``docs/observability.md`` documents):

====================  ====  =====================================================
name                  ph    meaning
====================  ====  =====================================================
``job:<rid>``         X     lane-occupancy span, admission -> completion
``admit``             i     job admitted (lane, rid, queue_delay, budget,
                            carbon intensity at dispatch time)
``reject``            i     job rejected (too late to finish greedily)
``evict``             i     job evicted from its lane (carbon, savings)
``gate``              C     carbon gate state per tick (dirty 0/1)
``carbon_gpkwh``      C     carbon intensity at the tick
``lanes_active``      C     occupied lanes per tick
``queue_len``         C     jobs waiting for a lane per tick
``forecast_resolve``  i     MPC/forecast re-quantile boundary
``xla:<name>``        X     wall-clock span of one timed call
                            (args.first_call marks the first per name)
====================  ====  =====================================================

Enable globally with ``REPRO_TRACE=1`` (checked on every
:func:`get_tracer` call, so tests can monkeypatch the environment), or
pass an explicit :class:`Tracer` to an engine.  Export with
:meth:`Tracer.export` and open the JSON at https://ui.perfetto.dev.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable

import torch

# Exported simulation timebase: 1 epoch = 1 ms = 1000 Chrome-trace us.
US_PER_EPOCH = 1000

# pids separate the two clocks into two Perfetto process groups.
PID_SIM = 1        # simulation events, epoch timebase
PID_WALL = 2       # host wall-clock spans (jit compile / warm steps)

# tids on the simulation track: lanes occupy 0..n_lanes-1, these sit below.
TID_COUNTERS = 1000
TID_EVENTS = 1001


class Tracer:
    """In-memory structured event log (host-side only; see module doc)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.events: list[dict] = []
        self._first_calls: set[str] = set()

    # -- simulation-clock records (timestamps are epochs) -------------------

    def instant(self, name: str, t: int, **args: Any) -> None:
        """Point event at epoch ``t`` (admission, rejection, eviction...)."""
        self.events.append({"name": name, "ph": "i", "t": int(t),
                            "args": args})

    def span(self, name: str, t0: int, t1: int, lane: int | None = None,
             **args: Any) -> None:
        """Duration event over epochs ``[t0, t1)`` — a lane-occupancy bar."""
        self.events.append({"name": name, "ph": "X", "t": int(t0),
                            "dur": max(int(t1) - int(t0), 0),
                            "lane": lane, "args": args})

    def counter(self, name: str, t: int, value: float) -> None:
        """Counter track sample at epoch ``t`` (gate state, occupancy...)."""
        self.events.append({"name": name, "ph": "C", "t": int(t),
                            "value": float(value)})

    # -- wall-clock records --------------------------------------------------

    def wall_span(self, name: str, seconds: float, **args: Any) -> None:
        """Host wall-clock span that just ended (duration known)."""
        self.events.append({"name": name, "ph": "X", "wall_end": self._clock(),
                            "wall_dur": float(seconds), "args": args})

    def timed(self, name: str, fn: Callable, *args: Any, **kwargs: Any):
        """Call ``fn`` and record its wall-clock span as ``xla:<name>``.

        The counterpart of the reference's ``Tracer.timed``.  Before the
        span ends, every CUDA device that holds a tensor of the result is
        synchronised, so the span covers the card's work (the values are
        unchanged).  The first call per ``name`` is flagged
        ``first_call=True``; later calls are warm.
        """
        first = name not in self._first_calls
        self._first_calls.add(name)
        t0 = self._clock()
        out = fn(*args, **kwargs)
        for dev in _cuda_devices(out):
            torch.cuda.synchronize(dev)
        self.wall_span(f"xla:{name}", self._clock() - t0, first_call=first)
        return out

    # -- export ----------------------------------------------------------------

    def to_chrome_trace(self, lane_names: dict[int, str] | None = None
                        ) -> dict:
        """Render the log as a Chrome-trace/Perfetto ``traceEvents`` dict.

        Simulation events land on pid 1 (lanes as threads, counters on a
        counter track); wall-clock spans on pid 2.  Load the JSON in
        https://ui.perfetto.dev (or chrome://tracing) to see the lane x time
        timeline next to the carbon/gate counter tracks.
        """
        out: list[dict] = [
            {"ph": "M", "pid": PID_SIM, "name": "process_name",
             "args": {"name": "simulation (1 epoch = 1 ms)"}},
            {"ph": "M", "pid": PID_WALL, "name": "process_name",
             "args": {"name": "host wall clock"}},
            {"ph": "M", "pid": PID_SIM, "tid": TID_EVENTS,
             "name": "thread_name", "args": {"name": "events"}},
        ]
        for lane, label in (lane_names or {}).items():
            out.append({"ph": "M", "pid": PID_SIM, "tid": int(lane),
                        "name": "thread_name", "args": {"name": label}})
        wall0 = min((e["wall_end"] - e["wall_dur"] for e in self.events
                     if "wall_end" in e), default=0.0)
        for e in self.events:
            if "wall_end" in e:                       # host wall-clock span
                start_us = (e["wall_end"] - e["wall_dur"] - wall0) * 1e6
                out.append({"name": e["name"], "ph": "X", "pid": PID_WALL,
                            "tid": 0, "ts": start_us,
                            "dur": e["wall_dur"] * 1e6,
                            "args": e.get("args", {})})
                continue
            ts = e["t"] * US_PER_EPOCH
            if e["ph"] == "C":
                out.append({"name": e["name"], "ph": "C", "pid": PID_SIM,
                            "tid": TID_COUNTERS, "ts": ts,
                            "args": {"value": e["value"]}})
            elif e["ph"] == "X":
                tid = e["lane"] if e.get("lane") is not None else TID_EVENTS
                out.append({"name": e["name"], "ph": "X", "pid": PID_SIM,
                            "tid": int(tid), "ts": ts,
                            "dur": e["dur"] * US_PER_EPOCH,
                            "args": e.get("args", {})})
            else:
                out.append({"name": e["name"], "ph": "i", "pid": PID_SIM,
                            "tid": TID_EVENTS, "ts": ts, "s": "t",
                            "args": e.get("args", {})})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str, lane_names: dict[int, str] | None = None
               ) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(lane_names), f)
            f.write("\n")
        return path


class _NullTracer(Tracer):
    """The off switch: every record method is a no-op (and ``enabled`` is
    False so per-tick record loops can skip building their arguments)."""

    enabled = False

    def __init__(self):
        super().__init__()

    def instant(self, *a: Any, **k: Any) -> None:
        pass

    def span(self, *a: Any, **k: Any) -> None:
        pass

    def counter(self, *a: Any, **k: Any) -> None:
        pass

    def wall_span(self, *a: Any, **k: Any) -> None:
        pass

    def timed(self, name: str, fn: Callable, *args: Any, **kwargs: Any):
        return fn(*args, **kwargs)


NULL_TRACER = _NullTracer()

_GLOBAL: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> None:
    """Install (or clear) the process-global tracer."""
    global _GLOBAL
    _GLOBAL = tracer


def trace_enabled() -> bool:
    """True when a global tracer is installed or ``REPRO_TRACE`` is set to a
    truthy value.  Reads the environment on every call so tests can
    monkeypatch it."""
    if _GLOBAL is not None:
        return True
    return os.environ.get("REPRO_TRACE", "") not in ("", "0")


def get_tracer() -> Tracer:
    """The ambient tracer: the installed global, a fresh env-enabled one, or
    :data:`NULL_TRACER`.  ``REPRO_TRACE=1`` lazily installs a global tracer
    on first use so one process-wide log accumulates across engines."""
    global _GLOBAL
    if _GLOBAL is not None:
        return _GLOBAL
    if os.environ.get("REPRO_TRACE", "") not in ("", "0"):
        _GLOBAL = Tracer()
        return _GLOBAL
    return NULL_TRACER


def _cuda_devices(out: Any) -> set[torch.device]:
    """The CUDA devices of every tensor in ``out`` (nested tuples, lists
    and dicts, named tuples included)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*map(_cuda_devices, out)) if out else set()
    return set()


def traced_call(name: str, fn: Callable, *args: Any, **kwargs: Any):
    """Host-side span around one entry point's call.

    The counterpart of the reference's ``traced_xla_call``.  With tracing
    off this is exactly ``fn(*args, **kwargs)``: no clock read, no
    synchronisation.  With tracing on it is :meth:`Tracer.timed` on the
    ambient tracer.  Values are the same either way.
    """
    tracer = get_tracer()
    if not tracer.enabled:
        return fn(*args, **kwargs)
    return tracer.timed(name, fn, *args, **kwargs)
