"""Structured event tracing with a Chrome-trace/Perfetto exporter, and the
program's span ring.

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
around one call, ended when the call returns.  The card is never waited
for: where the call leaves work on a CUDA device, a CUDA event pair
recorded around it gives the span's ``args.device_ms``, resolved only
when the log is read (:attr:`Tracer.events`) or exported.

**The span ring.**  :func:`span` is the program's one span system: a
``with span(name, **attrs):`` block records ``(name, start_ns, end_ns,
parent, attrs)`` into :data:`RING`, a process-wide ring of
:data:`RING_SLOTS` preallocated slots (oldest overwritten, counted in
:attr:`SpanRing.dropped`).  Stamps are ``time.time_ns()``; ``parent`` is
the span open on the same thread at entry.  Attributes are host values
(arguments, shapes).  A span never touches the device, never
synchronises and hooks nothing of the interpreter or the profiler, so the
ring is on by default, as a flight recorder: :func:`record_spans`
``(False)`` makes :func:`span` return a shared no-op.
:func:`spans_between` reads the spans of an interval back
(``docs/observability_torch.md``).

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
                            (args.first_call marks the first per name,
                            args.device_ms the card's time where it had
                            any)
``repro_torch.*``     X     the ring's spans, on the host track
====================  ====  =====================================================

Enable globally with ``REPRO_TRACE=1`` (checked on every
:func:`get_tracer` call, so tests can monkeypatch the environment), or
pass an explicit :class:`Tracer` to an engine.  Export with
:meth:`Tracer.export` and open the JSON at https://ui.perfetto.dev.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Callable, NamedTuple

import torch

# Exported simulation timebase: 1 epoch = 1 ms = 1000 Chrome-trace us.
US_PER_EPOCH = 1000

# pids separate the two clocks into two Perfetto process groups.
PID_SIM = 1        # simulation events, epoch timebase
PID_WALL = 2       # host wall-clock spans (jit compile / warm steps)

# tids on the simulation track: lanes occupy 0..n_lanes-1, these sit below.
TID_COUNTERS = 1000
TID_EVENTS = 1001
# tid of the ring's spans on the host track (the timed calls' is 0).
TID_SPANS = 1

RING_SLOTS = 1 << 16


# ---------------------------------------------------------------------------
# The span ring.
# ---------------------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One finished span as :func:`spans_between` returns it."""
    name: str
    start_ns: int               # time.time_ns() at entry
    end_ns: int                 # time.time_ns() at exit
    parent: int | None          # the parent's index in the same list
    attrs: dict


class SpanRing:
    """A bounded ring of finished spans: ``slots`` preallocated, the
    oldest overwritten, :attr:`dropped` counting those lost.  Spans are
    written as they end, from any thread: each takes the next number of
    an ``itertools.count`` (atomic under the interpreter lock) and its
    slot from it, so a write takes no lock."""

    def __init__(self, slots: int = RING_SLOTS):
        self._slots: list[tuple | None] = [None] * slots
        self._seq = itertools.count()

    def add(self, name: str, start_ns: int, end_ns: int, sid: int,
            parent: int | None, attrs: dict) -> None:
        """Write one span (``sid`` its id, ``parent`` its parent's)."""
        i = next(self._seq)
        self._slots[i % len(self._slots)] = (i, name, start_ns, end_ns, sid,
                                             parent, attrs)

    def _numbered(self) -> list[tuple]:
        return sorted(r for r in list(self._slots) if r is not None)

    @property
    def dropped(self) -> int:
        held = self._numbered()
        return held[-1][0] + 1 - len(held) if held else 0

    def held(self) -> tuple[list[tuple], int]:
        """The records held, oldest first, as ``(name, start_ns, end_ns,
        sid, parent, attrs)``, and the horizon: every span that started
        after it is held (0 while none was dropped).  Spans are written
        as they end, so a dropped one ended by the end of the oldest
        held."""
        held = self._numbered()
        dropped = held and held[-1][0] + 1 > len(held)
        return [r[1:] for r in held], held[0][3] if dropped else 0


class _Open(threading.local):
    """Each thread's stack of open span ids."""

    def __init__(self):
        self.stack: list[int] = []


class _Span:
    __slots__ = ("name", "attrs", "sid", "parent", "start_ns", "stack")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.stack = stack = _OPEN.stack
        self.parent = stack[-1] if stack else None
        self.sid = next(_IDS)
        stack.append(self.sid)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        self.stack.pop()
        RING.add(self.name, self.start_ns, end_ns, self.sid, self.parent,
                 self.attrs)
        return False

    def set(self, **attrs: Any) -> None:
        """Attributes known only inside the block."""
        self.attrs.update(attrs)


class _NoSpan:
    """What :func:`span` returns with the ring off: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


RING = SpanRing()
NO_SPAN = _NoSpan()
_OPEN = _Open()
_IDS = itertools.count()
_RECORD = True


def record_spans(on: bool) -> bool:
    """Turn the span ring on or off; returns the previous setting."""
    global _RECORD
    was, _RECORD = _RECORD, bool(on)
    return was


def span(name: str, **attrs: Any):
    """A context manager recording one span into :data:`RING` (host values
    only in ``attrs``); the shared :data:`NO_SPAN` with the ring off."""
    return _Span(name, attrs) if _RECORD else NO_SPAN


def spans_between(t0_ns: int, t1_ns: int,
                  ring: SpanRing | None = None) -> list[SpanRecord] | None:
    """The spans of ``ring`` (:data:`RING`) lying inside ``[t0_ns,
    t1_ns]`` (``time.time_ns()`` stamps), outer first, each ``parent`` the
    index of its parent in the list (None: no parent inside it); None
    where the ring has dropped part of the interval."""
    recs, horizon = (RING if ring is None else ring).held()
    if t0_ns <= horizon:
        return None
    inside = sorted((r for r in recs if r[1] >= t0_ns and r[2] <= t1_ns),
                    key=lambda r: (r[1], -r[2]))
    index = {r[3]: i for i, r in enumerate(inside)}
    return [SpanRecord(r[0], r[1], r[2], index.get(r[4]), r[5])
            for r in inside]


class Tracer:
    """In-memory structured event log (host-side only; see module doc)."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._events: list[dict] = []
        self._first_calls: set[str] = set()
        # Timed calls' CUDA event pairs, resolved when the log is read.
        self._pending: list[tuple[dict, Any, Any]] = []
        self._born_ns = time.time_ns()

    @property
    def events(self) -> list[dict]:
        """The log, with every timed call's ``args.device_ms`` resolved
        (waiting for the card's events, never for the card)."""
        for e, start, end in self._pending:
            end.synchronize()
            e["args"]["device_ms"] = start.elapsed_time(end)
        self._pending.clear()
        return self._events

    # -- simulation-clock records (timestamps are epochs) -------------------

    def instant(self, name: str, t: int, **args: Any) -> None:
        """Point event at epoch ``t`` (admission, rejection, eviction...)."""
        self._events.append({"name": name, "ph": "i", "t": int(t),
                             "args": args})

    def span(self, name: str, t0: int, t1: int, lane: int | None = None,
             **args: Any) -> None:
        """Duration event over epochs ``[t0, t1)`` — a lane-occupancy bar."""
        self._events.append({"name": name, "ph": "X", "t": int(t0),
                             "dur": max(int(t1) - int(t0), 0),
                             "lane": lane, "args": args})

    def counter(self, name: str, t: int, value: float) -> None:
        """Counter track sample at epoch ``t`` (gate state, occupancy...)."""
        self._events.append({"name": name, "ph": "C", "t": int(t),
                             "value": float(value)})

    # -- wall-clock records --------------------------------------------------

    def wall_span(self, name: str, seconds: float, **args: Any) -> None:
        """Host wall-clock span that just ended (duration known)."""
        self._events.append({"name": name, "ph": "X",
                             "wall_end": self._clock(),
                             "wall_dur": float(seconds), "args": args})

    def timed(self, name: str, fn: Callable, *args: Any, **kwargs: Any):
        """Call ``fn`` and record its wall-clock span as ``xla:<name>``.

        The counterpart of the reference's ``Tracer.timed``.  The span ends
        when ``fn`` returns; the card is not waited for.  Where the process
        has a CUDA context and the result holds a tensor on the current
        device, a CUDA event pair recorded on its current stream around the
        call gives ``args.device_ms``, resolved when the log is read.  The
        first call per ``name`` is flagged ``first_call=True``; later calls
        are warm.
        """
        first = name not in self._first_calls
        self._first_calls.add(name)
        start = _cuda_event()
        t0 = self._clock()
        out = fn(*args, **kwargs)
        self.wall_span(f"xla:{name}", self._clock() - t0, first_call=first)
        if start is not None and torch.device(
                "cuda", torch.cuda.current_device()) in _cuda_devices(out):
            self._pending.append((self._events[-1], start, _cuda_event()))
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
        events = self.events
        # The ring's spans since this tracer was made (those it still
        # holds), moved onto the tracer's clock by one reading of each.
        now_ns = time.time_ns()
        ring = spans_between(max(self._born_ns, RING.held()[1] + 1),
                             now_ns) or []
        off_s = now_ns / 1e9 - self._clock() if ring else 0.0
        wall0 = min([e["wall_end"] - e["wall_dur"] for e in events
                     if "wall_end" in e]
                    + [r.start_ns / 1e9 - off_s for r in ring], default=0.0)
        if ring:
            out.append({"ph": "M", "pid": PID_WALL, "tid": TID_SPANS,
                        "name": "thread_name",
                        "args": {"name": "program spans"}})
        for r in ring:
            out.append({"name": r.name, "ph": "X", "pid": PID_WALL,
                        "tid": TID_SPANS,
                        "ts": (r.start_ns / 1e9 - off_s - wall0) * 1e6,
                        "dur": (r.end_ns - r.start_ns) / 1e3,
                        "args": r.attrs})
        for e in events:
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
            json.dump(self.to_chrome_trace(lane_names), f, default=str)
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


def _cuda_event():
    """A timing event recorded on the current CUDA stream, where the
    process has a CUDA context (None where it has none)."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


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
