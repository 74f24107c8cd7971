"""Spans at the program's layer boundaries, and the reduction of a profiled
sample to spans, kernels, busy time and gaps.

The sample runs under ``torch.profiler`` with the device's activity only
(kernels, copies and sets, and the host's runtime calls that launched
them, joined by a correlation id).  Recording every host op as well
(which the program's ``record_function`` spans need) made a bound job
~1.5x longer on an H100 host and tripled the events the profiler keeps,
so the spans are taken here instead: :class:`SpanRecorder` marks
the entry and return of the program functions a driver names, through
``sys.monitoring`` events set on those functions' code alone (a few
thousand a job).  Both clocks are the wall clock in ns; one
``torch.cuda.synchronize`` at the sample's start, seen on both sides,
fixes the offset between them.

:func:`reduce_events` reads the profiler's raw events once, without
building the profiler's own event tree, and keeps in memory:

* every span, with its parent;
* every device operation, attributed through its launch's host time to
  the innermost span open at it;
* the busy time (the union of device operations) inside the sample's
  ``portbench.job`` span, and the idle gaps, each labelled with the
  innermost span the host was in when the gap began;
* as :attr:`Trace.host`, the spans of another job that ran under the
  recorder alone, whose host walls the profiler did not slow.

:class:`CallTap` takes the arguments and value of one program call the
same way, for the comparison with the reference.

Metric readers (``portbench/metrics/<name>.py``) take a :class:`Trace`.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import sys
import time

JOB_SPAN = "portbench.job"
SYNC_CALL = "cudaDeviceSynchronize"


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    parent: int = -1          # index of the enclosing span, -1 for none
    device_ns: int = 0        # device time launched inside it, inclusive

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Trace:
    spans: list[Span]
    ops_ns: dict[str, int]        # device time by operation name
    ops_count: dict[str, int]     # device operations by name
    busy_ns: int                  # union of device operations in the job
    window_ns: int                # the sampled job's host span
    gaps_ns: dict[str, int]       # idle time by what the host was in
    # The spans of a job run without the profiler, for host walls that
    # the profiler's own cost would distort (no device operations).
    host: "Trace | None" = None

    def named(self, name: str) -> list[int]:
        return [i for i, s in enumerate(self.spans) if s.name == name]

    def ancestor(self, i: int, name: str) -> int:
        """The nearest enclosing span of ``name`` of span ``i``, or -1."""
        p = self.spans[i].parent
        while p >= 0 and self.spans[p].name != name:
            p = self.spans[p].parent
        return p

    def has_child(self, i: int, name: str) -> bool:
        return any(s.parent == i and s.name == name for s in self.spans)

    def kernels_matching(self, part: str) -> tuple[int, int]:
        """Total device ns and count of the operations whose name holds
        ``part``."""
        ns = sum(v for k, v in self.ops_ns.items() if part in k)
        n = sum(v for k, v in self.ops_count.items() if part in k)
        return ns, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops_ns.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps_ns.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:200], v / 1e9] for k, v in ops],
                "idle_gaps": [[k, v / 1e9] for k, v in gaps]}


def _nest(spans: list[Span]) -> list[Span]:
    """Sort spans by start (outer first) and set each one's parent."""
    spans.sort(key=lambda s: (s.start_ns, -s.end_ns))
    stack: list[int] = []
    for i, s in enumerate(spans):
        while stack and spans[stack[-1]].end_ns <= s.start_ns:
            stack.pop()
        s.parent = stack[-1] if stack else -1
        stack.append(i)
    return spans


def _innermost(spans: list[Span], times: list[int]) -> list[int]:
    """For each host time, the innermost span open at it (-1: none)."""
    starts = [s.start_ns for s in spans]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i].end_ns < t:
            i = spans[i].parent
        out.append(i)
    return out


class _Monitor:
    """``sys.monitoring`` of the entry and return of some program
    functions, on a tool id of its own while entered."""

    def __init__(self, targets: dict[str, str]):
        self.codes = {}
        for name, where in targets.items():
            mod, fn = where.split(":")
            fn = getattr(importlib.import_module(mod), fn, None)
            if fn is not None:       # gone from the program: not monitored
                self.codes[fn.__code__] = name

    def _start(self, code, offset):
        raise NotImplementedError

    def _return(self, code, offset, value):
        raise NotImplementedError

    def __enter__(self):
        mon = sys.monitoring
        self.tool = next(i for i in (2, 3, 4) if mon.get_tool(i) is None)
        mon.use_tool_id(self.tool, "portbench")
        mon.register_callback(self.tool, mon.events.PY_START, self._start)
        mon.register_callback(self.tool, mon.events.PY_RETURN, self._return)
        for code in self.codes:
            mon.set_local_events(self.tool, code,
                                 mon.events.PY_START | mon.events.PY_RETURN)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        for code in self.codes:
            mon.set_local_events(self.tool, code, 0)
        mon.register_callback(self.tool, mon.events.PY_START, None)
        mon.register_callback(self.tool, mon.events.PY_RETURN, None)
        mon.free_tool_id(self.tool)
        return False


class SpanRecorder(_Monitor):
    """Spans of the program functions ``targets`` names (``{span name:
    "module:function"}``), recorded on entry and return while entered."""

    def __init__(self, targets: dict[str, str]):
        super().__init__(targets)
        self.spans: list[Span] = []
        self._open: list[tuple[str, int]] = []

    def _start(self, code, offset):
        self._open.append((self.codes[code], time.time_ns()))

    def _return(self, code, offset, value):
        name, t0 = self._open.pop()
        self.spans.append(Span(name, t0, time.time_ns()))


class CallTap(_Monitor):
    """The arguments and the value of one call of a program function
    (``"module:function"``), taken while entered without replacing it.

    Calls whose arguments ``keep(args)`` accepts are counted from 0; the
    ``n``-th one hands its arguments to ``copy`` on entry and its value on
    return, and the copies stand in :attr:`args` and :attr:`value` (None
    where fewer calls came).
    """

    def __init__(self, where: str, n: int, keep, copy):
        super().__init__({where: where})
        self.n, self.keep, self.copy = n, keep, copy
        self.args = self.value = None
        self._count = 0
        self._open: list[bool] = []

    def _start(self, code, offset):
        args = sys._getframe(1).f_locals
        take = False
        if self.keep(args):
            take = self._count == self.n
            self._count += 1
        if take:
            self.args = self.copy(args)
        self._open.append(take)

    def _return(self, code, offset, value):
        if self._open.pop():
            self.value = self.copy(value)


def reduce_events(events, device_cpu, spans: list[Span], mark_ns: int,
                  host_spans: list[Span] | None = None) -> Trace:
    """A :class:`Trace` of the profiler's raw events
    (``prof.profiler.kineto_results.events()``, device activity only) and
    the recorded ``spans``; ``device_cpu`` is the profiler's
    ``DeviceType.CPU``, ``mark_ns`` the wall clock just before the
    sample's first ``torch.cuda.synchronize``.  ``host_spans``, of a job
    run without the profiler, become its :attr:`Trace.host`."""
    launch: dict[int, int] = {}
    dev: list[tuple[str, int, int, int]] = []
    sync_ns = None
    for e in events:
        if e.device_type() == device_cpu:
            launch[e.correlation_id()] = e.start_ns()
            if sync_ns is None and e.name() == SYNC_CALL:
                sync_ns = e.start_ns()
        else:
            dev.append((e.name(), e.start_ns(), e.duration_ns(),
                        e.correlation_id()))
    offset = (sync_ns - mark_ns) if sync_ns is not None else 0
    spans = [Span(s.name, s.start_ns + offset, s.end_ns + offset)
             for s in spans]
    trace = build(spans, launch, dev)
    if host_spans:
        trace.host = build(list(host_spans), {}, [])
    return trace


def build(spans: list[Span], launch_ns: dict[int, int],
          dev: list[tuple[str, int, int, int]]) -> Trace:
    """The :class:`Trace` of spans, the host times of launches by
    correlation id, and device operations ``(name, start_ns, duration_ns,
    correlation)``, all on one clock."""
    spans = _nest(spans)
    jobs = [s for s in spans if s.name == JOB_SPAN]
    w0, w1 = ((jobs[0].start_ns, jobs[-1].end_ns) if jobs
              else (min((d[1] for d in dev), default=0),
                    max((d[1] + d[2] for d in dev), default=0)))

    launch = [launch_ns.get(d[3], -1) for d in dev]
    order = sorted(range(len(dev)), key=lambda i: launch[i])
    owner = dict(zip(order, _innermost(spans, [launch[i] for i in order])))
    ops_ns: dict[str, int] = {}
    ops_count: dict[str, int] = {}
    self_ns = [0] * len(spans)
    for i, (name, _, dur, _) in enumerate(dev):
        ops_ns[name] = ops_ns.get(name, 0) + dur
        ops_count[name] = ops_count.get(name, 0) + 1
        o = owner[i] if launch[i] >= 0 else -1
        if o >= 0:
            self_ns[o] += dur
    for i in range(len(spans) - 1, -1, -1):
        spans[i].device_ns += self_ns[i]
        p = spans[i].parent
        if p >= 0:
            spans[p].device_ns += spans[i].device_ns

    # Busy time and idle gaps inside the window.
    ivs = sorted((max(s, w0), min(s + d, w1)) for _, s, d, _ in dev
                 if s + d > w0 and s < w1)
    merged: list[list[int]] = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    labels = _innermost(spans, [g[0] for g in gaps])
    gaps_ns: dict[str, int] = {}
    for (a, b), lab in zip(gaps, labels):
        key = spans[lab].name if lab >= 0 else "outside any span"
        gaps_ns[key] = gaps_ns.get(key, 0) + (b - a)
    return Trace(spans, ops_ns, ops_count, busy, w1 - w0, gaps_ns)
