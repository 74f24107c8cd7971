"""The program's own spans in the job a traced run records without the
profiler, for the readers of ``source: program_span`` metrics.

The window is that job's ``repro_torch.solve_bilevel`` span as the
harness recorded it (``trace.host``); the spans inside it come from the
program's span ring (``repro_torch.obs.trace.spans_between``), stamped on
the same clock (``time.time_ns()``).  Both helpers return None where the
program has no ring (a checkout from before it) or the ring dropped part
of the window.
"""
from __future__ import annotations

JOB = "repro_torch.solve_bilevel"


def program_spans(trace):
    """The program's spans inside the unprofiled job's bound, or None."""
    host = trace.host
    if host is None:
        return None
    job = host.named(JOB)
    if len(job) != 1:
        return None
    try:
        from repro_torch.obs.trace import spans_between
    except ImportError:
        return None
    s = host.spans[job[0]]
    return spans_between(s.start_ns, s.end_ns)


def phase_wall(trace, name: str) -> float | None:
    """The summed wall of the program's ``name`` spans in the window (s),
    or None where there are none."""
    walls = [s.end_ns - s.start_ns for s in program_spans(trace) or ()
             if s.name == name]
    return sum(walls) / 1e9 if walls else None
