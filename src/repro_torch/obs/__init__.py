"""Host-side observability: event tracing, the span ring and metrics.

The counterpart of ``repro.obs``: :mod:`repro_torch.obs.metrics` is a copy
of the reference's registry, :mod:`repro_torch.obs.trace` its tracer, with
:func:`~repro_torch.obs.trace.traced_call` for the reference's
``traced_xla_call``.  :func:`~repro_torch.obs.trace.span` records the
program's own spans into a process-wide ring (on by default), read back by
:func:`~repro_torch.obs.trace.spans_between`.  Telemetry never touches what
the engines compute.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, RING, Tracer,  # noqa: F401
                                   get_tracer, record_spans, set_tracer,
                                   span, spans_between, trace_enabled,
                                   traced_call)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "RING", "Tracer", "get_tracer", "record_spans",
    "set_tracer", "span", "spans_between", "trace_enabled", "traced_call",
]
