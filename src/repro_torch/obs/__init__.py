"""Host-side observability: event tracing and metrics.

The counterpart of ``repro.obs``: :mod:`repro_torch.obs.metrics` is a copy
of the reference's registry, :mod:`repro_torch.obs.trace` its tracer, with
:func:`~repro_torch.obs.trace.traced_call` for the reference's
``traced_xla_call``.  Telemetry never touches what the engines compute.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, Tracer,  # noqa: F401
                                   get_tracer, set_tracer, trace_enabled,
                                   traced_call)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "Tracer", "get_tracer", "set_tracer", "trace_enabled",
    "traced_call",
]
