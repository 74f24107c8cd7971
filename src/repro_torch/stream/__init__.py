"""The streaming dispatch service on the port (counterpart of
``repro.stream``): arrival-process families and the lane-pool engine."""
from repro_torch.stream.arrivals import (ARRIVAL_NAMES, ARRIVALS, bursty,
                                         diurnal, poisson, sample_arrivals)
from repro_torch.stream.engine import (StreamConfig, StreamEngine, StreamJob,
                                       StreamResult, event_log,
                                       sample_stream_jobs, simulate_stream)

__all__ = [
    "ARRIVALS", "ARRIVAL_NAMES", "poisson", "bursty", "diurnal",
    "sample_arrivals", "StreamConfig", "StreamEngine", "StreamJob",
    "StreamResult", "event_log", "sample_stream_jobs", "simulate_stream",
]
