"""Arrival-process families for continuous DAG job streams.

A numpy copy of ``repro.stream.arrivals``: seeded, parametric generators
of arrival epochs, one per traffic shape.  The same ``(family, rng seed,
rate, horizon)`` gives bit-identical epochs in both packages
(``tests/test_torch_stream.py``).

========== =====================================================
family     arrival process (rate = mean jobs per epoch)
========== =====================================================
poisson    homogeneous Poisson: iid exponential gaps
bursty     compound Poisson: burst centers at ``rate/mean_burst``,
           geometric(mean ``mean_burst``) jobs per burst arriving
           together — the queue-stressing shape
diurnal    inhomogeneous Poisson (thinning): intensity swings
           ``rate * (1 ± amp)`` over the 96-epoch day, peaking at
           ``peak_epoch`` — office-hours traffic
========== =====================================================

Arrival times are sorted, lie in ``[0, horizon)`` and honor ``rate`` in
expectation (each family's mean job count is ``rate * horizon``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.carbon import EPOCHS_PER_DAY


def poisson(rng: np.random.Generator, rate: float, horizon: int
            ) -> np.ndarray:
    """Homogeneous Poisson at ``rate`` jobs/epoch: exponential gaps."""
    times, t = [], float(rng.exponential(1.0 / rate))
    while t < horizon:
        times.append(t)
        t += float(rng.exponential(1.0 / rate))
    return np.asarray(times, dtype=np.float64)


def bursty(rng: np.random.Generator, rate: float, horizon: int,
           mean_burst: float = 4.0) -> np.ndarray:
    """Compound Poisson: Poisson burst centers at ``rate / mean_burst``,
    each burst geometric(mean ``mean_burst``) jobs arriving together —
    overall job rate is ``rate``, variance is ~``2 * mean_burst - 1`` times
    Poisson's, so equal-load streams stress the lane queue much harder."""
    centers = poisson(rng, rate / mean_burst, horizon)
    times: list[float] = []
    for c in centers:
        times.extend([float(c)] * int(rng.geometric(1.0 / mean_burst)))
    return np.asarray(times, dtype=np.float64)


def diurnal(rng: np.random.Generator, rate: float, horizon: int,
            amp: float = 0.8, peak_epoch: float = 56.0) -> np.ndarray:
    """Inhomogeneous Poisson via thinning: intensity
    ``rate * (1 + amp * cos(2*pi*(t - peak_epoch) / 96))`` — a day-periodic
    swing peaking at ``peak_epoch`` (default 14:00, office hours).  The
    cosine integrates to zero over a day, so the mean rate is ``rate``."""
    if not 0.0 <= amp <= 1.0:
        raise ValueError(f"diurnal amp must be in [0, 1], got {amp}")
    lam_max = rate * (1.0 + amp)
    times = []
    for t in poisson(rng, lam_max, horizon):
        lam = rate * (1.0 + amp * np.cos(
            2.0 * np.pi * (t - peak_epoch) / EPOCHS_PER_DAY))
        if float(rng.random()) * lam_max < lam:
            times.append(float(t))
    return np.asarray(times, dtype=np.float64)


ARRIVALS = {
    "poisson": poisson,
    "bursty": bursty,
    "diurnal": diurnal,
}

ARRIVAL_NAMES = tuple(ARRIVALS)


def sample_arrivals(family: str, rng: np.random.Generator, rate: float,
                    horizon: int) -> np.ndarray:
    """Sorted int32 arrival epochs in ``[0, horizon)`` from a named family."""
    try:
        fn = ARRIVALS[family]
    except KeyError:
        raise ValueError(f"unknown arrival family {family!r}; "
                         f"have {ARRIVAL_NAMES}") from None
    if rate <= 0.0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1 epoch, got {horizon}")
    times = fn(rng, rate, horizon)
    epochs = np.sort(np.floor(times)).astype(np.int32)
    assert epochs.size == 0 or (0 <= epochs[0] and epochs[-1] < horizon)
    return epochs
