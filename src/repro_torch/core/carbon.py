"""Grid carbon-intensity traces.

The paper uses hourly Electricity Maps data (2024) from four regions:
AU-SA, US-CAL (CAISO), US-TEX (ERCOT) and CA-ON.  Real traces are not
redistributable inside this offline container, so we ship

  * a deterministic synthetic generator calibrated to the *statistical
    profile* the paper describes for each region (mean level, diurnal
    variability, solar penetration), and
  * a CSV ingestion path (``from_csv``) so real Electricity Maps exports can
    drop in unchanged on a production deployment.

Traces are resampled to 15-minute epochs.  The decoders never integrate
I(tau) directly; they use the *cumulative carbon-energy* array

    cum[e] = sum_{e' < e} I[e'] * EPOCH_HOURS        (gCO2 per kW)

so the emissions of a task on machine m starting at epoch s for d epochs are

    P_m * (cum[s + d] - cum[s])                      (gCO2)

— Def. 2.3 as a single gather.

A verbatim copy of ``repro.core.carbon`` (numpy only), so that the same
seed gives bit-identical traces and ``cum`` arrays in both packages.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.instance import EPOCH_HOURS

EPOCHS_PER_HOUR = 4
EPOCHS_PER_DAY = 96


@dataclasses.dataclass(frozen=True)
class RegionProfile:
    """Statistical knobs for the synthetic generator (per paper Section 3.2)."""

    name: str
    mean: float          # average intensity, gCO2/kWh
    diurnal_amp: float   # amplitude of the day/night sinusoid
    solar_depth: float   # midday dip from solar (duck curve), gCO2/kWh
    noise_std: float     # hour-to-hour noise (wind / dispatch)
    seasonal_amp: float  # yearly seasonal swing
    floor: float = 5.0   # intensity can't go below this


# Calibrated to the qualitative description in the paper:
#  AU-SA : high daily variation, strong renewables (solar+wind), moderate mean.
#  CAL   : duck curve — deep midday solar dip, evening ramp, moderate mean.
#  TEX   : higher mean, *less* daily variation (savings are smaller).
#  CA-ON : ~90% low-carbon (hydro/nuclear) — very low mean, little headroom.
REGIONS: dict[str, RegionProfile] = {
    "AU-SA": RegionProfile("AU-SA", mean=170.0, diurnal_amp=110.0,
                           solar_depth=120.0, noise_std=45.0, seasonal_amp=25.0),
    "CAL":   RegionProfile("CAL", mean=240.0, diurnal_amp=70.0,
                           solar_depth=140.0, noise_std=30.0, seasonal_amp=30.0),
    "TEX":   RegionProfile("TEX", mean=420.0, diurnal_amp=55.0,
                           solar_depth=45.0, noise_std=25.0, seasonal_amp=20.0),
    "CA-ON": RegionProfile("CA-ON", mean=45.0, diurnal_amp=28.0,
                           solar_depth=10.0, noise_std=12.0, seasonal_amp=8.0),
}


@dataclasses.dataclass(frozen=True)
class CarbonTrace:
    """A carbon-intensity trace at 15-minute resolution."""

    name: str
    intensity: np.ndarray  # float32 [E] gCO2/kWh per epoch

    @property
    def n_epochs(self) -> int:
        return int(self.intensity.shape[0])

    def cumulative(self) -> np.ndarray:
        """cum[e] in gCO2-per-kW; length E+1; cum[0] = 0."""
        cum = np.zeros(self.n_epochs + 1, dtype=np.float64)
        np.cumsum(self.intensity.astype(np.float64) * EPOCH_HOURS, out=cum[1:])
        return cum.astype(np.float32)

    def window(self, start_epoch: int, length: int) -> "CarbonTrace":
        """Slice ``length`` epochs starting at ``start_epoch`` (wraps around)."""
        idx = (start_epoch + np.arange(length)) % self.n_epochs
        return CarbonTrace(self.name, self.intensity[idx])


def synthesize(region: str = "AU-SA", days: int = 366, seed: int = 2024) -> CarbonTrace:
    """Generate a deterministic year-long synthetic trace for ``region``."""
    prof = REGIONS[region]
    # crc32, not hash(): str hashing is randomized per process, which would
    # make the "deterministic" generator emit a different trace every run.
    rng = np.random.default_rng((seed, zlib.crc32(region.encode()) & 0xFFFF))
    hours = days * 24
    t = np.arange(hours, dtype=np.float64)
    hod = t % 24.0
    doy = t / 24.0

    # Diurnal demand curve: low at 4am, peaks early evening (~19h).
    diurnal = prof.diurnal_amp * np.sin((hod - 9.0) / 24.0 * 2 * np.pi)
    # Solar dip: gaussian bump centred at 12:30, scaled by season.
    season = 1.0 + 0.35 * np.sin((doy - 15.0) / 366.0 * 2 * np.pi)  # summer peak
    solar = -prof.solar_depth * season * np.exp(-0.5 * ((hod - 12.5) / 2.6) ** 2)
    seasonal = prof.seasonal_amp * np.sin((doy - 30.0) / 366.0 * 2 * np.pi)
    # AR(1) noise for hour-to-hour persistence (wind fronts, dispatch).
    eps = rng.normal(0.0, prof.noise_std, size=hours)
    noise = np.empty(hours)
    acc = 0.0
    for i in range(hours):  # tiny; runs once per trace
        acc = 0.82 * acc + eps[i]
        noise[i] = acc
    noise *= np.sqrt(1 - 0.82 ** 2)

    hourly = np.maximum(prof.floor, prof.mean + diurnal + solar + seasonal + noise)
    per_epoch = np.repeat(hourly, EPOCHS_PER_HOUR).astype(np.float32)
    return CarbonTrace(region, per_epoch)


def from_csv(path: str, name: str = "csv", column: int = 1,
             hourly: bool = True) -> CarbonTrace:
    """Ingest an Electricity Maps-style CSV export: ``timestamp,intensity``.

    Real exports have holes (sensor outages parse as NaN).  Dropping those
    rows would *shift every later hour* on the time grid — a schedule's
    epoch ``e`` would no longer be the trace's hour ``e/4`` — so interior
    gaps are filled by linear interpolation on the row grid (the time axis
    stays aligned) and gaps at the trace edges, which have no anchor to
    interpolate from, raise instead of being silently invented.
    """
    vals = np.atleast_1d(np.genfromtxt(path, delimiter=",", skip_header=1,
                                       usecols=(column,))).astype(np.float64)
    if vals.size < 2:
        raise ValueError(
            f"{path}: only {vals.size} data row(s) — a trace needs at "
            "least 2 rows to define a time axis (truncated export?)")
    finite = np.isfinite(vals)
    if not finite.any():
        raise ValueError(f"{path}: no finite intensity values in column "
                         f"{column}")
    if not finite.all():
        idx = np.arange(vals.size)
        lo, hi = idx[finite][0], idx[finite][-1]
        if lo != 0 or hi != vals.size - 1:
            raise ValueError(
                f"{path}: non-finite values at the trace edges (rows "
                f"[0, {lo}) / ({hi}, {vals.size})) cannot be interpolated — "
                "trim the export or fill them upstream")
        vals[~finite] = np.interp(idx[~finite], idx[finite], vals[finite])
    vals = vals.astype(np.float32)
    if hourly:
        vals = np.repeat(vals, EPOCHS_PER_HOUR)
    return CarbonTrace(name, vals)


def constant(value: float, epochs: int, name: str = "const") -> CarbonTrace:
    """Flat trace — with it, carbon optimization degenerates to energy
    optimization; useful for tests."""
    return CarbonTrace(name, np.full(epochs, value, dtype=np.float32))


def sample_window(trace: CarbonTrace, rng: np.random.Generator,
                  horizon: int) -> CarbonTrace:
    """Random start point into a year trace (paper: 'Each instance starts at a
    random point in the trace').

    Every start with a full in-trace window is reachable: the valid starts
    are ``0 .. n_epochs - horizon`` *inclusive* (``rng.integers`` has an
    exclusive upper bound, hence the ``+ 1`` — without it the final window
    was never sampled).
    """
    start = int(rng.integers(0, max(1, trace.n_epochs - horizon + 1)))
    return trace.window(start, horizon)
