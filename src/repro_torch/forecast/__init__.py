"""Carbon-forecast subsystem: imperfect forecasts + rolling re-quantiles.

The counterpart of ``repro.forecast``.  It generates calibrated imperfect
forecasts over any carbon trace, rolls them forward MPC-style and feeds
them to the online gate (:mod:`repro_torch.forecast.rolling`) and the
rolling replanner (:mod:`repro_torch.core.solvers.rolling`), so the port
can measure how much of the offline bound survives a given forecast
quality.

Conventions (the reference's):

* time is the 15-minute epoch grid; ``truth`` is the realized intensity,
  float32 ``[..., E]``;
* a forecast *issued at* epoch ``t0`` spans absolute epochs ``0..E-1``;
  leads ``l = e - t0 <= 0`` are the observed prefix and equal ``truth``;
* per-lead error is ``scale * std(truth) * sqrt(1 - rho^(2l))``;
  ``scale = 0`` is the perfect oracle, bit-exact equal to ``truth``, so
  every rolling result at ``scale = 0`` reproduces the day-ahead
  perfect-forecast result;
* gate thresholds are ``theta``-quantiles over the forecast window
  ``point[t : t + window]`` with ``np.quantile``'s interpolation
  (:func:`repro_torch.kernels.ops.gate_threshold`);
* rolling re-quantile: epoch ``t`` is gated by the forecast issued at
  ``(t // every) * every``; issue ``k``'s noise is row ``k`` of the
  standard-normal draws ``xi``.
"""
from repro_torch.forecast.models import (AR1_RHO, EPOCHS_PER_DAY, Forecast,
                                         MODELS, error_std_per_lead, issue,
                                         lead_quantiles)
from repro_torch.forecast.rolling import (band_conditioned_theta,
                                          day_ahead_dirty_mask, n_replans,
                                          online_rolling_gated_torch,
                                          rolling_band_dirty_mask,
                                          rolling_dirty_mask,
                                          theta_band_features)

__all__ = [
    "AR1_RHO", "EPOCHS_PER_DAY", "Forecast", "MODELS",
    "error_std_per_lead", "issue", "lead_quantiles",
    "band_conditioned_theta", "day_ahead_dirty_mask", "n_replans",
    "online_rolling_gated_torch", "rolling_band_dirty_mask",
    "rolling_dirty_mask", "theta_band_features",
]
