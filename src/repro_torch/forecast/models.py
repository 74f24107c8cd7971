"""Carbon-intensity forecast generators over batched traces.

The counterpart of ``repro.forecast.models``, held against it by
``tests/test_torch_forecast.py``.  A *forecast* is what a grid operator or
a forecasting service hands the scheduler at an epoch: a point estimate of
the intensity for every epoch of the horizon, plus a per-lead uncertainty
band.

Conventions (shared with :mod:`repro_torch.forecast.rolling` and
:mod:`repro_torch.core.solvers.rolling`):

* ``truth`` is the realized intensity, float32 ``[*lead, E]`` at 15-min
  epochs.
* A forecast *issued at* epoch ``t0`` is a tensor over **absolute** epochs
  ``[*lead, E]``.  Epochs ``e <= t0`` are the *observed prefix* and equal
  ``truth`` exactly; epochs ``e > t0`` are predictions at **lead**
  ``l = e - t0 >= 1``.
* Per-lead error follows ``std(l) = scale * std(truth) * sqrt(1 - rho^(2l))``
  (the stationary-AR(1) growth).  ``scale = 0`` makes every model the
  perfect oracle: the point forecast *is* ``truth``, bit for bit.

Where the reference draws each issue's noise from ``jax.random`` inside
the function, :func:`issue` takes the standard-normal draws ``xi`` as a
tensor: callers draw them through the :class:`~repro_torch.core.solvers.
common.Draws` seam, and a test can hand in the reference's own draws.

Models:

* ``oracle_ar1`` — truth plus an AR(1) error process *in lead*;
* ``persistence`` — every future epoch equals the last observed value;
* ``diurnal`` — each future epoch copies the most recent observed epoch at
  the same time of day (96-epoch period).

``t0`` broadcasts against ``truth``'s leading axes, so one call issues
many forecasts at once (``t0`` of shape ``[K]`` against ``truth``
``[..., 1, E]`` gives ``K`` issues).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

MODELS = ("oracle_ar1", "persistence", "diurnal")

EPOCHS_PER_DAY = 96     # 15-minute epochs (mirrors repro_torch.core.carbon)
# Per-epoch persistence of the forecast error (the reference's value: an
# error correlation time of about two days).
AR1_RHO = 0.995


class Forecast(NamedTuple):
    """Issued forecasts over absolute epochs (see module docstring)."""

    point: torch.Tensor      # float32 [*lead, E]; == truth for e <= t0
    std: torch.Tensor        # float32 [*lead, E]; 0 for e <= t0
    issued_at: torch.Tensor  # int32, broadcasts to lead


def _t0(t0, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(t0, dtype=torch.int32, device=device)


def _leads(E: int, t0: torch.Tensor) -> torch.Tensor:
    """lead[..., e] = max(e - t0, 0), int32 ``[*t0.shape, E]``."""
    e = torch.arange(E, dtype=torch.int32, device=t0.device)
    return (e - t0[..., None]).clamp_min(0)


def _sigma(truth: torch.Tensor) -> torch.Tensor:
    """Population std over the epochs (``jnp.std``), keeping the axis."""
    return torch.std(truth, dim=-1, correction=0, keepdim=True)


def error_std_per_lead(truth: torch.Tensor, t0, scale,
                       rho: float = AR1_RHO) -> torch.Tensor:
    """Calibrated per-lead error std: ``scale * std(truth) * g(lead)``.

    ``g(l) = sqrt(1 - rho^(2l))``: ``g(0) = 0`` (the current epoch is
    observed) and ``g -> 1`` for day-ahead leads.  ``scale`` is a scalar.
    """
    t0 = _t0(t0, truth.device)
    lead = _leads(truth.shape[-1], t0).to(torch.float32)
    rho_f = torch.tensor(rho, dtype=torch.float32, device=truth.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=truth.device)
    return scale * _sigma(truth) * torch.sqrt(1.0 - rho_f ** (2.0 * lead))


def _ar1_error_path(xi: torch.Tensor, rho: float) -> torch.Tensor:
    """err[..., l] for leads l = 0..E-1 from draws ``xi [..., E]``: an
    AR(1) started at 0 with unit stationary std, ``err[..., 0] = 0``.

    The reference's ``lax.scan``, as a loop over the epochs on
    ``[..., E]`` tensors: step ``i`` gives the error at lead ``i + 1``.
    """
    a = torch.tensor(rho, dtype=torch.float32, device=xi.device)
    b = torch.sqrt(1.0 - a * a)
    err = torch.zeros_like(xi)
    acc = torch.zeros_like(xi[..., 0])
    for i in range(xi.shape[-1] - 1):
        acc = a * acc + b * xi[..., i]
        err[..., i + 1] = acc
    return err


def _observed(truth: torch.Tensor, t0: torch.Tensor,
              future: torch.Tensor) -> torch.Tensor:
    """Splice the observed prefix (epochs <= t0) over a future estimate."""
    e = torch.arange(truth.shape[-1], dtype=torch.int32, device=truth.device)
    return torch.where(e <= t0[..., None], truth, future)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` with ``x`` and ``idx`` broadcast against each other."""
    shape = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(shape + x.shape[-1:]), -1,
                        idx.expand(shape + idx.shape[-1:]).long())


def issue(truth: torch.Tensor, t0, xi: torch.Tensor | None = None,
          model: str = "oracle_ar1", scale=1.0,
          rho: float = AR1_RHO) -> Forecast:
    """Issue forecasts at epoch(s) ``t0`` (see module docstring).

    ``truth`` ``[*lead, E]``; ``t0`` an int or an int tensor broadcasting
    to ``lead``; ``xi`` the ``oracle_ar1`` model's standard-normal draws,
    ``[..., E]`` broadcasting to ``[*lead, E]`` (ignored by the
    structural models); ``scale`` a scalar calibrating the error band
    (0 == perfect oracle).
    """
    if model not in MODELS:
        raise ValueError(f"unknown forecast model {model!r}")
    truth = torch.as_tensor(truth, dtype=torch.float32)
    dev = truth.device
    t0 = _t0(t0, dev)
    E = truth.shape[-1]
    std = error_std_per_lead(truth, t0, scale, rho)

    if model == "oracle_ar1":
        if xi is None:
            raise ValueError("oracle_ar1 needs its standard-normal draws xi")
        err = _take(_ar1_error_path(xi.to(dev, torch.float32), rho),
                    _leads(E, t0))
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        point = truth + scale * _sigma(truth) * err
    elif model == "persistence":
        now = _take(truth, t0[..., None].clamp(0, E - 1))
        point = _observed(truth, t0, now)
    else:  # diurnal seasonal-naive
        e = torch.arange(E, dtype=torch.int32, device=dev)
        days_back = (e - t0[..., None] + EPOCHS_PER_DAY - 1) // EPOCHS_PER_DAY
        src = torch.minimum((e - EPOCHS_PER_DAY * days_back).clamp_min(0),
                            t0[..., None])
        point = _observed(truth, t0, _take(truth, src))

    # Intensity is physically non-negative; truth > 0, so the observed
    # prefix (and the scale=0 oracle) is untouched by the clamp.
    point = torch.maximum(point, torch.zeros((), device=dev))
    return Forecast(point=point, std=std, issued_at=t0)


def lead_quantiles(fc: Forecast, qs: Sequence[float]) -> torch.Tensor:
    """Gaussian per-lead quantile bands, float32 ``[*lead, Q, E]``.

    ``out[..., i, e] = max(point[e] + ndtri(qs[i]) * std[e], 0)``.  On the
    observed prefix std is 0, so every quantile collapses to the truth.
    """
    z = torch.special.ndtri(torch.tensor(qs, dtype=torch.float32,
                                         device=fc.point.device))
    return torch.maximum(fc.point[..., None, :]
                         + z[:, None] * fc.std[..., None, :],
                         torch.zeros((), device=fc.point.device))
