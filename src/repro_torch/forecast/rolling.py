"""Rolling re-quantile carbon gate: re-issue the forecast, re-gate dispatch.

The counterpart of ``repro.forecast.rolling``, held against it by
``tests/test_torch_forecast.py``.  The day-ahead online gate fixes its
quantile thresholds once, from the forecast available at epoch 0.  The
rolling scheme re-issues the forecast every ``every`` epochs
(:func:`repro_torch.forecast.models.issue` at the new ``t0``) and
recomputes the ``theta``-quantile thresholds from it.  The dirty decision
at epoch ``t`` compares the *observed* intensity ``truth[t]`` against the
quantile of the *forecast* window ``point[t : t + window]`` from the most
recent issue.

Where the reference scans the ``K = ceil(E / every)`` issues one by one,
the port stacks their point forecasts as ``[..., K, E]`` and takes every
threshold in **one** :func:`~repro_torch.kernels.ops.gate_threshold`
launch, then keeps row ``e // every`` at epoch ``e``.  All ``K x E``
thresholds are computed, as in the reference.  With ``scale = 0`` the
point forecast is the truth bit for bit, so the rolling gate equals the
day-ahead gate and :func:`~repro_torch.core.solvers.online_torch.
dirty_mask` on the truth, bit for bit, for every ``every``.

The forecast noise is the tensor ``xi [..., K, E]`` of standard-normal
draws, one row per issue (issue ``k`` uses ``xi[..., k, :]``; the
reference keys it ``fold_in(key, k)``).  The day-ahead gate uses issue 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.core.objectives import makespan
from repro_torch.core.solvers.online_torch import (DispatchState,
                                                   OnlineSchedule,
                                                   forecast_dirty_mask,
                                                   simulate_online)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.forecast import models


def n_replans(n_epochs: int, every: int) -> int:
    """Number of forecast issues covering ``n_epochs`` at one per ``every``."""
    if every <= 0:
        raise ValueError(f"replan interval must be positive, got {every}")
    return -(-n_epochs // every)


def rolling_forecasts(truth: torch.Tensor, xi: torch.Tensor | None,
                      scale, every: int, model: str = "oracle_ar1",
                      rho: float = models.AR1_RHO) -> models.Forecast:
    """The ``K = n_replans(E, every)`` issues at epochs ``0, every, ...``,
    stacked: fields ``[*lead, K, E]`` for ``truth [*lead, E]`` and ``xi``
    ``[..., >= K, E]`` (its leading axes broadcast against ``lead``)."""
    E = truth.shape[-1]
    K = n_replans(E, every)
    t0 = torch.arange(K, dtype=torch.int32, device=truth.device) * every
    return models.issue(truth[..., None, :], t0,
                        None if xi is None else xi[..., :K, :],
                        model=model, scale=scale, rho=rho)


def governed(rows: torch.Tensor, every: int) -> torch.Tensor:
    """``rows[..., e // every, e]``: each epoch from the issue governing it."""
    E = rows.shape[-1]
    e = torch.arange(E, device=rows.device)
    idx = (e // every).expand(rows.shape[:-2] + (1, E))
    return torch.gather(rows, -2, idx).squeeze(-2)


def rolling_mask_from_points(truth: torch.Tensor, points: torch.Tensor,
                             theta, window, every: int,
                             max_window: int) -> torch.Tensor:
    """The rolling gate on given issues: ``truth [*lead, E]`` against the
    thresholds of ``points [*lead, K, E]`` (one ``gate_quantile`` launch),
    each epoch from its governing issue.  ``theta`` broadcasts to
    ``points``, ``window`` to its leading axes."""
    rows = forecast_dirty_mask(truth[..., None, :], points, theta, window,
                               max_window)
    return governed(rows, every)


def rolling_dirty_mask(truth: torch.Tensor, theta, window, xi, scale,
                       every: int, max_window: int,
                       model: str = "oracle_ar1",
                       rho: float = models.AR1_RHO) -> torch.Tensor:
    """``dirty[..., t]`` under rolling re-quantile (see module docstring).

    ``truth [*lead, E]``; ``xi [..., K, E]`` broadcasting against
    ``lead``; the mask has the broadcast leading shape.
    """
    fc = rolling_forecasts(truth, xi, scale, every, model, rho)
    return rolling_mask_from_points(truth, fc.point, theta, window, every,
                                    max_window)


# ---------------------------------------------------------------------------
# Forecast-conditioned thetas: the gate quantile as a function of the
# per-lead uncertainty band.
# ---------------------------------------------------------------------------

def band_conditioned_theta(theta_base, theta_slope,
                           feat: torch.Tensor) -> torch.Tensor:
    """Per-epoch gate quantile ``clip(base + slope * feat, 0, 1)``.

    ``feat`` is the normalized per-lead uncertainty (error std in
    trace-stds).  ``slope = 0`` is exactly the flat ``theta_base``.
    """
    base = torch.as_tensor(theta_base, dtype=torch.float32,
                           device=feat.device)
    slope = torch.as_tensor(theta_slope, dtype=torch.float32,
                            device=feat.device)
    return torch.clamp(base + slope * feat, 0.0, 1.0)


def theta_band_features(truth: torch.Tensor, scale, every: int | None = None,
                        rho: float = models.AR1_RHO) -> torch.Tensor:
    """Normalized per-lead uncertainty feature, float32 ``[E]``:
    ``scale * g(lead)``, with leads growing over the whole horizon
    (``every = None``, day-ahead) or reset at each replan boundary."""
    E = truth.shape[-1]
    e = torch.arange(E, dtype=torch.int32, device=truth.device)
    lead = (e if every is None else e % every).to(torch.float32)
    rho_f = torch.tensor(rho, dtype=torch.float32, device=truth.device)
    g = torch.sqrt(1.0 - rho_f ** (2.0 * lead))
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=truth.device) * g


def rolling_band_dirty_mask(truth: torch.Tensor, theta_base, theta_slope,
                            window, xi, scale, every: int, max_window: int,
                            model: str = "oracle_ar1",
                            rho: float = models.AR1_RHO) -> torch.Tensor:
    """The rolling gate with a band-conditioned theta profile: the quantile
    at epoch ``e`` is :func:`band_conditioned_theta` of the governing
    issue's own uncertainty band.  ``theta_slope = 0`` is
    :func:`rolling_dirty_mask`, bit for bit, for ``theta_base`` in
    ``[0, 1]``."""
    sigma = torch.std(truth, dim=-1, correction=0, keepdim=True) \
        .clamp_min(1e-6)[..., None, :]
    fc = rolling_forecasts(truth, xi, scale, every, model, rho)
    theta = band_conditioned_theta(theta_base, theta_slope, fc.std / sigma)
    return rolling_mask_from_points(truth, fc.point, theta, window, every,
                                    max_window)


def day_ahead_dirty_mask(truth: torch.Tensor, theta, window, xi, scale,
                         max_window: int, model: str = "oracle_ar1",
                         rho: float = models.AR1_RHO) -> torch.Tensor:
    """The day-ahead gate under an imperfect forecast: one issue at epoch
    0 (``xi[..., 0, :]``) fixes every threshold.  With ``scale = 0`` it is
    :func:`~repro_torch.core.solvers.online_torch.dirty_mask` on
    ``truth``."""
    fc = models.issue(truth, 0, None if xi is None else xi[..., 0, :],
                      model=model, scale=scale, rho=rho)
    return forecast_dirty_mask(truth, fc.point, theta, window, max_window)


def online_rolling_gated_torch(inst: PackedInstance, truth, xi,
                               theta: float = 0.5, window: int = 96,
                               stretch: float = 1.5, every: int = 48,
                               scale: float = 1.0, model: str = "oracle_ar1",
                               machine_rule: str = "earliest_finish",
                               state0: DispatchState | None = None,
                               device: str | torch.device = DEFAULT_DEVICE
                               ) -> OnlineSchedule:
    """Gated online dispatch with rolling re-quantile thresholds, on
    ``device``.

    Mirrors :func:`~repro_torch.core.solvers.online_torch.
    online_carbon_gated_torch` (the greedy run fixes the stretch budget,
    then the gated simulation) with the day-ahead mask swapped for the
    rolling one.  ``truth [*instance_lead, E]``, ``xi [..., K, E]``.
    ``state0`` warm-starts both runs from an existing
    :class:`~repro_torch.core.solvers.online_torch.DispatchState`.
    """
    dev = resolve_device(device)
    inst = PackedInstance(*(f.to(dev) for f in inst))
    truth = torch.as_tensor(truth, dtype=torch.float32).to(dev)
    if xi is not None:
        xi = torch.as_tensor(xi, dtype=torch.float32).to(dev)
    if state0 is not None:
        state0 = DispatchState(*(x.to(dev) for x in state0))
    n_epochs = int(truth.shape[-1])
    g = simulate_online(
        inst, torch.zeros(inst.lead + (n_epochs,), dtype=torch.bool,
                          device=dev), 0, n_epochs,
        machine_rule=machine_rule, state0=state0)
    ms0 = makespan(inst, g.start, g.assign)
    budget = (torch.tensor(stretch, dtype=torch.float32, device=dev)
              * ms0.to(torch.float32)).to(torch.int32)
    dirty = rolling_dirty_mask(truth, theta, window, xi, scale, every=every,
                               max_window=int(window), model=model)
    return simulate_online(inst, dirty, budget, n_epochs,
                           machine_rule=machine_rule, state0=state0)
