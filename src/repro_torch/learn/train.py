"""Gate-policy training: per-group gate thetas learned by gradient.

The counterpart of ``repro.learn.train``, held against it and against
``tests/golden/learn_tiny.json`` by ``tests/test_torch_learn.py``.  Per
group (a scenario cell, or any partition of the instance batch) the
policy is ``theta(e) = sigmoid(base_g + slope_g * feat[e])``: with
``feats = None`` the slope is inert and each group learns one scalar
theta; with per-epoch features (e.g. the uncertainty bands of
:func:`repro_torch.forecast.rolling.theta_band_features`) each group
learns a forecast-conditioned theta profile.

Where the reference scans one jitted program, this is a Python loop over
steps (:func:`run_train_scan`); each step dispatches every row's hard
schedule, runs the relaxation forward and back through autograd, and
updates with :func:`repro_torch.optim.adamw.adamw_update`.  The
temperature anneals geometrically from ``temp0`` to ``temp1``.  Nothing
draws random numbers.

Cross-row reductions keep the reference's canonical order: each row's
loss is scaled by the ``1/B`` of a batched mean, its gradient is taken on
its own (``raw[group_of]`` is a ``[B, 2]`` leaf and rows share nothing
else, so one ``backward()`` of the rows' sum leaves every row's gradient
in its own row), and rows are summed by :func:`seq_sum`, one dependent
add a row in row order, which is what a sharded learner must reproduce.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.core.objectives import carbon, clip, makespan
from repro_torch.core.solvers.online_torch import (_on, dirty_mask,
                                                   online_greedy_torch,
                                                   simulate_online,
                                                   stretch_budget)
from repro_torch.core.validate import total_violations_batch
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize
from repro_torch.learn.loss import gate_loss
from repro_torch.obs import traced_call
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


class LearnConfig(NamedTuple):
    """Training knobs."""

    steps: int = 150            # gradient steps
    lr: float = 0.08
    temp0: float = 0.5          # relaxation temperature at step 0 ...
    temp1: float = 0.02         # ... annealed geometrically to this
    lam: float = 0.2            # budget-penalty weight
    straight_through: bool = True
    machine_rule: str = "earliest_finish"


class TrainResult(NamedTuple):
    raw: torch.Tensor           # float32 [G, 2] — (base, slope) logits
    theta: torch.Tensor         # float32 [G] — sigmoid(base), the flat theta
    loss_curve: torch.Tensor    # float32 [steps] — mean training loss
    carbon_curve: torch.Tensor  # float32 [steps] — mean carbon ratio (hard)
    theta_curve: torch.Tensor   # float32 [steps, G]
    step_seconds: list          # wall of each step, between synchronisations


def logit(p) -> torch.Tensor:
    p = clip(torch.as_tensor(p, dtype=torch.float32), 1e-4, 1.0 - 1e-4)
    return torch.log(p) - torch.log1p(-p)


def _anneal(cfg: LearnConfig, k: int,
            device: torch.device) -> torch.Tensor:
    frac = torch.tensor(k, dtype=torch.float32, device=device) \
        / max(cfg.steps - 1, 1)
    t0 = torch.tensor(cfg.temp0, dtype=torch.float32, device=device)
    t1 = torch.tensor(cfg.temp1, dtype=torch.float32, device=device)
    return t0 * (t1 / t0) ** frac


def greedy_reference(batch: PackedInstance, cum: torch.Tensor,
                     n_epochs: int, machine_rule: str = "earliest_finish"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-instance greedy baseline: (makespan [B], carbon [B]), from the
    dispatcher the fixed-grid sweeps use, on ``batch``'s device."""
    g = online_greedy_torch(batch, n_epochs, machine_rule=machine_rule,
                            device=batch.device)
    return (makespan(batch, g.start, g.assign),
            carbon(batch, g.start, g.assign, cum))


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis in strict index order: one dependent add
    a row, never reassociated (the canonical cross-row reduction)."""
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for v in x.unbind(0):
        acc = acc + v
    return acc


def per_row_loss(rows: torch.Tensor, temp: torch.Tensor,
                 inst: PackedInstance, cum: torch.Tensor,
                 intensity: torch.Tensor, window: torch.Tensor,
                 max_window: int, feat: torch.Tensor, budget: torch.Tensor,
                 bc: torch.Tensor, mn: torch.Tensor, inv_b: torch.Tensor,
                 cfg: LearnConfig, n_epochs: int
                 ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Every row's contribution to the training loss, ``[B]``.

    ``rows`` ``[B, 2]`` holds each row's group's ``(base, slope)``.  Each
    loss is scaled by ``inv_b`` (``1/B`` as float32), so the gradient of
    a row seeds its backward with the cotangent a batched mean would.  The
    aux pair is each row's ``(carbon, penalty)`` for the value path.
    """
    th = torch.sigmoid(rows[:, 0:1] + rows[:, 1:2] * feat)          # [B, E]
    terms = gate_loss(inst, cum, intensity, th, window, max_window, budget,
                      temp, n_epochs, cfg.straight_through, cfg.machine_rule)
    loss = terms.carbon / bc + cfg.lam * (terms.penalty / mn)
    return loss * inv_b, (terms.carbon, terms.penalty)


def per_row_grads(raw: torch.Tensor, group_of: torch.Tensor, loss_fn
                  ) -> tuple[torch.Tensor, tuple]:
    """Each row's gradient of ``loss_fn(raw[group_of])`` with respect to
    ``raw``, ``[B, G, 2]`` (zero outside the row's group), and the loss's
    aux values (detached)."""
    rows = raw[group_of].detach().requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn(rows)
        loss.sum().backward()
    B = rows.shape[0]
    g = torch.zeros((B,) + tuple(raw.shape), dtype=raw.dtype,
                    device=raw.device)
    g[torch.arange(B, device=raw.device), group_of] = rows.grad
    return g, tuple(x.detach() for x in aux)


def train_opt_cfg(cfg: LearnConfig) -> AdamWConfig:
    """The learner's Adam schedule."""
    return AdamWConfig(lr=cfg.lr, warmup_steps=max(1, cfg.steps // 10),
                       total_steps=cfg.steps, min_lr_frac=0.1,
                       weight_decay=0.0, clip_norm=1.0)


def build_train_step(cfg: LearnConfig, opt_cfg: AdamWConfig, n_epochs: int,
                     max_window: int, inv_b: torch.Tensor,
                     row_args: tuple) -> Callable:
    """One Adam step of the gate learner: the single copy of the update.

    ``row_args``: the per-row inputs ``(batch, cum, intensity, window,
    group_of, feats, budget, bc, mn)``, ``bc``/``mn`` the rows' carbon and
    makespan norms.  ``step((params, state), k)`` returns the new
    ``(params, state)`` and ``(loss, carbon ratio, theta)`` of step ``k``.
    """
    batch, cum, intensity, window, group_of, feats, budget, bc, mn = row_args

    def loss_fn(temp):
        return lambda rows: per_row_loss(
            rows, temp, batch, cum, intensity, window, max_window, feats,
            budget, bc, mn, inv_b, cfg, n_epochs)

    def step(carry, k: int):
        params, state = carry
        temp = _anneal(cfg, k, intensity.device)
        g, (c_row, p_row) = per_row_grads(params["raw"], group_of,
                                          loss_fn(temp))
        grads = seq_sum(g)                               # canonical row order
        ratio = c_row / bc
        pen = p_row / mn
        loss = seq_sum(ratio + cfg.lam * pen) * inv_b
        ratio_m = seq_sum(ratio) * inv_b
        params, state, _ = adamw_update(params, {"raw": grads}, state,
                                        opt_cfg)
        return (params, state), (loss, ratio_m,
                                 torch.sigmoid(params["raw"][:, 0]))

    return step


def run_train_scan(step: Callable, raw0: torch.Tensor,
                   opt_cfg: AdamWConfig, steps: int):
    """Run ``step`` over the training steps from a fresh Adam state.

    Returns the final raw logits, the stacked per-step outputs and each
    step's wall seconds (between synchronisations of the device)."""
    params = {"raw": raw0}
    state = adamw_init(params, opt_cfg)
    ys, walls = [], []
    dev = raw0.device
    for k in range(steps):
        synchronize(dev)
        t0 = time.perf_counter()
        (params, state), y = step((params, state), k)
        synchronize(dev)
        walls.append(time.perf_counter() - t0)
        ys.append(y)
    return params["raw"], tuple(torch.stack(c) for c in zip(*ys)), walls


def _train(batch, intensity, cum, group_of, window, budget, base_carbon,
           ms0, feats, raw0, cfg: LearnConfig, max_window: int,
           n_epochs: int) -> TrainResult:
    base_c = torch.clamp_min(base_carbon, 1e-6)
    ms_norm = torch.clamp_min(ms0.to(torch.float32), 1.0)
    inv_b = torch.tensor(1.0, dtype=torch.float32, device=intensity.device) \
        / torch.tensor(float(intensity.shape[0]), dtype=torch.float32,
                       device=intensity.device)
    opt_cfg = train_opt_cfg(cfg)
    step = build_train_step(
        cfg, opt_cfg, n_epochs, max_window, inv_b,
        row_args=(batch, cum, intensity, window, group_of, feats, budget,
                  base_c, ms_norm))
    raw, (losses, ratios, thetas), walls = run_train_scan(
        step, raw0, opt_cfg, cfg.steps)
    return TrainResult(raw=raw, theta=torch.sigmoid(raw[:, 0]),
                       loss_curve=losses, carbon_curve=ratios,
                       theta_curve=thetas, step_seconds=walls)


def _baseline(batch, cum, n_epochs, machine_rule, baseline, dev):
    if baseline is None:
        return greedy_reference(batch, cum, n_epochs, machine_rule)
    ms0, base_c = baseline
    return (torch.as_tensor(ms0, dtype=torch.int32).to(dev),
            torch.as_tensor(base_c, dtype=torch.float32).to(dev))


def train_gate(batch: PackedInstance, intensity, cum, group_of, window,
               stretch: float, theta0, cfg: LearnConfig = LearnConfig(),
               feats=None, baseline=None,
               device: str | torch.device = DEFAULT_DEVICE) -> TrainResult:
    """Learn per-group gate thetas on a stacked instance batch, on ``device``.

    ``batch``/``intensity``/``cum``: stacked ``[B, ...]`` instances with
    their forecast windows and cumulative traces; ``group_of [B]`` maps
    each instance to its group (0..G-1, G from ``theta0``'s length);
    ``window [B]`` each instance's gate window; ``stretch`` the shared
    stretch budget; ``theta0 [G]`` the initialization; ``feats [B, E]``
    optional per-epoch features; ``baseline`` an optional precomputed
    ``(greedy_makespan [B], greedy_carbon [B])`` (omitted, it is computed
    by :func:`greedy_reference`).  Deterministic.  The result's tensors
    lie on ``device``.
    """
    dev = resolve_device(device)
    batch = _on(batch, dev)
    intensity = torch.as_tensor(intensity, dtype=torch.float32).to(dev)
    cum = torch.as_tensor(cum, dtype=torch.float32).to(dev)
    n_epochs = int(intensity.shape[-1])
    window = np.asarray(window, np.int32)
    ms0, base_c = _baseline(batch, cum, n_epochs, cfg.machine_rule,
                            baseline, dev)
    budget = stretch_budget(stretch, ms0)
    theta0 = torch.as_tensor(np.asarray(theta0, np.float32), device=dev)
    raw0 = torch.stack([logit(theta0), torch.zeros_like(theta0)], dim=1)
    feats = (torch.zeros_like(intensity) if feats is None
             else torch.as_tensor(feats, dtype=torch.float32).to(dev))
    # traced_call: a direct _train call unless tracing is on, when the
    # host records its synchronised wall-clock span (repro_torch.obs).
    return traced_call(
        "learn.train", _train, batch, intensity, cum,
        torch.as_tensor(np.asarray(group_of), dtype=torch.long, device=dev),
        torch.as_tensor(window, device=dev), budget, base_c, ms0, feats,
        raw0, cfg, int(window.max()), n_epochs)


def _hard_eval(batch, intensity, cum, theta, window, budget,
               max_window: int, n_epochs: int, machine_rule: str):
    th = theta[:, None] if theta.ndim == 1 else theta
    dirty = dirty_mask(intensity, th, window, max_window)
    sch = simulate_online(batch, dirty, budget, n_epochs,
                          machine_rule=machine_rule)
    done = (sch.scheduled | ~batch.task_mask).all(-1)
    clean = total_violations_batch(batch, sch.start, sch.assign) == 0
    return (carbon(batch, sch.start, sch.assign, cum),
            makespan(batch, sch.start, sch.assign), done, clean)


def evaluate_theta(batch: PackedInstance, intensity, cum, theta, window,
                   stretch: float, machine_rule: str = "earliest_finish",
                   baseline=None,
                   device: str | torch.device = DEFAULT_DEVICE):
    """Hard-dispatch evaluation of learned thetas (no relaxation), on
    ``device``.

    ``theta``: per-instance ``[B]`` or per-epoch ``[B, E]``.  Returns
    ``(savings [B], gated_carbon [B], base_carbon [B], makespan_ratio
    [B])``, the metrics of the fixed-grid sweep.  Raises if a schedule is
    incomplete or fails the validator.  ``baseline`` as in
    :func:`train_gate`.
    """
    dev = resolve_device(device)
    batch = _on(batch, dev)
    intensity = torch.as_tensor(intensity, dtype=torch.float32).to(dev)
    cum = torch.as_tensor(cum, dtype=torch.float32).to(dev)
    n_epochs = int(intensity.shape[-1])
    window = np.asarray(window, np.int32)
    ms0, base_c = _baseline(batch, cum, n_epochs, machine_rule, baseline,
                            dev)
    budget = stretch_budget(stretch, ms0)
    gated_c, gated_ms, done, clean = traced_call(
        "learn.hard_eval", _hard_eval, batch, intensity, cum,
        torch.as_tensor(theta, dtype=torch.float32).to(dev),
        torch.as_tensor(window, device=dev), budget, int(window.max()),
        n_epochs, machine_rule)
    if not bool(done.all()):
        raise AssertionError(
            "gated dispatch incomplete at evaluation: raise the horizon")
    if not bool(clean.all()):
        raise AssertionError("learned gate's schedule infeasible")
    savings = 1.0 - gated_c / torch.clamp_min(base_c, 1e-6)
    ms_ratio = (gated_ms.to(torch.float32)
                / torch.clamp_min(ms0.to(torch.float32), 1.0))
    return savings, gated_c, base_c, ms_ratio
