"""Differentiable gate-policy learning for the online dispatcher.

The counterpart of ``repro.learn``.  The offline bi-level bound and the
fixed ``(theta, window, stretch)`` grid of the online gate bracket the
achievable savings; this package learns the gate threshold by gradient,
per group (a scenario family x fleet cell), optionally conditioned on
per-epoch forecast features:

    relax  — the relaxation: sigmoid gate over the ``gate_quantile``
             threshold, expected-wait epoch loop, DAG-propagated soft
             starts (``soft_dispatch``)
    loss   — carbon under a makespan budget: straight-through hard forward
             values, soft gradients; the penalty through the validator
    train  — the Adam loop (``repro_torch.optim.adamw``) over stacked
             instance batches, with geometric temperature annealing

``soft_dispatch``'s ``hard`` schedule equals ``online_carbon_gated_torch``
at every temperature, and ``soft.dirty > 0.5`` equals its dirty mask, so
training metrics with ``straight_through=True`` read in exact
hard-dispatch units; only gradients use the relaxation.
"""
from repro_torch.learn.loss import GateLossTerms, gate_loss
from repro_torch.learn.relax import (SoftDispatch, expected_wait,
                                     soft_dispatch, soft_gate, soft_starts)
from repro_torch.learn.train import (LearnConfig, TrainResult,
                                     evaluate_theta, greedy_reference, logit,
                                     train_gate)

__all__ = [
    "GateLossTerms", "gate_loss",
    "SoftDispatch", "expected_wait", "soft_dispatch", "soft_gate",
    "soft_starts",
    "LearnConfig", "TrainResult", "evaluate_theta", "greedy_reference",
    "logit", "train_gate",
]
