"""Sharded gate-policy training and evaluation over the instance axis.

The counterpart of ``repro.shard.train``.  :func:`train_sharded` is
:func:`repro_torch.learn.train.train_gate` with each step's per-row work
(the hard dispatch, the relaxation forward and its backward) run shard by
shard, each on its device.

**Bit-exact by canonical reduction.**  Per-shard partial sums combined
afterwards would reassociate float additions differently for every shard
count.  Nothing here sums across rows.  Each shard computes its rows'
gradients, each row's backward seeded with ``1/B`` of the **full** batch
(the cotangent the single-device mean gives it), and its rows'
``(carbon, penalty)``; the rows are gathered into row order, the padded
rows dropped, and :func:`repro_torch.learn.train.seq_sum` reduces them
once, on the first device, in one association for every shard count.
Parameters and Adam state stay on that device (in a fleet, every process
runs the same update on the same gathered rows).

:func:`greedy_sharded` and :func:`eval_theta_sharded` are the row-wise
greedy baseline and hard evaluation over shards.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.learn.train import (LearnConfig, TrainResult, _hard_eval,
                                     evaluate_theta, greedy_reference,
                                     per_row_grads, row_loss, train_gate)
from repro_torch.obs import traced_call
from repro_torch.shard.batch import (gather_rows, local_devices, pad_rows,
                                     run_rows_sharded, shard_blocks,
                                     take_rows, tree_map)


def greedy_sharded(batch: PackedInstance, cum, n_epochs: int,
                   machine_rule: str = "earliest_finish",
                   devices: int | Sequence | None = None,
                   processes: int | None = None):
    """Sharded :func:`repro_torch.learn.train.greedy_reference`: each
    instance's greedy baseline ``(makespan [B], carbon [B])``."""
    return run_rows_sharded(
        lambda b, c: greedy_reference(b, c, n_epochs, machine_rule),
        (batch, torch.as_tensor(cum, dtype=torch.float32)),
        devices=devices, processes=processes)


def _sharded_row_grads(cfg: LearnConfig, n_epochs: int, max_window: int,
                       devs: list, processes: int | None):
    """``row_grads_for(row_args, inv_b)`` of :func:`train_gate`: the rows
    padded to the shard count, each shard's block placed on its device
    once, and a ``row_grads`` that runs :func:`per_row_grads` on each
    shard and gathers the rows."""
    def row_grads_for(row_args, inv_b):
        B = int(row_args[2].shape[0])
        rows, starts, per = shard_blocks(B, len(devs), processes)
        padded = [pad_rows(a, rows) for a in row_args]
        # Floor the padded rows' norms as the real rows' are (no division
        # by zero in rows that are dropped anyway; a no-op on real rows).
        padded[7] = torch.clamp_min(padded[7], 1e-6)
        padded[8] = torch.clamp_min(padded[8], 1.0)
        shards = [(tuple(take_rows(a, lo, lo + per, d) for a in padded),
                   inv_b.to(d)) for lo, d in zip(starts, devs)]

        def row_grads(raw, temp):
            outs = [per_row_grads(raw.to(args[2].device), args[4], row_loss(
                cfg, n_epochs, max_window, ib, args,
                temp.to(args[2].device))) for args, ib in shards]
            return tree_map(lambda x: x[:B],
                            gather_rows(outs, processes, raw.device))

        return row_grads

    return row_grads_for


def train_sharded(batch: PackedInstance, intensity, cum, group_of, window,
                  stretch: float, theta0, cfg: LearnConfig = LearnConfig(),
                  feats=None, baseline=None,
                  devices: int | Sequence | None = None,
                  processes: int | None = None) -> TrainResult:
    """:func:`repro_torch.learn.train.train_gate` with the instances
    sharded over ``devices`` (``None``: every local card; ``processes``
    spans a fleet, see :func:`repro_torch.shard.batch.run_rows_sharded`).

    Same arguments and the same :class:`TrainResult`, bit for bit; the
    result's tensors lie on this process's first device.
    """
    devs = local_devices(devices, processes)
    max_window = int(np.asarray(window).max())
    return train_gate(
        batch, intensity, cum, group_of, window, stretch, theta0, cfg, feats,
        baseline, device=devs[0],
        greedy=functools.partial(greedy_sharded, devices=devs,
                                 processes=processes),
        row_grads_for=_sharded_row_grads(cfg, int(intensity.shape[-1]),
                                         max_window, devs, processes))


def eval_theta_sharded(batch: PackedInstance, intensity, cum, theta, window,
                       stretch: float,
                       machine_rule: str = "earliest_finish", baseline=None,
                       devices: int | Sequence | None = None,
                       processes: int | None = None):
    """Sharded :func:`repro_torch.learn.train.evaluate_theta`: the same
    ``(savings, gated_carbon, base_carbon, ms_ratio)`` per instance, bit
    for bit, with the hard dispatch run shard by shard."""
    devs = local_devices(devices, processes)

    def hard_eval(b, inten, c, th, win, budget, max_window, n_epochs, rule):
        # One learn.hard_eval span over every shard, as the single-device
        # evaluation records one.
        return traced_call(
            "learn.hard_eval", run_rows_sharded,
            lambda *a: _hard_eval(*a, max_window, n_epochs, rule),
            (b, inten, c, th, win, budget), devices=devs,
            processes=processes)

    return evaluate_theta(
        batch, intensity, cum, theta, window, stretch, machine_rule,
        baseline, device=devs[0],
        greedy=functools.partial(greedy_sharded, devices=devs,
                                 processes=processes),
        hard_eval=hard_eval)
