"""Sharded online dispatch: the policy sweep split over the instance axis.

The counterpart of ``repro.shard.dispatch``.  :func:`dispatch_sharded` is
:func:`repro_torch.core.solvers.online_torch.sweep_policies` with the
stacked instance batch split into row blocks, one per shard, each swept
on its device (one ``gate_quantile`` launch per shard).  Policies are
replicated: the policy grid is the cheap axis, the instances carry the
epoch loop.  Equal to ``sweep_policies`` bit for bit, because every
shard runs the same per-row program and nothing crosses rows
(:mod:`repro_torch.shard.batch`).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.core.solvers.online_torch import SweepResult, sweep_policies
from repro_torch.shard.batch import run_rows_sharded


def dispatch_sharded(batch: PackedInstance, intensity, thetas, windows,
                     stretches, machine_rule: str = "earliest_finish",
                     devices: int | Sequence | None = None,
                     processes: int | None = None) -> SweepResult:
    """``sweep_policies`` with the instance axis sharded over ``devices``.

    Same arguments and the same :class:`SweepResult`, bit for bit;
    ``devices`` and ``processes`` as in
    :func:`repro_torch.shard.batch.run_rows_sharded` (``None``: every
    local card).
    """
    def per_shard(b: PackedInstance, inten: torch.Tensor) -> SweepResult:
        return sweep_policies(b, inten, thetas, windows, stretches,
                              machine_rule=machine_rule, device=b.device)

    intensity = torch.as_tensor(intensity, dtype=torch.float32)
    return run_rows_sharded(per_shard, (batch, intensity), devices=devices,
                            processes=processes)
