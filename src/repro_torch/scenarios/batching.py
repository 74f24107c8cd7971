"""Shape-static batching of mixed-shape instances.

The counterpart of ``repro.scenarios.batching``, held against it field by
field by ``tests/test_torch_scenarios.py``.  Instances from different
scenario cells differ in task count *and* machine count; the port's
dispatchers and solvers run a stacked
:class:`~repro_torch.core.instance.PackedInstance` of one ``(T, M)``, so
this module pads every instance to the batch maximum on both axes and
stacks:

* task padding appends masked tasks (``task_mask == False``) that schedule
  instantly and never touch the objectives;
* machine padding appends never-``allowed`` zero-power machines that no
  decoder can select;
* batch padding (:func:`pad_stacked` / ``pack_aligned(pad_batch=...)``)
  appends whole *inert rows*, instances made entirely of padding tasks.

All three paddings are inert: every program over the batch treats rows
independently, so a padded row cannot influence a real one, and the
padded tasks and machines of a row change nothing on its real tasks.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.instance import (Instance, PackedInstance, pack,
                                       packed_from_numpy, stack_packed)
from repro_torch.device import DEFAULT_DEVICE, resolve_device


def aligned_shape(instances: Sequence[Instance]) -> tuple[int, int]:
    """The smallest common ``(pad_tasks, pad_machines)`` for a mixed batch."""
    if not instances:
        raise ValueError("aligned_shape: empty instance sequence")
    return (max(i.n_tasks for i in instances),
            max(i.n_machines for i in instances))


def pack_aligned(instances: Sequence[Instance],
                 pad_tasks: int | None = None,
                 pad_machines: int | None = None,
                 pad_batch: int | None = None,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> PackedInstance:
    """Pack mixed-shape instances to one stacked ``[B, ...]`` batch on
    ``device``.

    ``pad_tasks`` / ``pad_machines`` override the computed maxima; they
    must cover every instance.  ``pad_batch`` pads the batch axis to the
    given row count with inert all-padding rows (see :func:`pad_stacked`).
    """
    dev = resolve_device(device)
    T, M = aligned_shape(instances)
    T = max(T, pad_tasks or 0)
    M = max(M, pad_machines or 0)
    batch = stack_packed([pack(i, pad_tasks=T, pad_machines=M, device="cpu")
                          for i in instances])
    batch = PackedInstance(*(f.to(dev) for f in batch))
    if pad_batch is not None:
        batch = pad_stacked(batch, pad_batch)
    return batch


def padding_rows(rows: int, T: int, M: int,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> PackedInstance:
    """``rows`` stacked all-padding instances of shape ``(T, M)``.

    Each row follows :func:`repro_torch.core.instance.pack`'s padded-task
    convention exactly: every task masked out, zero duration, runnable
    only on machine 0, no dependencies, zero power.
    """
    allowed = np.zeros((rows, T, M), dtype=bool)
    allowed[:, :, 0] = True
    return packed_from_numpy({
        "dur": np.zeros((rows, T, M), np.int32),
        "allowed": allowed,
        "pred": np.zeros((rows, T, T), bool),
        "arrival": np.zeros((rows, T), np.int32),
        "job": np.zeros((rows, T), np.int32),
        "task_mask": np.zeros((rows, T), bool),
        "power": np.zeros((rows, M), np.float32)}, device)


def pad_stacked(batch: PackedInstance, rows: int) -> PackedInstance:
    """Pad a stacked ``[B, ...]`` batch's leading axis to ``rows`` with
    inert all-padding rows (:func:`padding_rows`), on the batch's device.

    Results on ``[:B]`` are those of the unpadded batch; callers slice the
    padded rows off.
    """
    B = batch.dur.shape[0]
    if rows < B:
        raise ValueError(f"pad_stacked: rows={rows} < batch size {B}")
    if rows == B:
        return batch
    pad = padding_rows(rows - B, batch.T, batch.M, batch.device)
    return PackedInstance(*(torch.cat([getattr(batch, f), getattr(pad, f)])
                            for f in PackedInstance._fields))
