"""Instance-axis shards: their devices, and the generic row-sharded runner.

The counterpart of ``repro.shard.batch``.  The sweeps this repo runs
(batched gated dispatch, the offline bi-level bound, gate-policy
training) are independent over the *instance* (row) axis of a stacked
:class:`~repro_torch.core.instance.PackedInstance` batch.  This module
owns what every sharded entry point shares:

* :func:`instance_devices`: the devices the rows are split over (torch
  has no device mesh; a list of devices, which may repeat one, takes its
  place);
* :func:`run_rows_sharded`: pad every argument's leading row axis to a
  multiple of the shard count, run a per-shard function on each
  contiguous block on its device, and concatenate the results in row
  order, sliced back to the real rows.

**Bit-exactness.**  The per-shard function is the same row-wise
independent batched program the single-device path runs; nothing reduces
across rows, each row's arithmetic is the same whichever shard it lands
in, and padded rows are sliced off before anything reads them.  So
sharded output equals single-device output exactly, for any shard count,
as long as the program's per-row arithmetic does not depend on how many
rows it is given (``tests/test_torch_shard.py`` holds it).

**Multi-process.**  With ``processes=P`` the shards span a
``torch.distributed`` fleet (:mod:`repro_torch.shard.distributed`):
process ``p`` owns rows ``[p * rows / P, (p + 1) * rows / P)``, splits
them over its own devices, and the blocks are all-gathered in process-id
order, which is row order.  Rows move; nothing is reduced.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.device import resolve_device
from repro_torch.scenarios.batching import pad_stacked
from repro_torch.shard import distributed


def device_count() -> int:
    """Local CUDA device count."""
    return torch.cuda.device_count()


def round_up(rows: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= ``rows``."""
    return -(-rows // multiple) * multiple


def instance_devices(devices: int | Sequence | None = None
                     ) -> list[torch.device]:
    """The devices a process splits its rows over, one shard each.

    ``None``: every local CUDA device (raises without a card).  An int
    ``n``: the first ``n`` local CUDA devices (raises if fewer exist).  A
    sequence of devices, which may repeat one: those, in order
    (``["cpu"] * 4`` runs four shards on the CPU, ``["cuda:0"] * 2`` two
    on one card).
    """
    if devices is None or isinstance(devices, (int, np.integer)):
        avail = torch.cuda.device_count()
        n = avail if devices is None else int(devices)
        if n < 1 or n > avail:
            raise RuntimeError(
                f"instance_devices: {n} cuda device(s) requested, "
                f"{avail} available (torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}); pass a sequence such as "
                "['cpu'] * n to shard on the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("instance_devices: empty device sequence")
    return devs


def local_devices(devices: int | Sequence | None,
                  processes: int | None) -> list[torch.device]:
    """This process's shard devices.  Without ``processes`` as
    :func:`instance_devices`; in a fleet, ``devices=None`` means the one
    card ``cuda:{rank % device_count()}``, so ranks share cards in turn."""
    if processes is None or devices is not None:
        return instance_devices(devices)
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError(
            "local_devices: no cuda device for this process "
            f"(torch.cuda.is_available() is {torch.cuda.is_available()}); "
            "pass devices=['cpu'] to run the fleet on the CPU")
    return [torch.device("cuda", distributed.process_index() % n)]


def call_devices(device, devices: int | Sequence | None,
                 processes: int | None) -> list[torch.device]:
    """The shard devices of an entry point that takes ``device`` and the
    shard layer's ``devices`` / ``processes``: ``[device]`` when neither
    is set (one shard, unsharded), else :func:`local_devices`."""
    if devices is None and processes is None:
        return [resolve_device(device)]
    return local_devices(devices, processes)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of nested tuples / NamedTuples, rebuilt in
    the same structure; ``rest`` are trees of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple):
        parts = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    raise TypeError(f"tree_map: unsupported leaf {type(tree).__name__}")


def leading_rows(a) -> int:
    if isinstance(a, PackedInstance):
        return int(a.dur.shape[0])
    return int(a.shape[0])


def pad_rows(a, rows: int):
    """Pad one argument's leading axis to ``rows``: inert rows for a
    PackedInstance, zero rows for a tensor or numpy array (padded rows'
    values are never read: results are sliced to the real rows)."""
    if isinstance(a, PackedInstance):
        return pad_stacked(a, rows)
    extra = rows - a.shape[0]
    if extra == 0:
        return a
    if isinstance(a, np.ndarray):
        return np.concatenate([a, np.zeros((extra,) + a.shape[1:], a.dtype)])
    return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])


def take_rows(a, lo: int, hi: int, dev: torch.device):
    """Rows ``[lo, hi)`` of one (padded) argument, on ``dev`` (numpy
    arrays stay on the host)."""
    if isinstance(a, np.ndarray):
        return a[lo:hi]
    return tree_map(lambda x: x[lo:hi].to(dev), a)


def shard_blocks(B: int, n_local: int, processes: int | None
                 ) -> tuple[int, list[int], int]:
    """``(rows, starts, per)``: the padded row count, the first row of each
    of this process's ``n_local`` shards, and the rows a shard holds."""
    procs = 1 if processes is None else distributed.check_processes(processes)
    rank = 0 if processes is None else distributed.process_index()
    shards = procs * n_local
    rows = round_up(B, shards)
    per = rows // shards
    return rows, [(rank * n_local + i) * per for i in range(n_local)], per


def gather_rows(outs: list, processes: int | None, dev: torch.device):
    """Concatenate this process's shard outputs in row order on ``dev``
    and, in a fleet, all-gather every process's block in rank order."""
    out = tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]), *outs)
    if processes is not None:
        out = tree_map(lambda x: distributed.all_gather_rows(x).to(dev), out)
    return out


def run_rows_sharded(fn: Callable, args: Sequence,
                     devices: int | Sequence | None = None,
                     processes: int | None = None):
    """Run ``fn(*args)`` sharded over the leading row axis of every arg.

    ``fn`` must be independent over rows; every argument (PackedInstance,
    tensor or numpy array) and every output tensor carries the row axis
    first, and ``fn`` finds its device on its tensor arguments.  Rows are
    padded to a multiple of the shard count, each shard's contiguous block
    runs on its device, and the outputs come back concatenated in row
    order on this process's first device, sliced to the real rows.  With
    ``processes=P`` the shards span the fleet (see module docstring).
    """
    if not args:
        raise ValueError("run_rows_sharded: no arguments")
    devs = local_devices(devices, processes)
    B = leading_rows(args[0])
    rows, starts, per = shard_blocks(B, len(devs), processes)
    padded = [pad_rows(a, rows) for a in args]
    outs = [fn(*(take_rows(a, lo, lo + per, dev) for a in padded))
            for lo, dev in zip(starts, devs)]
    return tree_map(lambda x: x[:B], gather_rows(outs, processes, devs[0]))
