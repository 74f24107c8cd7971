"""Sharded structure sweep: the offline bound and the whole sweep.

The counterpart of ``repro.shard.sweep``:

* :func:`bilevel_sharded`: :func:`repro_torch.core.solvers.bilevel.
  solve_bilevel_batch` with rows (instances, traces, row seeds) split
  into blocks, each block solved on its device with
  :class:`~repro_torch.core.solvers.common.RowDraws` over its own rows'
  seeds;
* :func:`sweep_sharded`: the full structure sweep through
  ``sweep_structure(devices=...)``, which routes dispatch, bound,
  training and evaluation through this package.

Bit-exact with the single-device bound because a row's SA chain draws
from its own seed only (``RowDraws``), rows never interact, and padded
rows (seed 0, inert instances) are sliced off.  It also needs the
solver's per-row arithmetic not to depend on how many rows a call holds;
``tests/test_torch_shard.py`` holds that on the CPU and ``chip_smoke.py``
on the card.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.instance import PackedInstance
from repro_torch.core.solvers.bilevel import BilevelResult, solve_bilevel_batch
from repro_torch.core.solvers.common import RowDraws
from repro_torch.shard.batch import run_rows_sharded


def bilevel_sharded(insts: PackedInstance, cums, seeds,
                    devices: int | Sequence | None = None,
                    processes: int | None = None, **kw) -> BilevelResult:
    """``solve_bilevel_batch(insts, cums, RowDraws(seeds), **kw)`` with the
    instance axis sharded.

    ``seeds``: one 64-bit seed per row, ``[B]``
    (:func:`~repro_torch.core.solvers.common.row_seeds`).  Rows are padded
    to a multiple of the shard count (inert instances, zero traces, seed
    0), each block is solved on its device, and the result comes back in
    row order, sliced to the real rows; ``devices`` / ``processes`` as in
    :func:`repro_torch.shard.batch.run_rows_sharded`.
    """
    def per_shard(b, c, s):
        return solve_bilevel_batch(b, c, RowDraws(s, c.device), **kw)

    return run_rows_sharded(per_shard,
                            (insts, cums, np.asarray(seeds, np.uint64)),
                            devices=devices, processes=processes)


def sweep_sharded(spec, offline: bool = True, learn=None,
                  devices: int | Sequence | None = None,
                  processes: int | None = None):
    """The full structure sweep, sharded: ``(rows, meta)`` as
    :func:`~repro_torch.scenarios.sweep.sweep_structure` returns them,
    bit-exact with the single-device sweep.  ``devices=None`` uses every
    local card (one card a process in a fleet)."""
    from repro_torch.scenarios.sweep import sweep_structure   # avoids a cycle
    from repro_torch.shard.batch import local_devices
    return sweep_structure(spec, offline=offline, learn=learn,
                           devices=local_devices(devices, processes),
                           processes=processes)
