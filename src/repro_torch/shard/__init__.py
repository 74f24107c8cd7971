"""Sharding of the instance axis, over devices and over processes.

The counterpart of ``repro.shard``.  The paper-scale sweeps (gated online
dispatch x policy grids, the offline SA bi-level bound, gate-policy
training) are independent over *instances*.  This package splits the
stacked instance batch into contiguous row blocks, one per shard, pads
it to a multiple of the shard count with inert rows
(:mod:`repro_torch.scenarios.batching`), runs each block on its device
and, across a ``torch.distributed`` fleet, gathers the blocks back in
row order.

    distributed — the fleet: ``init_process_group`` on gloo from
                  arguments or the ``REPRO_*`` env, the row gather
    batch       — the shard devices and the generic row-sharded runner
    dispatch    — ``dispatch_sharded``: the gate-policy sweep
    sweep       — ``bilevel_sharded`` (offline SA bound on row-keyed
                  draws) and ``sweep_sharded`` (the whole structure sweep)
    train       — ``greedy_sharded``, ``train_sharded`` and
                  ``eval_theta_sharded``: the learner, its per-row
                  gradients gathered and reduced once, canonically

The contract, held by ``tests/test_torch_shard.py`` and
``tests/test_torch_shard_distributed.py``: **sharded output equals the
single-device output bit for bit**, at any shard count and in a process
fleet whatever the spawn order, and the TINY goldens reproduce when
sharded.  The reference's ``shard_map`` bridge (``compat``), its mesh
axis name and its mesh functions have no torch counterpart: a list of
devices, which may repeat one, takes the mesh's place.

Exports resolve lazily (PEP 562), as the reference's do.
"""
from __future__ import annotations

_EXPORTS = {
    "initialize": "repro_torch.shard.distributed",
    "initialize_from_env": "repro_torch.shard.distributed",
    "is_initialized": "repro_torch.shard.distributed",
    "process_count": "repro_torch.shard.distributed",
    "process_index": "repro_torch.shard.distributed",
    "device_count": "repro_torch.shard.batch",
    "instance_devices": "repro_torch.shard.batch",
    "round_up": "repro_torch.shard.batch",
    "run_rows_sharded": "repro_torch.shard.batch",
    "dispatch_sharded": "repro_torch.shard.dispatch",
    "bilevel_sharded": "repro_torch.shard.sweep",
    "sweep_sharded": "repro_torch.shard.sweep",
    "greedy_sharded": "repro_torch.shard.train",
    "train_sharded": "repro_torch.shard.train",
    "eval_theta_sharded": "repro_torch.shard.train",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch.shard' has no attribute "
                         f"{name!r}")


def __dir__():
    return __all__
