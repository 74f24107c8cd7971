"""Parallelism configuration threaded through every model apply.

The counterpart of ``repro.models.parallel`` without a mesh: one card, so
``constrain`` and ``batch_spec`` are no-ops.  ``attn_block`` is the tile
of the plain blockwise attention (``attention.flash_unrolled``), which the
CPU runs; the card's kernel tiles itself.  The mesh, remat and MoE fields
come with the shard and train slices.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    attn_block: int = 2048       # flash block size (q and kv)


def constrain(x, par: ParallelCfg, spec=None):
    """A sharding constraint; a no-op on one card."""
    return x


def batch_spec(par: ParallelCfg, *rest):
    """The activation batch spec; there is none on one card."""
    return None
