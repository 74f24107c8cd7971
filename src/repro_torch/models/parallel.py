"""Parallelism configuration threaded through every model apply.

The counterpart of ``repro.models.parallel`` without a mesh: one card, so
``constrain`` and ``batch_spec`` are no-ops.  ``attn_block`` is the tile
of the plain blockwise attention (``attention.flash_unrolled``), which the
CPU runs and the train mode's backward recomputes; the card's kernel
tiles itself.  ``remat`` is the train mode's per-layer recompute policy
(``families._remat``), ``loss_chunk`` the sequence chunk of the
cross-entropy.  The mesh fields (``mesh``, ``rules``, ``seq_shard``,
``zero_stage``, ``moe_ep``, ``ar_barrier``) and ``scan_layers`` have no
one-card meaning and are not ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    remat: str = "full"          # full | dots | none  (per-layer recompute)
    attn_block: int = 2048       # flash block size (q and kv)
    loss_chunk: int = 1024       # CE loss seq chunk


def constrain(x, par: ParallelCfg, spec=None):
    """A sharding constraint; a no-op on one card."""
    return x


def batch_spec(par: ParallelCfg, *rest):
    """The activation batch spec; there is none on one card."""
    return None
