"""Parameter trees: ``ParamDef`` leaves, materialized on a device.

The counterpart of ``repro.models.params``.  Every layer builder returns a
nested dict of :class:`ParamDef` leaves carrying the shape, dtype, an
*initializer name* and the logical axis names (kept for the shard slice,
which ports ``ShardingRules`` and the pspec helpers).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[Any, ...]              # logical axis name (or None) per dim
    init: str = "normal"                  # normal | zeros | ones | scaled
    dtype: torch.dtype = torch.float32
    scale: float = 1.0                    # stddev multiplier for normal/scaled

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def tree_map_defs(fn: Callable[[ParamDef], Any], tree):
    """Apply ``fn`` to every ParamDef leaf of a nested dict."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    return {k: tree_map_defs(fn, v) for k, v in tree.items()}


def tree_leaves(tree) -> list:
    """Leaves of a nested dict, in sorted-key order (JAX's dict order)."""
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def _fan_in(shape: tuple[int, ...]) -> int:
    # For matmul weights [in, out] (our convention), fan-in = prod of all
    # dims except the last.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(int(np.prod(shape[:-1])), 1)


def init_params(generator: torch.Generator, tree, dtype_override=None):
    """Materialize a ParamDef tree on ``generator``'s device.

    The initializers are the reference's (``normal``: 0.02 x N(0, 1) x
    scale; ``scaled``: N(0, 1) x scale / sqrt(fan_in); ``zeros``;
    ``ones``), drawn leaf by leaf in sorted-key order from ``generator``.
    The numbers differ from ``jax.random``'s for the same seed: to compute
    what the reference computes, load its weights with
    :func:`repro_torch.models.convert.params_from_numpy`.
    """
    dev = generator.device

    def one(d: ParamDef):
        dt = dtype_override or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        if d.init == "normal":
            std = d.scale * 0.02
        elif d.init == "scaled":  # 1/sqrt(fan_in)
            std = d.scale / math.sqrt(_fan_in(d.shape))
        else:
            raise ValueError(f"unknown init {d.init!r}")
        x = torch.randn(d.shape, generator=generator, device=dev)
        return x.mul_(std).to(dt)

    def walk(t):
        if isinstance(t, ParamDef):
            return one(t)
        return {k: walk(t[k]) for k in sorted(t)}

    return walk(tree)


def count_params(tree) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(tree))
