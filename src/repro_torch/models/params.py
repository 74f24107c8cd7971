"""Parameter trees with logical sharding axes, materialized on a device.

The counterpart of ``repro.models.params``.  Every layer builder returns a
nested dict of :class:`ParamDef` leaves carrying the shape, dtype, an
*initializer name* and a tuple of *logical axis names*, one per
dimension.  A :class:`ShardingRules` table maps logical names to mesh
axes, as in the reference, so the dry run can size each device's share
of a mesh (``launch.dryrun``).  Consumers:

  * ``init_params``  — real tensors on a device;
  * ``param_specs``  — ``meta`` tensors of the same shapes and dtypes, the
                       counterpart of ``jax.ShapeDtypeStruct`` (nothing is
                       allocated);
  * ``param_pspecs`` — a tuple of mesh axes per dimension, the counterpart
                       of ``PartitionSpec``;
  * ``shard_params`` — one rank's blocks of a full tree, the counterpart of
                       ``param_shardings`` (``jax.device_put`` of a tree
                       under ``NamedSharding``s): each sharded dimension
                       holds the contiguous block that ``NamedSharding``
                       gives the rank's mesh device;
  * ``param_local_shapes`` — the shapes of those blocks.
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


# Logical-axis -> mesh-axis rules. A mesh axis may appear at most once per
# param; `fsdp` composes ("pod","data") on the multi-pod mesh so optimizer
# state shards across every device (ZeRO-3 posture).
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple[tuple[str, Any], ...] = (
        ("vocab", "model"),
        ("embed", None),          # d_model replicated by default
        ("heads", "model"),       # attention heads -> tensor parallel
        ("kv_heads", "model"),
        ("mlp", "model"),         # ffn hidden -> tensor parallel
        ("expert", "model"),      # MoE experts -> expert parallel
        ("expert_mlp", None),     # per-expert hidden dim
        ("fsdp", ("data",)),      # ZeRO axis for 2D-sharded big params
        ("layer", None),
        ("seq", None),
        ("ssm_inner", "model"),
        ("ssm_state", None),
        ("conv", None),
        ("batch", ("data",)),     # activation batch axis (single-pod)
        ("act_seq", None),        # activation sequence axis
    )

    def mesh_axes(self, logical: Any):
        for name, ax in self.rules:
            if name == logical:
                return ax
        return None

    def spec(self, logical_axes: tuple[Any, ...]) -> tuple:
        """The mesh axes of each dimension (a ``PartitionSpec`` as a
        tuple); a mesh axis is used once per array, by its first
        dimension."""
        used: list[Any] = []
        out = []
        for lg in logical_axes:
            ax = self.mesh_axes(lg) if lg is not None else None
            if ax is not None:
                flat = ax if isinstance(ax, tuple) else (ax,)
                if any(a in used for a in flat):
                    ax = None
                else:
                    used.extend(flat)
            out.append(ax)
        return tuple(out)

    def replace(self, **updates: Any) -> "ShardingRules":
        table = dict(self.rules)
        table.update(updates)
        return ShardingRules(tuple(table.items()))

    def for_multipod(self) -> "ShardingRules":
        """Fold the pod axis into batch + fsdp sharding."""
        return self.replace(batch=("pod", "data"), fsdp=("pod", "data"))


DEFAULT_RULES = ShardingRules()


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


def init_params(generator: torch.Generator, tree, dtype_override=None,
                block: Callable | None = None):
    """Materialize a ParamDef tree on ``generator``'s device.

    The initializers are the reference's (``normal``: 0.02 x N(0, 1) x
    scale; ``scaled``: N(0, 1) x scale / sqrt(fan_in); ``zeros``;
    ``ones``), drawn leaf by leaf in sorted-key order from ``generator``.
    The numbers differ from ``jax.random``'s for the same seed: to compute
    what the reference computes, load its weights with
    :func:`repro_torch.models.convert.params_from_numpy`.

    ``block(d, x)``, where given, is kept in place of each drawn leaf
    ``x`` (a rank's block of it: :func:`shard_params`' blocks of the tree
    drawn whole, holding one whole leaf at a time).
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
            return one(t) if block is None else block(t, one(t))
        return {k: walk(t[k]) for k in sorted(t)}

    return walk(tree)


def param_specs(tree, device: str | torch.device = "meta"):
    """The tree as empty tensors of each leaf's shape and dtype on
    ``device`` (``meta``: the dry run's stand-in, nothing allocated)."""
    return tree_map_defs(
        lambda d: torch.empty(d.shape, dtype=d.dtype, device=device), tree)


def logical_specs(tree):
    """The logical axes of each leaf."""
    return tree_map_defs(lambda d: d.logical, tree)


def param_pspecs(tree, rules: ShardingRules = DEFAULT_RULES):
    """The mesh axes of each leaf's dimensions under ``rules``."""
    return tree_map_defs(lambda d: rules.spec(d.logical), tree)


def count_params(tree) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(tree))


def sharded_size_bytes(tree, rules: ShardingRules, mesh_shape: dict[str, int]
                       ) -> int:
    """Max per-device bytes of the param tree under ``rules`` on a mesh of
    the given axis sizes: each leaf split over the mesh axes of its
    logical dims, rounded up."""
    total = 0
    for d in tree_leaves(tree):
        n = int(np.prod(d.shape))
        shards = 1
        for lg in d.logical:
            ax = rules.mesh_axes(lg) if lg is not None else None
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                shards *= mesh_shape.get(a, 1)
        total += math.ceil(n / shards) * d.dtype.itemsize
    return total


def _blocks(ax, mesh) -> tuple[int, int]:
    """``(count, index)`` of the blocks a dimension mapped to mesh axes
    ``ax`` splits into, and this rank's block (rank 0's on a mesh with no
    coordinates, a :class:`~repro_torch.launch.mesh.MeshShape`)."""
    if ax is None:
        return 1, 0
    n, i = 1, 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size = mesh.shape.get(a, 1)
        coord = mesh.coord(a) if hasattr(mesh, "coord") else 0
        n, i = n * size, i * size + coord
    return n, i


def local_shape(d: ParamDef, rules: ShardingRules, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of leaf ``d``; a sharded dimension
    must split evenly."""
    out = []
    for size, ax in zip(d.shape, rules.spec(d.logical)):
        n, _ = _blocks(ax, mesh)
        if size % n:
            raise ValueError(f"a dimension of {size} ({d.logical}) does not "
                             f"split into {n} blocks over {ax}")
        out.append(size // n)
    return tuple(out)


def param_local_shapes(tree, rules: ShardingRules, mesh):
    """Each leaf's block shape on ``mesh`` under ``rules``."""
    return tree_map_defs(lambda d: local_shape(d, rules, mesh), tree)


def local_slices(d: ParamDef, rules: ShardingRules, mesh) -> tuple:
    """The slices that cut this rank's block out of a full leaf."""
    out = []
    for size, ax in zip(d.shape, rules.spec(d.logical)):
        n, i = _blocks(ax, mesh)
        out.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(out)


def shard_params(params, defs, rules: ShardingRules, mesh,
                 device: str | torch.device | None = None):
    """This rank's blocks of the full tree ``params`` (tensors or numpy
    arrays, e.g. ``np.load(..., mmap_mode="r")``, of which only the block
    is read), each a new tensor in its ParamDef's dtype on ``device``
    (the mesh's device by default)."""
    device = mesh.device if device is None else device

    def walk(d, t, path):
        if isinstance(d, ParamDef):
            if tuple(t.shape) != d.shape:
                raise ValueError(f"{path}: shape {tuple(t.shape)}, expected "
                                 f"{d.shape}")
            return leaf_block(d, t, rules, mesh, device)
        return {k: walk(d[k], t[k], f"{path}.{k}".lstrip("."))
                for k in sorted(d)}

    return walk(defs, params, "")


def leaf_block(d: ParamDef, t, rules: ShardingRules, mesh,
               device: str | torch.device) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` (a tensor or a numpy
    array), as a new tensor in ``d``'s dtype on ``device``."""
    block = t[local_slices(d, rules, mesh)]
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(device=device, dtype=d.dtype, copy=True)
