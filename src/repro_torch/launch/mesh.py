"""Meshes: named axes and their sizes, and a mesh placed on a fleet.

The counterpart of ``repro.launch.mesh``.  A :class:`MeshShape` is the
axis names and sizes with no devices behind them, the duck type the
reference's roofline reads (``roofline._MeshLike``) and all the dry run's
policy needs.  A mesh is named ``pod`` and its sizes (``pod16x16``,
``pod2x16x16``, the reference's names; ``pod1x1`` one card); ``parse``
reads ``--mesh data=2,model=2``.

A :class:`ProcessMesh` places a shape on the ranks of a
``torch.distributed`` fleet (the reference places ``jax.devices()``):
one rank a mesh device, each holding its own shard of the model
(``models.params.shard_params``) and talking to the others only through
``models.parallel``'s collectives.  ``make_smoke_mesh`` and
``make_production_mesh`` are the reference's builders over such a fleet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.shard import distributed


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) \
                or min(self.sizes, default=0) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} must pair up, each size >= 1")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "pod" + "x".join(str(n) for n in self.sizes)

    @classmethod
    def production(cls, multi_pod: bool = False) -> "MeshShape":
        """The reference's production meshes: 16 x 16 (one pod) or
        2 x 16 x 16 (two pods)."""
        if multi_pod:
            return cls(("pod", "data", "model"), (2, 16, 16))
        return cls(("data", "model"), (16, 16))

    @classmethod
    def card(cls) -> "MeshShape":
        """One card, with the production axis names."""
        return cls(("data", "model"), (1, 1))

    @classmethod
    def parse(cls, spec: str) -> "MeshShape":
        """``"data=1,model=1"`` (or ``"pod=2,data=16,model=16"``)."""
        names, sizes = [], []
        for part in spec.split(","):
            name, _, size = part.partition("=")
            if not size.strip().isdigit():
                raise ValueError(f"mesh spec {spec!r}: want axis=size "
                                 "pairs separated by commas")
            names.append(name.strip())
            sizes.append(int(size))
        return cls(tuple(names), tuple(sizes))

    @classmethod
    def from_name(cls, name: str) -> "MeshShape":
        """The mesh a record's ``mesh`` name stands for (``pod16x16``)."""
        sizes = tuple(int(n) for n in name.removeprefix("pod").split("x"))
        axes = {2: ("data", "model"), 3: ("pod", "data", "model")}
        if len(sizes) not in axes:
            raise ValueError(f"mesh name {name!r}: want pod<data>x<model> "
                             "or pod<pod>x<data>x<model>")
        return cls(axes[len(sizes)], sizes)


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh(MeshShape):
    """A mesh of ``torch.distributed`` ranks, as seen from one of them.

    The counterpart of a placed ``jax.sharding.Mesh``: a
    :class:`MeshShape` (so everything that sizes a mesh reads it), this
    rank's coordinate on each axis, its device, and one gloo sub-group per
    axis of size > 1, holding the ranks that differ from this one only on
    that axis.  Ranks are laid out row-major over the axes, as
    ``np.asarray(devices).reshape(sizes)`` lays out the reference's: rank
    ``r`` sits at ``np.unravel_index(r, sizes)``, so on a
    ``(data, model)`` mesh device ``(d, m)`` is rank ``d * model + m``.

    ``groups is None`` marks a *counted* mesh: no fleet stands behind it,
    and ``models.parallel``'s collectives count the bytes they would move
    and move none (the dry run's rank 0 on ``meta``).
    """
    coords: tuple[int, ...] = ()
    device: torch.device = torch.device("meta")
    groups: dict | None = None

    def __post_init__(self):
        super().__post_init__()
        if len(self.coords) != len(self.sizes) or any(
                not 0 <= c < n for c, n in zip(self.coords, self.sizes)):
            raise ValueError(f"coordinates {self.coords} do not lie on the "
                             f"mesh {self.shape}")

    @property
    def rank(self) -> int:
        r = 0
        for c, n in zip(self.coords, self.sizes):
            r = r * n + c
        return r

    def coord(self, axis: str) -> int:
        """This rank's place on ``axis`` (0 on an axis the mesh lacks)."""
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def placed(self) -> bool:
        return self.groups is not None

    @classmethod
    def build(cls, shape: MeshShape,
              device: str | torch.device | None = None) -> "ProcessMesh":
        """This rank's view of ``shape`` over the fleet it joined
        (``shard.initialize_from_env``), whose size must be the mesh's.
        Every rank of the fleet must call it, with the same shape: each
        axis's sub-groups are made by every rank, in one order.  The
        device defaults to ``cuda:(rank % device_count)``."""
        count, rank = distributed.process_count(), distributed.process_index()
        if count != shape.size:
            raise ValueError(
                f"the mesh {shape.shape} needs {shape.size} ranks, but this "
                f"process belongs to a fleet of {count}: launch one worker "
                "per rank (python -m tests.harness --processes "
                f"{shape.size} -- ...)")
        coords = tuple(int(c) for c in np.unravel_index(rank, shape.sizes))
        if device is None:
            resolve_device("cuda")
            device = f"cuda:{rank % torch.cuda.device_count()}"
        groups: dict = {}
        grid = np.arange(shape.size).reshape(shape.sizes)
        for i, axis in enumerate(shape.axis_names):
            if shape.sizes[i] == 1:
                continue
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape.sizes[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line],
                                       backend="gloo")
                if rank in line:
                    groups[axis] = group
        return cls(shape.axis_names, shape.sizes, coords,
                   resolve_device(device), groups)

    @classmethod
    def counted(cls, shape: MeshShape, coords: tuple[int, ...] | None = None,
                device: str | torch.device = "meta") -> "ProcessMesh":
        """Rank ``coords`` (rank 0 by default) of ``shape`` with no fleet
        behind it: the collectives count and move nothing."""
        coords = coords if coords is not None else (0,) * len(shape.sizes)
        return cls(shape.axis_names, shape.sizes, tuple(coords),
                   torch.device(device), None)


def make_smoke_mesh(device: str | torch.device | None = None
                    ) -> ProcessMesh:
    """A 1 x 1 ``(data, model)`` mesh in one process (the reference's CPU
    test mesh); its collectives are the identity."""
    return ProcessMesh.build(MeshShape.card(), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None
                         ) -> ProcessMesh:
    """The reference's production mesh (16 x 16, or 2 x 16 x 16 with
    ``multi_pod``) over a fleet of 256 (512) ranks.  Raises where the
    reference raises, when the fleet has fewer ranks than the mesh
    needs, and also when it has more (every rank of a fleet is placed)."""
    shape = MeshShape.production(multi_pod)
    have = distributed.process_count()
    if have < shape.size:
        raise RuntimeError(
            f"need {shape.size} ranks for the production mesh, have {have} "
            f"(launch them with python -m tests.harness --processes "
            f"{shape.size} -- ...)")
    return ProcessMesh.build(shape, device)
