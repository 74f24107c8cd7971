"""Mesh shapes: named axes and their sizes, with no devices behind them.

The counterpart of ``repro.launch.mesh``.  The reference places
``jax.devices()`` on its production meshes (``make_production_mesh``,
``make_smoke_mesh``); the port's dry run runs on ``meta`` and needs only
the axis names and sizes, the duck type the reference's roofline already
reads (``roofline._MeshLike``).  So neither function is ported: a
:class:`MeshShape` is the mesh.  A mesh is named ``pod`` and its sizes
(``pod16x16``, ``pod2x16x16``, the reference's names; ``pod1x1`` one
card); ``parse`` reads the dry run's ``--mesh data=1,model=1``.
"""
from __future__ import annotations

import dataclasses
import math


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
