"""Heterogeneous machine-fleet generators (speed/power tiers).

A copy of ``repro.scenarios.fleets`` (numpy only), held against it by
``tests/test_torch_scenarios.py``: the same seeds give the same fleets.

The paper's Section 3.1 uses five server classes with power draw growing
faster than speed (so fast servers are energy-inefficient — the source of
the carbon/energy tension in its heterogeneous results).  This module turns
that single hand-rolled menu into named fleet generators over any machine
count:

=========== ==========================================================
fleet       composition
=========== ==========================================================
homog       all baseline: 1 kW, speed 1 (the paper's homogeneous setup)
tiered      the paper's 5-class menu cycled deterministically over the
            machines (machine ``i`` gets class ``i mod 5``)
mixed       each machine draws a class uniformly at random, with one
            machine forced to the baseline class so every fleet has a
            speed-1 reference server
=========== ==========================================================

Every generator returns ``(powers_kw, speeds)`` tuples ready for
:class:`repro_torch.core.instance.Instance`.  Adding a fleet: write
``def myfleet(rng, n_machines) -> (powers, speeds)`` and register it in
:data:`FLEETS`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.instance import HETERO_POWERS_KW, HETERO_SPEEDS

Fleet = tuple[tuple[float, ...], tuple[float, ...]]

_N_CLASSES = len(HETERO_POWERS_KW)
_BASELINE_CLASS = HETERO_SPEEDS.index(1.0)


def homog(rng: np.random.Generator, n_machines: int) -> Fleet:
    """All machines identical: 1 kW at speed 1."""
    return (1.0,) * n_machines, (1.0,) * n_machines


def tiered(rng: np.random.Generator, n_machines: int) -> Fleet:
    """The paper's 5-class menu, cycled deterministically over the fleet."""
    powers = tuple(HETERO_POWERS_KW[i % _N_CLASSES] for i in range(n_machines))
    speeds = tuple(HETERO_SPEEDS[i % _N_CLASSES] for i in range(n_machines))
    return powers, speeds


def mixed(rng: np.random.Generator, n_machines: int) -> Fleet:
    """Uniform random class per machine; machine 0 pinned to the baseline
    class so every fleet has a speed-1 reference server."""
    cls = rng.integers(0, _N_CLASSES, size=n_machines)
    cls[0] = _BASELINE_CLASS
    return (tuple(HETERO_POWERS_KW[c] for c in cls),
            tuple(HETERO_SPEEDS[c] for c in cls))


FLEETS = {
    "homog": homog,
    "tiered": tiered,
    "mixed": mixed,
}

FLEET_NAMES = tuple(FLEETS)


def build_fleet(fleet: str, rng: np.random.Generator,
                n_machines: int) -> Fleet:
    """Build a named fleet; returns ``(powers_kw, speeds)``."""
    if n_machines < 1:
        raise ValueError(f"n_machines must be >= 1, got {n_machines}")
    try:
        fn = FLEETS[fleet]
    except KeyError:
        raise ValueError(
            f"unknown fleet {fleet!r}; have {FLEET_NAMES}") from None
    return fn(rng, n_machines)
