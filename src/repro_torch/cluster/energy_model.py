"""Roofline-derived task durations and energy for ML jobs as FJSP tasks.

The counterpart of ``repro.cluster.energy_model``, copied (plain Python
over :class:`ArchConfig`): the same architecture, shape, step count and
machine class give the same ``(epochs, kWh)`` in both packages.  Each
architecture's roofline (FLOPs per step) prices a "train N steps of arch
X" or "serve N requests of arch X" task on a menu of heterogeneous
accelerator slices: the machine classes the paper's scheduler
(``repro_torch.core``) then places tasks on.

The constants below and :data:`TPU_V5E_CLASSES` are inputs of the
scheduling problem: they describe the *modeled* fleet (TPU v5e slices in
five power/speed tiers, standing in for the paper's heterogeneous
servers), not this package or the card it runs on.  No time or rate
derived from them is a measurement of any device.  They are kept equal to
the reference's so that both packages schedule the same instances.

If a dry-run JSON for the (arch, shape) cell exists under
``experiments/dryrun/`` the step's FLOPs come from it (the reference's
file name and format); otherwise from the analytic 6·N·D estimate.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.models.common import ArchConfig, SHAPES

# The modeled fleet's chips (inputs of the problem, not measurements).
PEAK_FLOPS = 197e12           # bf16 / chip
HBM_BW = 819e9                # bytes/s / chip
LINK_BW = 50e9                # bytes/s / link
CHIP_POWER_KW = 0.30          # chip + share of host/interconnect


@dataclasses.dataclass(frozen=True)
class MachineClass:
    name: str
    chips: int
    utilization: float            # achieved fraction of peak (MFU-ish)

    @property
    def power_kw(self) -> float:
        return self.chips * CHIP_POWER_KW

    @property
    def throughput(self) -> float:  # effective FLOP/s
        return self.chips * PEAK_FLOPS * self.utilization


# Five tiers, paper-style: speeds ~ {1/3, 1/2, 1, 4/3, 2} x the 64-chip
# baseline; smaller slices are more efficient per chip.
TPU_V5E_CLASSES: tuple[MachineClass, ...] = (
    MachineClass("v5e-16", 16, 0.55),
    MachineClass("v5e-32", 32, 0.50),
    MachineClass("v5e-64", 64, 0.45),
    MachineClass("v5e-96", 96, 0.42),
    MachineClass("v5e-160", 160, 0.38),
)

_DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun")


def _dryrun_step_flops(arch: str, shape: str) -> float | None:
    """Per-chip FLOPs x 256 chips from the single-pod dry-run, if present;
    None for a missing, unreadable or malformed record."""
    path = os.path.join(_DRYRUN_DIR, f"{arch}__{shape}__pod16x16.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            rec = json.load(f)
        if (not isinstance(rec, dict) or rec.get("status") != "ok"
                or "flops" not in rec):
            return None
        return float(rec["flops"]) * 256
    except (OSError, ValueError, KeyError, TypeError):
        return None


def step_flops(cfg: ArchConfig, shape: str) -> float:
    """Total FLOPs of one step of the (arch, shape) cell."""
    measured = _dryrun_step_flops(cfg.name, shape)
    if measured is not None:
        return measured
    sc = SHAPES[shape]
    tokens = sc.batch * (sc.seq if sc.kind != "decode" else 1)
    n = cfg.active_param_count()
    mult = 6.0 if sc.kind == "train" else 2.0
    return mult * n * tokens


def task_profile(cfg: ArchConfig, shape: str, n_steps: int,
                 machine: MachineClass, epoch_hours: float = 0.25
                 ) -> tuple[int, float]:
    """(duration_epochs, energy_kwh) of running ``n_steps`` of the cell on
    ``machine`` — the p_{t,m} / E_{t,m} inputs of the paper's Appendix A."""
    work = step_flops(cfg, shape) * n_steps
    seconds = work / machine.throughput
    epochs = max(1, round(seconds / (epoch_hours * 3600)))
    energy = machine.power_kw * epochs * epoch_hours
    return epochs, energy


def baseline_durations(cfg: ArchConfig, shape: str, n_steps: int,
                       classes=TPU_V5E_CLASSES) -> dict[str, int]:
    return {m.name: task_profile(cfg, shape, n_steps, m)[0] for m in classes}
