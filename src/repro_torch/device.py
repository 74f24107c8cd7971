"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Asking for the card on a host without one raises here: the
port never falls back to the CPU on its own.  Tests pass ``device="cpu"``.
:class:`Stages` times the stages of a bench run against the device.
"""
from __future__ import annotations

import contextlib
import time

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """``torch.device`` for ``device``; raises if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stages:
    """Wall seconds of named stages, each timed between two
    synchronisations of ``device``: ``with stages("name"): ...`` adds to
    ``stages.seconds["name"]``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
