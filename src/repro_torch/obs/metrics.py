"""Counters, gauges and histograms with a snapshot API.

A copy of ``repro.obs.metrics``: the host-side registry that
:meth:`repro_torch.serve.engine.ServeEngine.summary` is a view over.
Everything here is plain Python on the host, read around the engine's
steps, so metrics can never move what the engine computes.

Instruments:

* :class:`Counter` — monotone ``inc``;
* :class:`Gauge` — last-write-wins ``set``;
* :class:`Histogram` — ``observe`` samples, snapshot reports
  count/mean/p50/p90/max (the queue-delay and wall-clock distributions).
"""
from __future__ import annotations

import numpy as np


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    __slots__ = ("samples",)

    def __init__(self):
        self.samples: list[float] = []

    def observe(self, x: float) -> None:
        self.samples.append(float(x))

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples, np.float64), q))

    def snapshot(self) -> dict:
        if not self.samples:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                    "max": 0.0}
        a = np.asarray(self.samples, np.float64)
        return {"count": int(a.size), "mean": float(a.mean()),
                "p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)), "max": float(a.max())}


class MetricsRegistry:
    """Get-or-create instruments by name; one ``snapshot()`` dict out.

    Names are free-form; the type is fixed by whichever of
    ``counter``/``gauge``/``histogram`` first claims the name (claiming it
    again with a different type raises — a silent type swap would corrupt
    the snapshot).
    """

    def __init__(self):
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls()
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} is {type(inst).__name__}, "
                            f"not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def reset(self) -> None:
        self._instruments.clear()

    def snapshot(self) -> dict:
        """Flat name -> value dict: counters/gauges as scalars, histograms
        as their distribution dicts.  Safe to ``json.dump``."""
        out: dict = {}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, Histogram):
                out[name] = inst.snapshot()
            else:
                v = inst.value
                out[name] = float(v) if isinstance(v, float) else v
        return out
