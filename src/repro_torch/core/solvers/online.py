"""Online carbon-aware list scheduling: the sequential numpy oracle.

A copy of ``repro.core.solvers.online`` for the port, so that a machine
without JAX still has the reference the batched torch dispatcher
(:mod:`repro_torch.core.solvers.online_torch`) is held against.  It reads
a port :class:`~repro_torch.core.instance.PackedInstance` through
``.cpu().numpy()``; everything else is the reference's code.

* :func:`online_greedy` — carbon-agnostic earliest-task-first on the
  earliest-finishing machine (the classic Graham list scheduler): the
  online *makespan* baseline.
* :func:`online_carbon_gated` — same dispatch rule, but a ready task may
  *wait* while the current intensity is above the ``theta``-quantile of
  the forecast over the next ``window`` epochs — bounded by a makespan
  budget ``stretch x`` the carbon-agnostic online makespan.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.instance import PackedInstance

# Machine choice among the *free* allowed machines at dispatch time (all
# candidates start now, so min duration == earliest finish):
#   earliest_finish — (duration, energy) lexicographic.
#   min_energy      — (energy, duration) lexicographic.
# Ties beyond the key fall to the lowest machine index (stable min).
ONLINE_MACHINE_RULES = ("earliest_finish", "min_energy")


def _np_inst(inst: PackedInstance):
    return tuple(getattr(inst, f).cpu().numpy()
                 for f in ("dur", "allowed", "pred", "arrival", "task_mask",
                           "power"))


def _critical_path(dur, allowed, pred, mask) -> np.ndarray:
    """Downstream critical path per task (min-duration), incl. itself."""
    T = dur.shape[0]
    dmin = np.where(allowed, dur, 1 << 20).min(1)
    cp = np.zeros(T, np.int64)
    for t in range(T - 1, -1, -1):          # topological (pred[u,t] => t<u)
        if not mask[t]:
            continue
        succ = [u for u in range(T) if pred[u, t] and mask[u]]
        cp[t] = dmin[t] + (max(cp[u] for u in succ) if succ else 0)
    return cp


def _simulate(inst: PackedInstance, intensity: np.ndarray | None,
              theta: float, window: int, budget: int | None,
              machine_rule: str = "earliest_finish"):
    if machine_rule not in ONLINE_MACHINE_RULES:
        raise ValueError(f"unknown machine_rule {machine_rule!r}")
    dur, allowed, pred, arrival, mask, power = _np_inst(inst)
    T, M = dur.shape
    real = mask.nonzero()[0]
    cp = _critical_path(dur, allowed, pred, mask)
    start = np.zeros(T, np.int64)
    assign = np.zeros(T, np.int64)
    comp = np.full(T, -1, np.int64)
    mfree = np.zeros(M, np.int64)
    done: set[int] = set()
    horizon = len(intensity) if intensity is not None else 1 << 20
    t = 0
    while len(done) < len(real) and t < horizon - 1:
        progressed = True
        while progressed:
            progressed = False
            for tk in real:
                if comp[tk] >= 0 or arrival[tk] > t:
                    continue
                if any(pred[tk, u] and mask[u]
                       and (comp[u] < 0 or comp[u] > t) for u in range(T)):
                    continue
                # carbon gate: wait out dirty epochs while the task's
                # downstream critical path still fits the budget.
                if intensity is not None and budget is not None:
                    w = intensity[t:min(t + window, horizon)]
                    thresh = np.quantile(w, theta)
                    dirty = intensity[t] > thresh + 1e-9
                    if dirty and t + 1 + int(cp[tk]) <= budget:
                        continue
                free = [m for m in range(M)
                        if allowed[tk, m] and mfree[m] <= t]
                if not free:
                    continue
                if machine_rule == "min_energy":
                    m = min(free, key=lambda m: (power[m] * dur[tk, m],
                                                 dur[tk, m]))
                else:
                    m = min(free, key=lambda m: (dur[tk, m],
                                                 power[m] * dur[tk, m]))
                start[tk], assign[tk] = t, m
                comp[tk] = t + dur[tk, m]
                mfree[m] = comp[tk]
                if comp[tk] == t:               # zero-length guard
                    done.add(tk)
                progressed = True
        t += 1
        for tk in real:
            if comp[tk] == t and tk not in done:
                done.add(tk)
    return start, assign


def online_greedy(inst: PackedInstance,
                  machine_rule: str = "earliest_finish"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Carbon-agnostic earliest-task-first (online makespan baseline)."""
    return _simulate(inst, None, 0.0, 1, None, machine_rule=machine_rule)


def online_carbon_gated(inst: PackedInstance, intensity: np.ndarray,
                        theta: float = 0.5, window: int = 96,
                        stretch: float = 1.5, budget: int | None = None,
                        machine_rule: str = "earliest_finish"
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Carbon-gated dispatch under an online makespan budget.

    ``intensity``: per-epoch gCO2/kWh forecast.  Budget = ``stretch x``
    the greedy online makespan (computed first); pass ``budget`` directly
    (``int(stretch * greedy_makespan)``) to skip the internal greedy run.
    ``machine_rule`` picks among free machines (see ONLINE_MACHINE_RULES);
    the greedy budget run uses the same rule.
    """
    if budget is None:
        s0, a0 = online_greedy(inst, machine_rule=machine_rule)
        dur = inst.dur.cpu().numpy()
        mask = inst.task_mask.cpu().numpy()
        T = dur.shape[0]
        ms0 = int(max((s0[t] + dur[t, a0[t]]) for t in range(T) if mask[t]))
        budget = int(stretch * ms0)
    return _simulate(inst, np.asarray(intensity), theta, window, budget,
                     machine_rule=machine_rule)
