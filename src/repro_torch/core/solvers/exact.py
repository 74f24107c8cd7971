"""Exact oracle for tiny FJSP instances (pure Python / numpy).

A copy of ``repro.core.solvers.exact`` that reads the port's torch
:class:`~repro_torch.core.instance.PackedInstance`; held against the
reference's by ``tests/test_torch_exact.py``.

Replaces the paper's CP-SAT *in tests only*: it certifies that the port's
metaheuristics reach the optimal makespan and near-optimal carbon on
instances small enough to enumerate.  Two searches:

* :func:`exact_makespan` — enumerate (topological order, machine assignment)
  pairs and decode each with earliest-start SGS.  The SGS image contains a
  makespan-optimal schedule (DESIGN.md §3), so the minimum over the
  enumeration is the true OPT.
* :func:`exact_carbon` — DFS over tasks in topological order, branching on
  (machine, start epoch) with branch-and-bound pruning; exact over the given
  horizon.  Exponential — keep T <= 5, H <= 16 in tests.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.instance import PackedInstance


def _np_inst(inst: PackedInstance):
    return tuple(getattr(inst, f).cpu().numpy() for f in
                 ("dur", "allowed", "pred", "arrival", "task_mask", "power"))


def _topological_orders(pred: np.ndarray, mask: np.ndarray):
    """Yield every topological order of the real tasks."""
    T = pred.shape[0]
    real = [t for t in range(T) if mask[t]]

    def rec(placed: list[int], remaining: set[int]):
        if not remaining:
            yield list(placed)
            return
        for t in sorted(remaining):
            if all((not pred[t, u]) or (u in placed) for u in range(T) if mask[u]):
                placed.append(t)
                remaining.remove(t)
                yield from rec(placed, remaining)
                placed.pop()
                remaining.add(t)

    yield from rec([], set(real))


def _sgs_np(order, assign, dur, pred, arrival, mask, M):
    """Earliest-start SGS for a fixed order + assignment. Returns (start, ms)."""
    T = dur.shape[0]
    comp = np.zeros(T, np.int64)
    start = np.zeros(T, np.int64)
    mfree = np.zeros(M, np.int64)
    for t in order:
        m = assign[t]
        pc = max([comp[u] for u in range(T) if pred[t, u] and mask[u]], default=0)
        s = max(arrival[t], pc, mfree[m])
        start[t] = s
        comp[t] = s + dur[t, m]
        mfree[m] = comp[t]
    ms = max((comp[t] for t in range(T) if mask[t]), default=0)
    return start, ms


def exact_makespan(inst: PackedInstance) -> int:
    """True optimal makespan by enumeration. Exponential — tiny instances only."""
    dur, allowed, pred, arrival, mask, _ = _np_inst(inst)
    T, M = dur.shape
    real = [t for t in range(T) if mask[t]]
    best = np.inf
    machine_choices = [
        [m for m in range(M) if allowed[t, m]] for t in range(T)]
    for order in _topological_orders(pred, mask):
        for combo in itertools.product(*(machine_choices[t] for t in real)):
            assign = np.zeros(T, np.int64)
            for t, m in zip(real, combo):
                assign[t] = m
            _, ms = _sgs_np(order, assign, dur, pred, arrival, mask, M)
            best = min(best, ms)
    return int(best)


def exact_carbon(inst: PackedInstance, cum: np.ndarray, deadline: int
                 ) -> tuple[float, np.ndarray, np.ndarray]:
    """Exact minimum carbon subject to makespan <= deadline.

    Returns (carbon, start, assign). Branch-and-bound over tasks in
    topological index order; each branch picks (machine, start).
    """
    dur, allowed, pred, arrival, mask, power = _np_inst(inst)
    cum = np.asarray(cum, np.float64)
    T, M = dur.shape
    real = [t for t in range(T) if mask[t]]
    best = {"carbon": np.inf, "start": None, "assign": None}
    start = np.zeros(T, np.int64)
    assign = np.zeros(T, np.int64)
    busy: list[list[tuple[int, int]]] = [[] for _ in range(M)]

    def feasible_on(m: int, s: int, e: int) -> bool:
        return all(e <= bs or s >= be for (bs, be) in busy[m])

    def rec(i: int, carbon_so_far: float):
        if carbon_so_far >= best["carbon"]:
            return
        if i == len(real):
            best["carbon"] = carbon_so_far
            best["start"] = start.copy()
            best["assign"] = assign.copy()
            return
        t = real[i]
        pc = max([start[u] + dur[u, assign[u]]
                  for u in range(T) if pred[t, u] and mask[u]], default=0)
        lo = max(int(arrival[t]), pc)
        for m in range(M):
            if not allowed[t, m]:
                continue
            d = int(dur[t, m])
            for s in range(lo, deadline - d + 1):
                if not feasible_on(m, s, s + d):
                    continue
                g = float(power[m]) * (cum[s + d] - cum[s])
                start[t], assign[t] = s, m
                busy[m].append((s, s + d))
                rec(i + 1, carbon_so_far + g)
                busy[m].pop()
        start[t], assign[t] = 0, 0

    rec(0, 0.0)
    return best["carbon"], best["start"], best["assign"]
