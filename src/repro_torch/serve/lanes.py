"""Lane-pool bookkeeping for continuous-batching engines.

A copy of ``repro.serve.lanes``: a fixed pool of ``n_lanes`` slot lanes
whose device tensors stay shape-static, a FIFO queue of pending work, one
step over the whole pool per tick, and insert/evict between ticks.  The
pool tracks *which lane holds which payload* — nothing else.  Device
state (caches) stays with the engine; an empty lane's device rows are
inert by the engine's own padding convention.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


class LanePool:
    """Host-side occupancy of a fixed pool of slot lanes.

    Payloads are arbitrary (a serve ``Request``, a stream job record).
    ``admit`` fills free lanes from a FIFO queue (or, via its ``select``
    policy hook, from the ready prefix in policy order); ``evict`` frees one
    lane; ``drain`` empties the pool (the end-of-run reset that makes
    engines re-entrant).
    """

    def __init__(self, n_lanes: int):
        if n_lanes < 1:
            raise ValueError(f"LanePool needs >= 1 lane, got {n_lanes}")
        self._slots: list[Any] = [None] * n_lanes

    @property
    def n_lanes(self) -> int:
        return len(self._slots)

    def payload(self, lane: int) -> Any:
        """The payload in ``lane`` (None if free)."""
        return self._slots[lane]

    def payloads(self) -> list[Any]:
        """All slots in lane order (None where free) — for building per-lane
        device inputs."""
        return list(self._slots)

    def free_lanes(self) -> list[int]:
        return [l for l, s in enumerate(self._slots) if s is None]

    def active(self) -> Iterator[tuple[int, Any]]:
        """(lane, payload) pairs for occupied lanes, in lane order."""
        return ((l, s) for l, s in enumerate(self._slots) if s is not None)

    def any_active(self) -> bool:
        return any(s is not None for s in self._slots)

    def insert(self, lane: int, payload: Any) -> None:
        if self._slots[lane] is not None:
            raise ValueError(f"lane {lane} is occupied")
        if payload is None:
            raise ValueError("payload must not be None (None marks a free "
                             "lane)")
        self._slots[lane] = payload

    def evict(self, lane: int) -> Any:
        """Free ``lane``, returning its payload."""
        payload = self._slots[lane]
        if payload is None:
            raise ValueError(f"lane {lane} is already free")
        self._slots[lane] = None
        return payload

    def admit(self, queue, ready: Callable[[Any], bool] | None = None,
              select: Callable[[list], int] | None = None
              ) -> list[tuple[int, Any]]:
        """Fill free lanes from ``queue`` (removed in place).

        ``queue`` is any mutable sequence; a ``collections.deque`` makes the
        default FIFO pop O(1) — with a plain list every admission shifts the
        whole backlog (the O(n^2)-under-load behavior the stream engine's
        deque fixed; a list still works, for callers that don't care).

        ``ready`` (optional) guards eligibility — with ``queue`` sorted by
        readiness (arrival order), the eligible items are exactly the prefix
        passing ``ready``, and admission stops when the head fails it (a
        stream job that hasn't *arrived* yet must not jump the FIFO order).

        ``select`` (optional) is the admission-policy hook: given the list
        of currently-eligible payloads (the ready prefix, queue order), it
        returns the index of the one to admit next.  ``None`` is FIFO
        (always index 0).  Policies only reorder *within* the ready set, so
        the not-yet-ready tail can never be jumped into a lane.

        Returns the ``(lane, payload)`` placements so the engine can run its
        per-admission device work (prefill, greedy/budget solve) for exactly
        the new payloads.
        """
        placed: list[tuple[int, Any]] = []
        for lane in self.free_lanes():
            if not queue or (ready is not None and not ready(queue[0])):
                break
            if select is None:
                item = (queue.popleft() if hasattr(queue, "popleft")
                        else queue.pop(0))
            else:
                n_ready = len(queue)
                if ready is not None:
                    n_ready = 0
                    for x in queue:
                        if not ready(x):
                            break
                        n_ready += 1
                i = int(select([queue[k] for k in range(n_ready)]))
                if not 0 <= i < n_ready:
                    raise ValueError(
                        f"admission policy chose index {i} outside the "
                        f"ready prefix of length {n_ready}")
                item = queue[i]
                del queue[i]
            self._slots[lane] = item
            placed.append((lane, item))
        return placed

    def drain(self) -> list[Any]:
        """Evict every occupied lane; returns the payloads in lane order."""
        out = [s for s in self._slots if s is not None]
        self._slots = [None] * len(self._slots)
        return out
