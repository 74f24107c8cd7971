"""Parametric DAG families for the scenario generator.

A copy of ``repro.scenarios.families`` (numpy only), held against it by
``tests/test_torch_scenarios.py``: the same seeds give the same DAGs.

The paper's sensitivity analysis (and its Fig. 3) shows that *job structure*
drives how much of the carbon reduction is achievable: chains leave no
parallel slack to shift into clean windows, fan-outs leave a lot.  This
module widens the repo's three hand-rolled Fig. 3 shapes into parametric
families spanning that structural axis:

========== =====================================================
family     structure (one job)
========== =====================================================
chain      path of ``depth`` tasks — zero parallelism
fanout     source -> ``width`` branches of ``depth`` tasks -> sink
diamond    ``depth`` series-composed diamond blocks, each a split
           -> ``width`` parallel tasks -> join (series-parallel)
layered    random layered DAG: ``depth`` layers of 1..``width``
           tasks, every task wired to >= 1 parent one layer up
tpch       TPC-H-like multi-stage query plan a la gym-sparksched:
           ``width`` scan leaves, a binary join tree over them,
           then a ``depth``-stage aggregation tail
========== =====================================================

Every builder returns ``(k, edges)`` with local task indices ``0..k-1`` in
topological order (``u < v`` on every edge), the invariant
:func:`repro_torch.core.instance.pack` requires — so acyclicity holds by
construction and is re-checked by :func:`assert_topological` and the
property tests in ``tests/test_scenarios.py``.

Adding a family: write ``def myfam(rng, width, depth) -> (k, edges)``
keeping the topological invariant, and register it in :data:`FAMILIES`.
Builders take an ``np.random.Generator`` even when deterministic so every
family has the same signature (only ``layered`` and ``tpch`` draw from it).
"""
from __future__ import annotations

import numpy as np

Edges = tuple[tuple[int, int], ...]


def chain(rng: np.random.Generator, width: int, depth: int
          ) -> tuple[int, Edges]:
    """Path of ``depth`` tasks (``width`` ignored): the zero-parallelism pole."""
    k = max(1, depth)
    return k, tuple((i, i + 1) for i in range(k - 1))


def fanout(rng: np.random.Generator, width: int, depth: int
           ) -> tuple[int, Edges]:
    """Source -> ``width`` parallel branches of ``depth`` tasks each -> sink."""
    width, depth = max(1, width), max(1, depth)
    k = 2 + width * depth
    edges: list[tuple[int, int]] = []
    sink = k - 1
    for b in range(width):
        head = 1 + b * depth
        edges.append((0, head))
        for i in range(depth - 1):
            edges.append((head + i, head + i + 1))
        edges.append((head + depth - 1, sink))
    return k, tuple(sorted(edges))


def diamond(rng: np.random.Generator, width: int, depth: int
            ) -> tuple[int, Edges]:
    """``depth`` diamond blocks in series (split -> width middles -> join);
    each join doubles as the next block's split predecessor."""
    width, depth = max(1, width), max(1, depth)
    edges: list[tuple[int, int]] = []
    node = 0
    prev_join: int | None = None
    for _ in range(depth):
        split = node
        mids = list(range(split + 1, split + 1 + width))
        join = split + 1 + width
        if prev_join is not None:
            edges.append((prev_join, split))
        for m in mids:
            edges.append((split, m))
            edges.append((m, join))
        prev_join = join
        node = join + 1
    return node, tuple(sorted(edges))


def layered(rng: np.random.Generator, width: int, depth: int
            ) -> tuple[int, Edges]:
    """Random layered DAG: ``depth`` layers of 1..``width`` tasks; every
    non-root task draws >= 1 parent from the previous layer (p = 0.5 per
    candidate plus a guaranteed pick), so the DAG is layer-connected."""
    width, depth = max(1, width), max(1, depth)
    widths = [int(rng.integers(1, width + 1)) for _ in range(depth)]
    edges: list[tuple[int, int]] = []
    node = 0
    prev_layer: list[int] = []
    for w in widths:
        layer = list(range(node, node + w))
        for v in layer:
            if prev_layer:
                parents = [u for u in prev_layer if rng.random() < 0.5]
                if not parents:
                    parents = [prev_layer[int(rng.integers(len(prev_layer)))]]
                edges.extend((u, v) for u in parents)
        prev_layer = layer
        node += w
    return node, tuple(sorted(edges))


def tpch(rng: np.random.Generator, width: int, depth: int
         ) -> tuple[int, Edges]:
    """TPC-H-like multi-stage query plan (cf. gym-sparksched's TPC-H DAGs):
    ``width`` scan leaves, a (randomly paired) binary join tree reducing
    them to one root, then a ``depth``-stage aggregation tail."""
    width, depth = max(2, width), max(1, depth)
    edges: list[tuple[int, int]] = []
    frontier = list(range(width))   # scan stages, no parents
    node = width
    while len(frontier) > 1:        # join tree: pair off until one root
        rng.shuffle(frontier)
        nxt = []
        for i in range(0, len(frontier) - 1, 2):
            edges.append((frontier[i], node))
            edges.append((frontier[i + 1], node))
            nxt.append(node)
            node += 1
        if len(frontier) % 2:       # odd stage joins into the next level
            nxt.append(frontier[-1])
        frontier = nxt
    for _ in range(depth):          # aggregation / output tail
        edges.append((frontier[0], node))
        frontier = [node]
        node += 1
    return node, tuple(sorted(edges))


FAMILIES = {
    "chain": chain,
    "fanout": fanout,
    "diamond": diamond,
    "layered": layered,
    "tpch": tpch,
}

FAMILY_NAMES = tuple(FAMILIES)


def build_dag(family: str, rng: np.random.Generator, width: int,
              depth: int) -> tuple[int, Edges]:
    """Build one job DAG from a named family; returns ``(k, edges)``."""
    try:
        fn = FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown DAG family {family!r}; have {FAMILY_NAMES}") from None
    k, edges = fn(rng, width, depth)
    assert_topological(k, edges, ctx=family)
    return k, edges


def assert_topological(k: int, edges: Edges, ctx: str = "") -> None:
    """Every edge must satisfy ``0 <= u < v < k`` — which makes the graph a
    DAG outright (any cycle needs at least one non-increasing edge)."""
    for (u, v) in edges:
        if not (0 <= u < v < k):
            raise AssertionError(
                f"non-topological edge ({u}, {v}) with k={k}"
                f"{f' in family {ctx}' if ctx else ''}")
