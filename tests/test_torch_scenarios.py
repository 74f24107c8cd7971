"""Port vs reference: scenario generation, batching and the structure sweep.

The generators are numpy copies, so the same seeds must give the same
instances; the batching helpers must give the reference's fields; the
bench's copies of the structure grids must equal the reference harness's;
and the dispatch-only TINY sweep on the CPU must match
``tests/golden/structure_tiny.json`` as ``tests/test_structure_golden.py``
reads it (exact fields equal, other numbers within rtol 1e-4,
``online_best_policy`` skipped).
"""
import json

import numpy as np
import pytest
import torch

from benchmarks import structure_sweep as jbench
from repro.scenarios import batching as jbatching
from repro.scenarios import generator as jgenerator
from repro.scenarios import sweep as jsweep
from repro_torch import bench
from repro_torch.core.instance import PackedInstance
from repro_torch.scenarios import (FAMILY_NAMES, FLEET_NAMES, ScenarioConfig,
                                   aligned_shape, build_batch, pack_aligned,
                                   pad_stacked, padding_rows, sample_batch,
                                   structure_cells, trend_summary)
from repro_torch.scenarios import sweep_structure
from tests.test_structure_golden import GOLDEN_PATH, _assert_row_matches


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_tuple(inst):
    """An Instance of either package as plain nested tuples."""
    return (tuple((j.arrival, j.base_durations, j.edges) for j in inst.jobs),
            inst.powers_kw, inst.speeds, inst.allowed)


def _same_fields(want, got: PackedInstance, ctx=""):
    for f in PackedInstance._fields:
        g = getattr(got, f)
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      g.numpy(), err_msg=f"{ctx}{f}")


@pytest.mark.parametrize("family", FAMILY_NAMES)
@pytest.mark.parametrize("fleet", FLEET_NAMES)
def test_sample_batch_matches_reference(family, fleet):
    cfg = dict(family=family, fleet=fleet, n_jobs=3, width=3, depth=2,
               n_machines=4)
    for seed in (0, 17):
        want = jgenerator.sample_batch(np.random.default_rng(seed),
                                       jgenerator.ScenarioConfig(**cfg), 3)
        got = sample_batch(np.random.default_rng(seed),
                           ScenarioConfig(**cfg), 3)
        assert [_as_tuple(i) for i in got] == [_as_tuple(i) for i in want]
    assert ScenarioConfig(**cfg).label() == \
        jgenerator.ScenarioConfig(**cfg).label()


def _mixed(seed=3):
    cells = [jgenerator.ScenarioConfig(family=f, fleet=fl, n_jobs=2,
                                       width=2, depth=2, n_machines=m)
             for f, fl, m in (("chain", "homog", 2), ("diamond", "tiered", 5),
                              ("tpch", "mixed", 3))]
    rng = np.random.default_rng(seed)
    j = [i for c in cells for i in jgenerator.sample_batch(rng, c, 2)]
    rng = np.random.default_rng(seed)
    t = [i for c in cells
         for i in sample_batch(rng, ScenarioConfig(**vars(c)), 2)]
    return j, t


@pytest.mark.parametrize("pads", [dict(), dict(pad_tasks=30, pad_machines=7),
                                  dict(pad_batch=9)])
def test_pack_aligned_fields_equal(pads):
    j, t = _mixed()
    assert aligned_shape(t) == jbatching.aligned_shape(j)
    want = jbatching.pack_aligned(j, **pads)
    got = pack_aligned(t, device="cpu", **pads)
    _same_fields(want, got)


def test_padding_rows_and_pad_stacked_equal():
    _same_fields(jbatching.padding_rows(3, 7, 4),
                 padding_rows(3, 7, 4, device="cpu"))
    j, t = _mixed(5)
    jb = jbatching.pack_aligned(j)
    tb = pack_aligned(t, device="cpu")
    _same_fields(jbatching.pad_stacked(jb, 10), pad_stacked(tb, 10))
    assert pad_stacked(tb, tb.dur.shape[0]) is tb
    with pytest.raises(ValueError):
        pad_stacked(tb, 2)
    with pytest.raises(ValueError):
        aligned_shape([])


@pytest.mark.parametrize("tiny", [True, False])
def test_bench_grids_equal_reference(tiny):
    want = jbench.TINY if tiny else jbench.FULL
    got = bench.STRUCTURE_TINY if tiny else bench.STRUCTURE_FULL
    assert set(got) == set(want)
    for k in want:      # SAConfig: the two packages' NamedTuples
        g, w = (tuple(got[k]), tuple(want[k])) if k == "sa" \
            else (got[k], want[k])
        assert g == w, k
    assert bench.STRUCTURE_FAMILIES == jbench.FAMILIES
    js = jbench.make_spec(tiny=tiny)
    ts = bench.structure_spec(tiny=tiny)
    assert [c.label() for c in ts.cells] == [c.label() for c in js.cells]
    for f in ("instances_per_cell", "seed", "region", "horizon", "thetas",
              "windows", "stretches", "offline_stretch"):
        assert getattr(ts, f) == getattr(js, f), f
    assert tuple(ts.sa) == tuple(js.sa)
    assert bench.structure_spec(instances_per_cell=16).instances_per_cell \
        == 16


def test_structure_cells_needs_every_family():
    with pytest.raises(ValueError, match="missing"):
        structure_cells(("chain", "tpch"), {"chain": ((1, 2),)}, (2,),
                        ("homog",))
    cells = structure_cells(("chain", "fanout"), ((1, 2), (2, 2)), (2, 3),
                            ("homog",), n_jobs=2)
    assert len(cells) == 8


def test_build_batch_equals_reference():
    js = jbench.make_spec(tiny=True)
    ts = bench.structure_spec(tiny=True)
    want = jsweep.build_batch(js)
    got = build_batch(ts, "cpu")
    _same_fields(want.batch, got.batch)
    np.testing.assert_array_equal(np.asarray(want.intensity),
                                  got.intensity.numpy())
    np.testing.assert_array_equal(np.asarray(want.cum), got.cum.numpy())
    np.testing.assert_array_equal(want.cell_of, got.cell_of)


def test_tiny_sweep_matches_golden():
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)["structure_tiny"]
    rows, meta = sweep_structure(bench.structure_spec(tiny=True),
                                 offline=False, device="cpu")
    assert meta["pad_tasks"] == golden["pad_tasks"]
    assert meta["pad_machines"] == golden["pad_machines"]
    assert len(rows) == len(golden["cells"])
    for got, want in zip(rows, golden["cells"]):
        _assert_row_matches(got, want, f"cell[{want['family']}-m"
                            f"{want['n_machines']}-{want['fleet']}]")
    assert trend_summary(rows) == jsweep.trend_summary(rows)
    assert set(meta["seconds"]) == {"build", "dispatch", "validate"}


def test_offline_sweep_rows_on_own_draws():
    """Two cells with the offline bound: the row gains its savings, which
    are finite and >= 0 (phase 2 falls back to the feasible baseline)."""
    spec = bench.structure_spec(tiny=True)
    spec = type(spec)(cells=spec.cells[:2], instances_per_cell=2,
                      horizon=spec.horizon, sa=spec.sa._replace(iters=6))
    rows, meta = sweep_structure(spec, offline=True, device="cpu")
    assert meta["instances"] == 4 and "offline_bound" in meta["seconds"]
    for r in rows:
        assert np.isfinite(r["offline_bound_savings_pct"])
        assert r["offline_bound_savings_pct"] >= 0.0
    trends = trend_summary(rows)
    assert "offline_bound_savings_pct_by_family" in trends
