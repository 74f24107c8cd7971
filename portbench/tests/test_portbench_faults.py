"""The control and each fault a bound cell can have, planted under a whole
run of the harness on the CPU (at the tiny size), come out not correct;
sound runs come out correct.

The faults (``portbench.control.FAULTS``): the timing sweep returns its
starts unchanged; every SA iteration leaves its chains unchanged; half
of a job's instances are solved and stand for the rest; one start of
each instance is altered where phase 2's schedule is produced; the
population's carbon integral reads ``cum`` one epoch late, or comes out
scaled by ``1 + 2**-10`` (neither reaches the reported schedules'
carbon: only the fitness check sees them).  A bound
cell runs on one card, so no exchange between cards can be left out.
"""
from __future__ import annotations

import pytest

from portbench.control import FAULTS
from portbench.tests.portbench_tiny import CELLS, make_root, run_many

SEED = 7


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("tiny"))
    specs = ([{"cell": c, "seed": SEED} for c in CELLS]
             + [{"cell": c, "seed": SEED, "control": True} for c in CELLS]
             + [{"cell": c, "seed": SEED, "fault": f}
                for c in CELLS for f in FAULTS])
    keys = [(s["cell"], s.get("fault") or ("control" if s.get("control")
                                             else "sound")) for s in specs]
    return dict(zip(keys, run_many(root, specs)))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(runs, cell):
    res = runs[(cell, "sound")]
    assert res["rc"] == 0 and res["result"]["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(runs, cell):
    res = runs[(cell, "control")]
    assert res["rc"] == 0 and res["result"]["correct"] is False
    checks = res["result"]["checks"]
    for n in ("carbon_rel_gap", "fitness_rel_gap"):
        assert checks[n]["value"] > checks[n]["limit"], n


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(runs, cell, fault):
    res = runs[(cell, fault)]
    assert res["rc"] == 0
    line = res["result"]
    assert line["correct"] is False and line["failed"] > 0
    if fault.startswith("carbon_"):
        checks = line["checks"]
        assert checks["fitness_rel_gap"]["value"] \
            > checks["fitness_rel_gap"]["limit"]
