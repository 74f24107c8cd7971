"""The program's own spans against the harness's: the same functions, the
same counts and one clock on a tiny job; and the readers of the program's
spans (``phase1_s``, ``phase2_s``, ``sgs_step_ms``) on a real tiny job,
on a synthetic window computed by hand, and on empty or dropped ones."""
from __future__ import annotations

import time

import pytest
import torch

from portbench.drivers import bound
from portbench.harness.spec import Bench
from portbench.harness.trace import Span, SpanRecorder, build
from portbench.tests.portbench_tiny import CELLS, REPO, make_root
from repro_torch.obs import trace as ptrace

READERS = ("phase1_s.bound", "phase2_s.bound", "sgs_step_ms.bound")
BOUND, P1, P2, FIT, SGS = ("repro_torch.solve_bilevel", "repro_torch.phase1",
                           "repro_torch.phase2",
                           "repro_torch.population_fitness",
                           "repro_torch.sgs")
CTX = {"B": 2, "Pop": 3, "T": 4, "H": 9}


@pytest.fixture(scope="module", params=CELLS)
def tiny_job(request, tmp_path_factory):
    """Job 0 of a cell at the tiny size, on the CPU, under the harness's
    span recorder: the recorder's spans and the program's own in the
    job's bound."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bench = Bench(make_root(tmp_path_factory.mktemp("tiny")))
        cell = bench.workload(request.param)
        driver = bound.Bound(bench.config(cell["config"]),
                             bench.mix(cell["traffic"]), 2**31 + 5,
                             torch.device("cpu"))
        with SpanRecorder(bound.SPANS) as rec:
            driver.run_job(0)
    finally:
        torch.set_num_threads(n)
    (job,) = [s for s in rec.spans if s.name == BOUND]
    return rec.spans, ptrace.spans_between(job.start_ns, job.end_ns)


def test_program_spans_lie_inside_the_harness_spans(tiny_job):
    harness, program = tiny_job
    for name in bound.SPANS:
        h = sorted((s for s in harness if s.name == name),
                   key=lambda s: s.start_ns)
        p = [s for s in program if s.name == name]
        assert len(p) == len(h) > 0, name
        for a, b in zip(h, p):
            assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns, name


def test_readers_read_the_tiny_job(tiny_job):
    harness, _ = tiny_job
    tr = build([Span("portbench.job", 0, 10)], {}, [])
    tr.host = build([Span(s.name, s.start_ns, s.end_ns) for s in harness],
                    {}, [])
    bench = Bench(REPO)
    got = {m: bench.reader(m).read(tr, CTX) for m in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    job = tr.host.spans[tr.host.named(BOUND)[0]].wall_ns / 1e9
    assert 0.9 * job < got["phase1_s.bound"] + got["phase2_s.bound"] <= job


def _host(t0, t1):
    tr = build([Span("portbench.job", 0, 10)], {}, [])
    tr.host = build([Span(BOUND, t0, t1)], {}, [])
    return tr


def _fill(ring, t0):
    """Spans of a bound at ``t0`` (ns offsets by hand): phase 1 with two
    fitness calls (SGS of 40 steps, 8000 and 12000 ns) and one SGS of
    the baseline's decode outside them; phase 2 with one fitness call."""
    recs = [  # (name, start, end, id, parent id, attrs)
        (SGS, 20, 8020, 3, 2, {"steps": 40}),
        (FIT, 10, 9000, 2, 1, {}),
        (SGS, 9100, 21100, 5, 4, {"steps": 40}),
        (FIT, 9050, 22000, 4, 1, {}),
        (SGS, 22100, 30000, 6, 1, {"steps": 40}),
        (P1, 5, 30005, 1, 0, {}),
        (SGS, 30100, 31100, 8, 7, {"steps": 40}),
        (FIT, 30050, 50000, 7, 9, {}),
        (P2, 30010, 60010, 9, 0, {}),
        (BOUND, 0, 60100, 0, None, {})]
    for name, a, b, i, p, attrs in recs:
        ring.add(name, t0 + a, t0 + b, i, p, attrs)


@pytest.fixture
def ring(monkeypatch):
    r = ptrace.SpanRing(16)
    monkeypatch.setattr(ptrace, "RING", r)
    return r


def test_readers_on_a_synthetic_window(ring):
    t0 = time.time_ns()
    _fill(ring, t0)
    bench = Bench(REPO)
    tr = _host(t0 - 1000, t0 + 61000)       # the recorder's wider span
    read = {m: bench.reader(m).read(tr, CTX) for m in READERS}
    assert read["phase1_s.bound"] == pytest.approx(30000e-9)
    assert read["phase2_s.bound"] == pytest.approx(30000e-9)
    assert read["sgs_step_ms.bound"] == pytest.approx(
        (8000 + 12000) / 80 / 1e6)


@pytest.mark.parametrize("case", ["no host job", "no bound span",
                                  "empty window", "dropped"])
def test_readers_find_nothing_in_an_empty_or_dropped_window(ring, case):
    t0 = time.time_ns()
    _fill(ring, t0)
    tr = _host(t0 - 1000, t0 + 61000)
    if case == "no host job":
        tr.host = None
    elif case == "no bound span":
        tr.host = build([Span("repro_torch.solve_sa", t0, t0 + 61000)],
                        {}, [])
    elif case == "empty window":
        tr = _host(t0 + 100000, t0 + 200000)
    else:
        for i in range(7):            # 17 spans in 16 slots
            ring.add("later", t0 + 70000 + i, t0 + 70001 + i, 100 + i,
                     None, {})
        assert ring.dropped == 1
    bench = Bench(REPO)
    for m in READERS:
        assert bench.reader(m).read(tr, CTX) is None, m
