"""The port's span ring (``repro_torch.obs.trace.span``): its slots,
overwrite and dropped count, parents across threads, the off switch, the
spans the bound path records, results unchanged with the ring off, the
Chrome-trace export, and the kernel-load span and build count."""
from __future__ import annotations

import json
import pathlib
import subprocess
import threading
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.bench import BenchSetup, paper_batch
from repro_torch.core.solvers import SAConfig, TorchDraws, solve_bilevel_batch
from repro_torch.kernels import build
from repro_torch.obs import trace

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring of 8 slots in place of the process's, the ring on."""
    r = trace.SpanRing(8)
    monkeypatch.setattr(trace, "RING", r)
    was = obs.record_spans(True)
    yield r
    obs.record_spans(was)


def _names(spans):
    return [s.name for s in spans]


@pytest.mark.parametrize("n", [3, 8, 13])
def test_ring_slots_overwrite_and_dropped(ring, n):
    t0 = time.time_ns()
    for i in range(n):
        with obs.span(f"s{i}", i=i):
            pass
    recs, horizon = ring.held()
    assert len(ring._slots) == 8
    assert [r[0] for r in recs] == [f"s{i}" for i in range(max(0, n - 8), n)]
    assert ring.dropped == max(0, n - 8)
    got = obs.spans_between(t0, time.time_ns())
    if n > 8:
        # The oldest spans are gone: the interval reads as dropped, while
        # one starting after the oldest held span's end is whole.
        assert got is None and horizon == recs[0][2]
        assert _names(obs.spans_between(horizon + 1, time.time_ns())) \
            == [f"s{i}" for i in range(n - 7, n)]
    else:
        assert horizon == 0
        assert _names(got) == [f"s{i}" for i in range(n)]
        assert [s.attrs["i"] for s in got] == list(range(n))


def test_spans_between_nests_and_bounds(ring):
    t0 = time.time_ns()
    with obs.span("outer"):
        with obs.span("mid") as sp:
            with obs.span("inner"):
                pass
            sp.set(late=1)
        with obs.span("mid2"):
            pass
    t1 = time.time_ns()
    got = obs.spans_between(t0, t1)
    assert _names(got) == ["outer", "mid", "inner", "mid2"]
    assert [s.parent for s in got] == [None, 0, 1, 0]
    assert got[1].attrs == {"late": 1}
    assert all(a.start_ns <= b.start_ns for a, b in zip(got, got[1:]))
    # A window that cuts the outer span off keeps its children, parentless.
    inner = obs.spans_between(got[1].start_ns, got[3].end_ns)
    assert _names(inner) == ["mid", "inner", "mid2"]
    assert [s.parent for s in inner] == [None, 0, None]


def test_parents_stay_on_their_thread(monkeypatch):
    monkeypatch.setattr(trace, "RING", trace.SpanRing(256))
    gate = threading.Barrier(4)

    def work(k):
        with obs.span(f"t{k}"):
            gate.wait(timeout=10)
            for j in range(3):
                with obs.span(f"t{k}.{j}"):
                    gate.wait(timeout=10)

    t0 = time.time_ns()
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = obs.spans_between(t0, time.time_ns())
    assert len(got) == 16
    for s in got:
        if "." in s.name:
            assert got[s.parent].name == s.name.split(".")[0]
        else:
            assert s.parent is None


@pytest.mark.parametrize("how", ["closed", "open"])
def test_the_off_switch_records_nothing(ring, how):
    """Off, ``span`` is the shared no-op and records nothing; a span
    already open when the ring goes off still records at its end."""
    if how == "open":
        with obs.span("outer"):
            assert obs.record_spans(False) is True
            with obs.span("inner") as sp:
                sp.set(a=1)
        assert [r[0] for r in ring.held()[0]] == ["outer"]
        assert obs.record_spans(True) is False
        return
    assert obs.record_spans(False) is True
    with obs.span("x") as sp:
        sp.set(a=1)
    assert obs.span("y") is trace.NO_SPAN
    assert ring.held() == ([], 0)
    assert obs.record_spans(True) is False


SA = SAConfig(pop=6, iters=5, migrate_every=2)


def _solve(objective="carbon"):
    batch, cum = paper_batch(BenchSetup(n_jobs=2, k_tasks=3, n_machines=3,
                                        instances=2, objective=objective),
                             device="cpu")
    return solve_bilevel_batch(batch, cum, TorchDraws(7, "cpu"),
                               objective=objective, stretch=1.5, cfg1=SA,
                               cfg2=SA)


@pytest.mark.parametrize("objective", ["carbon", "energy"])
def test_bound_path_span_counts(objective):
    t0 = time.time_ns()
    _solve(objective)
    got = obs.spans_between(t0, time.time_ns())
    count = {n: _names(got).count(n) for n in set(_names(got))}
    fits = 1 + SA.iters + SA.iters // SA.migrate_every     # a phase
    assert count == {
        "repro_torch.solve_bilevel": 1, "repro_torch.phase1": 1,
        "repro_torch.phase2": 1, "repro_torch.solve_sa": 2,
        "repro_torch.population_fitness": 2 * fits,
        "repro_torch.decode_full": 3, "repro_torch.sgs": 2 * fits + 3,
        "repro_torch.timing_sweep": fits + 2,
        "repro_torch.population_carbon": fits,
        "repro_torch.total_violations": fits}
    (top,) = [s for s in got if s.parent is None]
    assert top.name == "repro_torch.solve_bilevel"
    assert top.attrs == {"B": 2, "objective": objective, "stretch": 1.5}
    by = {n: [s for s in got if s.name == n] for n in count}
    p1, p2 = by["repro_torch.phase1"][0], by["repro_torch.phase2"][0]
    assert p1.end_ns <= p2.start_ns
    for s in by["repro_torch.population_fitness"]:
        assert s.attrs["rows"] == 2 * SA.pop
        phase = got[got[s.parent].parent]
        assert s.attrs["objective"] == ("makespan" if phase is p1
                                        else objective)
    assert {s.attrs["steps"] for s in by["repro_torch.sgs"]} == {6}
    assert {s.attrs["rule"] for s in by["repro_torch.sgs"]} \
        == {"earliest_finish", "fixed"}
    assert {s.attrs["steps"] for s in by["repro_torch.timing_sweep"]} \
        == {SA.sweeps * 6}


def test_results_equal_with_the_ring_off():
    on = _solve()
    was = obs.record_spans(False)
    try:
        off = _solve()
    finally:
        obs.record_spans(was)
    for a, b in zip(torch.utils._pytree.tree_leaves(on),
                    torch.utils._pytree.tree_leaves(off)):
        assert torch.equal(a, b)


def test_no_profiler_range_left_in_the_port():
    hits = [str(p.relative_to(SRC)) for p in SRC.rglob("*.py")
            if "record_function" in p.read_text()]
    assert hits == []


def test_chrome_trace_has_the_ring_on_the_host_track(ring, tmp_path):
    with obs.span("before"):
        pass
    tr = obs.Tracer()
    assert tr.timed("f", lambda: 3) == 3
    with obs.span("outer", rows=4):
        with obs.span("inner"):
            pass
    doc = json.loads(pathlib.Path(tr.export(str(tmp_path / "t.json")))
                     .read_text())
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e.get("tid") == trace.TID_SPANS]
    assert [e["name"] for e in spans] == ["outer", "inner"]
    assert all(e["pid"] == trace.PID_WALL for e in spans)
    assert spans[0]["args"] == {"rows": 4}
    (timed,) = [e for e in doc["traceEvents"] if e["name"] == "xla:f"]
    assert "device_ms" not in timed["args"]        # no card: no events
    assert 0 <= timed["ts"] <= spans[0]["ts"]
    assert spans[0]["ts"] <= spans[1]["ts"] and \
        spans[1]["ts"] + spans[1]["dur"] <= spans[0]["ts"] + spans[0]["dur"]


def test_kernel_load_span_and_build_count(ring, monkeypatch, tmp_path):
    """A first load that compiles records ``built=True``, one build in the
    count; a load of the built library records ``built=False``."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "probe.cu").write_text("// probe\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))

    def fake_nvcc(cmd, **kw):
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_text("so")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    t0 = time.time_ns()
    assert build.load("probe")[0] == "lib"
    build._libs.clear()
    build.load("probe")
    build.load("probe")                          # cached: no span
    got = obs.spans_between(t0, time.time_ns())
    assert [(s.name, s.attrs) for s in got] == [
        ("repro_torch.kernel_load", {"kernel": "probe", "built": True}),
        ("repro_torch.kernel_load", {"kernel": "probe", "built": False})]
    assert sum(s.attrs["built"] for s in got) == 1
