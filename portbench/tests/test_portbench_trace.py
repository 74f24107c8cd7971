"""The trace's reduction (spans, attribution, busy time, gaps), the span
recorder, and the per-layer readers with their roofline counts against
hand counts at a small shape."""
from __future__ import annotations

import pytest

from portbench.harness import peaks
from portbench.harness.spec import Bench
from portbench.harness.trace import CallTap, Span, SpanRecorder, build
from portbench.tests.portbench_tiny import REPO

FIT, SWEEP, SGS, SA = ("repro_torch.population_fitness",
                       "repro_torch.timing_sweep", "repro_torch.sgs",
                       "repro_torch.solve_sa")
CTX = {"B": 2, "Pop": 3, "T": 4, "H": 9, "power_limit": "700 W"}


def _trace():
    spans = [Span("portbench.job", 0, 1000), Span(SA, 10, 990),
             Span(FIT, 100, 400), Span(SGS, 110, 140), Span(SWEEP, 150, 350),
             Span(FIT, 500, 800), Span(SGS, 510, 530)]
    launch = {1: 160, 2: 120, 3: 600, 4: 900, 5: 170}
    dev = [("sweep_kernel", 200, 100, 1), ("sgs_kernel", 130, 20, 2),
           ("sgs_kernel", 610, 30, 3), ("schedule_delta_kernel<true>",
                                         950, 40, 4),
           ("sweep_kernel", 290, 20, 5)]
    tr = build(spans, launch, dev)
    # The host spans' job: the same calls, as the recorder alone sees them.
    tr.host = build([Span(x.name, x.start_ns, x.end_ns) for x in spans],
                    {}, [])
    return tr


def test_attribution_busy_and_gaps():
    tr = _trace()
    by = {(s.name, s.start_ns): s for s in tr.spans}
    assert by[(SWEEP, 150)].device_ns == 120        # 100 + 20 (overlap)
    assert by[(FIT, 100)].device_ns == 140          # + the SGS kernel
    assert by[(FIT, 500)].device_ns == 30
    assert by[(SA, 10)].device_ns == 210
    assert tr.ancestor(tr.named(SGS)[0], SA) == tr.named(SA)[0]
    assert tr.has_child(tr.named(FIT)[0], SWEEP)
    assert not tr.has_child(tr.named(FIT)[1], SWEEP)
    # Device busy: [130,150) [200,310) [610,640) [950,990) = 200 of 1000.
    assert tr.window_ns == 1000 and tr.busy_ns == 200
    assert sum(tr.gaps_ns.values()) == 800
    # Each gap goes to the innermost span open where it began: [0, 130)
    # the job; [150, 200) and [310, 610) the sweep; [640, 950) the second
    # fitness call; [990, 1000) the SA.
    assert tr.gaps_ns == {"portbench.job": 130, SWEEP: 350, FIT: 310,
                          SA: 10}
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["sweep_kernel", 120e-9]
    assert len(bd["idle_gaps"]) <= 10


def test_readers_on_the_synthetic_trace():
    bench = Bench(REPO)
    tr = _trace()

    def read(name):
        got = bench.reader(name).read(tr, CTX)
        return got[0] if isinstance(got, tuple) else got

    assert read("fitness_ms.bound") == pytest.approx(140e-6)
    assert read("timing_sweep_ms.bound") == pytest.approx(120e-6)
    assert read("sgs_ms.bound") == pytest.approx((30 + 20) / 2 / 1e6)
    assert read("sa_self_ms.bound") == pytest.approx(
        (980 - 300 - 300) / 2 / 1e6)
    assert read("device_idle.bound") == pytest.approx(80.0)
    least = 504 / peaks.HBM_BW
    assert read("timing_sweep_roofline.bound") == pytest.approx(
        100 * least / 120e-9)
    least = max(24 / peaks.FP32_FLOPS, 368 / peaks.HBM_BW)
    assert read("schedule_eval_roofline.bound") == pytest.approx(
        100 * least / 40e-9)


def test_roofline_counts_by_hand():
    bench = Bench(REPO)
    sweep = bench.reader("timing_sweep_roofline.bound")
    # [2, 3, 4] starts, servers and durations (int32) read, cum [2, 10]
    # float32, pred [2, 4, 4] bool, deadline [2] int32; starts written.
    assert sweep.sweep_bytes(2, 3, 4, 9) == 3 * 96 + 80 + 32 + 8 + 96
    se = bench.reader("schedule_eval_roofline.bound")
    assert se.cost(2, 3, 4, 9) == (24, 24 * 12 + 80)
    assert peaks.bound_s(24, 368) == (368 / peaks.HBM_BW, "bytes")


def test_readers_find_nothing_to_read():
    bench = Bench(REPO)
    empty = build([Span("portbench.job", 0, 10)], {}, [])
    for m in bench.spec["per_layer"]:
        assert bench.reader(m["name"]).read(empty, CTX) is None, m["name"]


def _inner(x):
    return x + 1


def _outer(x):
    return _inner(x) * 2


def test_span_recorder_nests_program_calls():
    mod = __name__
    rec = SpanRecorder({"outer": f"{mod}:_outer", "inner": f"{mod}:_inner",
                        "gone": f"{mod}:_no_such_function"})
    with rec:
        _outer(1)
        _outer(2)
    _outer(3)
    names = [s.name for s in rec.spans]
    assert names == ["inner", "outer", "inner", "outer"]
    inner, outer = rec.spans[0], rec.spans[1]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _scored(x, tag):
    return x * 10


def _calls():
    return [_scored(i, "a" if i % 2 else "b") for i in range(6)]


@pytest.mark.parametrize("n,want", [(0, (1, 10)), (2, (5, 50)),
                                    (3, (None, None))])
def test_call_tap_takes_the_nth_kept_call(n, want):
    tap = CallTap(f"{__name__}:_scored", n, keep=lambda a: a["tag"] == "a",
                  copy=lambda v: v["x"] if isinstance(v, dict) else v)
    with tap:
        assert _calls() == [0, 10, 20, 30, 40, 50]
    assert (tap.args, tap.value) == want
    _calls()
    assert (tap.args, tap.value) == want


def test_host_walls_come_from_the_unprofiled_job():
    bench = Bench(REPO)
    tr = _trace()
    tr.host = build([Span(SA, 0, 100), Span(FIT, 10, 30), Span(SGS, 12, 16)],
                    {}, [])
    assert bench.reader("sgs_ms.bound").read(tr, CTX) == pytest.approx(4e-6)
    assert bench.reader("sa_self_ms.bound").read(tr, CTX) \
        == pytest.approx(80e-6)
    tr.host = None
    assert bench.reader("sgs_ms.bound").read(tr, CTX) is None
    assert bench.reader("sa_self_ms.bound").read(tr, CTX) is None
