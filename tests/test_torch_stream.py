"""Port vs reference: the streaming dispatch service on the CPU.

``repro_torch.stream`` is held to ``repro.stream`` on the same seeds:

* **arrivals** — the numpy copy gives bit-identical epochs;
* **goldens** — ``simulate_stream`` reproduces ``tests/golden/
  stream_tiny.json`` and ``stream_contention_tiny.json`` (ints exact,
  floats at the golden test's rtol 1e-4 / atol 2e-3), and the live
  reference's event log and meta: ints exact, each job's carbon and
  energy (unrounded) at rtol 1e-6, and the log's rounded floats within
  one unit of their last digit;
* **closed-batch parity** — at t = 0 every partitioned job's schedule
  equals the reference's ``online_carbon_gated_jax`` and the port's
  ``online_carbon_gated_torch``;
* the service semantics of ``tests/test_stream.py`` (back-pressure,
  re-entry, rejection, truncation, the immutable summary), the
  forecast-banded gate on the reference's replayed ``fold_in`` draws, and
  tracing (event logs unchanged; the sim-clock events equal the
  reference's; ``traced_call``).

The shared-fleet contracts and the TINY bench are in
``tests/test_torch_stream_shared.py``.
"""
import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.core.carbon import sample_window as jsample_window
from repro.core.carbon import synthesize as jsynthesize
from repro.core.instance import Instance as JInstance
from repro.core.instance import Job as JJob
from repro.core.instance import pack as jpack
from repro.core.solvers.online_jax import online_carbon_gated_jax
from repro.obs import Tracer as JTracer
from repro.scenarios.fleets import build_fleet as jbuild_fleet
from repro.scenarios.generator import ScenarioConfig as JScenarioConfig
from repro.scenarios.generator import sample_job as jsample_job
from repro import stream as jstream
from repro_torch import obs
from repro_torch.core.carbon import CarbonTrace
from repro_torch.core.instance import Instance, Job, pack, stack_packed
from repro_torch.core.solvers import online_torch
from repro_torch.forecast.rolling import n_replans
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch import stream as tstream
from repro_torch.stream import (ARRIVAL_NAMES, StreamConfig, StreamEngine,
                                sample_arrivals, simulate_stream)
from repro_torch.stream.engine import StreamResult
from tests.strategies import family_names, fleet_names, seeds

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
N_MACHINES = 3
PAD_TASKS = 8
HORIZON = 400
EXACT = ("rid", "arrival", "admitted", "queue_delay", "finished", "budget",
         "greedy_makespan", "completed", "truncated")
# The event log's rounded floats and their last digit's unit.
ROUNDED = {"greedy_carbon_g": 1e-3, "carbon_g": 1e-3, "energy_kwh": 1e-4,
           "carbon_savings_pct": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(**kw):
    """The goldens' stream (``test_stream_golden.py``), fields overridable;
    a dict both packages' ``StreamConfig`` take."""
    base = dict(arrivals="bursty", rate=0.08, horizon=192, n_lanes=3,
                family="layered", width=3, depth=2, n_machines=3,
                fleet="tiered", mean_dur=5.0, theta=0.5, window=96,
                stretch=1.5, seed=2024)
    base.update(kw)
    return base


def run_both(cfg, **port_kw):
    ref = jstream.simulate_stream(jstream.StreamConfig(**cfg))
    got = simulate_stream(StreamConfig(**cfg), device="cpu", **port_kw)
    return got, ref


def assert_same_stream(got, ref):
    """Event log and meta equal (ints exact, rounded floats within one unit
    of their last digit) and every job's schedule, carbon and energy
    (unrounded, rtol 1e-6)."""
    assert got.meta == ref.meta
    assert len(got.events) == len(ref.events)
    for g, w in zip(got.events, ref.events):
        assert set(g) == set(w), (w["rid"], set(g) ^ set(w))
        for k, wv in w.items():
            if k in EXACT:
                assert g[k] == wv, (w["rid"], k, g[k], wv)
            else:
                assert abs(g[k] - wv) <= ROUNDED[k] + 1e-6 * abs(wv), \
                    (w["rid"], k, g[k], wv)
    for g, w in zip(got.jobs, ref.jobs):
        assert (g.admitted, g.completed, g.budget, g.finished,
                g.truncated) == (w.admitted, w.completed, w.budget,
                                 w.finished, w.truncated)
        if w.finished:
            np.testing.assert_array_equal(g.start, np.asarray(w.start))
            np.testing.assert_array_equal(g.assign, np.asarray(w.assign))
        for f in ("carbon", "energy", "greedy_carbon", "greedy_energy"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-6, err_msg=f"rid {w.rid} {f}")


def _jobs(seed, family, fleet, n, arrival=0):
    """``n`` jobs, the fleet and a trace from one numpy stream (the
    reference's ``tests/test_stream.py`` helper), as port objects."""
    rng = np.random.default_rng(seed)
    scen = JScenarioConfig(family=family, n_jobs=1, width=2, depth=2,
                           n_machines=N_MACHINES, fleet=fleet).validate()
    jobs = [dataclasses.replace(jsample_job(rng, scen), arrival=arrival)
            for _ in range(n)]
    powers, speeds = jbuild_fleet(fleet, rng, N_MACHINES)
    trace = jsample_window(jsynthesize("AU-SA", days=10, seed=7), rng,
                           HORIZON)
    return ([Job(j.arrival, j.base_durations, j.edges) for j in jobs],
            powers, speeds, CarbonTrace(trace.name, trace.intensity))


def engine(trace, powers, speeds, **kw):
    kw.setdefault("n_lanes", 4)
    kw.setdefault("pad_tasks", PAD_TASKS)
    return StreamEngine(trace, powers, speeds, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Arrival families.
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=seeds(), family=st.sampled_from(ARRIVAL_NAMES),
       rate10=st.integers(1, 30), horizon=st.integers(8, 600))
def test_arrivals_bit_identical(seed, family, rate10, horizon):
    rate = rate10 / 100.0
    got = sample_arrivals(family, np.random.default_rng(seed), rate, horizon)
    want = jstream.sample_arrivals(family, np.random.default_rng(seed), rate,
                                   horizon)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ARRIVAL_NAMES)
def test_arrival_family_matches_reference(family):
    """Each family's float times, and the rng state after them, equal the
    reference's over many seeds (bursty and diurnal draw extra numbers)."""
    for s in range(20):
        r1, r2 = np.random.default_rng(s), np.random.default_rng(s)
        got = tstream.ARRIVALS[family](r1, 0.1, 512)
        want = jstream.ARRIVALS[family](r2, 0.1, 512)
        np.testing.assert_array_equal(got, want)
        assert r1.random() == r2.random()


def test_arrivals_validation_errors():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="unknown arrival family"):
        sample_arrivals("nope", rng, 0.1, 10)
    with pytest.raises(ValueError, match="rate must be positive"):
        sample_arrivals("poisson", rng, 0.0, 10)
    with pytest.raises(ValueError, match="horizon"):
        sample_arrivals("poisson", rng, 0.1, 0)
    with pytest.raises(ValueError, match="amp"):
        tstream.diurnal(rng, 0.1, 10, amp=1.5)
    assert set(ARRIVAL_NAMES) == {"poisson", "bursty", "diurnal"}


def test_sample_stream_jobs_match_reference():
    for arrivals in ARRIVAL_NAMES:
        cfg = tiny_cfg(arrivals=arrivals, rate=0.1)
        got = tstream.sample_stream_jobs(np.random.default_rng(5),
                                         StreamConfig(**cfg))
        want = jstream.sample_stream_jobs(np.random.default_rng(5),
                                          jstream.StreamConfig(**cfg))
        assert [dataclasses.astuple(j) for j in got] == \
            [dataclasses.astuple(j) for j in want]


# ---------------------------------------------------------------------------
# Goldens and the live reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_fleet", [False, True],
                         ids=["partitioned", "shared"])
def test_stream_tiny_matches_golden(shared_fleet):
    name = ("stream_contention_tiny.json" if shared_fleet
            else "stream_tiny.json")
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        golden = json.load(f)
    res = simulate_stream(StreamConfig(**tiny_cfg(shared_fleet=shared_fleet)),
                          device="cpu")
    assert {k: res.meta[k] for k in golden["meta"]} == golden["meta"]
    assert len(res.events) == len(golden["events"])
    for g, w in zip(res.events, golden["events"]):
        assert set(g) == set(w)
        for k, wv in w.items():
            if k in EXACT:
                assert g[k] == wv, (w["rid"], k)
            else:
                np.testing.assert_allclose(float(g[k]), float(wv), rtol=1e-4,
                                           atol=2e-3, err_msg=k)


@pytest.mark.parametrize("kw", [
    {},
    {"shared_fleet": True},
    {"arrivals": "poisson", "rate": 0.1, "admission": "scpf"},
    {"arrivals": "diurnal", "rate": 0.12, "shared_fleet": True,
     "admission": "scpf", "n_machines": 2, "fleet": "homog"},
    {"machine_rule": "min_energy", "fleet": "mixed", "seed": 7},
    {"rate": 0.2, "horizon": 96, "n_lanes": 2, "seed": 3},
], ids=["bursty", "shared", "scpf", "shared-scpf-diurnal", "min-energy",
        "backlog"])
def test_stream_matches_live_reference(kw):
    got, ref = run_both(tiny_cfg(**kw))
    assert_same_stream(got, ref)
    for k in ("jobs_admitted", "jobs_rejected", "jobs_completed",
              "jobs_truncated", "queue_delay_epochs", "ticks",
              "gate_closed_epochs", "final_lane_occupancy"):
        assert got.summary[k] == ref.summary[k], k


# ---------------------------------------------------------------------------
# Closed-batch bit-exactness: streaming == batched gate at t = 0.
# ---------------------------------------------------------------------------

def _assert_closed_batch(seed, family, fleet, machine_rule, shared=False):
    jobs, powers, speeds, trace = _jobs(seed, family, fleet, n=3)
    eng = engine(trace, powers, speeds, machine_rule=machine_rule,
                 shared_fleet=shared)
    sjobs = eng.run(jobs)
    assert all(sj.finished for sj in sjobs)
    for sj in sjobs:
        jj = JJob(0, sj.job.base_durations, sj.job.edges)
        jinst = jpack(JInstance(jobs=(jj,), powers_kw=powers, speeds=speeds),
                      pad_tasks=PAD_TASKS)
        ref = online_carbon_gated_jax(jinst, jnp.asarray(trace.intensity),
                                      machine_rule=machine_rule)
        port = online_torch.online_carbon_gated_torch(
            pack(Instance(jobs=(sj.job,), powers_kw=powers, speeds=speeds),
                 pad_tasks=PAD_TASKS, device="cpu"), trace.intensity,
            machine_rule=machine_rule, device="cpu")
        for name, want in (("reference", ref), ("port batch", port)):
            np.testing.assert_array_equal(sj.start, np.asarray(want.start),
                                          err_msg=f"rid={sj.rid} {name}")
            np.testing.assert_array_equal(sj.assign, np.asarray(want.assign),
                                          err_msg=f"rid={sj.rid} {name}")


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=seeds(), family=family_names(), fleet=fleet_names())
def test_stream_matches_batched_gate_at_t0(seed, family, fleet):
    _assert_closed_batch(seed, family, fleet, "earliest_finish")


@pytest.mark.parametrize("machine_rule", ["earliest_finish", "min_energy"])
@pytest.mark.parametrize("family,fleet", [("layered", "tiered"),
                                          ("tpch", "mixed"),
                                          ("diamond", "homog")])
def test_stream_matches_batched_gate_both_rules(family, fleet, machine_rule):
    _assert_closed_batch(3, family, fleet, machine_rule)


def test_closed_batch_budget_is_the_batched_budget():
    """The admission budget at t = 0 is ``int(float32(1.5) * makespan)``,
    the batched path's float32 cast chain."""
    jobs, powers, speeds, trace = _jobs(4, "chain", "tiered", n=3)
    for sj in engine(trace, powers, speeds).run(jobs):
        ms = sj.greedy_makespan
        assert sj.budget == int(np.float32(1.5) * np.float32(ms))


# ---------------------------------------------------------------------------
# Service semantics.
# ---------------------------------------------------------------------------

def test_backpressure_queue_delay():
    """More t=0 jobs than lanes: the overflow waits for evictions, FIFO."""
    jobs, powers, speeds, trace = _jobs(5, "layered", "homog", n=6)
    sjobs = engine(trace, powers, speeds, n_lanes=2).run(jobs)
    assert all(sj.finished for sj in sjobs)
    assert all(sj.admitted >= sj.arrival for sj in sjobs)
    admits = [sj.admitted for sj in sjobs]
    assert admits == sorted(admits), "FIFO admission order broken"
    assert sum(sj.queue_delay > 0 for sj in sjobs) >= 4
    for t in range(HORIZON):
        assert sum(sj.admitted <= t < sj.completed for sj in sjobs) <= 2


def test_engine_run_reentry():
    """Back-to-back run() calls on one engine are independent."""
    jobs, powers, speeds, trace = _jobs(9, "fanout", "tiered", n=3)
    eng = engine(trace, powers, speeds, n_lanes=2)
    a, b = eng.run(jobs), eng.run(jobs)
    for x, y in zip(a, b):
        assert (x.admitted, x.completed, x.budget) == \
            (y.admitted, y.completed, y.budget)
        np.testing.assert_array_equal(x.start, y.start)
        np.testing.assert_array_equal(x.assign, y.assign)


def test_simulate_stream_deterministic_and_seed_sensitive():
    cfg = StreamConfig(arrivals="bursty", rate=0.06, horizon=192,
                       n_lanes=3, seed=13)
    r1, r2 = (simulate_stream(cfg, device="cpu") for _ in range(2))
    assert r1.events == r2.events
    r3 = simulate_stream(dataclasses.replace(cfg, seed=14), device="cpu")
    assert r1.events != r3.events
    assert r1.meta["n_finished"] >= 1


def test_stream_job_too_large_rejected():
    jobs, powers, speeds, trace = _jobs(1, "layered", "homog", n=1)
    with pytest.raises(ValueError, match="exceeds pad_tasks"):
        engine(trace, powers, speeds, pad_tasks=2).run(jobs)


def test_late_arrival_rejected_not_wedged():
    """A job too close to the trace end to finish even greedily surfaces
    unadmitted, as in the reference (on the same trace: the reference's
    engine reads the port's ``CarbonTrace`` through the same methods)."""
    jobs, powers, speeds, trace = _jobs(2, "layered", "homog", n=1,
                                        arrival=HORIZON - 2)
    eng = engine(trace, powers, speeds, n_lanes=2)
    (sj,) = eng.run(jobs)
    assert not sj.finished and sj.admitted == -1
    assert eng.summary()["jobs_rejected"] == 1
    jeng = jstream.StreamEngine(trace, powers, speeds, n_lanes=2,
                                pad_tasks=PAD_TASKS)
    (jsj,) = jeng.run([JJob(j.arrival, j.base_durations, j.edges)
                       for j in jobs])
    assert not jsj.finished and jsj.admitted == -1


def test_truncated_completion_surfaced_not_dropped():
    """A job fully placed by the final tick whose completion lands past it
    surfaces finished with ``truncated=True``."""
    job = Job(arrival=HORIZON - 50, base_durations=(300,), edges=())
    _, powers, speeds, trace = _jobs(4, "layered", "homog", n=1)
    eng = engine(trace, powers, speeds, n_lanes=2, theta=1.0)
    (sj,) = eng.run([job])
    assert sj.finished and sj.truncated
    assert sj.completed > HORIZON - 1
    assert sj.start is not None and sj.carbon > 0.0
    assert eng.summary()["jobs_truncated"] == 1
    jobs2, powers, speeds, trace = _jobs(5, "layered", "homog", n=1)
    (sj2,) = engine(trace, powers, speeds, n_lanes=2).run(jobs2)
    assert sj2.finished and not sj2.truncated


def test_truncated_stream_matches_reference():
    """A backlogged stream of long jobs: its rejections, truncated flags
    and their stats equal the reference's."""
    got, ref = run_both(tiny_cfg(arrivals="poisson", rate=0.1, horizon=96,
                                 n_lanes=2, mean_dur=40.0, width=2, seed=5))
    assert sum(bool(e.get("truncated")) for e in ref.events) == 2
    assert ref.summary["jobs_rejected"] == 4
    assert_same_stream(got, ref)
    assert got.summary["jobs_truncated"] == ref.summary["jobs_truncated"]


def test_stream_result_summary_never_aliases():
    a = StreamResult(jobs=[], events=[], meta={})
    b = StreamResult(jobs=[], events=[], meta={})
    assert dict(a.summary) == {}
    with pytest.raises(TypeError):
        a.summary["leak"] = 1
    assert dict(b.summary) == {}
    cfg = StreamConfig(arrivals="poisson", rate=0.05, horizon=128,
                       n_lanes=2, seed=3)
    r1, r2 = (simulate_stream(cfg, device="cpu") for _ in range(2))
    assert r1.summary is not r2.summary
    r1.summary["leak"] = True
    assert "leak" not in r2.summary


def test_stream_config_validation_and_fields():
    with pytest.raises(ValueError, match="unknown arrival family"):
        StreamConfig(arrivals="nope").validate()
    with pytest.raises(ValueError, match="n_lanes"):
        StreamConfig(n_lanes=0).validate()
    with pytest.raises(ValueError, match="admission policy"):
        StreamConfig(admission="nope").validate()
    assert dataclasses.asdict(StreamConfig()) == \
        dataclasses.asdict(jstream.StreamConfig())
    assert tstream.__all__ == jstream.__all__


def test_summary_matches_job_list():
    jobs, powers, speeds, trace = _jobs(11, "layered", "tiered", n=5)
    jobs = [dataclasses.replace(j, arrival=3 * i) for i, j in enumerate(jobs)]
    eng = engine(trace, powers, speeds, n_lanes=2)
    sjobs = eng.run(jobs)
    s = eng.summary()
    assert s["jobs_admitted"] == sum(1 for sj in sjobs if sj.admitted >= 0)
    assert s["jobs_completed"] == sum(1 for sj in sjobs if sj.finished)
    assert s["queue_delay_epochs"]["count"] == s["jobs_admitted"]
    assert s["carbon_savings_pct"]["count"] == s["jobs_completed"]
    assert s["ticks"] > 0 and s["wall"]["tick_wall_s_first"]["count"] == 1
    assert s["wall"]["tick_wall_s_warm"]["count"] == s["ticks"] - 1
    json.dumps(s)
    eng.run(jobs)
    assert eng.summary()["jobs_admitted"] == s["jobs_admitted"]


# ---------------------------------------------------------------------------
# The gate: one gate_quantile launch per engine; the banded gate on the
# reference's replayed draws.
# ---------------------------------------------------------------------------

class FoldInDraws:
    """The reference's banded-gate noise: issue k reads
    ``normal(fold_in(key(seed), k), (E,))``."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)
        self.calls = 0

    def normal(self, shape):
        K, E = shape
        self.calls += 1
        return torch.tensor(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(self.key, k), (E,), jnp.float32))
            for k in range(K)]))


@pytest.mark.parametrize("every,scale", [(24, 2.0), (48, 1.0), (24, 0.0),
                                         (96, 0.5)])
def test_banded_gate_on_replayed_draws(every, scale):
    """With the reference's draws passed in, the port's banded mask equals
    the reference's, and so does the event log of a banded stream.  A
    flip within 4 ulps of its threshold would be logged in ROADMAP Queue
    3 item 2; none shows."""
    _, powers, speeds, trace = _jobs(8, "layered", "tiered", n=1)
    draws = FoldInDraws(21)
    eng = engine(trace, powers, speeds, forecast_every=every,
                 forecast_scale=scale, draws=draws)
    jeng = jstream.StreamEngine(trace, powers, speeds, n_lanes=4,
                                pad_tasks=PAD_TASKS, forecast_every=every,
                                forecast_scale=scale, seed=21)
    assert draws.calls == 1 and eng.dirty.shape == (HORIZON,)
    np.testing.assert_array_equal(eng.dirty.numpy(), np.asarray(jeng.dirty))
    cfg = tiny_cfg(arrivals="poisson", rate=0.05, seed=21,
                   forecast_every=every, forecast_scale=scale)
    got, ref = run_both(cfg, draws=FoldInDraws(21))
    assert_same_stream(got, ref)


def test_gate_built_once_per_engine(monkeypatch):
    """Day-ahead and banded gates: one threshold call each, at ``[E]``
    (one ``[1, E]`` row) and ``[K, E]``; on the CPU no kernel launches."""
    jobs, powers, speeds, trace = _jobs(6, "layered", "tiered", n=3)
    calls = []
    orig = online_torch.ops.gate_threshold

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return orig(x, *a, **k)

    monkeypatch.setattr(online_torch.ops, "gate_threshold", spy)
    reset_launches()
    engine(trace, powers, speeds).run(jobs)
    engine(trace, powers, speeds, forecast_every=24,
           forecast_scale=1.0).run(jobs)
    assert calls == [(HORIZON,), (n_replans(HORIZON, 24), HORIZON)]
    assert LAUNCHES.get("gate_quantile", 0) == 0


# ---------------------------------------------------------------------------
# Tracing changes nothing.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_fleet", [False, True],
                         ids=["partitioned", "shared"])
def test_tracing_leaves_event_log_unchanged(shared_fleet, monkeypatch):
    cfg = StreamConfig(**tiny_cfg(shared_fleet=shared_fleet))
    off = simulate_stream(cfg, device="cpu")
    monkeypatch.setenv("REPRO_TRACE", "1")
    obs.set_tracer(None)
    try:
        on = simulate_stream(cfg, device="cpu")
        tracer = obs.get_tracer()
        assert tracer.enabled and len(tracer.events) > 0
    finally:
        obs.set_tracer(None)
    assert on.events == off.events
    tr = obs.Tracer()
    assert simulate_stream(cfg, tracer=tr, device="cpu").events == off.events


@pytest.mark.parametrize("kw", [{}, {"shared_fleet": True,
                                     "forecast_every": 48}],
                         ids=["partitioned", "shared-banded"])
def test_trace_events_match_reference(kw):
    """The sim-clock events (names, epoch stamps, spans, counts per name)
    equal the reference's on the same stream."""
    cfg = tiny_cfg(**kw)
    draws = FoldInDraws(cfg["seed"]) if "forecast_every" in kw else None
    tr, jtr = obs.Tracer(), JTracer()
    simulate_stream(StreamConfig(**cfg), tracer=tr, device="cpu", draws=draws)
    jstream.simulate_stream(jstream.StreamConfig(**cfg), tracer=jtr)

    def key(e):
        return (e["name"], e["ph"], e["t"], e.get("dur"), e.get("value"))

    assert [key(e) for e in tr.events] == [key(e) for e in jtr.events]
    assert collections.Counter(e["name"] for e in tr.events) == \
        collections.Counter(e["name"] for e in jtr.events)
    for e, je in zip(tr.events, jtr.events):
        if e["name"] in ("admit", "reject", "evict"):
            assert e["args"] == je["args"]


def test_timed_syncs_and_flags_first_call():
    tr = obs.Tracer(clock=iter(np.arange(0.0, 10.0, 0.5)).__next__)
    x = torch.arange(4)
    assert torch.equal(tr.timed("f", lambda a: a + 1, x), x + 1)
    assert tr.timed("f", lambda: (x, {"k": [x]}))[0] is x
    spans = [e for e in tr.events if e["name"] == "xla:f"]
    assert [e["args"]["first_call"] for e in spans] == [True, False]
    assert spans[0]["wall_dur"] == pytest.approx(0.5)
    assert obs.NULL_TRACER.timed("g", lambda: 7) == 7
    assert obs.NULL_TRACER.events == []


def test_traced_call_passthrough_and_capture():
    obs.set_tracer(None)
    assert obs.traced_call("f", lambda a, b: a + b, 2, b=3) == 5
    tr = obs.Tracer()
    obs.set_tracer(tr)
    try:
        assert obs.traced_call("f", lambda a, b: a + b, 2, b=3) == 5
        assert [e["name"] for e in tr.events] == ["xla:f"]
    finally:
        obs.set_tracer(None)


def test_sweep_policies_traced_unchanged():
    """``sweep_policies`` under a tracer: one ``xla:online_torch.sweep``
    span, and the same schedules as untraced."""
    jobs, powers, speeds, trace = _jobs(2, "layered", "tiered", n=2)
    insts = [pack(Instance(jobs=(j,), powers_kw=powers, speeds=speeds),
                  pad_tasks=PAD_TASKS, device="cpu") for j in jobs]
    batch = stack_packed(insts)
    inten = torch.tensor(np.stack([trace.intensity[:200]] * 2))
    args = (batch, inten, [0.5], [48], [1.5])
    off = online_torch.sweep_policies(*args, device="cpu")
    tr = obs.Tracer()
    obs.set_tracer(tr)
    try:
        on = online_torch.sweep_policies(*args, device="cpu")
    finally:
        obs.set_tracer(None)
    assert [e["name"] for e in tr.events] == ["xla:online_torch.sweep"]
    assert torch.equal(on.gated.start, off.gated.start)
    assert torch.equal(on.budget, off.budget)
