"""Port vs reference: the streaming engine's shared fleet, its pool ticks,
the admission policies and the TINY stream bench, on the CPU.

The shared-fleet properties of ``tests/test_stream_shared.py``, each held
on the port and, where the reference can run the same case, against it:
intra-epoch contention, the contended admission budget, the cross-lane
overlap check, lane-permutation invariance of the shared tick (whose
lanes run one after another in priority order, free lanes left out),
priority by admission order, ``scpf`` order with no future arrival
admitted, and policy validation.  Both pool ticks are held tick by tick
to the reference's jitted ones.  ``bench.run_stream(tiny=True)``
gives the reference harness's counts and distributions.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from benchmarks import stream_serve
from repro.core.instance import Instance as JInstance
from repro.core.instance import Job as JJob
from repro.core.instance import PackedInstance as JPackedInstance
from repro.core.instance import pack as jpack
from repro.core.solvers import online_jax
from repro.core.solvers.online_jax import online_carbon_gated_jax
from repro import stream as jstream
from repro.stream import engine as jengine
from repro_torch import bench
from repro_torch.core.carbon import CarbonTrace, sample_window, synthesize
from repro_torch.core.instance import Instance, Job, PackedInstance, pack
from repro_torch.core.solvers.online_torch import (LaneState,
                                                   downstream_critical_path)
from repro_torch.scenarios.batching import padding_rows
from repro_torch.scenarios.fleets import build_fleet
from repro_torch.scenarios.generator import ScenarioConfig, sample_job
from repro_torch.stream import StreamConfig, StreamEngine, simulate_stream
from repro_torch.stream import engine as tengine
from repro_torch.stream.engine import StreamJob
from tests.strategies import family_names, fleet_names, seeds

N_MACHINES = 3
PAD_TASKS = 8
HORIZON = 400


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(seed: int, horizon: int = HORIZON) -> CarbonTrace:
    rng = np.random.default_rng(seed)
    return sample_window(synthesize("AU-SA", days=10, seed=7), rng, horizon)


def _chain_job(durs, arrival=0):
    """A linear-chain job (critical path == sum of durations)."""
    return Job(arrival=arrival, base_durations=tuple(durs),
               edges=tuple((i, i + 1) for i in range(len(durs) - 1)))


def _ref_jobs(jobs):
    return [JJob(j.arrival, j.base_durations, j.edges) for j in jobs]


def _one_machine(shared_fleet, n_lanes=2, seed=11, **kw):
    """The port's one-machine engine and the reference's on the same
    trace (the reference reads the port's ``CarbonTrace`` through the
    same methods)."""
    trace = _trace(seed)
    kw = dict(powers_kw=(1.0,), speeds=(1.0,), n_lanes=n_lanes, pad_tasks=2,
              theta=1.0, shared_fleet=shared_fleet, **kw)
    return (StreamEngine(trace, device="cpu", **kw),
            jstream.StreamEngine(trace, **kw))


def run_both(shared_fleet, jobs, **kw):
    eng, jeng = _one_machine(shared_fleet, **kw)
    got = eng.run([dataclasses.replace(j) for j in jobs])
    want = jeng.run(_ref_jobs(jobs))
    for g, w in zip(got, want):
        assert (g.admitted, g.completed, g.budget, g.greedy_makespan) == \
            (w.admitted, w.completed, w.budget, w.greedy_makespan)
        np.testing.assert_array_equal(g.start, np.asarray(w.start))
    return got


# ---------------------------------------------------------------------------
# Partitioned mode is the batched simulator's loop body.
# ---------------------------------------------------------------------------

@settings(max_examples=8, deadline=None, derandomize=True)
@given(seed=seeds(), family=family_names(), fleet=fleet_names(),
       machine_rule=st.sampled_from(["earliest_finish", "min_energy"]))
def test_partitioned_matches_batched_gate(seed, family, fleet, machine_rule):
    rng = np.random.default_rng(seed)
    scen = ScenarioConfig(family=family, n_jobs=1, width=2, depth=2,
                          n_machines=N_MACHINES, fleet=fleet).validate()
    jobs = [dataclasses.replace(sample_job(rng, scen), arrival=0)
            for _ in range(3)]
    powers, speeds = build_fleet(fleet, rng, N_MACHINES)
    trace = _trace(seed)
    eng = StreamEngine(trace, powers, speeds, n_lanes=3, pad_tasks=PAD_TASKS,
                       machine_rule=machine_rule, shared_fleet=False,
                       device="cpu")
    for sj in eng.run(jobs):
        assert sj.finished
        (jj,) = _ref_jobs([sj.job])
        inst = jpack(JInstance(jobs=(jj,), powers_kw=powers, speeds=speeds),
                     pad_tasks=PAD_TASKS)
        ref = online_carbon_gated_jax(inst, jnp.asarray(trace.intensity),
                                      machine_rule=machine_rule)
        np.testing.assert_array_equal(sj.start, np.asarray(ref.start))
        np.testing.assert_array_equal(sj.assign, np.asarray(ref.assign))


# ---------------------------------------------------------------------------
# The shared fleet contends.
# ---------------------------------------------------------------------------

def test_intra_epoch_contention_on_one_machine():
    """Two single-task jobs on ONE machine, gate open: partitioned lanes
    both start at 0; the shared fleet serializes them."""
    jobs = [_chain_job([4]), _chain_job([4])]
    part = run_both(False, jobs)
    shared = run_both(True, jobs)
    assert all(sj.finished for sj in part + shared)
    assert [int(sj.start[0]) for sj in part] == [0, 0]
    s0, s1 = (int(sj.start[0]) for sj in shared)
    assert s0 == 0 and s1 >= 4


def test_shared_admission_budget_reflects_contention():
    """A job admitted while the shared machine is busy gets a later
    deadline and a worse greedy baseline than on an idle partition."""
    jobs = [_chain_job([20], arrival=0), _chain_job([4], arrival=2)]
    part = run_both(False, jobs)
    shared = run_both(True, jobs)
    assert shared[1].admitted == part[1].admitted == 2
    assert shared[1].greedy_makespan > part[1].greedy_makespan
    assert shared[1].budget > part[1].budget
    assert int(shared[1].start[0]) >= 20


def test_shared_fleet_eviction_overlap_validated():
    """A densely loaded shared stream runs end to end with every eviction
    checked for cross-lane overlap, and equals the reference."""
    cfg = dict(arrivals="bursty", rate=0.1, horizon=192, n_lanes=4,
               n_machines=2, fleet="homog", seed=5, shared_fleet=True)
    res = simulate_stream(StreamConfig(**cfg), device="cpu")
    ref = jstream.simulate_stream(jstream.StreamConfig(**cfg))
    assert res.meta["n_finished"] >= 1
    assert [{k: v for k, v in e.items() if isinstance(v, (bool, int))}
            for e in res.events] == \
        [{k: v for k, v in e.items() if isinstance(v, (bool, int))}
         for e in ref.events]


def test_overlap_check_raises():
    """The check fires on a schedule that collides with one already
    evicted on the same machine, and passes one that does not."""
    eng, _ = _one_machine(True)
    sj = StreamJob(rid=1, job=_chain_job([4]))
    eng._fleet_busy[0].append((2, 8, 0))
    with pytest.raises(AssertionError, match="shared-fleet overlap"):
        eng._check_fleet_overlap(sj, np.array([5, 0], np.int32),
                                 np.array([0, 0], np.int32))
    eng._check_fleet_overlap(sj, np.array([8, 0], np.int32),
                             np.array([0, 0], np.int32))
    assert eng._fleet_busy[0][-1] == (8, 12, 1)


# ---------------------------------------------------------------------------
# The pool ticks, held to the reference's.
# ---------------------------------------------------------------------------

POWERS, SPEEDS = (1.0, 2.0), (1.0, 1.0)
T_POOL, M_POOL, E_POOL = 4, 2, 64


def _pool(jobs_or_pad):
    """Port and reference pools of three lanes: chain jobs, or None for a
    padding lane."""
    pad = padding_rows(1, T_POOL, M_POOL, "cpu")
    insts = [PackedInstance(*(f[0] for f in pad)) if j is None else
             pack(Instance(jobs=(j,), powers_kw=POWERS, speeds=SPEEDS),
                  pad_tasks=T_POOL, device="cpu") for j in jobs_or_pad]
    pool = PackedInstance(*(torch.stack([getattr(i, f) for i in insts])
                            for f in PackedInstance._fields))
    cp = torch.stack([downstream_critical_path(i) for i in insts])
    jpool = JPackedInstance(*(jnp.asarray(f.numpy()) for f in pool))
    return pool, cp, jpool, jnp.asarray(cp.numpy())


def _zero_state(L=3):
    return LaneState(torch.zeros((L, T_POOL), dtype=torch.bool),
                     *(torch.zeros((L, T_POOL), dtype=torch.int32)
                       for _ in range(3)))


def _to_jax_state(ls):
    return online_jax.LaneState(*(jnp.asarray(f.numpy()) for f in ls))


def _assert_state(ls, jls, ctx):
    for f, x, y in zip(LaneState._fields, ls, jls):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                      err_msg=f"{ctx} {f}")


JOB_A, JOB_B = _chain_job([3, 5]), _chain_job([4, 2])


@pytest.mark.parametrize("gate", ["open", "mixed"])
def test_pool_tick_shared_matches_reference(gate):
    """The shared tick (lanes one after another in priority order, free
    lanes left out) equals the reference's scan over all lanes, tick by
    tick: rows, shared mfree, done flags and completion epochs."""
    pool, cp, jpool, jcp = _pool([JOB_A, None, JOB_B])
    g = np.random.default_rng(4)
    dirty = (torch.zeros(E_POOL, dtype=torch.bool) if gate == "open"
             else torch.tensor(g.random(E_POOL) < 0.5))
    budget = torch.tensor([14, 0, 12], dtype=torch.int32)
    ls, mf = _zero_state(), torch.zeros(M_POOL, dtype=torch.int32)
    jls, jmf = _to_jax_state(ls), jnp.zeros((M_POOL,), jnp.int32)
    order = [2, 0]                   # B before A; lane 1 is free
    for t in range(16):
        ls, mf, done, comp = tengine._pool_tick_shared(
            pool, cp, ls, mf, dirty[t], budget, t, order,
            machine_rule="earliest_finish")
        jls, jmf, jdone, jcomp = jengine._pool_tick_shared(
            jpool, jcp, jls, jmf, jnp.asarray(dirty.numpy()),
            jnp.asarray(budget.numpy()), jnp.int32(t),
            jnp.asarray(order + [1], jnp.int32),
            machine_rule="earliest_finish")
        _assert_state(ls, jls, f"t={t}")
        np.testing.assert_array_equal(mf.numpy(), np.asarray(jmf))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))


@pytest.mark.parametrize("machine_rule", ["earliest_finish", "min_energy"])
def test_pool_tick_partitioned_matches_reference(machine_rule):
    """The partitioned tick (one dispatch call over the lane axis, a
    machine row per lane) equals the reference's vmapped tick."""
    pool, cp, jpool, jcp = _pool([JOB_A, JOB_B, None])
    dirty = torch.tensor(np.random.default_rng(9).random(E_POOL) < 0.4)
    budget = torch.tensor([12, 11, 0], dtype=torch.int32)
    ls, mf = _zero_state(), torch.zeros((3, M_POOL), dtype=torch.int32)
    jls, jmf = _to_jax_state(ls), jnp.zeros((3, M_POOL), jnp.int32)
    for t in range(16):
        ls, mf, done, comp = tengine._pool_tick(
            pool, cp, ls, mf, dirty[t], budget, t, machine_rule=machine_rule)
        jls, jmf, jdone, jcomp = jengine._pool_tick(
            jpool, jcp, jls, jmf, jnp.asarray(dirty.numpy()),
            jnp.asarray(budget.numpy()), jnp.int32(t),
            machine_rule=machine_rule)
        _assert_state(ls, jls, f"t={t}")
        np.testing.assert_array_equal(mf.numpy(), np.asarray(jmf))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))


def test_pool_tick_shared_lane_permutation_invariant():
    """Permuting jobs across lanes (the priority order permuted to match)
    gives identical per-job rows and the identical shared mfree."""
    pool1, cp1, _, _ = _pool([JOB_A, JOB_B, None])
    pool2, cp2, _, _ = _pool([JOB_B, None, JOB_A])
    dirty = torch.zeros(E_POOL, dtype=torch.bool)
    budget = torch.full((3,), 10**6, dtype=torch.int32)
    ls1, ls2 = _zero_state(), _zero_state()
    mf1 = mf2 = torch.zeros(M_POOL, dtype=torch.int32)
    for t in range(10):
        ls1, mf1, done1, comp1 = tengine._pool_tick_shared(
            pool1, cp1, ls1, mf1, dirty[t], budget, t, [0, 1],
            machine_rule="earliest_finish")
        ls2, mf2, done2, comp2 = tengine._pool_tick_shared(
            pool2, cp2, ls2, mf2, dirty[t], budget, t, [2, 0],
            machine_rule="earliest_finish")
        assert torch.equal(mf1, mf2), t
        for x1, x2 in zip(ls1, ls2):
            assert torch.equal(x1[0], x2[2]) and torch.equal(x1[1], x2[0])
        assert (bool(done1[0]), int(comp1[0])) == (bool(done2[2]),
                                                   int(comp2[2]))
        assert (bool(done1[1]), int(comp1[1])) == (bool(done2[0]),
                                                   int(comp2[0]))


def test_pool_tick_shared_free_lanes_inert():
    """Dispatching the free lane too (as the reference's scan does)
    changes nothing: leaving it out of the order is exact."""
    pool, cp, _, _ = _pool([JOB_A, None, JOB_B])
    dirty = torch.zeros(E_POOL, dtype=torch.bool)
    budget = torch.full((3,), 10**6, dtype=torch.int32)
    a = b = (_zero_state(), torch.zeros(M_POOL, dtype=torch.int32))
    for t in range(10):
        a = tengine._pool_tick_shared(pool, cp, *a[:2], dirty[t], budget, t,
                                      [0, 2], "earliest_finish")
        b = tengine._pool_tick_shared(pool, cp, *b[:2], dirty[t], budget, t,
                                      [0, 2, 1], "earliest_finish")
        for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
            assert torch.equal(x, y), t


def test_engine_priority_is_admission_order_not_lane_index():
    """More jobs than lanes: lane reuse puts later jobs on arbitrary
    lanes, yet the run is replay-identical and equal to the reference."""
    cfg = dict(arrivals="poisson", rate=0.08, horizon=192, n_lanes=3,
               n_machines=2, seed=31, shared_fleet=True)
    r1, r2 = (simulate_stream(StreamConfig(**cfg), device="cpu")
              for _ in range(2))
    assert r1.events == r2.events
    ref = jstream.simulate_stream(jstream.StreamConfig(**cfg))
    assert [e["admitted"] for e in r1.events] == \
        [e["admitted"] for e in ref.events]
    assert [e.get("completed") for e in r1.events] == \
        [e.get("completed") for e in ref.events]


# ---------------------------------------------------------------------------
# Admission policy.
# ---------------------------------------------------------------------------

def test_scpf_admits_short_critical_path_first():
    jobs = [_chain_job([10, 10]), _chain_job([2])]     # cp 20 vs cp 2
    fifo = run_both(False, jobs, n_lanes=1)
    scpf = run_both(False, jobs, n_lanes=1, admission="scpf")
    assert all(sj.finished for sj in fifo + scpf)
    assert fifo[0].admitted < fifo[1].admitted
    assert scpf[1].admitted < scpf[0].admitted


def test_scpf_never_admits_future_arrivals():
    jobs = [_chain_job([10, 10], arrival=0), _chain_job([2], arrival=50)]
    scpf = run_both(False, jobs, n_lanes=1, admission="scpf")
    assert scpf[0].admitted == 0
    assert scpf[1].admitted >= 50


def test_admission_policy_validation():
    with pytest.raises(ValueError, match="admission policy"):
        StreamConfig(admission="nope").validate()
    with pytest.raises(ValueError, match="admission policy"):
        StreamEngine(_trace(1), (1.0,), (1.0,), 2, 2, admission="nope",
                     device="cpu")
    with pytest.raises(ValueError, match="machine_rule"):
        StreamEngine(_trace(1), (1.0,), (1.0,), 2, 2, machine_rule="nope",
                     device="cpu")


# ---------------------------------------------------------------------------
# The TINY stream bench.
# ---------------------------------------------------------------------------

def test_tiny_bench_matches_reference(tmp_path):
    """``bench.run_stream(tiny=True)`` on the CPU: the
    reference harness's counts, queue-delay distributions and fleet
    deltas exactly, its savings allclose."""
    got = bench.run_stream(tiny=True, device="cpu")
    out = tmp_path / "stream.json"
    stream_serve.run(tiny=True, shared_fleet=True, out=str(out))
    want = json.loads(out.read_text())
    assert got["service_epochs"] == want["service_epochs"]
    assert got["capacity_jobs_per_epoch"] == want["capacity_jobs_per_epoch"]
    assert len(got["cells"]) == len(want["cells"]) == 12
    for g, w in zip(got["cells"], want["cells"]):
        ctx = (w["arrivals"], w["load"], w["shared_fleet"])
        for k in ("arrivals", "load", "shared_fleet", "rate_jobs_per_epoch",
                  "n_jobs", "n_admitted", "n_rejected", "n_finished",
                  "n_truncated", "n_unfinished", "final_lane_occupancy",
                  "queue_delay_epochs", "realized_stretch"):
            assert g[k] == w[k], (ctx, k)
        for q, v in w["carbon_savings_pct"].items():
            np.testing.assert_allclose(g["carbon_savings_pct"][q], v,
                                       rtol=1e-5, atol=2e-3,
                                       err_msg=f"{ctx} {q}")
        assert g["tick_wall_s"]["count"] == g["ticks"] - 1 > 0
        assert g["jobs_per_sec"] > 0
    for g, w in zip(got["fleet_deltas"], want["fleet_deltas"]):
        assert {k: v for k, v in g.items() if "savings" not in k} == \
            {k: v for k, v in w.items() if "savings" not in k}
        assert g["savings_mean_delta_pct"] == pytest.approx(
            w["savings_mean_delta_pct"], abs=2e-3)
