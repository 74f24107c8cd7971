"""Port vs reference: the online carbon-gated dispatcher on the CPU.

The port's batched torch dispatcher (``online_torch``) is held to the
reference's JAX dispatcher (``online_jax``) and to the numpy oracle — the
reference's ``online.py`` and the port's own copy of it — with *equal*
``(start, assign, scheduled)``, on every scenario family and fleet, under
both machine rules.  Cases come from ``tests.strategies.scenario_case``,
padded to one ``(T, M)`` as ``test_online_jax.py`` does, and are carried
over with ``packed_from_numpy``.  Stretches are binary-exact.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core.instance import stack_packed
from repro.core.solvers import online as jonline
from repro.core.solvers import online_jax
from repro.scenarios import FAMILY_NAMES, FLEET_NAMES
from repro_torch.core import validate
from repro_torch.core.instance import packed_from_numpy
from repro_torch.core.solvers import online as tonline
from repro_torch.core.solvers import online_torch
from repro_torch.kernels import LAUNCHES, reset_launches
from tests.strategies import family_names, fleet_names, scenario_case, seeds

HORIZON = 400
PAD_T, PAD_M = 40, 5
RULES = ("earliest_finish", "min_energy")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, family=None, fleet=None, **kw):
    kw.setdefault("n_jobs", 3)
    return scenario_case(seed, family=family, fleet=fleet, horizon=HORIZON,
                         pad_tasks=PAD_T, pad_machines=PAD_M, **kw)


def to_port(p):
    return packed_from_numpy({f: np.asarray(getattr(p, f)) for f in p._fields},
                             device="cpu")


def np_of(sched):
    return [x.numpy() for x in sched]


def assert_same(got, start, assign, ctx):
    np.testing.assert_array_equal(np.asarray(start), got[0], err_msg=ctx)
    np.testing.assert_array_equal(np.asarray(assign), got[1], err_msg=ctx)


def test_critical_path_matches_reference_and_oracle():
    packs = [_case(s, FAMILY_NAMES[s % len(FAMILY_NAMES)],
                   FLEET_NAMES[s % len(FLEET_NAMES)])[0] for s in range(5)]
    batch = online_torch.downstream_critical_path(
        to_port(stack_packed(packs)))
    for i, p in enumerate(packs):
        want = np.asarray(online_jax.downstream_critical_path(p))
        got = online_torch.downstream_critical_path(to_port(p)).numpy()
        oracle = tonline._critical_path(*(np.asarray(getattr(p, f)) for f in
                                          ("dur", "allowed", "pred",
                                           "task_mask")))
        np.testing.assert_array_equal(want, got)
        np.testing.assert_array_equal(oracle, got)
        np.testing.assert_array_equal(batch[i].numpy(), got)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("seed,fleet", [(0, "homog"), (1, "tiered"),
                                       (2, "mixed")])
def test_batch_matches_reference_and_oracle(seed, fleet, rule):
    """One batched port call over every family: greedy and gated rows
    equal the reference's single-instance JAX calls and both oracles."""
    cases = [_case(seed + 10 * i, fam, fleet)
             for i, fam in enumerate(FAMILY_NAMES)]
    packs = [p for p, _ in cases]
    inten = np.stack([w.intensity for _, w in cases])
    batch = to_port(stack_packed(packs))
    kw = dict(theta=0.4, window=96, stretch=1.5, machine_rule=rule)
    g = np_of(online_torch.online_greedy_torch(batch, HORIZON,
                                               machine_rule=rule,
                                               device="cpu"))
    c = np_of(online_torch.online_carbon_gated_torch(batch, inten,
                                                     device="cpu", **kw))
    for b, (p, w) in enumerate(cases):
        ctx = f"{FAMILY_NAMES[b]}/{fleet}/{rule}"
        assert (g[2][b] | ~np.asarray(p.task_mask)).all(), ctx
        assert (c[2][b] | ~np.asarray(p.task_mask)).all(), ctx
        jg = online_jax.online_greedy_jax(p, HORIZON, machine_rule=rule)
        assert_same((g[0][b], g[1][b]), jg.start, jg.assign, "greedy " + ctx)
        jc = online_jax.online_carbon_gated_jax(p, w.intensity, **kw)
        assert_same((c[0][b], c[1][b]), jc.start, jc.assign, "gated " + ctx)
        np.testing.assert_array_equal(np.asarray(jc.scheduled), c[2][b])
        for oracle in (jonline, tonline):
            q = p if oracle is jonline else to_port(p)
            assert_same((g[0][b], g[1][b]),
                        *oracle.online_greedy(q, machine_rule=rule),
                        "oracle greedy " + ctx)
            assert_same((c[0][b], c[1][b]),
                        *oracle.online_carbon_gated(q, w.intensity, **kw),
                        "oracle gated " + ctx)
        tp = to_port(p)
        assert int(validate.total_violations(
            tp, torch.as_tensor(c[0][b]), torch.as_tensor(c[1][b]))) == 0


@settings(max_examples=8, deadline=None, derandomize=True)
@given(seed=seeds(), family=family_names(), fleet=fleet_names(),
       theta=st.sampled_from([0.25, 0.4, 0.5, 0.75]),
       window=st.sampled_from([24, 48, 96, 130]),
       stretch=st.sampled_from([1.25, 1.5, 2.0]),
       rule=st.sampled_from(RULES))
def test_gated_matches_reference_property(seed, family, fleet, theta,
                                          window, stretch, rule):
    p, w = _case(seed, family, fleet)
    kw = dict(theta=theta, window=window, stretch=stretch, machine_rule=rule)
    got = np_of(online_torch.online_carbon_gated_torch(
        to_port(p), w.intensity, device="cpu", **kw))
    want = online_jax.online_carbon_gated_jax(p, w.intensity, **kw)
    assert_same(got, want.start, want.assign, f"seed {seed}")
    np.testing.assert_array_equal(np.asarray(want.scheduled), got[2])


@pytest.mark.parametrize("rule", RULES)
def test_warm_fleet_state0(rule):
    """Dispatch onto a fleet whose machines are busy until given epochs:
    both the greedy budget run and the gated run start from ``state0``."""
    p, w = _case(4, "layered", "tiered", n_jobs=4)
    mfree = np.array([30, 0, 55, 12, 0], np.int32)
    T = p.T
    jstate = online_jax.init_dispatch_state(T, PAD_M)._replace(
        mfree=jnp.asarray(mfree))
    tstate = online_torch.init_dispatch_state(T, PAD_M, device="cpu") \
        ._replace(mfree=torch.as_tensor(mfree))
    kw = dict(theta=0.3, window=48, stretch=1.25, machine_rule=rule)
    want = online_jax.online_carbon_gated_jax(p, w.intensity, state0=jstate,
                                              **kw)
    got = np_of(online_torch.online_carbon_gated_torch(
        to_port(p), w.intensity, state0=tstate, device="cpu", **kw))
    assert_same(got, want.start, want.assign, "warm fleet")
    np.testing.assert_array_equal(np.asarray(want.scheduled), got[2])
    # The warm fleet really was warm: no task starts on a machine before
    # that machine is free.
    real = np.asarray(p.task_mask)
    assert (got[0][real] >= mfree[got[1][real]]).all()
    # ... and the state was not changed in place.
    np.testing.assert_array_equal(tstate.mfree.numpy(), mfree)


def test_sweep_matches_reference():
    """``sweep_policies`` against the reference's sweep: greedy and gated
    schedules, greedy makespan, budget, and the policy order; the first
    instance's cells against the numpy oracle."""
    cases = [_case(s, FAMILY_NAMES[s], FLEET_NAMES[s % 3]) for s in range(3)]
    packs = [p for p, _ in cases]
    inten = np.stack([w.intensity for _, w in cases])
    thetas, windows, stretches = [0.3, 0.5], [48, 96], [1.25, 1.5]
    want = online_jax.sweep_policies(stack_packed(packs), jnp.asarray(inten),
                                     thetas, windows, stretches)
    reset_launches()
    got = online_torch.sweep_policies(to_port(stack_packed(packs)), inten,
                                      thetas, windows, stretches,
                                      device="cpu")
    assert sum(LAUNCHES.values()) == 0          # CPU: the plain version
    for name in ("start", "assign", "scheduled"):
        for part in ("greedy", "gated"):
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(want, part), name)),
                getattr(getattr(got, part), name).numpy(),
                err_msg=f"{part}.{name}")
    np.testing.assert_array_equal(np.asarray(want.greedy_makespan),
                                  got.greedy_makespan.numpy())
    np.testing.assert_array_equal(np.asarray(want.budget), got.budget.numpy())
    assert got.gated.start.shape == (3, 8, PAD_T)
    for a, b in zip(online_jax.policy_grid(thetas, windows, stretches),
                    online_torch.policy_grid(thetas, windows, stretches)):
        np.testing.assert_array_equal(np.asarray(a), b)
    th, wi, _ = online_torch.policy_grid(thetas, windows, stretches)
    tp = to_port(packs[0])
    for j in range(len(th)):
        s, a = tonline.online_carbon_gated(
            tp, inten[0], theta=float(th[j]), window=int(wi[j]),
            budget=int(got.budget[0, j]))
        assert_same((got.gated.start[0, j].numpy(),
                     got.gated.assign[0, j].numpy()), s, a, f"policy {j}")


def test_dispatch_epoch_steps_reproduce_simulate():
    """Stepping ``dispatch_epoch`` epoch by epoch (the pool-step entry
    point) gives ``simulate_online``'s schedule."""
    p, w = _case(2, "fanout", "homog")
    tp = to_port(p)
    inten = torch.as_tensor(w.intensity)
    dirty = online_torch.dirty_mask(inten, 0.4, 48, max_window=48)
    sim = online_torch.simulate_online(tp, dirty, 150, HORIZON)
    state = online_torch.init_dispatch_state(tp.T, tp.M, device="cpu")
    for t in range(HORIZON - 1):
        state = online_torch.dispatch_epoch(tp, state, dirty[t],
                                            torch.tensor(150), t)
    for x, y in zip(sim, state.schedule()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_unknown_machine_rule_raises():
    p, _ = _case(0, "chain", "homog")
    with pytest.raises(ValueError, match="machine_rule"):
        online_torch.online_greedy_torch(to_port(p), 10, machine_rule="x",
                                         device="cpu")


def test_online_bench_cell_matches_reference():
    """The bench's online cell (without the bound) on 4 instances: the
    same numpy stream as ``benchmarks/online_vs_offline.py`` gives the
    same instances, and the sweep, validator and savings agree with the
    reference's on them (savings at rtol 1e-5: two float reductions)."""
    import jax

    from repro.core import generate_instance, pack, synthesize
    from repro.core.objectives import evaluate
    from repro_torch import bench

    setup = bench.BenchSetup(stretch=1.5, instances=4)
    r = bench.run_online(setup, "cpu")
    assert r["unscheduled_greedy"] == r["unscheduled_gated"] == 0
    assert not r["greedy_violations"].any()
    assert not r["gated_violations"].any()

    rng = np.random.default_rng(setup.seed)
    year = synthesize(setup.region, days=366, seed=2024)
    packs, intens, cums = [], [], []
    for _ in range(setup.instances):
        packs.append(pack(generate_instance(rng), pad_tasks=40))
        w = year.window(int(rng.integers(0, year.n_epochs
                                         - bench.SIM_HORIZON)),
                        bench.SIM_HORIZON)
        intens.append(w.intensity)
        cums.append(w.cumulative())
    batch = stack_packed(packs)
    np.testing.assert_array_equal(np.stack(intens), r["intensity"].numpy())
    for f in batch._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(batch, f)),
            torch.stack([getattr(p, f) for p in r["packs"]]).numpy())
    want = online_jax.sweep_policies(batch, jnp.asarray(np.stack(intens)),
                                     bench.ONLINE_THETAS,
                                     bench.ONLINE_WINDOWS,
                                     bench.ONLINE_STRETCHES)
    res = r["result"]
    for part in ("greedy", "gated"):
        for name in ("start", "assign"):
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(want, part), name)),
                getattr(getattr(res, part), name).numpy(),
                err_msg=f"{part}.{name}")
    cum = jnp.asarray(np.stack(cums))
    base = jax.vmap(evaluate)(batch, want.greedy.start, want.greedy.assign,
                              cum)
    for j in range(want.budget.shape[1]):
        gated = jax.vmap(evaluate)(batch, want.gated.start[:, j],
                                   want.gated.assign[:, j], cum)
        sav = 1.0 - np.asarray(gated.carbon) / np.asarray(base.carbon)
        np.testing.assert_allclose(r["savings"][:, j], sav, rtol=1e-5)
    rows = bench.online_summary(r)
    assert len(rows) == 12 and rows[0]["online_gated_savings_pct"] \
        >= rows[-1]["online_gated_savings_pct"]
