"""Port vs reference: the bi-level solver end to end, and the bench.

Held as ``test_torch_solvers.py`` holds SA and GA: on the reference's
replayed ``jax.random`` draws the integer results (OPT, deadlines, starts,
assignments) must be equal and the float objectives allclose at rtol
1e-5; on the port's own generator every schedule must be validator-clean
with savings >= 0.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from repro.core.instance import stack_packed
from repro.core.solvers.annealing import SAConfig as JSAConfig
from repro.core.solvers.bilevel import solve_bilevel as jsolve_bilevel
from repro.core.solvers.bilevel import (
    solve_bilevel_batch as jsolve_bilevel_batch)
from repro.core.solvers.genetic import GAConfig as JGAConfig
from repro.scenarios import FLEET_NAMES
from repro_torch import bench
from repro_torch.core import instance as tinstance
from repro_torch.core.carbon import synthesize
from repro_torch.core.solvers import common as tcommon
from repro_torch.core.solvers.annealing import SAConfig
from repro_torch.core.solvers.bilevel import solve_bilevel, solve_bilevel_batch
from repro_torch.core.solvers.genetic import GAConfig
from repro_torch.core.validate import total_violations
from tests.strategies import scenario_case
from tests.test_torch_solvers import (GA_CFG, RTOL_SOLVE, SA_CFG,
                                      ReplayDraws, bilevel_draws, stacked,
                                      to_port)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_schedule_equal(want, got, ctx):
    for f in ("start", "assign", "makespan"):
        assert_array_equal(np.asarray(getattr(want, f)),
                           getattr(got, f).numpy(), err_msg=f"{ctx}.{f}")
    for f in ("energy", "carbon", "utilization"):
        assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                        rtol=RTOL_SOLVE, err_msg=f"{ctx}.{f}")


def test_solve_bilevel_ga_replayed():
    """``solver="ga"`` end to end: both phases on replayed draws."""
    p, w = scenario_case(23, family="chain", fleet="mixed", horizon=400)
    cum = w.cumulative()
    key = jax.random.PRNGKey(5)
    jcfg, tcfg = JGAConfig(**GA_CFG), GAConfig(**GA_CFG)
    want = jsolve_bilevel(p, jnp.asarray(cum), key, stretch=1.5, solver="ga",
                          cfg1=jcfg, use_kernels=False)
    draws = ReplayDraws(bilevel_draws(key, p.T, p.M, jcfg, "ga"))
    got = solve_bilevel(to_port(p), torch.as_tensor(cum), draws, stretch=1.5,
                        solver="ga", cfg1=tcfg)
    assert draws.done
    assert int(want.opt_makespan) == int(got.opt_makespan)
    assert int(want.deadline) == int(got.deadline)
    assert_schedule_equal(want.baseline, got.baseline, "baseline")
    assert_schedule_equal(want.optimized, got.optimized, "optimized")


@pytest.mark.parametrize("objective,stretch", [("carbon", 1.5),
                                               ("energy", 1.25)])
def test_solve_bilevel_batch_replayed(objective, stretch):
    """Instances advance in lockstep; each must match the reference's
    vmapped run on its own key."""
    pt, pm = 32, 4
    cases = [scenario_case(s, family=f, fleet=FLEET_NAMES[s % 3],
                           horizon=400, pad_tasks=pt, pad_machines=pm)
             for s, f in ((23, "fanout"), (29, "chain"), (31, "layered"))]
    batch = stack_packed([p for p, _ in cases])
    cums = np.stack([w.cumulative() for _, w in cases])
    keys = jax.random.split(jax.random.PRNGKey(3), len(cases))
    jcfg, tcfg = JSAConfig(**SA_CFG), SAConfig(**SA_CFG)
    want = jsolve_bilevel_batch(batch, jnp.asarray(cums), keys,
                                objective=objective, stretch=stretch,
                                cfg1=jcfg, use_kernels=False)
    draws = ReplayDraws(stacked([bilevel_draws(k, pt, pm, jcfg)
                                 for k in keys]))
    tb = to_port(batch)
    got = solve_bilevel_batch(tb, torch.as_tensor(cums), draws,
                              objective=objective, stretch=stretch,
                              cfg1=tcfg)
    assert draws.done
    assert_array_equal(np.asarray(want.opt_makespan), got.opt_makespan.numpy())
    assert_array_equal(np.asarray(want.deadline), got.deadline.numpy())
    assert_schedule_equal(want.baseline, got.baseline, "baseline")
    assert_schedule_equal(want.optimized, got.optimized, "optimized")
    for f in ("carbon_savings", "energy_savings"):
        assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                        rtol=RTOL_SOLVE, atol=1e-6, err_msg=f)
    assert not total_violations(tb, got.optimized.start, got.optimized.assign,
                                got.deadline).any()


# ---------------------------------------------------------------------------
# The port's own draws, and the bench
# ---------------------------------------------------------------------------

def test_own_draws_paper_instances_clean():
    """8 paper instances (n=4 jobs x k=3 tasks, M=3) on the port's own
    generator: every schedule validator-clean, savings >= 0."""
    rng = np.random.default_rng(11)
    year = synthesize("AU-SA", days=30, seed=2024)
    packs, cums = [], []
    for _ in range(8):
        inst = tinstance.generate_instance(rng, n_jobs=4, k_tasks=3,
                                           n_machines=3)
        packs.append(tinstance.pack(inst, pad_tasks=12, device="cpu"))
        cums.append(year.window(int(rng.integers(0, year.n_epochs - 300)),
                                300).cumulative())
    tb = tinstance.stack_packed(packs)
    res = solve_bilevel_batch(tb, torch.as_tensor(np.stack(cums)),
                              tcommon.TorchDraws(0, device="cpu"),
                              stretch=1.5, cfg1=SAConfig(**SA_CFG))
    assert not total_violations(tb, res.baseline.start,
                                res.baseline.assign).any()
    assert not total_violations(tb, res.optimized.start, res.optimized.assign,
                                res.deadline).any()
    assert (res.optimized.makespan <= res.deadline).all()
    assert (res.carbon_savings >= 0).all()
    assert torch.isfinite(res.optimized.carbon).all()


def test_bench_run_batch_summary_keys(monkeypatch):
    from benchmarks.common import summarize as jsummarize
    monkeypatch.setattr(bench, "SA_FAST",
                        SAConfig(pop=8, iters=4, migrate_every=2))
    setup = bench.BenchSetup(n_jobs=3, k_tasks=2, n_machines=3, instances=2)
    r = bench.run_batch(setup, device="cpu")
    row = bench.summarize(r)
    assert list(row) == list(jsummarize(r))
    assert all(np.isfinite(v) for v in row.values())
    assert not r["baseline_violations"].any()
    assert not r["optimized_violations"].any()
