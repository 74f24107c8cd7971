"""Port vs reference: the exact oracle, and the port's solvers against it.

``exact_makespan`` / ``exact_carbon`` are numpy copies reading the port's
torch instances: on the same tiny instances they must give the
reference's answers exactly.  Then ``tests/test_core_scheduling.py``'s
oracle checks run on the port's solvers (on the port's own draws): SA and
GA reach the optimal makespan, and the bi-level carbon is within 2% of
the exact minimum.
"""
import numpy as np
import pytest
import torch

from repro.core import generate_instance as jgenerate
from repro.core import pack as jpack
from repro.core.instance import Instance as JInstance, Job as JJob
from repro.core.solvers.exact import exact_carbon as jexact_carbon
from repro.core.solvers.exact import exact_makespan as jexact_makespan
from repro_torch.core.carbon import sample_window, synthesize
from repro_torch.core.instance import Instance, Job, generate_instance, pack
from repro_torch.core.solvers import (GAConfig, SAConfig, TorchDraws,
                                      decode_full, solve_bilevel, solve_ga,
                                      solve_sa)
from repro_torch.core.solvers.exact import exact_carbon, exact_makespan
from tests.test_torch_solvers import to_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace_cum(rng, horizon=400):
    return sample_window(synthesize("AU-SA", days=10), rng,
                         horizon).cumulative()


@pytest.mark.parametrize("seed,n_jobs,k_tasks,m,hetero",
                         [(7, 2, 2, 2, True), (3, 1, 3, 2, False),
                          (11, 2, 2, 3, True), (5, 1, 4, 2, True)])
def test_exact_makespan_matches_reference(seed, n_jobs, k_tasks, m, hetero):
    inst = jgenerate(np.random.default_rng(seed), n_jobs=n_jobs,
                     k_tasks=k_tasks, n_machines=m, heterogeneous=hetero,
                     arrival_horizon=4)
    p = jpack(inst)
    assert exact_makespan(to_port(p)) == jexact_makespan(p)


@pytest.mark.parametrize("seed,deadline", [(3, 8), (4, 12), (9, 16)])
def test_exact_carbon_matches_reference(seed, deadline):
    rng = np.random.default_rng(seed)
    job = Job(arrival=0, base_durations=(2, 1 + seed % 3), edges=((0, 1),))
    inst = Instance(jobs=(job,), powers_kw=(1.0, 0.5),
                    speeds=(1.0, 0.5))
    cum = sample_window(synthesize("AU-SA", days=2), rng, 16).cumulative()
    jinst = JInstance(jobs=(JJob(**vars(job)),), powers_kw=(1.0, 0.5),
                      speeds=(1.0, 0.5))
    want = jexact_carbon(jpack(jinst), cum, deadline)
    got = exact_carbon(pack(inst, device="cpu"), cum, deadline)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("solver", ["sa", "ga"])
def test_port_solver_reaches_exact_makespan(solver):
    inst = generate_instance(np.random.default_rng(7), n_jobs=2, k_tasks=2,
                             n_machines=2, heterogeneous=True,
                             arrival_horizon=1)
    p = pack(inst, device="cpu")
    opt = exact_makespan(p)
    cum = torch.tensor(_trace_cum(np.random.default_rng(7)))
    fn = solve_sa if solver == "sa" else solve_ga
    cfgs = dict(sa=SAConfig(pop=64, iters=120), ga=GAConfig(pop=64, gens=80))
    out = fn(p, cum, 1 << 27, TorchDraws(1, "cpu"), objective="makespan",
             machine_rule="earliest_finish", cfg=cfgs[solver])
    res = decode_full(p, cum, 1 << 27, out.prio, out.assign,
                      objective="makespan", machine_rule="earliest_finish",
                      sweeps=0)
    assert int(res.makespan) == opt


def test_port_bilevel_within_exact_carbon():
    rng = np.random.default_rng(3)
    job = Job(arrival=0, base_durations=(2, 2), edges=((0, 1),))
    inst = Instance(jobs=(job,), powers_kw=(1.0, 1.0), speeds=(1.0, 1.0))
    p = pack(inst, device="cpu")
    cum_np = sample_window(synthesize("AU-SA", days=2), rng, 16).cumulative()
    res = solve_bilevel(p, torch.tensor(cum_np), TorchDraws(0, "cpu"),
                        objective="carbon", stretch=2.0,
                        cfg1=SAConfig(pop=64, iters=100),
                        cfg2=SAConfig(pop=64, iters=100))
    c_exact, _, _ = exact_carbon(p, cum_np, int(res.deadline))
    assert float(res.optimized.carbon) <= c_exact * 1.02 + 1e-6
    assert int(res.opt_makespan) == exact_makespan(p)
