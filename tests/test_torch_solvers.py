"""Port vs reference: population fitness, SA and GA.

The reference draws from ``jax.random``'s split tree and the port from a
``torch.Generator``; the two never give the same numbers.  So the solvers
are held on **replayed** draws: the test draws the very arrays the
reference's split tree draws (``annealing.py``/``genetic.py``/
``bilevel.py`` key splits, in the port's documented draw order) and hands
them to the port through a replaying draws object.  Integer results
(assignments, starts, OPT, deadlines) must then be equal, float objectives
allclose at rtol 1e-5.  The bi-level solver and the port's own draws are
held in ``test_torch_bilevel.py``, which shares these helpers.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from repro.core.solvers import common as jcommon
from repro.core.solvers.annealing import SAConfig as JSAConfig
from repro.core.solvers.annealing import solve_sa as jsolve_sa
from repro.core.solvers.genetic import GAConfig as JGAConfig
from repro.core.solvers.genetic import solve_ga as jsolve_ga
from repro_torch.core import instance as tinstance
from repro_torch.core.solvers import common as tcommon
from repro_torch.core.solvers.annealing import SAConfig, solve_sa
from repro_torch.core.solvers.genetic import GAConfig, solve_ga
from tests.strategies import scenario_case

RTOL_SOLVE = 1e-5
SA_CFG = dict(pop=16, iters=12, migrate_every=5)
GA_CFG = dict(pop=12, gens=6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(p):
    return tinstance.packed_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields}, device="cpu")


# ---------------------------------------------------------------------------
# Replaying the reference's jax.random draws
# ---------------------------------------------------------------------------

class ReplayDraws:
    """Hands the port a recorded sequence of (kind, array) draws."""

    def __init__(self, seq):
        self.seq = list(seq)
        self.i = 0

    def _next(self, kind, shape):
        k, arr = self.seq[self.i]
        self.i += 1
        assert k == kind and tuple(arr.shape) == tuple(shape), (
            f"draw {self.i - 1}: port asked {kind}{tuple(shape)}, "
            f"replay has {k}{tuple(arr.shape)}")
        return torch.tensor(np.asarray(arr))

    def normal(self, shape):
        return self._next("normal", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def bernoulli(self, p, shape):
        return self._next("bernoulli", shape)

    def randint(self, low, high, shape):
        return self._next("randint", shape)

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    @property
    def done(self):
        return self.i == len(self.seq)


def sa_draws(key, T, M, cfg, assign_given):
    """What ``repro.core.solvers.annealing.solve_sa`` draws from ``key``."""
    r = jax.random
    k_init, k_assign, k_run = r.split(key, 3)
    out = [("normal", r.normal(k_init, (cfg.pop, T)))]
    if not assign_given:
        out.append(("gumbel", r.gumbel(k_assign, (cfg.pop, T, M))))
    key = k_run
    for it in range(cfg.iters):
        key, k1, k2, k3, k4, k5, k6 = r.split(key, 7)
        out += [("bernoulli", r.bernoulli(k1, 2.0 / T, (cfg.pop, T))),
                ("normal", r.normal(k2, (cfg.pop, T))),
                ("bernoulli", r.bernoulli(k3, cfg.p_machine_move,
                                          (cfg.pop,))),
                ("randint", r.randint(k4, (cfg.pop,), 0, T)),
                ("gumbel", r.gumbel(k5, (cfg.pop, T, M))),
                ("uniform", r.uniform(k6, (cfg.pop,)))]
        key, km = r.split(key)
        if it % cfg.migrate_every == cfg.migrate_every - 1:
            kk1, _ = r.split(km)
            out.append(("normal", r.normal(kk1, (cfg.pop, T))))
    return out


def ga_draws(key, T, M, cfg, assign_given):
    """What ``repro.core.solvers.genetic.solve_ga`` draws from ``key``."""
    r = jax.random
    k_init, k_assign, k_run = r.split(key, 3)
    out = [("normal", r.normal(k_init, (cfg.pop, T)))]
    if not assign_given:
        out.append(("gumbel", r.gumbel(k_assign, (cfg.pop, T, M))))
    key = k_run
    for _ in range(cfg.gens):
        key, k1, k2, k3, k4, k5, k6, k7 = r.split(key, 8)
        out += [("randint", r.randint(k1, (2, cfg.pop, cfg.tourn), 0,
                                      cfg.pop)),
                ("bernoulli", r.bernoulli(k2, cfg.p_cross, (cfg.pop, 1))),
                ("bernoulli", r.bernoulli(k3, 0.5, (cfg.pop, T))),
                ("bernoulli", r.bernoulli(k4, cfg.p_mut_prio, (cfg.pop, 1))),
                ("bernoulli", r.bernoulli(k5, 2.0 / T, (cfg.pop, T))),
                ("normal", r.normal(k5, (cfg.pop, T))),
                ("bernoulli", r.bernoulli(k6, cfg.p_mut_mach, (cfg.pop, 1))),
                ("randint", r.randint(k7, (cfg.pop, 1), 0, T)),
                ("gumbel", r.gumbel(k7, (cfg.pop, T, M)))]
    return out


def bilevel_draws(key, T, M, cfg, solver="sa"):
    """``solve_bilevel``: phase 1 from split(key)[0], phase 2 from [1]."""
    k1, k2 = jax.random.split(key)
    draws = sa_draws if solver == "sa" else ga_draws
    return draws(k1, T, M, cfg, False) + draws(k2, T, M, cfg, True)


def stacked(seqs):
    """Per-instance draw sequences -> one sequence of [B, ...] arrays."""
    return [(items[0][0], np.stack([np.asarray(a) for _, a in items]))
            for items in zip(*seqs)]


# ---------------------------------------------------------------------------
# population_fitness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["makespan", "carbon", "energy"])
@pytest.mark.parametrize("rule", ["fixed", "earliest_finish", "min_energy"])
def test_population_fitness_matches_jnp_path(objective, rule):
    rng = np.random.default_rng(21)
    p, w = scenario_case(7, family="layered", fleet="tiered", horizon=400)
    cum = w.cumulative()
    prio = rng.normal(size=(6, p.T)).astype(np.float32)
    allowed = np.asarray(p.allowed)
    assign = np.stack([rng.choice(np.nonzero(allowed[t])[0], size=6)
                       for t in range(p.T)], 1).astype(np.int32)
    sweeps = 0 if objective == "makespan" else 2
    want = jcommon.population_fitness(
        p, jnp.asarray(cum), jnp.int32(180), jnp.asarray(prio),
        jnp.asarray(assign), objective, rule, sweeps, use_kernels=False)
    got = tcommon.population_fitness(
        to_port(p), torch.as_tensor(cum), 180, torch.as_tensor(prio),
        torch.as_tensor(assign), objective, rule, sweeps)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # decode_full + fitness_of compute the same fitness through
    # objectives.carbon instead of the kernel wrapper: bitwise equal.
    res = tcommon.decode_full(to_port(p), torch.as_tensor(cum), 180,
                              torch.as_tensor(prio), torch.as_tensor(assign),
                              objective, rule, sweeps)
    assert torch.equal(tcommon.fitness_of(to_port(p), res, 180, objective),
                       got)
    with pytest.raises(ValueError):
        tcommon.population_fitness(
            to_port(p), torch.as_tensor(cum), 180, torch.as_tensor(prio),
            torch.as_tensor(assign), "watts", rule, sweeps)


def test_random_allowed_assign_replayed():
    p, _ = scenario_case(4, fleet="mixed", pad_machines=5)
    key = jax.random.PRNGKey(8)
    want = jcommon.random_allowed_assign(key, p, (7,))
    g = jax.random.gumbel(key, (7, p.T, p.M))
    got = tcommon.random_allowed_assign(ReplayDraws([("gumbel", g)]),
                                        to_port(p), (7,))
    assert_array_equal(np.asarray(want), got.numpy())
    assert np.asarray(p.allowed)[np.arange(p.T), got.numpy()].all()


# ---------------------------------------------------------------------------
# SA / GA / bi-level on replayed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective,rule,deadline", [
    ("carbon", "fixed", 200), ("makespan", "earliest_finish", 1 << 27)])
def test_solve_sa_replayed(objective, rule, deadline):
    p, w = scenario_case(17, family="diamond", fleet="tiered", horizon=400)
    cum = w.cumulative()
    key = jax.random.PRNGKey(0)
    jcfg, tcfg = JSAConfig(**SA_CFG), SAConfig(**SA_CFG)
    want = jsolve_sa(p, jnp.asarray(cum), jnp.int32(deadline), key,
                     objective=objective, machine_rule=rule, cfg=jcfg,
                     use_kernels=False)
    draws = ReplayDraws(sa_draws(key, p.T, p.M, jcfg, False))
    got = solve_sa(to_port(p), torch.as_tensor(cum), deadline, draws,
                   objective=objective, machine_rule=rule, cfg=tcfg)
    assert draws.done
    assert_array_equal(np.asarray(want.assign), got.assign.numpy())
    assert_allclose(got.prio.numpy(), np.asarray(want.prio), rtol=1e-6)
    assert_allclose(got.fitness.numpy(), np.asarray(want.fitness),
                    rtol=RTOL_SOLVE)


def test_solve_ga_replayed():
    p, w = scenario_case(19, family="tpch", fleet="homog", horizon=400)
    cum = w.cumulative()
    key = jax.random.PRNGKey(2)
    jcfg, tcfg = JGAConfig(**GA_CFG), GAConfig(**GA_CFG)
    want = jsolve_ga(p, jnp.asarray(cum), jnp.int32(200), key, cfg=jcfg,
                     use_kernels=False)
    draws = ReplayDraws(ga_draws(key, p.T, p.M, jcfg, False))
    got = solve_ga(to_port(p), torch.as_tensor(cum), 200, draws, cfg=tcfg)
    assert draws.done
    assert_array_equal(np.asarray(want.assign), got.assign.numpy())
    assert_allclose(got.prio.numpy(), np.asarray(want.prio), rtol=1e-6)
    assert_allclose(got.fitness.numpy(), np.asarray(want.fitness),
                    rtol=RTOL_SOLVE)
