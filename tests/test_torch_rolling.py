"""Port vs reference: the MPC rolling replanner.

The replan loop cannot be held end to end: each replan's forecast ``cum``
comes from ``forecast_cum``, a float32 prefix sum whose association order
(XLA's) no torch scan reproduces, and the searches draw from different
RNG streams.  So the replanner is held at its seams:

* ``forecast_cum`` allclose at the reference's own tolerance (rtol 2e-5);
* ``_project`` and ``_frozen_instance`` bitwise;
* one replan step, fed the reference's ``cum_k`` and its replayed SA
  draws, gives the reference's integers;
* the reference's invariants (``tests/test_rolling.py``) on the port's
  own draws: the frozen prefix never moves, the final plan is feasible
  within the deadline, and a perfect forecast never ends worse than the
  day-ahead plan;
* a batch equals its single runs within the port.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import jax
import jax.numpy as jnp

from repro.core.instance import stack_packed
from repro.core.solvers.annealing import SAConfig as JSAConfig
from repro.core.solvers import rolling as jrolling
from repro.forecast import models as jm
from repro_torch.core import validate
from repro_torch.core.solvers import TorchDraws
from repro_torch.core.solvers import rolling as trolling
from repro_torch.core.solvers.annealing import SAConfig
from tests.strategies import scenario_case
from tests.test_torch_solvers import ReplayDraws, sa_draws, to_port

HORIZON = 320
PAD_T, PAD_M = 24, 4
SA = dict(pop=16, iters=16, sweeps=1)
P1 = dict(pop=24, iters=40)
JCFG = jrolling.MPCConfig(every=24, n_replans=5, stretch=1.5,
                          sa=JSAConfig(**SA), sa_phase1=JSAConfig(**P1))
CFG = trolling.MPCConfig(every=24, n_replans=5, stretch=1.5,
                         sa=SAConfig(**SA), sa_phase1=SAConfig(**P1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, family=None, fleet=None):
    p, w = scenario_case(seed, family=family, fleet=fleet, n_jobs=3,
                         width=2, depth=2, n_machines=3, horizon=HORIZON,
                         pad_tasks=PAD_T, pad_machines=PAD_M)
    return p, w.intensity, w.cumulative()


def _xi(seed, K=CFG.n_replans):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((K, HORIZON), generator=g)


def test_forecast_cum_allclose():
    """rtol 2e-5 is the reference's own (``test_rolling.py``): XLA's
    float32 cumsum associates in an order torch's cannot reproduce, so no
    bitwise claim is possible."""
    _, truth, cum = _case(7)
    want = np.asarray(jrolling.forecast_cum(jnp.asarray(truth)))
    got = trolling.forecast_cum(torch.tensor(truth))
    assert got.dtype == torch.float32 and got.shape == (HORIZON + 1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), cum, rtol=2e-5)
    assert float(got[0]) == 0.0
    many = trolling.forecast_cum(torch.tensor(np.stack([truth, truth])))
    assert torch.equal(many[1], got)


def test_project_and_frozen_instance_bitwise():
    p, _, _ = _case(3)
    rng = np.random.default_rng(0)
    T = p.T
    start = rng.integers(0, 60, T).astype(np.int32)
    assign = np.asarray(jax.random.categorical(
        jax.random.key(0), jnp.where(p.allowed, 0.0, -jnp.inf))).astype(
            np.int32)
    frozen = np.asarray(p.task_mask) & (start < 30)
    prio = (rng.normal(size=T) * 1e6).astype(np.float32)
    cand_a = rng.integers(0, PAD_M, T).astype(np.int32)
    want = jrolling._project(jnp.asarray(prio), jnp.asarray(cand_a),
                             jnp.asarray(frozen), jnp.asarray(start),
                             jnp.asarray(assign))
    got = trolling._project(torch.tensor(prio), torch.tensor(cand_a),
                            torch.tensor(frozen), torch.tensor(start),
                            torch.tensor(assign))
    for w, g in zip(want, got):
        assert_array_equal(np.asarray(w), g.numpy())
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32

    want = jrolling._frozen_instance(p, jnp.asarray(frozen),
                                     jnp.asarray(start), jnp.asarray(assign),
                                     jnp.int32(30))
    got = trolling._frozen_instance(to_port(p), torch.tensor(frozen),
                                    torch.tensor(start),
                                    torch.tensor(assign), 30)
    for f in want._fields:
        assert_array_equal(np.asarray(getattr(want, f)),
                           getattr(got, f).numpy(), err_msg=f)
        assert getattr(got, f).dtype == getattr(to_port(p), f).dtype


@pytest.mark.parametrize("seed,scale", [(0, 0.0), (1, 0.8), (2, 1.5)])
def test_replan_step_replayed(seed, scale):
    """Replans 0 and 1 of the reference's solve_mpc, each from the
    reference's incumbent, with its cum_k and its SA draws."""
    p, truth, cum = _case(seed)
    key, fc_key = jax.random.key(seed), jax.random.key(1000 + seed)
    jcfg = JCFG._replace(n_replans=2)
    want = jrolling.solve_mpc(p, jnp.asarray(truth), jnp.asarray(cum), key,
                              fc_key, jnp.float32(scale), cfg=jcfg)
    _, k_run = jax.random.split(key)
    start = torch.tensor(np.asarray(want.baseline.start))
    assign = torch.tensor(np.asarray(want.baseline.assign))
    deadline = torch.tensor(np.asarray(want.deadline))
    tp = to_port(p)
    for k in range(2):
        k_run, k_sa = jax.random.split(k_run)
        fc = jm.issue(jnp.asarray(truth), jnp.int32(k * jcfg.every),
                      key=jax.random.fold_in(fc_key, k), scale=scale)
        cum_k = torch.tensor(np.asarray(jrolling.forecast_cum(fc.point)))
        draws = ReplayDraws(sa_draws(k_sa, p.T, p.M, jcfg.sa, True))
        start, assign, n_frozen, planned = trolling.replan_step(
            tp, start, assign, k * CFG.every, cum_k, draws, deadline,
            cfg=CFG)
        assert draws.done
        assert_array_equal(np.asarray(want.plans_start[k]), start.numpy())
        assert_array_equal(np.asarray(want.plans_assign[k]), assign.numpy())
        assert int(n_frozen) == int(want.frozen_counts[k])
        np.testing.assert_allclose(float(planned),
                                   float(want.planned_carbon[k]), rtol=1e-5)


def _assert_invariants(p, res, every):
    """``tests/test_rolling.py``'s: the final plan is feasible within the
    deadline, and tasks started before each boundary keep (start, assign)
    from then on."""
    start, assign = res.start.numpy(), res.assign.numpy()
    validate.assert_feasible_np(p, start, assign,
                                deadline=int(res.deadline), ctx="mpc final")
    ps, pa = res.plans_start.numpy(), res.plans_assign.numpy()
    mask = p.task_mask.numpy()
    for k in range(ps.shape[0] - 1):
        frozen = mask & (ps[k] < (k + 1) * every)
        assert_array_equal(ps[k + 1][frozen], ps[k][frozen],
                           err_msg=f"start moved at replan {k + 1}")
        assert_array_equal(pa[k + 1][frozen], pa[k][frozen],
                           err_msg=f"assign moved at replan {k + 1}")
    assert_array_equal(start, ps[-1])
    assert_array_equal(assign, pa[-1])
    assert int(res.realized.makespan) <= int(res.deadline)


def _solve(seed, scale, family=None, fleet=None):
    p, truth, cum = _case(seed, family=family, fleet=fleet)
    tp = to_port(p)
    res = trolling.solve_mpc(tp, truth, cum, TorchDraws(seed, "cpu"),
                             _xi(1000 + seed), scale, cfg=CFG, device="cpu")
    return tp, res


@pytest.mark.parametrize("seed,family,fleet,scale",
                         [(0, None, "homog", 0.0), (1, None, "tiered", 0.8),
                          (2, None, "mixed", 1.5), (5, "chain", "homog", 1.0),
                          (6, "tpch", "mixed", 2.0)])
def test_mpc_frozen_prefix_and_feasibility(seed, family, fleet, scale):
    tp, res = _solve(seed, scale, family, fleet)
    _assert_invariants(tp, res, CFG.every)
    assert res.plans_start.shape == (CFG.n_replans, PAD_T)
    assert (res.frozen_counts[1:] >= res.frozen_counts[:-1]).all()


def test_mpc_zero_noise_never_worse_than_baseline():
    for seed in range(3):
        tp, res = _solve(seed + 20, 0.0)
        assert float(res.realized.carbon) <= \
            float(res.baseline.carbon) * (1 + 1e-6), seed
        assert int(res.realized.makespan) <= int(res.deadline)


class Recorder:
    """TorchDraws that keep what they drew, to replay into a batch."""

    def __init__(self, seed):
        self.src = TorchDraws(seed, "cpu")
        self.seq = []

    def __getattr__(self, kind):
        def draw(*args):
            x = getattr(self.src, kind)(*args)
            self.seq.append((kind, x))
            return x
        return draw


class Stacked:
    """Replays per-instance draw sequences as ``[B, ...]`` draws, shaped as
    asked (``[B, ...]`` for phase 1, ``[B, 1, ...]`` for the replans)."""

    def __init__(self, seqs):
        self.items = [list(x) for x in zip(*seqs)]
        self.i = 0

    def _next(self, kind, shape):
        items = self.items[self.i]
        self.i += 1
        assert all(k == kind for k, _ in items), (kind, items[0][0])
        return torch.stack([x for _, x in items]).reshape(tuple(shape))

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


def test_mpc_batch_matches_single():
    """Two instances x two forecast seeds at once equal the four single
    runs: search draws per instance, shared across the seeds; forecast
    draws per seed, shared across instances."""
    cases = [_case(s) for s in (0, 1)]
    xi = torch.stack([_xi(1000), _xi(1001)])
    singles, seqs = {}, []
    for b, (p, truth, cum) in enumerate(cases):
        for s in range(2):
            rec = Recorder(b)
            singles[b, s] = trolling.solve_mpc(to_port(p), truth, cum, rec,
                                               xi[s], 0.7, cfg=CFG,
                                               device="cpu")
        seqs.append(rec.seq)
    batch = to_port(stack_packed([p for p, _, _ in cases]))
    out = trolling.solve_mpc_batch(
        batch, np.stack([t for _, t, _ in cases]),
        np.stack([c for _, _, c in cases]), Stacked(seqs), xi, 0.7, cfg=CFG,
        device="cpu")
    assert out.start.shape == (2, 2, PAD_T)
    assert out.plans_start.shape == (2, 2, CFG.n_replans, PAD_T)
    assert out.deadline.shape == out.baseline.carbon.shape == (2, 2)
    for (b, s), one in singles.items():
        for f in ("start", "assign", "plans_start", "plans_assign",
                  "frozen_counts", "deadline", "opt_makespan"):
            assert torch.equal(getattr(out, f)[b, s], getattr(one, f)), f
        assert torch.equal(out.baseline.start[b, s], one.baseline.start)
        torch.testing.assert_close(out.realized.carbon[b, s],
                                   one.realized.carbon, rtol=1e-6, atol=0)


def test_seed_shared_draws_expand():
    draws = trolling.SeedShared(TorchDraws(0, "cpu"), (3,), (2,))
    x = draws.normal((3, 2, 5, 7))
    assert x.shape == (3, 2, 5, 7)
    assert torch.equal(x[:, 0], x[:, 1])
    assert not torch.equal(x[0], x[1])
    g = draws.gumbel((3, 2, 4))
    assert torch.equal(g[:, 0], g[:, 1])


def test_solve_mpc_batch_rejects_bad_axes():
    p, truth, cum = _case(0)
    with pytest.raises(ValueError, match="batch axis"):
        trolling.solve_mpc_batch(to_port(p), truth, cum,
                                 TorchDraws(0, "cpu"), _xi(0)[None], 0.5,
                                 cfg=CFG, device="cpu")
    batch = to_port(stack_packed([p]))
    with pytest.raises(ValueError, match="xi"):
        trolling.solve_mpc_batch(batch, truth[None], cum[None],
                                 TorchDraws(0, "cpu"), _xi(0), 0.5, cfg=CFG,
                                 device="cpu")


def test_forecast_cell_shares_phase_one_across_cells():
    """The forecast cell searches every (scale, every) cell from the same
    draws, as the reference harness passes one set of ``mpc_keys`` to
    every cell: phase 1 (OPT, deadline, the baseline plan) is the same in
    all nine cells, and at scale 0 no cell ends worse than that one
    baseline."""
    from repro_torch import bench
    setup = bench.ForecastSetup(instances=2, sa_pop=4, sa_iters=2)
    out = bench.run_forecast(setup, "cpu")
    cells = out["mpc"]
    # The last cell equals a search started afresh from the cell's seed.
    scale, every = bench.FC_SCALES[-1], bench.FC_EVERYS[-1]
    alone = trolling.solve_mpc_batch(
        out["batch"], out["truths"], out["cums"],
        TorchDraws(setup.seed + 2, "cpu"), out["xi"][:setup.mpc_seeds],
        scale, objective="carbon", cfg=bench.mpc_config(setup, every),
        device="cpu")
    for f in ("start", "assign", "plans_start", "plans_assign"):
        assert torch.equal(getattr(cells[(scale, every)], f),
                           getattr(alone, f)), f
    assert sorted(cells) == sorted((s, e) for s in bench.FC_SCALES
                                   for e in bench.FC_EVERYS)
    first = cells[(0.0, bench.FC_EVERYS[0])]
    for key, mpc in cells.items():
        for f in ("opt_makespan", "deadline"):
            assert torch.equal(getattr(mpc, f), getattr(first, f)), (key, f)
        for f in ("start", "assign", "carbon"):
            assert torch.equal(getattr(mpc.baseline, f),
                               getattr(first.baseline, f)), (key, f)
    base = first.baseline.carbon
    for every in bench.FC_EVERYS:
        realized = cells[(0.0, every)].realized.carbon
        assert bool((realized <= base * (1 + 1e-6)).all()), every
