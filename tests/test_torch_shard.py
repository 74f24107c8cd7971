"""The port's shard layer on the CPU: row-keyed draws, then sharded == single.

* ``threefry2x32`` equals JAX's ``threefry_2x32`` word for word;
  ``RowDraws`` gives a row the same draws whatever batch it sits in and
  at whatever position, bitwise, for every draw kind;
* ``solve_bilevel_batch`` on ``RowDraws``: rows solved alone are bitwise
  the same rows solved in a batch (the counterpart of the reference's
  ``test_bilevel_batch_size_independent``);
* every sharded entry (``dispatch_sharded``, ``bilevel_sharded``,
  ``greedy_sharded``, ``train_sharded``, ``eval_theta_sharded``,
  ``sweep_sharded`` and ``sweep_structure(devices=...)``) bitwise equal
  to the port's single-device entry at ``devices=["cpu"] * d``, d = 1-4,
  with B = 3 or 5 so that the padding bites; the dispatch's integers equal
  to the reference's ``sweep_policies``, the evaluation allclose to the
  reference's at ``tests/test_torch_learn.py``'s tolerances; both TINY
  goldens reproduced when sharded.

The reference's own sharded parity tests fail under the installed jax,
so the sharded runs are held to the port's own single-device runs.
Torch runs at one intra-op thread: ATen's vectorised CPU loops may round
a transcendental apart in their scalar tail, and multi-threaded chunks
move that tail (``RowDraws`` lays its draws out so that it never bites).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax._src import prng

from repro.core.instance import stack_packed
from repro.core.solvers import online_jax
from repro.learn import evaluate_theta as jevaluate_theta
from repro.scenarios import FAMILY_NAMES, FLEET_NAMES
from repro_torch import bench, shard
from repro_torch.core.instance import packed_from_numpy
from repro_torch.core.solvers import SAConfig, solve_bilevel_batch
from repro_torch.core.solvers.common import RowDraws, row_seeds, threefry2x32
from repro_torch.core.solvers.online_torch import sweep_policies
from repro_torch.learn import LearnConfig, evaluate_theta, train_gate
from repro_torch.learn.train import greedy_reference
from repro_torch.scenarios import sweep_structure
from repro_torch.shard import batch as sbatch
from repro_torch.shard import distributed
from tests.strategies import scenario_case
from tests.test_structure_golden import GOLDEN_PATH, _assert_row_matches

SHARDS = (1, 2, 3, 4)
HORIZON = 400
PAD_T, PAD_M = 24, 5
THETAS, WINDOWS, STRETCHES = (0.3, 0.6), (48,), (1.5,)
SA_TINY = SAConfig(pop=8, iters=10, sweeps=1)
LEARN_GOLDEN = dict(loss_curve=(1e-3, 2e-4), final_theta=(1e-3, 2e-3),
                    learned_savings_pct=(1e-4, 2e-3))   # test_torch_learn's
KINDS = ("bits", "uniform", "bernoulli", "randint", "normal", "gumbel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(d, kind, shape):
    if kind == "bernoulli":
        return d.bernoulli(0.3, shape)
    if kind == "randint":
        return d.randint(2, 19, shape)
    return getattr(d, kind)(shape)


def _same_bits(x, y):
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def _leaves(tree):
    out = []
    sbatch.tree_map(lambda x: out.append(x), tree)
    return out


def _assert_tree_bits(a, b, ctx):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), ctx
    for i, (x, y) in enumerate(zip(la, lb)):
        assert _same_bits(x, y), f"{ctx} [leaf {i}]"


def _cases(n, seed0=0):
    """``n`` scenario cases over every family and fleet: the reference's
    stacked batch, the port's copy, intensities and cumulative traces."""
    cases = [scenario_case(seed0 + s, FAMILY_NAMES[s % 5], FLEET_NAMES[s % 3],
                           n_jobs=3, horizon=HORIZON, pad_tasks=PAD_T,
                           pad_machines=PAD_M) for s in range(n)]
    jb = stack_packed([p for p, _ in cases])
    tb = packed_from_numpy({f: np.asarray(getattr(jb, f))
                            for f in jb._fields}, device="cpu")
    inten = np.stack([w.intensity for _, w in cases]).astype(np.float32)
    cum = np.stack([w.cumulative() for _, w in cases]).astype(np.float32)
    return jb, tb, torch.as_tensor(inten), torch.as_tensor(cum)


# ---------------------------------------------------------------------------
# Row-keyed draws
# ---------------------------------------------------------------------------

def test_threefry_matches_jax():
    zero = threefry2x32(0, 0, torch.zeros(1, dtype=torch.int64),
                        torch.zeros(1, dtype=torch.int64))
    assert [int(w) for w in zero] == [0x6B200159, 0x99BA4EFE]
    rng = np.random.default_rng(0)
    for _ in range(3):
        k = rng.integers(0, 2**32, 2, dtype=np.uint64)
        c = rng.integers(0, 2**32, (2, 64), dtype=np.uint64)
        want = np.asarray(prng.threefry_2x32(
            jnp.asarray(k.astype(np.uint32)),
            jnp.asarray(c.astype(np.uint32).reshape(-1)))).astype(np.int64)
        got = threefry2x32(torch.tensor(int(k[0])), torch.tensor(int(k[1])),
                           torch.as_tensor(c[0].astype(np.int64)),
                           torch.as_tensor(c[1].astype(np.int64)))
        np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_row_draws_independent_of_batch(kind):
    """A row's draws depend on its seed and the call only: rows 2:5 drawn
    alone, or at other positions of another batch, give the same bits,
    call after call, at shapes whose row sizes are not aligned."""
    seeds = row_seeds(5, 7)
    shapes = [(7, 23, 13), (7, 3), (7, 5, 3, 4), (7, 1)]
    full = RowDraws(seeds, "cpu")
    part = RowDraws(seeds[2:5], "cpu")
    moved = RowDraws(np.concatenate([seeds[4:1:-1], row_seeds(9, 2)]), "cpu")
    for shape in shapes:
        f = _draw(full, kind, shape)
        p = _draw(part, kind, (3,) + shape[1:])
        m = _draw(moved, kind, (5,) + shape[1:])
        assert _same_bits(f[2:5], p), (kind, shape)
        assert _same_bits(f[2:5], m[:3].flip(0)), (kind, shape)
    assert full.calls == part.calls == len(shapes)


def test_row_draws_values():
    """Uniforms are multiples of 2**-24 in [0, 1); integers cover
    [low, high); Bernoulli masks hit about p; normals and Gumbels have
    their means and spreads; seeds give distinct rows."""
    d = RowDraws(row_seeds(1, 8), "cpu")
    u = d.uniform((8, 5000))
    assert u.dtype == torch.float32
    assert bool((u >= 0).all() and (u < 1).all())
    assert torch.equal(u * 2**24, torch.floor(u * 2**24))
    r = d.randint(3, 10, (8, 5000))
    assert r.dtype == torch.int64 and int(r.min()) == 3 and int(r.max()) == 9
    assert abs(float(d.bernoulli(0.25, (8, 5000)).float().mean()) - 0.25) \
        < 0.02
    z = d.normal((8, 5000)).double()
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1) < 0.03
    g = d.gumbel((8, 5000)).double()
    assert bool(torch.isfinite(g).all())
    assert abs(float(g.mean()) - 0.5772) < 0.05
    assert abs(float(g.std()) - 1.2825) < 0.05
    b = d.bits((8, 64))
    assert len({tuple(row.tolist()) for row in b}) == 8
    assert bool((b >= 0).all() and (b < 2**32).all())
    s = row_seeds(2024, 6)
    assert s.dtype == np.uint64 and len(set(s.tolist())) == 6
    np.testing.assert_array_equal(s, row_seeds(2024, 6))
    np.testing.assert_array_equal(s[:4], row_seeds(2024, 4))


def test_row_draws_want_the_row_axis():
    d = RowDraws(row_seeds(0, 4), "cpu")
    with pytest.raises(ValueError, match="leading axis"):
        d.normal((3, 5))
    with pytest.raises(ValueError, match="leading axis"):
        d.uniform(())


def test_bilevel_batch_size_independent():
    """Paper-style instances (4 jobs x 3 tasks, 3 machines, 300-epoch
    AU-SA windows, S = 1.5, SA 30 iterations): rows solved alone, at
    another batch size and an odd population, equal the batch's rows."""
    batch, cum = bench.paper_batch(bench.BenchSetup(
        n_jobs=4, k_tasks=3, n_machines=3, instances=6), "cpu")
    cum = cum[:, :301].contiguous()
    seeds = row_seeds(11, 6)
    for pop in (24, 23):
        cfg = SAConfig(pop=pop, iters=30, sweeps=2)
        kw = dict(objective="carbon", stretch=1.5, cfg1=cfg, cfg2=cfg)
        full = solve_bilevel_batch(batch, cum, RowDraws(seeds, "cpu"), **kw)
        for lo, hi in ((1, 3), (0, 1), (5, 6)):
            part = solve_bilevel_batch(
                type(batch)(*(f[lo:hi] for f in batch)), cum[lo:hi],
                RowDraws(seeds[lo:hi], "cpu"), **kw)
            _assert_tree_bits(sbatch.tree_map(lambda x: x[lo:hi], full),
                              part, f"pop {pop} rows {lo}:{hi}")


# ---------------------------------------------------------------------------
# The shard devices and the row runner
# ---------------------------------------------------------------------------

def test_instance_devices():
    assert sbatch.instance_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="empty"):
        sbatch.instance_devices([])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for devices in (None, 1, 2):
        with pytest.raises(RuntimeError, match="cuda"):
            sbatch.instance_devices(devices)
    with pytest.raises(RuntimeError, match="cuda"):
        sbatch.local_devices(None, 1)
    assert sbatch.local_devices(["cpu"], 1) == [torch.device("cpu")]
    assert shard.device_count() == 0


def test_round_up_and_blocks():
    assert [shard.round_up(b, 4) for b in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert sbatch.shard_blocks(5, 3, None) == (6, [0, 2, 4], 2)
    with pytest.raises(ValueError, match="fleet of 1"):
        sbatch.shard_blocks(5, 3, 2)


@pytest.mark.parametrize("d", SHARDS)
def test_run_rows_sharded_pads_and_slices(d):
    """Row blocks on their devices, outputs in row order: a tensor, a
    numpy array and a nested NamedTuple come back as one call gives."""
    _, tb, inten, _ = _cases(3)
    arr = np.arange(3, dtype=np.uint64) * 7
    seen = []

    def fn(b, x, a):
        seen.append(int(x.shape[0]))
        assert isinstance(a, np.ndarray)
        return (x * 2, {"t": torch.as_tensor(a.astype(np.int64))}["t"],
                b.task_mask.sum(-1))

    out = shard.run_rows_sharded(fn, (tb, inten, arr),
                                 devices=["cpu"] * d)
    want = (inten * 2, torch.as_tensor(arr.astype(np.int64)),
            tb.task_mask.sum(-1))
    _assert_tree_bits(out, want, f"d={d}")
    assert seen == [-(-3 // d)] * d
    with pytest.raises(ValueError, match="no arguments"):
        shard.run_rows_sharded(fn, (), devices=["cpu"])


def test_process_contract_in_one_process(monkeypatch):
    for var in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert not shard.is_initialized()
    assert shard.initialize_from_env() is False
    assert (shard.process_count(), shard.process_index()) == (1, 0)
    with pytest.raises(ValueError, match="coordinator"):
        shard.initialize(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="REPRO_PROCESS_ID"):
        shard.initialize(coordinator="127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match="fleet of 1"):
        shard.dispatch_sharded(*_cases(1)[1:3], THETAS, WINDOWS, STRETCHES,
                               devices=["cpu"], processes=2)


# ---------------------------------------------------------------------------
# Sharded entries == the port's single-device entries
# ---------------------------------------------------------------------------

def test_dispatch_sharded_parity():
    B = 5
    jb, tb, inten, _ = _cases(B)
    ref = sweep_policies(tb, inten, THETAS, WINDOWS, STRETCHES, device="cpu")
    want = online_jax.sweep_policies(jb, jnp.asarray(inten.numpy()), THETAS,
                                     WINDOWS, STRETCHES)
    for name in ("start", "assign", "scheduled"):
        np.testing.assert_array_equal(getattr(ref.gated, name).numpy(),
                                      np.asarray(getattr(want.gated, name)))
        np.testing.assert_array_equal(getattr(ref.greedy, name).numpy(),
                                      np.asarray(getattr(want.greedy, name)))
    np.testing.assert_array_equal(ref.budget.numpy(), np.asarray(want.budget))
    for d in SHARDS:
        got = shard.dispatch_sharded(tb, inten, THETAS, WINDOWS, STRETCHES,
                                     devices=["cpu"] * d)
        _assert_tree_bits(got, ref, f"B={B} d={d}")


def test_bilevel_sharded_parity():
    _, tb, _, cum = _cases(5)
    seeds = row_seeds(3, 5)
    kw = dict(objective="carbon", stretch=1.5, cfg1=SA_TINY, cfg2=SA_TINY)
    ref = solve_bilevel_batch(tb, cum, RowDraws(seeds, "cpu"), **kw)
    for d in SHARDS:
        got = shard.bilevel_sharded(tb, cum, seeds, devices=["cpu"] * d,
                                    **kw)
        _assert_tree_bits(got, ref, f"d={d}")


def test_greedy_and_eval_theta_sharded_parity():
    """Per-instance thetas; ``test_train_sharded_parity`` runs per-epoch
    ones through the same hard dispatch."""
    jb, tb, inten, cum = _cases(5, seed0=7)
    B, E = inten.shape
    theta = np.random.default_rng(3).random(B).astype(np.float32)
    window = np.array([24, 48, 96, 48, 24], np.int32)
    g_ref = greedy_reference(tb, cum, E)
    ref = evaluate_theta(tb, inten, cum, theta, window, 1.5, device="cpu")
    jref = jevaluate_theta(jb, inten.numpy(), cum.numpy(),
                           jnp.asarray(theta), window, 1.5)
    np.testing.assert_array_equal(ref[3].numpy(), np.asarray(jref[3]))
    np.testing.assert_allclose(1 - ref[0].numpy(), 1 - np.asarray(jref[0]),
                               rtol=1e-6)
    for d in SHARDS:
        devs = ["cpu"] * d
        _assert_tree_bits(shard.greedy_sharded(tb, cum, E, devices=devs),
                          g_ref, f"greedy d={d}")
        got = shard.eval_theta_sharded(tb, inten, cum, theta, window, 1.5,
                                       devices=devs)
        _assert_tree_bits(got, ref, f"eval d={d}")


def test_train_sharded_parity():
    """B = 5 rows in 3 groups with per-epoch features, from no baseline
    (the sharded greedy computes it) and from a given one."""
    _, tb, inten, cum = _cases(5, seed0=20)
    group = np.array([0, 1, 2, 1, 0])
    window = np.array([48, 24, 48, 96, 48], np.int32)
    feats = torch.linspace(-1, 1, inten.shape[1]).expand_as(inten)
    cfg = LearnConfig(steps=3)
    args = (tb, inten, cum, group, window, 1.5, [0.5, 0.3, 0.7], cfg, feats)
    ref = train_gate(*args, device="cpu")
    base = greedy_reference(tb, cum, inten.shape[1])
    for d in SHARDS:
        got = shard.train_sharded(*args, devices=["cpu"] * d)
        _assert_tree_bits(tuple(got[:5]), tuple(ref[:5]), f"d={d}")
        assert len(got.step_seconds) == cfg.steps
    got = shard.train_sharded(*args, baseline=base, devices=["cpu"] * 2)
    _assert_tree_bits(tuple(got[:5]), tuple(ref[:5]), "given baseline")


def test_learn_tiny_golden_sharded():
    """The golden tiny run (4 instances, 40 steps) through
    ``train_sharded`` and ``eval_theta_sharded`` at 3 shards (padded to
    6 rows): the golden at its tolerances (``test_train_sharded_parity``
    holds the sharded learner bitwise to the single-device one)."""
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "learn_tiny.json")) as f:
        golden = json.load(f)["learn_tiny"]
    k = bench.LEARN_TINY
    batch, intens, cums, group, window = bench.learn_tiny_inputs("cpu")
    theta0 = np.full(len(k["families"]), k["theta0"], np.float32)
    cfg = LearnConfig(steps=k["steps"])
    res = shard.train_sharded(batch, intens, cums, group, window,
                              k["stretch"], theta0, cfg, devices=["cpu"] * 3)
    sav = shard.eval_theta_sharded(
        batch, intens, cums, res.theta[torch.as_tensor(group)], window,
        k["stretch"], devices=["cpu"] * 3)[0].numpy()
    got = {"loss_curve": [round(float(v), 6) for v in res.loss_curve],
           "final_theta": [round(float(v), 6) for v in res.theta],
           "learned_savings_pct": [
               round(100 * float(sav[group == gi].mean()), 3)
               for gi in range(len(k["families"]))]}
    for key, (rtol, atol) in LEARN_GOLDEN.items():
        np.testing.assert_allclose(got[key], golden[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def test_structure_tiny_golden_sharded():
    """The dispatch-only TINY grid (40 rows) at 3 shards pads to 42: rows
    equal to the single-device sweep's and to the golden; with the
    learner and its evaluation sharded too (2 steps), equal again."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)["structure_tiny"]
    spec = bench.structure_spec(tiny=True)
    single, _ = sweep_structure(spec, offline=False, device="cpu")
    rows, meta = sweep_structure(spec, offline=False, devices=["cpu"] * 3)
    assert rows == single
    assert (meta["devices"], meta["processes"]) == (3, 1)
    assert meta["pad_tasks"] == golden["pad_tasks"]
    for got, want in zip(rows, golden["cells"]):
        _assert_row_matches(got, want, f"cell[{want['family']}-m"
                            f"{want['n_machines']}-{want['fleet']}]")
    learn = LearnConfig(steps=2)
    a, _ = sweep_structure(spec, offline=False, learn=learn, device="cpu")
    b, _ = shard.sweep_sharded(spec, offline=False, learn=learn,
                               devices=["cpu"] * 2)
    assert a == b


def test_offline_sweep_sharded_parity():
    """The offline bound on row-keyed draws: two cells x 2 instances at
    1-4 shards equal the single-device sweep's rows."""
    spec = bench.structure_spec(tiny=True)
    spec = type(spec)(cells=spec.cells[:2], instances_per_cell=2,
                      horizon=spec.horizon, sa=spec.sa._replace(iters=6))
    single, meta = sweep_structure(spec, offline=True, device="cpu")
    assert meta["devices"] == meta["processes"] == 1
    for d in SHARDS:
        rows, _ = sweep_structure(spec, offline=True, devices=["cpu"] * d)
        assert rows == single, d


@pytest.fixture(scope="module")
def learned_tiny():
    """The learned_gate cell on the TINY grid at 2 steps, unsharded."""
    return bench.run_learned_gate(bench.structure_spec(tiny=True), steps=2,
                                  device="cpu")


def test_learned_gate_cell_sharded(learned_tiny):
    """``run_learned_gate(devices=...)`` shards the learner: the same
    cells and summary as the unsharded cell, stamped with 2 devices."""
    rec = bench.run_learned_gate(bench.structure_spec(tiny=True), steps=2,
                                 device="cpu", devices=["cpu"] * 2)
    assert rec["cells"] == learned_tiny["cells"]
    assert rec["summary_by_family"] == learned_tiny["summary_by_family"]
    assert (rec["devices"], rec["processes"]) == (2, 1)
    assert learned_tiny["devices"] == 1


def test_bench_learned_gate_sharded(learned_tiny, monkeypatch, tmp_path):
    """``--only learned_gate --device cpu --devices 2`` reaches the
    sharded learner (the cell cut to the TINY grid at 2 steps): its CSV
    says 2 devices and holds the unsharded cell's learned fields."""
    run = bench.run_learned_gate
    monkeypatch.setattr(bench, "run_learned_gate", lambda spec, **kw: run(
        bench.structure_spec(tiny=True), steps=2, **kw))
    monkeypatch.setattr(bench, "OUT_DIR", str(tmp_path))
    assert bench.main(["--only", "learned_gate", "--device", "cpu",
                       "--devices", "2"]) == 0
    with open(tmp_path / f"{bench.CELLS['learned_gate'][1]}.csv") as f:
        keys, *lines = [line.rstrip("\n").split(",") for line in f]
    rows = [dict(zip(keys, line)) for line in lines]
    assert len(rows) == len(learned_tiny["cells"])
    for row, cell in zip(rows, learned_tiny["cells"]):
        assert (row["devices"], row["processes"]) == ("2", "1")
        for sx, got in cell["learned"].items():
            for k in ("theta", "savings_pct", "improved"):
                assert row[f"learned_S{sx}_{k}"] == str(got[k]), (sx, k)


def test_bench_shard_devices():
    assert bench.shard_devices("cpu", None, None) is None
    assert bench.shard_devices("cpu", 3, None) == [torch.device("cpu")] * 3
    assert bench.shard_devices("cpu", None, 2) == [torch.device("cpu")]
    assert bench.shard_devices("cuda", 2, None) == 2
    assert bench.shard_devices("cuda", None, 2) is None
    with pytest.raises(SystemExit):
        bench.main(["--only", "fig5", "--devices", "2", "--device", "cpu"])
