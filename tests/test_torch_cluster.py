"""Port vs reference: the cluster slice and the architecture registry.

* ``configs``: all ten architectures equal the reference's, in its order;
  the port builds the dense ones without a frontend and refuses the rest.
* ``cluster.energy_model`` and ``cluster.workloads`` are copies: the same
  inputs give equal Python floats and ints, the same seeds the same
  ``Instance`` and packed tensors.
* ``cluster.executor`` is held two ways, as the solvers are: on the
  reference's ``jax.random`` draws, replayed through the executor's
  ``draws`` seam (the plan from ``key(seed)``, each re-solve from the next
  ``split`` along the reference's key chain), integers must be equal,
  ``planned_carbon`` allclose at rtol 1e-6 and the host simulation's
  float64 carbon and energy at rtol 1e-12; on the port's own draws, the
  reference's four executor tests hold.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.cluster import energy_model as jenergy
from repro.cluster import executor as jexecutor
from repro.cluster import workloads as jworkloads
from repro.core import instance as jinstance
from repro.core.carbon import sample_window as jsample_window
from repro.core.carbon import synthesize as jsynthesize
from repro.core.solvers.annealing import SAConfig as JSAConfig
from repro_torch import bench, cluster, configs
from repro_torch.cluster import energy_model, executor, workloads
from repro_torch.core import instance as tinstance
from repro_torch.core.carbon import sample_window, synthesize
from repro_torch.core.validate import assert_feasible_np
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.models.common import SHAPES
from tests.test_torch_solvers import ReplayDraws, bilevel_draws

J_PLAN = JSAConfig(pop=64, iters=60)
J_RESOLVE = JSAConfig(pop=32, iters=40)
RTOL_PLAN = 1e-6        # float32 objective: XLA and torch sum in other orders
RTOL_HOST = 1e-12       # float64 host sums over equal schedules


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The architecture registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jconfigs.ALL_ARCHS)
def test_config_equals_reference(name):
    want, got = jconfigs.ARCHS[name], configs.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())


def test_registry_lists_all_ten_in_reference_order():
    assert len(configs.ALL_ARCHS) == 10
    assert configs.ALL_ARCHS == jconfigs.ALL_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-5")


@pytest.mark.parametrize("name", ["llava-next-34b", "whisper-base",
                                  "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_vlm_encdec_moe_archs_build_and_serve(name):
    """The vision frontend, encdec and moe archs build reduced and serve
    through the launcher, the frontends' positions inside the horizon."""
    model = build_model(configs.get(name).reduced(), device="cpu")
    assert model.cfg.family == configs.get(name).family
    done = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8",
                       "--max-new", "2", "--slots", "2"])
    assert [len(r.out_tokens) for r in done] == [3, 3]
    assert not any(r.truncated for r in done)


@pytest.mark.parametrize("name", ["codeqwen1.5-7b", "deepseek-67b",
                                  "minitron-4b"])
def test_dense_archs_serve(name):
    done = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8",
                       "--max-new", "2", "--slots", "2"])
    assert [len(r.out_tokens) for r in done] == [3, 3]


# ---------------------------------------------------------------------------
# The energy model
# ---------------------------------------------------------------------------

def test_modeled_fleet_equals_reference():
    for f in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "CHIP_POWER_KW"):
        assert getattr(energy_model, f) == getattr(jenergy, f)
    assert [dataclasses.asdict(m) for m in cluster.TPU_V5E_CLASSES] == \
        [dataclasses.asdict(m) for m in jenergy.TPU_V5E_CLASSES]
    for m, jm in zip(cluster.TPU_V5E_CLASSES, jenergy.TPU_V5E_CLASSES):
        assert (m.power_kw, m.throughput) == (jm.power_kw, jm.throughput)


@pytest.mark.parametrize("name", jconfigs.ALL_ARCHS)
def test_energy_model_exact(name):
    cfg, jcfg = configs.get(name), jconfigs.ARCHS[name]
    pairs = list(zip(energy_model.TPU_V5E_CLASSES, jenergy.TPU_V5E_CLASSES))
    for shape in SHAPES:
        assert energy_model.step_flops(cfg, shape) == \
            jenergy.step_flops(jcfg, shape)
        for n in (1, 50, 399, 10_000):
            for m, jm in pairs:
                got = energy_model.task_profile(cfg, shape, n, m)
                want = jenergy.task_profile(jcfg, shape, n, jm)
                assert got == want and type(got[0]) is type(want[0])
            assert energy_model.task_profile(
                cfg, shape, n, pairs[0][0], epoch_hours=1.0) == \
                jenergy.task_profile(jcfg, shape, n, pairs[0][1],
                                     epoch_hours=1.0)
            assert energy_model.baseline_durations(cfg, shape, n) == \
                jenergy.baseline_durations(jcfg, shape, n)


@pytest.mark.parametrize("content,record", [
    ({"status": "ok", "flops": 1.5e15}, 1.5e15),
    ({"status": "ok", "flops": "2e15"}, 2e15),
    ({"status": "failed", "flops": 1.5e15}, None),
    ({"status": "ok"}, None),
    ({"status": "ok", "flops": None}, None),
    ({"status": "ok", "flops": "many"}, None),
    ([1, 2], None),
    ("{not json", None),
    ("", None),
    ("a directory", None),
], ids=["ok", "ok-str", "failed", "no-flops", "null", "bad-str", "list",
        "malformed", "empty", "directory"])
def test_dryrun_lookup_same_in_both(content, record, tmp_path, monkeypatch):
    """A dry-run record under the same path prices a task the same way in
    both packages (its per-chip FLOPs x 256); a missing field, a bad value
    or an unreadable file falls back to 6·N·D in both."""
    monkeypatch.setattr(energy_model, "_DRYRUN_DIR", str(tmp_path))
    monkeypatch.setattr(jenergy, "_DRYRUN_DIR", str(tmp_path))
    name, shape = "minitron-4b", "train_4k"
    cfg, jcfg = configs.get(name), jconfigs.ARCHS[name]
    path = tmp_path / f"{name}__{shape}__pod16x16.json"
    if content == "a directory":
        path.mkdir()
    else:
        path.write_text(content if isinstance(content, str)
                        else json.dumps(content))
    want = (6.0 * cfg.active_param_count() * 256 * 4096 if record is None
            else record * 256)
    assert energy_model.step_flops(cfg, shape) == want
    assert jenergy.step_flops(jcfg, shape) == want
    m, jm = energy_model.TPU_V5E_CLASSES[2], jenergy.TPU_V5E_CLASSES[2]
    assert energy_model.task_profile(cfg, shape, 100, m) == \
        jenergy.task_profile(jcfg, shape, 100, jm)


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

def _assert_instances_equal(ij, it):
    assert [dataclasses.asdict(j) for j in it.jobs] == \
        [dataclasses.asdict(j) for j in ij.jobs]
    assert (it.powers_kw, it.speeds, it.allowed) == \
        (ij.powers_kw, ij.speeds, ij.allowed)
    pj, pt = jinstance.pack(ij), tinstance.pack(it, device="cpu")
    for f in jinstance.PackedInstance._fields:
        want = np.asarray(getattr(pj, f))
        got = getattr(pt, f).numpy()
        assert got.dtype == want.dtype, f
        assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("seed,n_jobs", [(0, 1), (1, 4), (3, 6), (7, 8),
                                         (11, 12), (2024, 20)])
def test_daily_batch_equals_reference(seed, n_jobs):
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    specs_j = jworkloads.sample_daily_batch(rng_j, n_jobs=n_jobs)
    specs_t = workloads.sample_daily_batch(rng_t, n_jobs=n_jobs)
    assert [dataclasses.asdict(s) for s in specs_t] == \
        [dataclasses.asdict(s) for s in specs_j]
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    _assert_instances_equal(
        jworkloads.make_cluster_instance(specs_j, seed=seed + 1),
        workloads.make_cluster_instance(specs_t, seed=seed + 1))


@pytest.mark.parametrize("template", workloads.TEMPLATES)
def test_every_arch_and_template_equals_reference(template):
    """Explicit specs over the whole registry (the daily batch draws only
    the five small archs), at two shapes and arrivals."""
    specs = [(template, name, shape, n, arr)
             for name in jconfigs.ALL_ARCHS
             for shape, n, arr in (("train_4k", 120, 0),
                                   ("prefill_32k", 7, 30))]
    ij = jworkloads.make_cluster_instance(
        [jworkloads.WorkloadSpec(*s) for s in specs], seed=5)
    it = workloads.make_cluster_instance(
        [workloads.WorkloadSpec(*s) for s in specs], seed=5)
    _assert_instances_equal(ij, it)


def test_unknown_template_raises():
    spec = ("pretrain_forever", "minitron-4b", "train_4k", 10)
    with pytest.raises(ValueError, match="unknown template"):
        jworkloads.make_cluster_instance([jworkloads.WorkloadSpec(*spec)])
    with pytest.raises(ValueError, match="unknown template"):
        workloads.make_cluster_instance([workloads.WorkloadSpec(*spec)])


# ---------------------------------------------------------------------------
# The executor on the reference's replayed draws
# ---------------------------------------------------------------------------

class ReferenceKeys:
    """The reference executor's draws, as the port executor's ``draws``
    seam: the plan from ``key(seed)`` (never split), each re-solve from
    ``split(key)[1]`` with the key advancing along ``split(key)[0]``."""

    def __init__(self, seed, T, M):
        self.plan_key = self.key = jax.random.key(seed)
        self.T, self.M = T, M
        self.last = None

    def __call__(self, kind):
        if kind == "plan":
            seq = bilevel_draws(self.plan_key, self.T, self.M, J_PLAN)
        else:
            self.key, k = jax.random.split(self.key)
            seq = bilevel_draws(k, self.T, self.M, J_RESOLVE)
        self.last = ReplayDraws(seq)
        return self.last


def flagship_inputs(seed):
    """The flagship example's day in both packages: packed instances and
    the cumulative carbon window (equal arrays)."""
    rngs = np.random.default_rng(seed), np.random.default_rng(seed)
    ij = jworkloads.make_cluster_instance(
        jworkloads.sample_daily_batch(rngs[0], n_jobs=6), seed=seed)
    it = workloads.make_cluster_instance(
        workloads.sample_daily_batch(rngs[1], n_jobs=6), seed=seed)
    cum_j = jsample_window(jsynthesize("AU-SA", days=30), rngs[0],
                           2000).cumulative()
    cum_t = sample_window(synthesize("AU-SA", days=30), rngs[1],
                          2000).cumulative()
    assert_array_equal(cum_t, cum_j)
    return jinstance.pack(ij), tinstance.pack(it, device="cpu"), cum_j


@pytest.fixture(scope="module")
def replayed():
    """Seed 3 of the flagship scenario: the reference executor (given the
    ``jnp`` window its example gives it) and the port's (given the numpy
    window, widened to float64: it rounds to float32 itself) on the
    reference's draws.  Every test executes on both, so their key chains
    advance in step."""
    seed = 3
    pj, pt, cum = flagship_inputs(seed)
    jex = jexecutor.ClusterExecutor(pj, jnp.asarray(cum), stretch=1.5,
                                    seed=seed)
    keys = ReferenceKeys(seed, pt.T, pt.M)
    tex = executor.ClusterExecutor(pt, cum.astype(np.float64), stretch=1.5,
                                   seed=seed, draws=keys, device="cpu")
    jplan, tplan = jex.plan(), tex.plan()
    assert keys.last.done
    return jex, jplan, tex, tplan, keys


def test_cum_is_rounded_to_float32_then_widened():
    """What the reference's callers do at its boundary (``jnp.asarray``
    under x32), whatever dtype the port is given."""
    _, pt, cum = flagship_inputs(4)
    fine = cum.astype(np.float64) + 1e-5 * np.arange(cum.size)
    want = fine.astype(np.float32).astype(np.float64)
    assert not np.array_equal(fine, want)
    for given in (fine, torch.as_tensor(fine)):
        ex = executor.ClusterExecutor(pt, given, device="cpu")
        assert ex.cum.dtype == np.float64
        assert_array_equal(ex.cum, want)
        assert ex._cum.dtype == torch.float32


def assert_reports_equal(want, got):
    for f in ("planned_makespan", "achieved_makespan", "n_resolves",
              "n_restarts", "n_speculative"):
        assert getattr(got, f) == getattr(want, f), f
    assert_allclose(got.planned_carbon, want.planned_carbon, rtol=RTOL_PLAN)
    for f in ("achieved_carbon", "achieved_energy"):
        assert_allclose(getattr(got, f), getattr(want, f), rtol=RTOL_HOST,
                        err_msg=f)
    assert got.recovery_overhead == want.recovery_overhead


def test_plan_on_replayed_draws(replayed):
    jex, jplan, tex, tplan, _ = replayed
    for f in ("start", "assign"):
        assert tplan[f].dtype == jplan[f].dtype == np.int32
        assert_array_equal(tplan[f], jplan[f], err_msg=f)
    assert tplan["makespan"] == jplan["makespan"]
    assert_allclose(tplan["carbon"], jplan["carbon"], rtol=RTOL_PLAN)
    assert tex.cum.dtype == np.float64
    assert_array_equal(tex.cum, jex.cum)         # float32-rounded, widened
    assert_feasible_np(tex.inst, tplan["start"], tplan["assign"])


def test_clean_run_on_replayed_draws(replayed):
    jex, jplan, tex, tplan, _ = replayed
    want, got = jex.execute(jplan), tex.execute(tplan)
    assert_reports_equal(want, got)
    assert got.achieved_makespan == tplan["makespan"]
    assert got.n_resolves == got.n_restarts == got.n_speculative == 0


def restart_fault(plan, inst):
    """A failure that loses a running task: the longest planned task (the
    earliest of those) fails one epoch before it would finish, so the
    checkpoint rounding throws away progress (``d - 1`` epochs of it,
    rounded down to a multiple of ``ckpt_epochs``)."""
    T = inst.T
    d = inst.dur.numpy()[np.arange(T), plan["assign"]]
    cand = [tk for tk in range(T) if inst.task_mask[tk] and d[tk] >= 2]
    assert cand, "no planned task runs two epochs or more"
    tk = max(cand, key=lambda k: (d[k], -plan["start"][k]))
    return executor.FaultPlan(fail_machine=int(plan["assign"][tk]),
                              fail_epoch=int(plan["start"][tk] + d[tk] - 1))


@pytest.mark.parametrize("when,ckpt", [("quarter", 4), ("third", 4),
                                       ("restart", 4), ("restart", 2)])
def test_machine_failure_on_replayed_draws(replayed, when, ckpt):
    jex, jplan, tex, tplan, keys = replayed
    if ckpt != tex.ckpt_epochs:      # a fresh pair, its own key chains
        keys = ReferenceKeys(3, tex.inst.T, tex.inst.M)
        jex = jexecutor.ClusterExecutor(jex.inst, jnp.asarray(jex.cum,
                                                              jnp.float32),
                                        ckpt_epochs=ckpt, stretch=1.5,
                                        seed=3)
        tex = executor.ClusterExecutor(tex.inst, tex.cum, ckpt_epochs=ckpt,
                                       stretch=1.5, seed=3, draws=keys,
                                       device="cpu")
    if when == "restart":
        fault = restart_fault(tplan, tex.inst)
    else:
        div = {"quarter": 4, "third": 3}[when]
        fault = executor.FaultPlan(fail_machine=2,
                                   fail_epoch=tplan["makespan"] // div)
    jfault = jexecutor.FaultPlan(**dataclasses.asdict(fault))
    want, got = jex.execute(jplan, jfault), tex.execute(tplan, fault)
    assert keys.last.done
    assert_reports_equal(want, got)
    assert got.n_resolves == 1
    if when == "restart":
        assert got.n_restarts >= 1


@pytest.mark.parametrize("factor", [3.0, 4.0])
def test_straggler_on_replayed_draws(replayed, factor):
    jex, jplan, tex, tplan, _ = replayed
    want = jex.execute(jplan, jexecutor.FaultPlan(straggle_task=1,
                                                  straggle_factor=factor))
    got = tex.execute(tplan, executor.FaultPlan(straggle_task=1,
                                                straggle_factor=factor))
    assert_reports_equal(want, got)
    assert got.n_speculative >= 1


# A feasible plan of seed 3's day in which task 1 (one epoch on machine 2,
# from epoch 38) crosses a 3x straggler's threshold while every other
# machine is busy.
BUSY_PLAN = dict(
    start=[34, 38, 39, 38, 55, 56, 56, 58, 41, 42, 42, 52, 30, 34, 38, 30,
           39, 39, 49, 53, 58],
    assign=[2, 2, 3, 1, 2, 2, 3, 2, 3, 1, 0, 1, 1, 0, 0, 0, 2, 4, 0, 2, 0],
    makespan=62, carbon=7146.212890625)


@pytest.mark.parametrize("factor,copies", [(3.0, 0), (4.0, 1)])
def test_straggler_copy_needs_an_idle_machine(replayed, factor, copies):
    """A speculative copy is issued only on an idle live machine, so the
    same straggler gets none on a plan that keeps the fleet busy when it
    crosses its threshold, in both packages."""
    jex, _, tex, _, _ = replayed
    plan = {k: np.asarray(v, np.int32) if isinstance(v, list) else v
            for k, v in BUSY_PLAN.items()}
    assert_feasible_np(tex.inst, plan["start"], plan["assign"])
    want = jex.execute(plan, jexecutor.FaultPlan(straggle_task=1,
                                                 straggle_factor=factor))
    got = tex.execute(plan, executor.FaultPlan(straggle_task=1,
                                               straggle_factor=factor))
    assert_reports_equal(want, got)
    assert got.n_speculative == copies


# ---------------------------------------------------------------------------
# The executor on its own draws: the reference's executor tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planned():
    """The reference test's case: seed 3, 4 jobs, a 1500-epoch window."""
    rng = np.random.default_rng(3)
    inst = workloads.make_cluster_instance(
        workloads.sample_daily_batch(rng, n_jobs=4), seed=1)
    p = tinstance.pack(inst, device="cpu")
    cum = sample_window(synthesize("AU-SA", days=20), rng, 1500).cumulative()
    ex = executor.ClusterExecutor(p, cum, stretch=1.5, device="cpu")
    plan = ex.plan()
    assert_feasible_np(p, plan["start"], plan["assign"])
    return ex, plan


def test_executor_clean_run_matches_plan(planned):
    ex, plan = planned
    rep = ex.execute(plan)
    assert rep.achieved_makespan == plan["makespan"]
    assert rep.achieved_carbon == pytest.approx(plan["carbon"], rel=1e-3)
    assert rep.n_resolves == 0 and rep.n_restarts == 0


def test_executor_machine_failure_recovers(planned):
    ex, plan = planned
    rep = ex.execute(plan, executor.FaultPlan(
        fail_machine=2, fail_epoch=plan["makespan"] // 4))
    assert rep.n_resolves == 1
    assert rep.recovery_overhead < 1.0      # recovers within 2x plan
    assert len(ex.resolve_seconds) >= 1


def test_executor_straggler_speculation(planned):
    ex, plan = planned
    rep = ex.execute(plan, executor.FaultPlan(straggle_task=1,
                                              straggle_factor=4.0))
    assert rep.n_speculative >= 1
    assert rep.achieved_makespan < plan["makespan"] * 3


def test_executor_rejects_infeasible_resolve(planned, monkeypatch):
    """Every elastic re-solve is validated in-line: a solver that hands
    back an infeasible recovery plan is caught, not executed."""
    ex0, plan = planned
    ex = executor.ClusterExecutor(ex0.inst, ex0.cum, stretch=1.5,
                                  device="cpu")
    T = ex.inst.T
    bad = types.SimpleNamespace(optimized=types.SimpleNamespace(
        start=torch.zeros((T,), dtype=torch.int32),
        assign=torch.zeros((T,), dtype=torch.int32)))
    monkeypatch.setattr(executor, "solve_bilevel", lambda *a, **k: bad)
    with pytest.raises(RuntimeError, match="infeasible"):
        ex.execute(plan, executor.FaultPlan(
            fail_machine=2, fail_epoch=plan["makespan"] // 4))


def test_plan_is_repeatable(planned):
    """plan() draws afresh from its seed: twice gives the same plan."""
    ex, plan = planned
    again = ex.plan()
    for f in ("start", "assign"):
        assert_array_equal(again[f], plan[f])
    assert (again["makespan"], again["carbon"]) == \
        (plan["makespan"], plan["carbon"])


def test_bench_cluster_cell_on_cpu(capsys):
    """The bench's cell for one day on the CPU: the example's printout,
    one row a day, the wall's split, and the reference test's invariants
    on the port's own draws."""
    rows = bench.cluster(1, "cpu")
    out = capsys.readouterr().out
    assert "# today's batch:" in out and "# carbon-aware plan (S=1.5)" in out
    assert "speculative cop(y/ies) issued" in out and "stages plan=" in out
    (row,) = rows
    assert (row["bench"], row["seed"], row["T"]) == ("cluster", 3, 21)
    assert row["clean_achieved_makespan"] == row["plan_makespan"]
    assert row["clean_achieved_carbon"] == pytest.approx(
        row["plan_carbon_g"], rel=1e-3)
    assert row["failure_n_resolves"] == 1
    assert row["failure_recovery_overhead"] < 1.0
    assert row["straggler_n_resolves"] == 0
    assert 0 < row["failure_resolve_seconds"] <= row["failure_seconds"]
    assert not any(isinstance(v, (list, dict)) for v in row.values())
