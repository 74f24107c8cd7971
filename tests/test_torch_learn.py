"""Port vs reference: the gate-policy learner on the CPU.

``repro_torch.learn`` (relaxation, loss, Adam loop) and the soft
objectives it needs are held to ``repro.learn`` and
``repro.core.objectives`` on the same numpy-seeded inputs, and to
``tests/golden/learn_tiny.json``:

* ``interp`` bitwise equal to ``jnp.interp``, values and gradients;
* ``soft_carbon`` / ``soft_makespan`` at rtol 1e-6, their start
  gradients too (a start exactly at 0.0 pins ``jnp.clip``'s half gradient
  at a tie), and equal to ``carbon`` / ``makespan`` at integer starts;
* ``soft_dispatch``'s hard schedule bitwise equal to
  ``online_carbon_gated_torch`` and with the integers of
  ``online_carbon_gated_jax``; ``soft.dirty > 0.5`` equal to the hard
  mask;
* each row's gradient against ``jax.vmap(jax.grad(per_row_loss))`` at
  rtol 1e-4, atol 1e-6 x max |grad| (sigmoid, the std, reductions and
  scatter-adds reassociate);
* the tiny training run at the golden's own tolerances, and equal to
  itself; the hard evaluation with equal makespans and its carbon and
  carbon ratio (1 - savings) at rtol 1e-6; ``sweep_structure(learn=...)``
  on the TINY grid against the reference's.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import objectives as jobj
from repro.core.instance import stack_packed
from repro.core.solvers import online_jax
from repro.learn import LearnConfig as JLearnConfig
from repro.learn import evaluate_theta as jevaluate_theta
from repro.learn import expected_wait as jexpected_wait
from repro.learn import train as jtrain
from repro.scenarios import FAMILY_NAMES
from repro.scenarios import learned_summary as jlearned_summary
from repro.scenarios import sweep_structure as jsweep_structure
from repro_torch import bench, obs
from repro_torch.core import objectives as tobj
from repro_torch.core.instance import packed_from_numpy
from repro_torch.core.solvers import online_torch
from repro_torch.forecast.rolling import theta_band_features
from repro_torch.learn import (LearnConfig, evaluate_theta, expected_wait,
                               gate_loss, soft_dispatch, train_gate)
from repro_torch.learn import train as ttrain
from repro_torch.core.solvers.online_torch import stretch_budget
from repro_torch.scenarios import learned_summary, sweep_structure
from tests.strategies import scenario_case

HORIZON = 400
PAD_T, PAD_M = 36, 4
FLEETS = ("homog", "tiered", "mixed")
GRAD_RTOL = 1e-4
GOLDEN = dict(loss_curve=(1e-3, 2e-4), final_theta=(1e-3, 2e-3),
              learned_savings_pct=(1e-4, 2e-3))      # (rtol, atol)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(p):
    return packed_from_numpy({f: np.asarray(getattr(p, f)) for f in p._fields},
                             device="cpu")


def _batch(seed0, fleets=FLEETS):
    """One instance of every family, fleets in turn: the reference's
    stacked batch, its port copy, intensities and cumulative traces."""
    cases = [scenario_case(seed0 + i, fam, fleets[i % len(fleets)],
                           n_jobs=3, horizon=HORIZON, pad_tasks=PAD_T,
                           pad_machines=PAD_M)
             for i, fam in enumerate(FAMILY_NAMES)]
    jb = stack_packed([p for p, _ in cases])
    inten = np.stack([w.intensity for _, w in cases]).astype(np.float32)
    cum = np.stack([w.cumulative() for _, w in cases]).astype(np.float32)
    return jb, to_port(jb), inten, cum


# ---------------------------------------------------------------------------
# interp and the soft objectives
# ---------------------------------------------------------------------------

def test_interp_matches_jnp_interp_bitwise():
    """Values and gradients in x bitwise at knots, between them, at both
    ends and outside.  The gradient in fp sums several contributions into
    one knot, which a scatter-add accumulates in its own order: rtol 1e-6
    (atol 1e-6 x its largest magnitude)."""
    rng = np.random.default_rng(0)
    fp = rng.random((3, 9)).astype(np.float32) * 100
    x = np.array([-2.0, 0.0, 0.25, 1.0, 3.0, 4.5, 7.999, 8.0, 8.5, 12.0],
                 np.float32)
    xs = np.stack([x, x[::-1], np.roll(x, 3)])
    w = rng.standard_normal(xs.shape).astype(np.float32)   # cotangents
    xp = np.arange(9, dtype=np.float32)

    def jloss(xv, f):
        y = jax.vmap(lambda a, b: jnp.interp(a, jnp.asarray(xp), b))(xv, f)
        return jnp.sum(y * w), y

    (_, jy), (jgx, jgf) = (
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(xs), jnp.asarray(fp)))
    tx = torch.tensor(xs, requires_grad=True)
    tf = torch.tensor(fp, requires_grad=True)
    ty = tobj.interp(tx, torch.tensor(xp), tf)
    (ty * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgx))
    jgf = np.asarray(jgf)
    np.testing.assert_allclose(tf.grad.numpy(), jgf, rtol=1e-6,
                               atol=1e-6 * np.abs(jgf).max())


def test_interp_gradient_at_a_knot_is_the_right_segment():
    fp = torch.tensor([[0.0, 1.0, 3.0, 7.0, 8.0]])
    x = torch.tensor([[2.0]], requires_grad=True)
    tobj.interp(x, torch.arange(5.0), fp).sum().backward()
    assert float(x.grad) == 4.0                 # fp[3] - fp[2]


def test_soft_objectives_match_reference():
    """Fractional starts (some exactly 0.0, one past the trace's end):
    values at rtol 1e-6 and start gradients; at integer starts the soft
    terms equal carbon and makespan."""
    jb, tb, _, cum = _batch(3)
    rng = np.random.default_rng(1)
    B, T = np.asarray(jb.task_mask).shape
    assign = np.zeros((B, T), np.int32)
    for b in range(B):
        for t in range(T):
            ok = np.flatnonzero(np.asarray(jb.allowed)[b, t])
            assign[b, t] = ok[rng.integers(len(ok))] if ok.size else 0
    start = (rng.random((B, T)) * 300).astype(np.float32)
    start[:, :3] = 0.0
    start[0, 3] = HORIZON + 5.0
    for b in range(B):
        jp = jax.tree.map(lambda x: x[b], jb)

        def jc(s):
            return jobj.soft_carbon(jp, s, jnp.asarray(assign[b]),
                                    jnp.asarray(cum[b]))
        want, jgrad = jax.value_and_grad(jc)(jnp.asarray(start[b]))
        ts = torch.tensor(start[b], requires_grad=True)
        tp = type(tb)(*(f[b] for f in tb))
        got = tobj.soft_carbon(tp, ts, torch.tensor(assign[b]),
                               torch.tensor(cum[b]))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-6, atol=1e-6 * float(
                                       np.abs(np.asarray(jgrad)).max()))
        ms = jobj.soft_makespan(jp, jnp.asarray(start[b]),
                                jnp.asarray(assign[b]))
        assert float(tobj.soft_makespan(tp, torch.tensor(start[b]),
                                        torch.tensor(assign[b]))) == float(ms)
    # integer starts: the soft terms are the hard ones
    si = torch.tensor(np.floor(start).astype(np.int32))
    at = torch.tensor(assign)
    np.testing.assert_allclose(
        tobj.soft_carbon(tb, si.float(), at, torch.tensor(cum)).numpy(),
        tobj.carbon(tb, si, at, torch.tensor(cum)).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(
        tobj.soft_makespan(tb, si.float(), at).numpy(),
        tobj.makespan(tb, si, at).numpy().astype(np.float32))


def test_clip_splits_the_gradient_at_a_tie():
    """jnp.clip's rule (lax.max then lax.min): half the gradient at a
    bound, where torch.clamp would pass all of it."""
    x = torch.tensor([0.0, 0.5, 1.0, 2.0], requires_grad=True)
    tobj.clip(x, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.array([0.0, 0.5, 1.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.5, 1.0, 0.5, 0.0]


def test_expected_wait_counts_dirty_runs_on_hard_masks():
    rng = np.random.default_rng(0)
    dirty = (rng.random((3, 64)) < 0.5).astype(np.float32)
    got = expected_wait(torch.tensor(dirty)).numpy()
    for b in range(3):
        ref = np.zeros(64)
        for e in range(64):
            run = 0
            while e + run < 64 and dirty[b, e + run] > 0.5:
                run += 1
            ref[e] = run
        np.testing.assert_array_equal(got[b], ref)
        np.testing.assert_allclose(
            got[b], np.asarray(jexpected_wait(jnp.asarray(dirty[b]))),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# soft_dispatch: the hard schedule is the gated dispatcher's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed0,fleets", [(0, ("homog",)),
                                          (10, ("tiered",)),
                                          (20, ("mixed", "tiered"))])
def test_soft_dispatch_hard_fields_match(seed0, fleets):
    jb, tb, inten, _ = _batch(seed0, fleets)
    kw = dict(theta=0.4, window=48, stretch=1.5)
    sd = soft_dispatch(tb, torch.tensor(inten), kw["theta"], kw["window"],
                       kw["stretch"], max_window=48, temp=1e-6)
    hard = online_torch.online_carbon_gated_torch(tb, inten, device="cpu",
                                                  **kw)
    for a, b in zip(sd.hard, hard):
        assert torch.equal(a, b)
    greedy = online_torch.online_greedy_torch(tb, inten.shape[-1],
                                              device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(sd.greedy, greedy))
    mask = online_torch.dirty_mask(torch.tensor(inten), 0.4, 48, 48)
    assert torch.equal(sd.dirty > 0.5, mask)
    for b in range(len(FAMILY_NAMES)):
        jp = jax.tree.map(lambda x: x[b], jb)
        jh = online_jax.online_carbon_gated_jax(jp, inten[b], **kw)
        np.testing.assert_array_equal(sd.hard.start[b].numpy(),
                                      np.asarray(jh.start))
        np.testing.assert_array_equal(sd.hard.assign[b].numpy(),
                                      np.asarray(jh.assign))
        np.testing.assert_array_equal(sd.hard.scheduled[b].numpy(),
                                      np.asarray(jh.scheduled))


def test_gate_loss_relaxes_the_soft_dispatch():
    """gate_loss at soft_dispatch's own budget sees its hard schedule and
    its soft starts, value for value, and its straight-through carbon is
    the hard schedule's exact carbon."""
    _, tb, inten, cum = _batch(40)
    theta = torch.full(inten.shape, 0.35)
    sd = soft_dispatch(tb, torch.tensor(inten), theta, 48, 1.5,
                       max_window=48, temp=0.1)
    terms = gate_loss(tb, torch.tensor(cum), torch.tensor(inten), theta, 48,
                      48, sd.budget, torch.tensor(0.1), HORIZON)
    assert torch.equal(terms.soft_start, sd.start)
    np.testing.assert_array_equal(
        terms.carbon.numpy(),
        tobj.soft_carbon(tb, sd.hard.start.to(torch.float32), sd.hard.assign,
                         torch.tensor(cum)).numpy())


# ---------------------------------------------------------------------------
# per-row gradients against jax.vmap(jax.grad(per_row_loss))
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_row_grads(straight_through: bool, n_epochs: int):
    per_row = functools.partial(
        jtrain.per_row_loss,
        cfg=JLearnConfig(straight_through=straight_through),
        n_epochs=n_epochs)
    return jax.jit(jax.vmap(jax.grad(per_row, has_aux=True),
                            in_axes=(None, None) + (0,) * 10 + (None,)))


def _grad_case(seed0, raw, temp, straight_through, use_feats):
    jb, tb, inten, cum = _batch(seed0)
    B = inten.shape[0]
    gid = np.arange(B) % raw.shape[0]
    window = np.full(B, 48, np.int32)
    feats = (np.stack([theta_band_features(torch.tensor(i), 1.0, 48).numpy()
                       for i in inten]) if use_feats
             else np.zeros_like(inten))
    ms0, bc = ttrain.greedy_reference(tb, torch.tensor(cum), HORIZON)
    bud = stretch_budget(1.5, ms0)
    mn = torch.clamp_min(ms0.to(torch.float32), 1.0)
    bcc = torch.clamp_min(bc, 1e-6)
    inv_b = torch.tensor(1.0) / torch.tensor(float(B))
    tt = torch.tensor(temp, dtype=torch.float32)
    cfg = LearnConfig(straight_through=straight_through)

    def loss_fn(rows):
        return ttrain.per_row_loss(rows, tt, tb, torch.tensor(cum),
                                   torch.tensor(inten), torch.tensor(window),
                                   48, torch.tensor(feats), bud, bcc, mn,
                                   inv_b, cfg, HORIZON)
    g, (c, p) = ttrain.per_row_grads(torch.tensor(raw), torch.tensor(gid),
                                     loss_fn)
    sv, n = jax.vmap(lambda i, w: online_jax.sorted_windows(i, w, 48))(
        jnp.asarray(inten), jnp.asarray(window))
    jg, (jc, jp) = _jax_row_grads(straight_through, HORIZON)(
        jnp.asarray(raw), jnp.float32(temp), jb, jnp.asarray(cum),
        jnp.asarray(inten), sv, n, jnp.asarray(gid), jnp.asarray(feats),
        jnp.asarray(bud.numpy()), jnp.asarray(bcc.numpy()),
        jnp.asarray(mn.numpy()), jnp.float32(1.0) / jnp.float32(B))
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=GRAD_RTOL,
                               atol=1e-6 * np.abs(jg).max())
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    return tb, inten, cum, tt, bud


@pytest.mark.parametrize("use_feats", [False, True], ids=["scalar", "feats"])
@pytest.mark.parametrize("straight_through", [True, False],
                         ids=["st", "soft"])
def test_per_row_grads_match_reference(use_feats, straight_through):
    raw = np.array([[0.2, 0.7], [-0.5, -0.4]], np.float32)
    _grad_case(0, raw, 0.3, straight_through, use_feats)


def test_per_row_grads_with_a_start_at_zero():
    """At the final temperature and theta 0.95 two tasks of the tpch row
    start exactly at 0.0 (arrival 0, no predecessor, the gate's first
    sigmoid underflows to 0): the clip in soft_carbon meets its bound."""
    raw = np.array([[float(np.log(0.95 / 0.05)), 0.0]], np.float32)
    tb, inten, cum, tt, bud = _grad_case(30, raw, 0.02, True, False)
    starts = gate_loss(tb, torch.tensor(cum), torch.tensor(inten),
                       torch.full(inten.shape, 0.95), 48, 48, bud, tt,
                       HORIZON).soft_start
    assert bool(((starts == 0.0) & tb.task_mask).any())


# ---------------------------------------------------------------------------
# training, evaluation and the sweep
# ---------------------------------------------------------------------------

def test_train_gate_matches_golden_and_repeats():
    import json
    import os
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "learn_tiny.json")) as f:
        golden = json.load(f)["learn_tiny"]
    first = bench.run_learn_tiny("cpu")
    assert first["families"] == golden["families"]
    for key, (rtol, atol) in GOLDEN.items():
        np.testing.assert_allclose(first[key], golden[key], rtol=rtol,
                                   atol=atol, err_msg=key)
    second = bench.run_learn_tiny("cpu")
    for key in GOLDEN:
        assert second[key] == first[key], key


def test_train_gate_traced_unchanged():
    """``learn.train`` and ``learn.hard_eval`` spans under a tracer, with
    the same values as untraced."""
    jb, tb, inten, cum = _batch(5)
    group = np.arange(inten.shape[0]) % 2
    window = np.full(inten.shape[0], 48, np.int32)
    args = (tb, inten, cum, group, window, 1.5, np.array([0.5, 0.3]),
            LearnConfig(steps=2))
    off = train_gate(*args, device="cpu")
    tr = obs.Tracer()
    obs.set_tracer(tr)
    try:
        on = train_gate(*args, device="cpu")
        evaluate_theta(tb, inten, cum, on.theta[group], window, 1.5,
                       device="cpu")
    finally:
        obs.set_tracer(None)
    assert [e["name"] for e in tr.events] == ["xla:learn.train",
                                              "xla:learn.hard_eval"]
    assert torch.equal(on.raw, off.raw)
    assert torch.equal(on.loss_curve, off.loss_curve)
    assert len(on.step_seconds) == 2


@pytest.mark.parametrize("per_epoch", [False, True])
def test_evaluate_theta_matches_reference(per_epoch):
    jb, tb, inten, cum = _batch(7)
    B, E = inten.shape
    rng = np.random.default_rng(3)
    theta = (rng.random((B, E)) if per_epoch else rng.random(B)) \
        .astype(np.float32)
    window = np.array([24, 48, 96, 48, 24], np.int32)
    got = evaluate_theta(tb, inten, cum, theta, window, 1.5, device="cpu")
    want = jevaluate_theta(jb, inten, cum, jnp.asarray(theta), window, 1.5)
    sav, gc, bc, ratio = (x.numpy() for x in got)
    np.testing.assert_array_equal(ratio, np.asarray(want[3]))   # makespans
    # savings = 1 - carbon ratio: the ratio at rtol 1e-6 (a small saving
    # magnifies the float32 carbon sums' last-bit differences)
    np.testing.assert_allclose(1 - sav, 1 - np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_allclose(gc, np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(bc, np.asarray(want[2]), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_learn_sweeps():
    spec = bench.structure_spec(tiny=True)
    from benchmarks.structure_sweep import make_spec
    port = sweep_structure(spec, offline=False, learn=LearnConfig(steps=5),
                           device="cpu")
    ref = jsweep_structure(make_spec(tiny=True), offline=False,
                           learn=JLearnConfig(steps=5))
    return port, ref


# The sweep's row fields held exactly; the other numbers are float32
# carbon sums (XLA and torch associate them differently) rounded to three
# decimals: held at rtol 1e-6 beside the rounding unit.
EXACT = ("family", "width", "depth", "n_jobs", "n_machines", "fleet",
         "tasks_per_job", "greedy_makespan", "online_best_policy")


def _assert_close_fields(got, want, ctx):
    for k, w in want.items():
        if k in EXACT:
            assert got[k] == w, (ctx, k)
        else:
            np.testing.assert_allclose(np.asarray(got[k], float),
                                       np.asarray(w, float), rtol=1e-6,
                                       atol=1e-3 + 1e-9, err_msg=f"{ctx} {k}")


def test_sweep_structure_learn_matches_reference(tiny_learn_sweeps):
    """Fixed-grid fields as the structure golden holds them; learned
    fields at the learn golden's savings tolerance.  Where training ends
    level with the best fixed policy the reference's ``improved`` flag is
    float noise (its hard evaluation sums carbon in another order than
    its sweep, ROADMAP Queue 3 item 8); the flag and the kept theta are
    held where the two savings differ."""
    (rows, meta), (jrows, jmeta) = tiny_learn_sweeps
    assert meta["learn"] == jmeta["learn"]
    assert len(rows) == len(jrows) == 20
    rtol, atol = GOLDEN["learned_savings_pct"]
    ties = 0
    for r, j in zip(rows, jrows):
        ctx = f"{j['family']}-m{j['n_machines']}-{j['fleet']}"
        _assert_close_fields({k: v for k, v in r.items() if k != "learned"},
                             {k: v for k, v in j.items() if k != "learned"},
                             ctx)
        assert set(r["learned"]) == set(j["learned"]) == {"1.5", "2.0"}
        for sx, w in j["learned"].items():
            g = r["learned"][sx]
            assert (g["init_theta"], g["window"]) == (w["init_theta"],
                                                      w["window"])
            for k in ("savings_pct", "trained_savings_pct",
                      "fixed_best_savings_pct"):
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                           err_msg=f"{ctx} S={sx} {k}")
            if abs(w["trained_savings_pct"]
                   - w["fixed_best_savings_pct"]) > atol:
                assert (g["improved"], g["theta"]) == (w["improved"],
                                                       w["theta"]), ctx
            else:
                ties += 1
                assert not g["improved"] and g["theta"] == g["init_theta"]
    assert ties < 2 * len(rows)


def test_learned_summary_matches_reference(tiny_learn_sweeps):
    (rows, _), (jrows, _) = tiny_learn_sweeps
    assert learned_summary(jrows) == jlearned_summary(jrows)
    summary, ok = learned_summary(rows)
    assert ok and set(summary) == set(FAMILY_NAMES)


def test_sweep_structure_learn_wants_earliest_finish():
    with pytest.raises(ValueError, match="earliest_finish"):
        sweep_structure(bench.structure_spec(tiny=True), offline=False,
                        learn=LearnConfig(machine_rule="min_energy"),
                        device="cpu")


def test_learned_gate_cell_tiny():
    """The bench cell on the TINY grid at 2 steps: the record's shape,
    a wall per step and stretch, and the acceptance flag."""
    rec = bench.run_learned_gate(bench.structure_spec(tiny=True), steps=2,
                                 device="cpu")
    assert rec["acceptance"]["learned_ge_fixed_everywhere"]
    assert rec["instances"] == 40 and len(rec["cells"]) == 20
    assert {k: len(v) for k, v in rec["learn_step_seconds"].items()} == \
        {"1.5": 2, "2.0": 2}
    assert set(rec["seconds_by_stage"]) == {"build", "dispatch", "validate",
                                            "learn"}
