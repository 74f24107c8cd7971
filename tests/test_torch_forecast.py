"""Port vs reference: forecast models and the rolling re-quantile gate.

What can be held bitwise and what cannot:

* ``persistence`` and ``diurnal`` are gathers and ``where``s: bitwise.
* ``oracle_ar1`` on the reference's replayed ``jax.random`` draws is
  allclose, not bitwise: ``jnp.std`` and ``torch.std`` sum in different
  orders, and ``float32(rho) ** (2 * lead)`` rounds differently in a few
  entries.  At ``scale = 0`` the point forecast is the truth, bitwise.
* The gate is bitwise once the point forecasts are the same: with the
  reference's points passed in, the port's rolling and band masks equal
  the reference's.  End to end on replayed draws a mask may only differ
  where the observed intensity sits within 4 float32 ulps of its
  threshold.
* At ``scale = 0`` the rolling gate equals the day-ahead gate and the
  plain ``dirty_mask`` on the truth, bitwise, for every ``every``
  (``tests/test_forecast.py``'s regression), and the dispatch schedules
  equal the reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import generate_instance, pack
from repro.core import synthesize as jsynthesize
from repro.core.carbon import sample_window
from repro.core.solvers.online_jax import dirty_mask as jdirty_mask
from repro.core.solvers.online_jax import quantile_threshold, sorted_windows
from repro.forecast import models as jm
from repro.forecast import rolling as jr
from repro_torch.core import validate
from repro_torch.core.instance import packed_from_numpy
from repro_torch.core.solvers import online_torch
from repro_torch.forecast import models as tm
from repro_torch.forecast import rolling as tr
from repro_torch.kernels import ops

E = 400
THETA, WINDOW = 0.4, 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, shape=None, hetero=False):
    rng = np.random.default_rng(seed)
    inst = generate_instance(rng, n_jobs=4, k_tasks=3, n_machines=3,
                             heterogeneous=hetero, shape=shape)
    p = pack(inst)
    w = sample_window(jsynthesize("AU-SA", days=10), rng, E)
    return p, w.intensity


def to_port(p):
    return packed_from_numpy({f: np.asarray(getattr(p, f)) for f in p._fields},
                             device="cpu")


def jax_xi(key, K):
    """The reference's draws: issue k reads normal(fold_in(key, k), (E,))."""
    return torch.tensor(np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, k), (E,), jnp.float32)) for k in range(K)]))


def ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return np.spacing(x).astype(np.float64)


# ---------------------------------------------------------------------------
# Forecast models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["persistence", "diurnal"])
@pytest.mark.parametrize("t0", [0, 150, E - 1])
def test_structural_models_bitwise(model, t0):
    _, truth = _case(0)
    want = jm.issue(jnp.asarray(truth), jnp.int32(t0), model=model,
                    scale=1.0)
    got = tm.issue(torch.tensor(truth), t0, model=model, scale=1.0)
    np.testing.assert_array_equal(np.asarray(want.point), got.point.numpy())
    np.testing.assert_allclose(got.std.numpy(), np.asarray(want.std),
                               rtol=1e-6, atol=1e-4)
    assert int(got.issued_at) == t0


def test_diurnal_exact_on_periodic_trace():
    day = np.abs(np.sin(np.arange(96) / 96 * 2 * np.pi)) * 100 + 50
    truth = torch.tensor(np.tile(day, 6), dtype=torch.float32)
    fc = tm.issue(truth, 100, model="diurnal", scale=1.0)
    assert torch.equal(fc.point, truth)


@pytest.mark.parametrize("t0,scale", [(0, 0.5), (150, 1.0), (37, 2.0)])
def test_oracle_ar1_replayed(t0, scale):
    """The reference's own draw for one issue, through ``xi``."""
    _, truth = _case(1)
    key = jax.random.key(3 + t0)
    want = jm.issue(jnp.asarray(truth), jnp.int32(t0), key=key,
                    model="oracle_ar1", scale=scale)
    xi = torch.tensor(np.asarray(jax.random.normal(key, (E,), jnp.float32)))
    got = tm.issue(torch.tensor(truth), t0, xi, model="oracle_ar1",
                   scale=scale)
    sigma = float(np.std(truth))
    for f in ("point", "std"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-4 * sigma, err_msg=f)
    np.testing.assert_array_equal(got.point.numpy()[:t0 + 1], truth[:t0 + 1])


def test_oracle_ar1_needs_draws():
    with pytest.raises(ValueError, match="xi"):
        tm.issue(torch.ones(8), 0, None, model="oracle_ar1")
    with pytest.raises(ValueError, match="unknown"):
        tm.issue(torch.ones(8), 0, None, model="weather")


@pytest.mark.parametrize("model", tm.MODELS)
def test_zero_scale_point_is_truth_bitwise(model):
    _, truth = _case(2)
    xi = torch.randn(E, generator=torch.Generator().manual_seed(0))
    fc = tm.issue(torch.tensor(truth), 0, xi, model=model, scale=0.0)
    if model == "oracle_ar1":
        assert torch.equal(fc.point, torch.tensor(truth))
    assert float(fc.std.max()) == 0.0


def test_issues_stack_over_t0():
    """A ``[K]`` t0 issues K forecasts at once, each equal to its own."""
    _, truth = _case(3)
    tt = torch.tensor(truth)
    xi = torch.randn((3, E), generator=torch.Generator().manual_seed(1))
    t0 = torch.tensor([0, 48, 96], dtype=torch.int32)
    for model in tm.MODELS:
        many = tm.issue(tt[None, :], t0, xi, model=model, scale=0.7)
        for k in range(3):
            one = tm.issue(tt, int(t0[k]), xi[k], model=model, scale=0.7)
            assert torch.equal(many.point[k], one.point), (model, k)
            assert torch.equal(many.std[k], one.std), (model, k)


def test_lead_quantiles_allclose():
    _, truth = _case(3)
    key = jax.random.key(2)
    qs = (0.1, 0.5, 0.9)
    fc_j = jm.issue(jnp.asarray(truth), jnp.int32(100), key=key, scale=1.0)
    want = np.asarray(jm.lead_quantiles(fc_j, qs))
    fc_t = tm.Forecast(torch.tensor(np.asarray(fc_j.point)),
                       torch.tensor(np.asarray(fc_j.std)),
                       torch.tensor(100, dtype=torch.int32))
    got = tm.lead_quantiles(fc_t, qs).numpy()
    assert got.shape == (3, E)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got[:, :101],
                               np.broadcast_to(truth[:101], (3, 101)),
                               rtol=1e-6)


def test_n_replans():
    assert tr.n_replans(512, 96) == 6
    assert tr.n_replans(96, 96) == 1
    assert tr.n_replans(97, 96) == 2
    assert tr.n_replans(512, 24) == 22
    with pytest.raises(ValueError):
        tr.n_replans(96, 0)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("every", [24, 48, 96])
@pytest.mark.parametrize("seed", [0, 1])
def test_zero_noise_rolling_is_day_ahead_is_dirty_mask(seed, every):
    _, truth = _case(seed)
    tt = torch.tensor(truth)
    xi = jax_xi(jax.random.key(11), tr.n_replans(E, every))
    d0 = online_torch.dirty_mask(tt, THETA, WINDOW, WINDOW)
    dr = tr.rolling_dirty_mask(tt, THETA, WINDOW, xi, 0.0, every, WINDOW)
    da = tr.day_ahead_dirty_mask(tt, THETA, WINDOW, xi, 0.0, WINDOW)
    assert torch.equal(d0, dr) and torch.equal(d0, da)
    want = jdirty_mask(jnp.asarray(truth), jnp.float32(THETA),
                       jnp.int32(WINDOW), max_window=WINDOW)
    np.testing.assert_array_equal(np.asarray(want), dr.numpy())


def _reference_issues(truth, key, scale, every):
    K = tr.n_replans(E, every)
    return [jm.issue(jnp.asarray(truth), jnp.int32(k * every),
                     key=jax.random.fold_in(key, k), scale=scale)
            for k in range(K)]


@pytest.mark.parametrize("every,scale", [(24, 0.5), (48, 1.0), (96, 2.0)])
def test_masks_on_reference_points_bitwise(every, scale):
    """The reference's point forecasts (and band thetas) through the
    port's gate: one gate_quantile pass over the K issues, equal masks."""
    _, truth = _case(4)
    key = jax.random.key(5)
    fcs = _reference_issues(truth, key, scale, every)
    points = torch.tensor(np.stack([np.asarray(f.point) for f in fcs]))
    tt = torch.tensor(truth)
    want = jr.rolling_dirty_mask(jnp.asarray(truth), jnp.float32(THETA),
                                 jnp.int32(WINDOW), key, jnp.float32(scale),
                                 every=every, max_window=WINDOW)
    got = tr.rolling_mask_from_points(tt, points, THETA, WINDOW, every,
                                      WINDOW)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())

    sigma = jnp.maximum(jnp.std(jnp.asarray(truth)), 1e-6)
    thetas = torch.tensor(np.stack([np.asarray(jr.band_conditioned_theta(
        jnp.float32(THETA), jnp.float32(-0.3), f.std / sigma)) for f in fcs]))
    want = jr.rolling_band_dirty_mask(
        jnp.asarray(truth), jnp.float32(THETA), jnp.float32(-0.3),
        jnp.int32(WINDOW), key, jnp.float32(scale), every=every,
        max_window=WINDOW)
    got = tr.rolling_mask_from_points(tt, points, thetas, WINDOW, every,
                                      WINDOW)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _flips_within_ulps(truth, want, got, points, theta, every):
    """Every epoch where the masks differ has the truth within 4 ulps of
    the port's threshold from the governing issue; returns the count."""
    thr = ops.gate_threshold(points, theta, WINDOW, WINDOW).numpy()
    e = np.arange(E)
    thr = thr[e // every, e] if thr.ndim == 2 else thr
    diff = np.nonzero(np.asarray(want) != got.numpy())[0]
    gap = np.abs(truth[diff].astype(np.float64) - thr[diff])
    assert (gap <= 4 * ulp(thr[diff])).all(), (diff, gap)
    return diff.size


@pytest.mark.parametrize("seed,every,scale", [
    (6 + i, every, scale) for i, (every, scale) in enumerate(
        (e, s) for e in (24, 48, 96) for s in (0.5, 1.0, 2.0))])
def test_end_to_end_on_replayed_draws(seed, every, scale):
    """The whole path on the reference's draws: rolling, band and
    day-ahead masks equal the reference's except within 4 ulps of a
    threshold (none has been seen; ROADMAP Queue 3 logs any)."""
    _, truth = _case(seed)
    tt = torch.tensor(truth)
    key = jax.random.key(100 + seed)
    K = tr.n_replans(E, every)
    xi = jax_xi(key, K)
    fc = tr.rolling_forecasts(tt, xi, scale, every)
    flips = 0

    want = jr.rolling_dirty_mask(jnp.asarray(truth), jnp.float32(THETA),
                                 jnp.int32(WINDOW), key, jnp.float32(scale),
                                 every=every, max_window=WINDOW)
    got = tr.rolling_dirty_mask(tt, THETA, WINDOW, xi, scale, every, WINDOW)
    flips += _flips_within_ulps(truth, want, got, fc.point, THETA, every)

    want = jr.rolling_band_dirty_mask(
        jnp.asarray(truth), jnp.float32(THETA), jnp.float32(0.3),
        jnp.int32(WINDOW), key, jnp.float32(scale), every=every,
        max_window=WINDOW)
    got = tr.rolling_band_dirty_mask(tt, THETA, 0.3, WINDOW, xi, scale,
                                     every, WINDOW)
    sigma = tt.std(correction=0).clamp_min(1e-6)
    theta = tr.band_conditioned_theta(THETA, 0.3, fc.std / sigma)
    flips += _flips_within_ulps(truth, want, got, fc.point, theta, every)

    want = jr.day_ahead_dirty_mask(jnp.asarray(truth), jnp.float32(THETA),
                                   jnp.int32(WINDOW), key,
                                   jnp.float32(scale), max_window=WINDOW)
    got = tr.day_ahead_dirty_mask(tt, THETA, WINDOW, xi, scale, WINDOW)
    flips += _flips_within_ulps(truth, want, got, fc.point[0], THETA,
                                10 ** 9)
    assert flips == 0, f"{flips} gate flips at seed {seed}: log them"


def test_band_slope_zero_is_flat_gate():
    _, truth = _case(3)
    tt = torch.tensor(truth)
    xi = jax_xi(jax.random.key(9), tr.n_replans(E, 24))
    changed = False
    for every in (24, 48):
        for scale in (0.0, 0.8):
            flat = tr.rolling_dirty_mask(tt, THETA, 48, xi, scale, every, 48)
            band0 = tr.rolling_band_dirty_mask(tt, THETA, 0.0, 48, xi, scale,
                                               every, 48)
            assert torch.equal(flat, band0), (every, scale)
            band1 = tr.rolling_band_dirty_mask(tt, THETA, 0.4, 48, xi, scale,
                                               every, 48)
            changed |= not torch.equal(flat, band1)
    assert changed


@pytest.mark.parametrize("every", [None, 24])
def test_theta_band_features_and_theta(every):
    _, truth = _case(2)
    want = np.asarray(jr.theta_band_features(jnp.asarray(truth), 0.8,
                                             every=every))
    got = tr.theta_band_features(torch.tensor(truth), 0.8, every=every)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    feat = torch.linspace(-1.0, 3.0, 50)
    np.testing.assert_array_equal(
        tr.band_conditioned_theta(0.3, 0.4, feat).numpy(),
        np.asarray(jr.band_conditioned_theta(jnp.float32(0.3),
                                             jnp.float32(0.4),
                                             jnp.asarray(feat.numpy()))))


def test_masks_batch_over_instances_and_seeds():
    """``truth [B, 1, E]`` x ``xi [S, K, E]`` gives ``[B, S, E]``, each row
    the single-instance, single-seed mask."""
    truths = torch.tensor(np.stack([_case(s)[1] for s in (0, 1)]))
    xi = torch.randn((2, tr.n_replans(E, 48), E),
                     generator=torch.Generator().manual_seed(2))
    many = tr.rolling_dirty_mask(truths[:, None], THETA, WINDOW, xi, 1.0,
                                 48, WINDOW)
    da = tr.day_ahead_dirty_mask(truths[:, None], THETA, WINDOW, xi, 1.0,
                                 WINDOW)
    assert many.shape == da.shape == (2, 2, E)
    for b in range(2):
        for s in range(2):
            one = tr.rolling_dirty_mask(truths[b], THETA, WINDOW, xi[s], 1.0,
                                        48, WINDOW)
            assert torch.equal(many[b, s], one)
            one = tr.day_ahead_dirty_mask(truths[b], THETA, WINDOW, xi[s],
                                          1.0, WINDOW)
            assert torch.equal(da[b, s], one)


@pytest.mark.parametrize("seed,shape,hetero,every,scale",
                         [(0, "chain", False, 24, 0.0),
                          (1, "fanout", True, 48, 0.0),
                          (5, None, False, 24, 0.5),
                          (12, "branch", True, 96, 1.5)])
def test_online_rolling_gated_matches_reference(seed, shape, hetero, every,
                                                scale):
    p, truth = _case(seed, shape, hetero)
    key = jax.random.key(4 + seed)
    want = jr.online_rolling_gated_jax(p, jnp.asarray(truth), key,
                                       theta=0.3, stretch=1.5, every=every,
                                       scale=scale)
    xi = jax_xi(key, tr.n_replans(E, every))
    got = tr.online_rolling_gated_torch(to_port(p), truth, xi, theta=0.3,
                                        stretch=1.5, every=every,
                                        scale=scale, device="cpu")
    np.testing.assert_array_equal(np.asarray(want.start), got.start.numpy())
    np.testing.assert_array_equal(np.asarray(want.assign),
                                  got.assign.numpy())
    np.testing.assert_array_equal(np.asarray(want.scheduled),
                                  got.scheduled.numpy())
    assert int(validate.total_violations(to_port(p), got.start,
                                         got.assign)) == 0
    if scale == 0.0:
        day = online_torch.online_carbon_gated_torch(
            to_port(p), truth, theta=0.3, stretch=1.5, device="cpu")
        assert torch.equal(day.start, got.start)
        assert torch.equal(day.assign, got.assign)


def test_quantile_thresholds_match_reference_sort():
    """The port's per-issue thresholds equal the reference's masked sort
    on the same forecast rows."""
    _, truth = _case(10)
    fcs = _reference_issues(truth, jax.random.key(1), 1.0, 96)
    for f in fcs:
        sv, n = sorted_windows(f.point, jnp.int32(WINDOW), WINDOW)
        want = quantile_threshold(sv, n, jnp.float32(THETA))
        got = ops.gate_threshold(torch.tensor(np.asarray(f.point)), THETA,
                                 WINDOW, WINDOW)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_online_rolling_gated_warm_fleet_matches_reference():
    """``state0``: both runs dispatch onto machines busy until given
    epochs, as the reference's mirror does."""
    from repro.core.solvers.online_jax import init_dispatch_state
    p, truth = _case(3, "fanout", True)
    s0 = init_dispatch_state(p.T, p.M)._replace(
        mfree=jnp.asarray([30, 0, 75], jnp.int32))
    key = jax.random.key(21)
    want = jr.online_rolling_gated_jax(p, jnp.asarray(truth), key, theta=0.3,
                                       stretch=1.5, every=48, scale=1.0,
                                       state0=s0)
    state0 = online_torch.DispatchState(
        *(torch.tensor(np.asarray(x)) for x in s0))
    got = tr.online_rolling_gated_torch(
        to_port(p), truth, jax_xi(key, tr.n_replans(E, 48)), theta=0.3,
        stretch=1.5, every=48, scale=1.0, state0=state0, device="cpu")
    np.testing.assert_array_equal(np.asarray(want.start), got.start.numpy())
    np.testing.assert_array_equal(np.asarray(want.assign),
                                  got.assign.numpy())
