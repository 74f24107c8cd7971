"""Port vs reference: the ``gate_quantile`` kernel path on the CPU.

On CPU tensors the port's wrapper runs the kernel's plain version (a
stable ``torch.sort`` of the masked windows), so here:

* ``(a, b, n)`` are held bitwise to the reference's Pallas kernel
  (interpret mode) — both only *select* values;
* ``ops.gate_threshold`` is held bitwise to the port's naive
  ``ref.gate_threshold_ref``, and at rtol 1e-6 to the reference's
  thresholds (XLA may contract the lerp's mul+add where torch eager
  rounds each op; on these cases, and on 300 AU-SA sweep windows, no
  threshold differed at all);
* ``dirty_mask`` equals the reference's on both of its paths and a direct
  ``np.quantile`` loop.

The kernel itself is compared with the plain version on the card in
``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from repro.core.solvers import online_jax
from repro.kernels import ops as jops
from repro.kernels.gate_quantile import gate_quantile_stats_pallas
from repro_torch.core.solvers import online_torch
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels.gate_quantile import gate_quantile_stats
from repro_torch.kernels.ref import gate_threshold_ref

RTOL = 1e-6

# The reference suite's shapes (tests/test_kernels.py), ties injected.
SHAPES = [(300, 48, 0.3), (257, 96, 0.5), (64, 24, 0.9), (100, 1, 0.25),
          (130, 130, 0.6), (16, 96, 0.0), (200, 48, 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def forecast(seed, E, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(50, 900, E).astype(np.float32)
    if ties:
        x[::7] = x[0]
    return x


def port_stats(inten, theta, window, max_window):
    """One row through the port's wrapper (CPU: the plain version)."""
    E = inten.shape[0]
    theta = np.broadcast_to(np.asarray(theta, np.float32), (E,))
    return [x[0].numpy() for x in gate_quantile_stats(
        torch.as_tensor(inten)[None], torch.as_tensor(theta.copy())[None],
        torch.tensor([window], dtype=torch.int32), max_window)]


def pallas_stats(inten, theta, window, max_window):
    E = inten.shape[0]
    theta = np.broadcast_to(np.asarray(theta, np.float32), (E,))
    return [np.asarray(x) for x in gate_quantile_stats_pallas(
        jnp.asarray(inten), jnp.asarray(theta), jnp.int32(window),
        max_window=max_window, interpret=True)]


def exact(a, b, ctx=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{ctx}: dtype {a.dtype} != {b.dtype}"
    assert np.array_equal(a, b), f"{ctx}: {np.sum(a != b)} elements differ"


@pytest.mark.parametrize("E,W,theta", SHAPES)
def test_stats_equal_pallas_kernel(E, W, theta):
    inten = forecast(E * 1000 + W, E)
    got = port_stats(inten, theta, W, W)
    want = pallas_stats(inten, theta, W, W)
    for name, g, w in zip("abn", got, want):
        exact(w, g, f"{name} E={E} W={W} theta={theta}")


@pytest.mark.parametrize("window,max_window", [(200, 200), (150, 200),
                                               (129, 131), (7, 200)])
def test_stats_wide_and_capped_windows(window, max_window):
    """Windows wider than the TPU's 128 lanes, and a window under the
    static ``max_window`` (the traced-window case of a sweep)."""
    inten = forecast(window + max_window, 257)
    theta = np.random.default_rng(window).uniform(0, 1, 257)
    got = port_stats(inten, theta, window, max_window)
    want = pallas_stats(inten, theta, window, max_window)
    for name, g, w in zip("abn", got, want):
        exact(w, g, f"{name} window={window} max_window={max_window}")


def test_stats_per_epoch_theta_rows():
    """Several rows in one call, each with its own per-epoch theta vector
    and window, held row by row against the reference kernel."""
    rng = np.random.default_rng(5)
    R, E, max_window = 4, 220, 96
    inten = np.stack([forecast(r, E) for r in range(R)])
    theta = rng.uniform(0, 1, (R, E)).astype(np.float32)
    theta[:, ::11] = 0.0
    theta[:, 5::11] = 1.0
    window = np.array([96, 48, 1, 60], np.int32)
    got = gate_quantile_stats(torch.as_tensor(inten), torch.as_tensor(theta),
                              torch.as_tensor(window), max_window)
    for r in range(R):
        want = pallas_stats(inten[r], theta[r], int(window[r]), max_window)
        for name, g, w in zip("abn", got, want):
            exact(w, g[r].numpy(), f"{name} row {r}")


@pytest.mark.parametrize("E,W,theta", SHAPES)
def test_threshold_equals_naive_and_reference(E, W, theta):
    inten = forecast(E * 1000 + W, E)
    ti = torch.as_tensor(inten)
    got = ops.gate_threshold(ti, theta, W, W)
    naive = gate_threshold_ref(ti[None], torch.full((1, E), theta),
                               torch.tensor([W], dtype=torch.int32), W)[0]
    exact(naive.numpy(), got.numpy(), "vs gate_threshold_ref")
    sv, n = online_jax.sorted_windows(jnp.asarray(inten), jnp.int32(W), W)
    ref = np.asarray(online_jax.quantile_threshold(sv, n, jnp.float32(theta)))
    kern = np.asarray(jops.gate_threshold(jnp.asarray(inten),
                                          jnp.float32(theta), jnp.int32(W),
                                          W, interpret=True))
    assert_allclose(got.numpy(), ref, rtol=RTOL)
    assert_allclose(got.numpy(), kern, rtol=RTOL)
    # The port's own plain pair (sort + lerp) is the same expression.
    psv, pn = online_torch.sorted_windows(ti, W, W)
    exact(online_torch.quantile_threshold(psv, pn, theta).numpy(),
          got.numpy(), "vs online_torch.quantile_threshold")


def test_threshold_per_epoch_theta():
    rng = np.random.default_rng(5)
    E, W = 220, 48
    inten = forecast(5, E, ties=False)
    theta = rng.uniform(0, 1, E).astype(np.float32)
    got = ops.gate_threshold(torch.as_tensor(inten), torch.as_tensor(theta),
                             W, W)
    sv, n = online_jax.sorted_windows(jnp.asarray(inten), jnp.int32(W), W)
    ref = np.asarray(online_jax.quantile_threshold(sv, n, jnp.asarray(theta)))
    assert_allclose(got.numpy(), ref, rtol=RTOL)


def np_dirty(inten, theta, window):
    out = np.zeros(len(inten), bool)
    for t in range(len(inten)):
        win = inten[t:min(t + window, len(inten))]
        out[t] = inten[t] > np.quantile(win, theta) + 1e-9
    return out


@pytest.mark.parametrize("theta", [0.25, 0.4, 0.5, 0.9])
@pytest.mark.parametrize("window", [16, 96])
def test_dirty_mask_matches_reference_and_np_quantile(theta, window):
    """The reference's ``test_dirty_mask_matches_np_quantile`` case
    (CAL, 300 epochs), against both of the reference's paths too."""
    from repro_torch.core.carbon import sample_window, synthesize
    rng = np.random.default_rng(3)
    w = sample_window(synthesize("CAL", days=10), rng, 300)
    inten = w.intensity
    got = online_torch.dirty_mask(torch.as_tensor(inten), theta, window,
                                  max_window=window).numpy()
    np.testing.assert_array_equal(np_dirty(inten, theta, window), got)
    for use_kernels in (False, True):
        ref = online_jax.dirty_mask(jnp.asarray(inten), jnp.float32(theta),
                                    jnp.int32(window), max_window=window,
                                    use_kernels=use_kernels)
        np.testing.assert_array_equal(np.asarray(ref), got)


def test_dirty_mask_rows_equal_single_calls():
    """A batch of gate rows ``[B, Th, W, E]`` (the sweep's layout) gives
    each row's single-forecast mask."""
    thetas, windows = (0.3, 0.5), (24, 96)
    inten = torch.as_tensor(np.stack([forecast(s, 150) for s in range(3)]))
    rows = online_torch.gate_rows(inten, torch.tensor(thetas),
                                  torch.tensor(windows, dtype=torch.int32))
    got = online_torch.dirty_mask(*rows, max_window=max(windows))
    assert got.shape == (3, 2, 2, 150)
    for b in range(3):
        for i, th in enumerate(thetas):
            for j, wi in enumerate(windows):
                want = online_torch.dirty_mask(inten[b], th, wi,
                                               max_window=max(windows))
                exact(want.numpy(), got[b, i, j].numpy(), f"{b},{th},{wi}")


def test_cpu_runs_the_plain_version_and_counts_nothing():
    reset_launches()
    inten = torch.as_tensor(forecast(1, 64))
    ops.gate_threshold(inten, 0.4, 24, 24)
    assert all(n == 0 for n in LAUNCHES.values())


@pytest.mark.parametrize("bad", ["dtype", "window_dtype", "shape",
                                 "window_shape", "max_window"])
def test_gate_quantile_rejects_bad_inputs(bad):
    inten = torch.zeros((2, 10))
    theta = torch.zeros((2, 10))
    window = torch.ones(2, dtype=torch.int32)
    max_window = 4
    if bad == "dtype":
        inten = inten.double()
    elif bad == "window_dtype":
        window = window.long()
    elif bad == "shape":
        theta = theta[:1]
    elif bad == "window_shape":
        window = window[:1]
    else:
        max_window = 0
    with pytest.raises((TypeError, ValueError)):
        gate_quantile_stats(inten, theta, window, max_window)
