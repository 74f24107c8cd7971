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
  ``np.quantile`` loop;
* a step-by-step emulation of the CUDA kernel's sliding-window selection
  (``sliding_stats`` below: segments, the register ring, removal,
  insertion, the tail cut at E, the register / shared-memory width split)
  is held bitwise to the plain version and to the reference's Pallas
  kernel, so the kernel's algorithm is tested where the kernel cannot run.

The kernel itself is compared with the plain version on the card in
``test_torch_gpu.py``.
"""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from numpy.testing import assert_allclose

import jax.numpy as jnp

from repro.core.solvers import online_jax
from repro.kernels import ops as jops
from repro.kernels.gate_quantile import gate_quantile_stats_pallas
from repro_torch.core.solvers import online_torch
from repro_torch.kernels import LAUNCHES, build, ops, reset_launches
from repro_torch.kernels.gate_quantile import (WIDE_SEGMENT,
                                               gate_quantile_stats)
from repro_torch.kernels.ref import (gate_quantile_stats_ref,
                                     gate_threshold_ref)

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


# ---------------------------------------------------------------------------
# The CUDA kernel's sliding-window selection, emulated step by step.

def kernel_constants() -> dict:
    """``kSeg``, ``kRegWindow`` and ``kWideSeg`` as ``gate_quantile.cu``
    defines them, so the emulation slides as the kernel does."""
    src = (build.CSRC / "gate_quantile.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                src).group(1))
            for name in ("kSeg", "kRegWindow", "kWideSeg")}


EMPTY = 1 << 30          # the kernel's kEmpty: an empty ring slot's rank


def _ranks_of(theta, n, top):
    """The kernel's ``ranks_of``: one float32 product, floor, clamp."""
    lo_ = int(torch.floor(theta * float(n - 1)))
    return (min(max(lo_, 0), top), min(max(min(lo_ + 1, n - 1), 0), top))


def _pick(vals, ranks, r):
    hit = vals[ranks == r]
    assert hit.numel() <= 1, "two slots share a rank"
    return hit[0] if hit.numel() else torch.tensor(float("inf"))


def _slide_regs(x, th, w, top, t0, t1, out):
    """The register path: a ring of ``w`` slots (slot i is lane i % 32,
    register i // 32); an empty slot holds NaN and rank ``EMPTY``."""
    E = x.shape[0]
    K = -(-w // 32)
    i = torch.arange(32 * K)
    n0 = min(w, E - t0)
    val = torch.where(i < n0, x[(t0 + i).clamp_max(E - 1)], float("nan"))
    # The first window by counting; ring order is epoch order here.
    before = i[:, None] < i[None, :]                      # slot u before i
    rank = torch.where(before, val[:, None] <= val[None, :],
                       val[:, None] < val[None, :]).sum(0)
    rank = torch.where(i < n0, rank, EMPTY)
    head = 0
    for t in range(t0, t1):
        lo, hi = _ranks_of(th[t], min(w, E - t), top)
        out[0][t], out[1][t] = _pick(val, rank, lo), _pick(val, rank, hi)
        if t + 1 == t1:
            break
        xo = x[t]
        xn = x[t + w] if t + w < E else torch.tensor(float("nan"))
        g = val > xn
        rank = rank + g.int() - (val >= xo).int()
        greater = int(g.sum()) - int(xo > xn)       # the leaving slot's share
        val[head] = xn                               # it takes the slot over
        rank[head] = w - 1 - greater if bool(xn == xn) else EMPTY
        head = head + 1 if head + 1 < w else 0


def _slide_shared(x, th, w, top, t0, t1, wide_seg, max_window, out):
    """The shared-memory path: ranks indexed by epoch in a span of
    ``wide_seg + max_window - 1``, values read from the row."""
    E = x.shape[0]
    rk = torch.full((wide_seg + max_window - 1,), -1)
    n0 = min(w, E - t0)
    v = x[t0:t0 + n0]
    u = torch.arange(n0)
    rk[:n0] = torch.where(u[:, None] < u[None, :], v[:, None] <= v[None, :],
                          v[:, None] < v[None, :]).sum(0)
    for t in range(t0, t1):
        n = min(w, E - t)
        lo, hi = _ranks_of(th[t], n, top)
        win, r = x[t:t + n], rk[t - t0:t - t0 + n]
        out[0][t], out[1][t] = _pick(win, r, lo), _pick(win, r, hi)
        if t + 1 == t1:
            break
        xo = x[t]
        rest = win[1:]                      # win[0] is the slot that leaves
        g = rest > (x[t + w] if t + w < E else float("nan"))
        rk[t - t0 + 1:t - t0 + n] += g.int() - (rest >= xo).int()
        if t + w < E:
            rk[t + w - t0] = w - 1 - int(g.sum())


def sliding_stats(intensity, theta, window, max_window, seg=None,
                  reg_window=None, wide_seg=None):
    """``(a, b, n)`` as the CUDA kernel computes them, row by row and
    segment by segment; the kernel's constants unless overridden."""
    c = kernel_constants()
    seg = seg or c["kSeg"]
    reg_window = reg_window or c["kRegWindow"]
    wide_seg = wide_seg or c["kWideSeg"]
    R, E = intensity.shape
    a = torch.full((R, E), float("nan"))
    b = torch.full((R, E), float("nan"))
    n = torch.zeros((R, E), dtype=torch.int32)
    for r in range(R):
        w = min(int(window[r]), max_window)
        if w <= 0:
            a[r], b[r] = float("inf"), float("inf")
            continue
        n[r] = (E - torch.arange(E)).clamp_max(w).to(torch.int32)
        step = seg if max_window <= reg_window else wide_seg
        for t0 in range(0, E, step):
            t1 = min(t0 + step, E)
            out = (a[r], b[r])
            if max_window <= reg_window:
                _slide_regs(intensity[r], theta[r], w, max_window - 1, t0,
                            t1, out)
            else:
                _slide_shared(intensity[r], theta[r], w, max_window - 1, t0,
                              t1, wide_seg, max_window, out)
    return a, b, n


def trace(kind, E, seed):
    """Forecast rows the gate sees: ``hourly`` repeats each value over 4
    epochs as ``core/carbon.py`` does, ``flat`` is all-equal, ``zeros``
    mixes -0.0 and +0.0 (ties by float ==, distinct bit patterns)."""
    rng = np.random.default_rng(seed)
    if kind == "hourly":
        x = np.repeat(rng.uniform(50, 900, -(-E // 4)), 4)[:E]
    elif kind == "flat":
        x = np.full(E, rng.uniform(50, 900))
    elif kind == "zeros":
        x = np.where(rng.uniform(size=E) < 0.5, -0.0, 0.0)
        x[rng.uniform(size=E) < 0.2] = 1.0
    else:
        x = rng.uniform(50, 900, E)
    return x.astype(np.float32)


def exact_bits(got, want, ctx):
    """Equal as bit patterns (-0.0 != +0.0), and of one dtype."""
    for name, g, w in zip("abn", got, want):
        assert g.dtype == w.dtype, f"{ctx} {name}: dtype"
        gi, wi = (g.view(torch.int32) if g.is_floating_point() else g,
                  w.view(torch.int32) if w.is_floating_point() else w)
        assert torch.equal(gi, wi), \
            f"{ctx} {name}: {int((gi != wi).sum())} elements differ"


def test_wrapper_admits_what_the_shared_path_holds():
    """The wrapper's shared-memory check uses the kernel's segment."""
    assert WIDE_SEGMENT == kernel_constants()["kWideSeg"]


@settings(max_examples=30, deadline=None, derandomize=True)
@given(kind=st.sampled_from(["hourly", "flat", "zeros", "random"]),
       E=st.integers(1, 300),
       windows=st.lists(st.sampled_from([0, 1, 2, 3, 31, 32, 33, 48, 96,
                                         200, 256, 400]),
                        min_size=1, max_size=3),
       max_window=st.sampled_from([1, 2, 48, 96, 200, 256]),
       seg=st.sampled_from([None, 5, 32, 64]),
       theta_kind=st.sampled_from(["uniform", "edges", "zero", "one",
                                   "outside"]),
       seed=st.integers(0, 2**16))
def test_sliding_emulation_equals_plain_property(kind, E, windows,
                                                 max_window, seg, theta_kind,
                                                 seed):
    """The register path (max_window <= kRegWindow) with the kernel's
    segment and shorter ones (more boundaries inside a row), per-epoch
    thetas with 0 and 1 (and outside [0, 1], where lo/hi are clamped as
    the plain version's gather clamps them), windows 1, 2 and wider than
    E."""
    R = len(windows)
    inten = torch.as_tensor(np.stack([trace(kind, E, seed + r)
                                      for r in range(R)]))
    rng = np.random.default_rng(seed)
    theta = {"uniform": rng.uniform(0, 1, (R, E)),
             "edges": rng.choice([0.0, 1.0, 0.5], (R, E)),
             "zero": np.zeros((R, E)), "one": np.ones((R, E)),
             "outside": rng.uniform(-1, 2, (R, E))}[theta_kind]
    theta = torch.as_tensor(theta.astype(np.float32))
    window = torch.tensor(windows, dtype=torch.int32)
    got = sliding_stats(inten, theta, window, max_window, seg=seg)
    want = gate_quantile_stats_ref(inten, theta, window, max_window)
    exact_bits(got, want, f"{kind} E={E} windows={windows} mw={max_window}")


@pytest.mark.parametrize("max_window,windows", [
    (256, [256, 255, 129]),          # the register path's widest
    (257, [257, 256, 1]),            # the shared-memory path's narrowest
    (300, [300, 40, 0])])
@pytest.mark.parametrize("kind", ["hourly", "zeros"])
def test_sliding_emulation_width_split(max_window, windows, kind):
    """Each side of kRegWindow, with the kernel's own segments."""
    E = 301
    inten = torch.as_tensor(np.stack([trace(kind, E, r) for r in range(3)]))
    theta = torch.as_tensor(np.random.default_rng(max_window).uniform(
        0, 1, (3, E)).astype(np.float32))
    theta[:, ::9] = 0.0
    theta[:, 4::9] = 1.0
    window = torch.tensor(windows, dtype=torch.int32)
    got = sliding_stats(inten, theta, window, max_window)
    want = gate_quantile_stats_ref(inten, theta, window, max_window)
    exact_bits(got, want, f"max_window={max_window} {kind}")


@pytest.mark.parametrize("kind,E,window,max_window,theta,seg", [
    ("hourly", 300, 96, 96, 0.3, None),      # E not a multiple of kSeg
    ("hourly", 257, 48, 96, 0.5, 64),        # segments inside the row
    ("flat", 200, 96, 96, 0.4, 32),
    ("zeros", 130, 33, 48, 0.5, 16),
    ("random", 40, 64, 64, 1.0, None),       # window wider than E
    ("random", 100, 1, 96, 0.0, 8),
    ("random", 100, 2, 2, 0.9, 8),
    ("hourly", 70, 280, 300, 0.6, None),     # shared path, window > E
    ("zeros", 90, 270, 270, 0.0, None)])
def test_sliding_emulation_equals_pallas_kernel(kind, E, window, max_window,
                                                theta, seg):
    """Against the reference's Pallas kernel (interpret mode): bitwise,
    except that the Pallas kernel selects by a masked sum, which turns a
    selected -0.0 into +0.0 (the stable sort, the port's contract, keeps
    -0.0); so zeros are held equal as values, and bitwise to the plain
    version."""
    inten = trace(kind, E, E + window)
    args = (torch.as_tensor(inten)[None], torch.full((1, E), theta),
            torch.tensor([window], dtype=torch.int32), max_window)
    got = [x[0] for x in sliding_stats(*args, seg=seg)]
    ctx = f"{kind} E={E} window={window}"
    exact_bits(got, [x[0] for x in gate_quantile_stats_ref(*args)], ctx)
    want = [torch.as_tensor(np.array(x)) for x in pallas_stats(
        inten, theta, window, max_window)]
    for name, g, w in zip("abn", got, want):
        exact(w.numpy(), g.numpy(), f"{ctx} {name}")      # -0.0 == +0.0
        nz = w != 0
        exact_bits([g[nz]], [w[nz]], f"{ctx} {name}, non-zero")
