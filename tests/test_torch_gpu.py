"""The port's CUDA kernels and solver on the card.

Runs only where ``torch.cuda.is_available()``; elsewhere every test skips
(decided inside the tests, never at import or collection).  This file
imports no JAX, so it runs on a machine that has only the port's
dependencies (``--noconftest``: ``tests/conftest.py`` imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import bench
from repro_torch.core import objectives
from repro_torch.core.instance import PackedInstance
from repro_torch.core.solvers import (SAConfig, TorchDraws, common,
                                      solve_bilevel_batch)
from repro_torch.core.validate import total_violations
from repro_torch.core.solvers import online_torch
from repro_torch.core.solvers.rolling import forecast_cum, solve_mpc_batch
from repro_torch.forecast.rolling import (day_ahead_dirty_mask, n_replans,
                                          rolling_dirty_mask,
                                          rolling_forecasts)
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels.gate_quantile import gate_quantile_stats
from repro_torch.kernels.ref import (gate_quantile_stats_ref,
                                     schedule_delta_ref)
from repro_torch.kernels.schedule_eval import schedule_delta

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _case(dev, B, P, T, H, lo, hi, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    start = torch.randint(lo, hi, (B, P, T), generator=g, device=dev,
                          dtype=torch.int32)
    dur = torch.randint(0, 50, (B, P, T), generator=g, device=dev,
                        dtype=torch.int32)
    cum = torch.zeros((B, H + 1), device=dev)
    cum[:, 1:] = torch.cumsum(torch.rand((B, H), generator=g, device=dev),
                              dim=1)
    return start, dur, cum


def _same_bits(x, y):
    """Equal dtype and bit patterns (torch.equal takes -0.0 == +0.0)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


@pytest.mark.parametrize("shape", [(1000, 96, 40, 1500, 0, 1400),
                                   (7, 13, 37, 333, 0, 300),
                                   (1, 1, 1, 1, -5, 5),
                                   (5, 9, 11, 100, -150, 260),
                                   # P*T = 35 and 6: unaligned instance slices
                                   (3, 5, 7, 200, 0, 210),
                                   (4, 3, 2, 100, -10, 90),
                                   # B=1, P*T >= 2**20: one instance, 257 blocks
                                   (1, 256, 4100, 1500, -20, 1520),
                                   # a block that loads two batches
                                   (2, 9, 1000, 5000, 0, 5100),
                                   # H+1 beyond shared memory: gathered from L2
                                   (3, 17, 19, 60000, -100, 60100)])
def test_schedule_delta_bitwise(cuda, shape):
    start, dur, cum = _case(cuda, *shape)
    reset_launches()
    out = schedule_delta(start, dur, cum)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_eval"] == 1
    assert _same_bits(out, schedule_delta_ref(start, dur, cum))


def test_schedule_delta_unaligned_pointers(cuda):
    """Views that start one element into their storage: not 16-byte
    aligned, so the kernel takes every element on its own."""
    start, dur, cum = _case(cuda, 3, 7, 9, 50, -5, 60)
    s1 = torch.empty(start.numel() + 1, dtype=torch.int32, device=cuda)
    s1[1:] = start.reshape(-1)
    view = s1[1:].view(start.shape)
    out = schedule_delta(view, dur, cum)
    torch.cuda.synchronize()
    assert _same_bits(out, schedule_delta_ref(start, dur, cum))


def test_schedule_delta_rejects_non_contiguous(cuda):
    start, dur, cum = _case(cuda, 2, 4, 6, 50, 0, 40)
    with pytest.raises(ValueError):
        schedule_delta(start.transpose(1, 2).contiguous().transpose(1, 2),
                       dur, cum)


def test_population_carbon_bitwise(cuda):
    setup = bench.BenchSetup(instances=16)
    batch, cum = bench.paper_batch(setup, cuda)
    draws = TorchDraws(0, cuda)
    assign = common.random_allowed_assign(draws, batch, (24,))
    start = draws.randint(-20, 1600, batch.lead + (24, batch.T)) \
        .to(torch.int32)
    got = ops.population_carbon(batch, start, assign, cum)
    assert torch.equal(got, objectives.carbon(batch, start, assign, cum))


def test_solve_bilevel_batch_on_card(cuda):
    """A small batch on the card: validator-clean, savings >= 0, and the
    same phase-1 result as the CPU on the same draws."""
    setup = bench.BenchSetup(n_jobs=4, k_tasks=3, n_machines=3, instances=6,
                             stretch=1.5, seed=9)
    cfg = SAConfig(pop=16, iters=10, migrate_every=5)
    batch, cum = bench.paper_batch(setup, "cpu")

    out = {}
    for dev in ("cpu", cuda):
        b = PackedInstance(*(f.to(dev) for f in batch))
        reset_launches()
        r = solve_bilevel_batch(b, cum.to(dev), common.HostDraws(1, dev),
                                stretch=1.5, cfg1=cfg)
        assert not total_violations(b, r.baseline.start,
                                    r.baseline.assign).any()
        assert not total_violations(b, r.optimized.start, r.optimized.assign,
                                    r.deadline).any()
        assert (r.carbon_savings >= 0).all()
        out[str(dev)] = r
    assert LAUNCHES["schedule_eval"] == 1 + 10 + 2
    cpu, card = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(cpu.opt_makespan.numpy(),
                                  card.opt_makespan.cpu().numpy())
    np.testing.assert_array_equal(cpu.baseline.start.numpy(),
                                  card.baseline.start.cpu().numpy())


def _gate_case(dev, shape):
    """Gate rows at chip_smoke.py's shapes: the sweep's main shape (1000
    paper forecasts x thetas 0.3/0.4/0.5 x windows 48/96), a ragged one
    (max_window 200 > 128, ties injected) and an edge one (theta 0 and 1,
    window 1, E < window); and the sliding kernel's edges: segment
    boundaries inside rows of hourly traces (E = 300, not a multiple of
    the 128-epoch segment), each side of the register / shared-memory
    split (max_window 256 and 257) and a wide shared-memory window, -0.0
    and +0.0 ties, an all-equal trace, and thetas outside [0, 1] on both
    paths."""
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    if shape in ("segment", "reg_widest", "shared_narrowest", "shared_wide",
                 "zeros", "flat", "theta_out", "theta_out_wide"):
        E = {"shared_wide": 1500}.get(shape, 300)
        max_window, window = {
            "segment": (96, [96, 48, 33, 32, 1, 0]),
            "reg_widest": (256, [256, 255, 129, 97, 400, 2]),
            "shared_narrowest": (257, [257, 256, 1, 300]),
            "shared_wide": (1000, [1000, 700, 3]),
            "zeros": (96, [96, 48, 7, 1]),
            "flat": (200, [200, 96, 5, 1]),
            "theta_out": (96, [96, 48, 7, 1]),
            "theta_out_wide": (300, [300, 96, 1])}[shape]
        R = len(window)
        hours = torch.rand((R, -(-E // 4)), generator=g) * 800 + 50
        inten = hours.repeat_interleave(4, dim=1)[:, :E].contiguous()
        if shape == "zeros":
            inten = torch.where(torch.rand((R, E), generator=g) < 0.5,
                                -0.0, 0.0)
            inten[torch.rand((R, E), generator=g) < 0.2] = 1.0
        elif shape == "flat":
            inten = torch.full((R, E), 371.25)
        theta = torch.rand((R, E), generator=g)
        theta[:, ::7] = 0.0
        theta[:, 3::7] = 1.0
        if shape.startswith("theta_out"):
            theta = theta * 3.0 - 1.0
        return (inten.to(dev), theta.to(dev),
                torch.tensor(window, dtype=torch.int32, device=dev),
                max_window)
    if shape == "main":
        _, _, inten, _ = bench.online_batch(
            bench.BenchSetup(stretch=1.5, instances=1000), dev)
        rows = online_torch.gate_rows(
            inten, torch.tensor(bench.ONLINE_THETAS, device=dev),
            torch.tensor(bench.ONLINE_WINDOWS, dtype=torch.int32,
                         device=dev))
        E = inten.shape[-1]
        return (rows[0].reshape(-1, E).contiguous(),
                rows[1].reshape(-1, E).contiguous(),
                rows[2].reshape(-1).contiguous(),
                max(bench.ONLINE_WINDOWS))
    if shape == "ragged":
        R, E, max_window = 7, 257, 200
        inten = torch.rand((R, E), generator=g) * 800 + 50
        inten[:, ::5] = inten[:, :1]
        theta = torch.rand((R, E), generator=g)
        window = torch.tensor([1, 17, 48, 96, 128, 150, 200],
                              dtype=torch.int32)
    else:
        R, E, max_window = 4, 40, 64
        inten = torch.rand((R, E), generator=g) * 800 + 50
        theta = torch.tensor([0.0, 1.0, 0.0, 1.0])[:, None].expand(R, E)
        window = torch.tensor([1, 1, 64, 64], dtype=torch.int32)
    return (inten.to(dev), theta.contiguous().to(dev), window.to(dev),
            max_window)


@pytest.mark.parametrize("shape", ["main", "ragged", "edge", "segment",
                                   "reg_widest", "shared_narrowest",
                                   "shared_wide", "zeros", "flat",
                                   "theta_out", "theta_out_wide"])
def test_gate_quantile_bitwise(cuda, shape):
    inten, theta, window, max_window = _gate_case(cuda, shape)
    reset_launches()
    got = gate_quantile_stats(inten, theta, window, max_window)
    torch.cuda.synchronize()
    assert LAUNCHES["gate_quantile"] == 1
    want = gate_quantile_stats_ref(inten, theta, window, max_window)
    for name, x, y in zip("abn", got, want):
        assert _same_bits(x, y), name
    if shape != "main":      # the plain version on the CPU, too
        cpu = gate_quantile_stats_ref(inten.cpu(), theta.cpu(), window.cpu(),
                                      max_window)
        for name, x, y in zip("abn", got, cpu):
            assert _same_bits(x.cpu(), y), f"{name} vs the CPU"


def test_gate_quantile_rejects_non_contiguous(cuda):
    inten, theta, window, max_window = _gate_case(cuda, "ragged")
    with pytest.raises(ValueError):
        gate_quantile_stats(inten.t().contiguous().t(), theta, window,
                            max_window)


def test_gate_threshold_card_equals_cpu(cuda):
    """The lerp after the kernel is torch eager on both devices, one
    rounding per op: the card's thresholds equal the CPU's bitwise."""
    inten, theta, window, max_window = _gate_case(cuda, "ragged")
    got = ops.gate_threshold(inten, theta, window, max_window)
    want = ops.gate_threshold(inten.cpu(), theta.cpu(), window.cpu(),
                              max_window)
    assert torch.equal(got.cpu(), want)


def test_sweep_card_equals_cpu(cuda):
    """A small online sweep on the card: one gate_quantile launch, every
    row scheduled, and the same schedules as on the CPU."""
    setup = bench.BenchSetup(stretch=1.5, instances=8)
    reset_launches()
    card = bench.run_online(setup, cuda)
    assert LAUNCHES["gate_quantile"] == 1
    cpu = bench.run_online(setup, "cpu")
    assert card["unscheduled_greedy"] == card["unscheduled_gated"] == 0
    assert not card["gated_violations"].any()
    for part in ("greedy", "gated"):
        for name in ("start", "assign", "scheduled"):
            assert torch.equal(
                getattr(getattr(card["result"], part), name).cpu(),
                getattr(getattr(cpu["result"], part), name)), (part, name)
    np.testing.assert_array_equal(card["result"].budget.cpu().numpy(),
                                  cpu["result"].budget.numpy())


# ---------------------------------------------------------------------------
# The forecast path: the kernels at the rolling gate's and the MPC's
# shapes, and the forecast gate on the card against the CPU.
# ---------------------------------------------------------------------------

def _forecast_points(dev, every=24, scale=1.0):
    """The forecast cell's issues ``[B, S, K, E]``: 1000 instances x 3
    seeds x K issues x 512 epochs (K = 22 at every = 24)."""
    setup = bench.ForecastSetup()
    _, truths, _ = bench.forecast_batch(setup, dev)
    E = truths.shape[-1]
    xi = TorchDraws(setup.seed + 1, dev).normal(
        (setup.seeds, n_replans(E, every), E))
    return rolling_forecasts(truths[:, None], xi, scale, every).point


def test_gate_quantile_rolling_shape_bitwise(cuda):
    points = _forecast_points(cuda)
    assert points.shape == (1000, 3, 22, 512)
    inten = points.reshape(-1, points.shape[-1]).contiguous()
    theta = torch.full_like(inten, bench.FC_THETA)
    window = torch.full(inten.shape[:1], bench.FC_WINDOW, dtype=torch.int32,
                        device=cuda)
    reset_launches()
    got = gate_quantile_stats(inten, theta, window, bench.FC_WINDOW)
    torch.cuda.synchronize()
    assert LAUNCHES["gate_quantile"] == 1
    want = gate_quantile_stats_ref(inten, theta, window, bench.FC_WINDOW)
    for name, x, y in zip("abn", got, want):
        assert _same_bits(x, y), name


def test_schedule_delta_mpc_shape_bitwise(cuda):
    """B*S = 2000 (instance, seed) rows, each with its own forecast cum of
    513 epochs, 24 candidates of 18 tasks."""
    cum = forecast_cum(_forecast_points(cuda)[:, :2, 0])    # [B, S, 513]
    cum = cum.reshape(-1, cum.shape[-1]).contiguous()
    start, dur, _ = _case(cuda, cum.shape[0], 24, 18, 512, -5, 520)
    reset_launches()
    out = schedule_delta(start, dur, cum)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_eval"] == 1
    assert _same_bits(out, schedule_delta_ref(start, dur, cum))


def test_forecast_gate_scale0_card_equals_cpu(cuda):
    """At scale 0 the day-ahead and rolling masks on the card equal the
    CPU's and the plain dirty mask on the truth, bitwise."""
    setup = bench.ForecastSetup(instances=8)
    xi = TorchDraws(1, "cpu").normal((setup.seeds, 22, setup.horizon))
    out = {}
    for dev in ("cpu", cuda):
        _, truths, _ = bench.forecast_batch(setup, dev)
        t = truths[:, None]
        masks = [day_ahead_dirty_mask(t, bench.FC_THETA, bench.FC_WINDOW,
                                      xi.to(dev), 0.0, bench.FC_WINDOW)]
        masks += [rolling_dirty_mask(t, bench.FC_THETA, bench.FC_WINDOW,
                                     xi.to(dev), 0.0, every, bench.FC_WINDOW)
                  for every in bench.FC_EVERYS]
        perfect = online_torch.dirty_mask(truths, bench.FC_THETA,
                                          bench.FC_WINDOW, bench.FC_WINDOW)
        for m in masks:
            assert torch.equal(m, perfect[:, None].expand(m.shape))
        out[str(dev)] = [m.cpu() for m in masks]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)


def test_solve_mpc_batch_on_card(cuda):
    """A small MPC batch on the card: the frozen prefix holds, every plan
    is feasible within its deadline."""
    setup = bench.ForecastSetup(instances=6, sa_pop=8, sa_iters=6)
    batch, truths, cums = bench.forecast_batch(setup, cuda)
    cfg = bench.mpc_config(setup, 48)
    xi = TorchDraws(3, cuda).normal((2, cfg.n_replans, truths.shape[-1]))
    reset_launches()
    res = solve_mpc_batch(batch, truths, cums, TorchDraws(4, cuda), xi, 1.0,
                          cfg=cfg, device=cuda)
    assert LAUNCHES["schedule_eval"] == cfg.n_replans * (1 + cfg.sa.iters)
    assert not total_violations(batch, res.start, res.assign,
                                res.deadline).any()
    ps, mask = res.plans_start, batch.task_mask[:, None]
    for k in range(cfg.n_replans - 1):
        frozen = mask & (ps[..., k, :] < (k + 1) * cfg.every)
        assert torch.equal(torch.where(frozen, ps[..., k + 1, :], 0),
                           torch.where(frozen, ps[..., k, :], 0))


# ---------------------------------------------------------------------------
# The model kernels: flash_attention and ssd_scan against their plain
# versions on the card (allclose: both reassociate), and the serve path.
# ---------------------------------------------------------------------------

def _flash_case(dev, B, H, KVH, Sq, Skv, dh, dtype, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((B, H, Sq, dh), (B, KVH, Skv, dh), (B, KVH, Skv, dh))]


@pytest.mark.parametrize("B,H,KVH,S,dh,causal,window,dtype", [
    (2, 4, 2, 128, 64, True, 0, torch.float32),
    (1, 8, 8, 256, 32, True, 64, torch.float32),
    (2, 2, 1, 128, 64, False, 0, torch.float32),
    (1, 4, 4, 128, 128, True, 0, torch.bfloat16),
    (1, 3, 1, 777, 64, True, 100, torch.bfloat16),
    (1, 25, 5, 4096, 64, True, 2048, torch.bfloat16),
    # the wgmma route's edges: head dims 32 and 128, lengths ragged
    # against the 64-row tiles, a window of exactly one tile, GQA group 5,
    # non-causal
    (1, 4, 2, 200, 32, True, 0, torch.bfloat16),
    (2, 4, 2, 200, 128, True, 0, torch.bfloat16),
    (1, 4, 2, 65, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 1000, 64, True, 0, torch.bfloat16),
    (1, 4, 2, 1000, 64, True, 64, torch.bfloat16),
    (1, 25, 5, 333, 64, True, 0, torch.bfloat16),
    (2, 4, 2, 300, 64, False, 0, torch.bfloat16),
])
def test_flash_attention_kernel_matches_plain(cuda, B, H, KVH, S, dh, causal,
                                              window, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref, flash_attention_plain
    q, k, v = _flash_case(cuda, B, H, KVH, S, S, dh, dtype)
    reset_launches()
    out = flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, causal, window).float(),
        atol=tol, rtol=tol)
    if S <= 1024:
        torch.testing.assert_close(
            out.float(), attention_ref(q, k, v, causal, window).float(),
            atol=tol, rtol=tol)


def test_flash_attention_kernel_refuses(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _flash_case(cuda, 1, 2, 1, 64, 64, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _flash_case(cuda, 1, 2, 1, 64, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def _ssd_case(dev, B, S, H, P, G, N, dtype, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = (0.5 * torch.randn((B, S, H, P), generator=g, device=dev)).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g, device=dev))
    Bm = (0.5 * torch.randn((B, S, G, N), generator=g, device=dev)).to(dtype)
    Cm = (0.5 * torch.randn((B, S, G, N), generator=g, device=dev)).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,dtype", [
    (2, 128, 4, 32, 2, 16, 32, torch.float32),
    (1, 64, 2, 16, 1, 8, 16, torch.float32),
    (1, 256, 8, 64, 1, 32, 64, torch.float32),
    (2, 64, 4, 32, 4, 16, 32, torch.bfloat16),
    (1, 777, 4, 100, 1, 16, 256, torch.bfloat16),
    (1, 4096, 32, 100, 1, 16, 256, torch.bfloat16),
    (1, 2048, 32, 64, 1, 128, 256, torch.bfloat16),
    # the chunk-parallel kernels' edges: P = 100 with odd H (200-byte head
    # rows, 8- but not 16-byte aligned), one step past a chunk, G = 2, and
    # float32 at mamba2's P = 64, N = 128
    (1, 300, 5, 100, 1, 16, 256, torch.bfloat16),
    (1, 257, 4, 100, 1, 16, 256, torch.bfloat16),
    (1, 512, 4, 64, 2, 16, 128, torch.bfloat16),
    (1, 300, 4, 64, 1, 128, 128, torch.float32),
])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, G, N, chunk, dtype):
    from repro_torch.models.ssm import ssd_chunked, ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    args = _ssd_case(cuda, B, S, H, P, G, N, dtype)
    reset_launches()
    y, h = ssd_scan(*args, chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    yr, hr = ssd_chunked(*args, chunk)
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, hr, atol=3e-4, rtol=3e-4)
    if S <= 256:
        ys, hs = ssd_ref(*args)
        torch.testing.assert_close(y.float(), ys.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(h, hs, atol=tol, rtol=tol)


def test_ssd_scan_kernel_refuses(cuda):
    from repro_torch.kernels.ssd_scan import ssd_scan
    args = _ssd_case(cuda, 1, 64, 2, 600, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="exceed"):
        ssd_scan(*args, 64)


def test_reduced_hymba_card_equals_cpu(cuda):
    """The hybrid's serve path on the card (both kernels) against the same
    weights on the CPU (both plain versions): prefill and two decode
    steps allclose at 3e-2, each kernel launched once per layer."""
    from repro_torch import configs
    from repro_torch.models.api import build_model
    cfg = configs.get("hymba-1.5b").reduced()
    card = build_model(cfg, cuda, seed=1)
    cpu = build_model(cfg, "cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 90)))
    reset_launches()
    lg, cg = card.prefill({"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == LAUNCHES["ssd_scan"] == \
        cfg.n_layers
    lc, cc = cpu.prefill({"tokens": toks})
    torch.testing.assert_close(lg.cpu(), lc, atol=3e-2, rtol=3e-2)
    for t in range(2):
        tok = torch.argmax(lc, -1)[:, None]
        lg, cg = card.decode({"token": tok.to(cuda),
                              "pos": torch.tensor(90 + t, device=cuda), **cg})
        lc, cc = cpu.decode({"token": tok, "pos": torch.tensor(90 + t), **cc})
        torch.testing.assert_close(lg.cpu(), lc, atol=3e-2, rtol=3e-2)


# ---------------------------------------------------------------------------
# The moe, encdec and vlm families: the attention kernel at their shapes
# (queries and keys of other lengths, short keys, GQA groups 7 and 8),
# and one MoE layer card vs CPU.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KVH,Sq,Skv,dh,causal,dtype", [
    (4, 2, 37, 300, 64, False, torch.bfloat16),      # Sq != Skv
    (8, 8, 448, 1500, 64, False, torch.bfloat16),    # whisper's cross
    (4, 2, 37, 300, 64, False, torch.float32),
    (4, 2, 8, 8, 64, False, torch.bfloat16),         # Skv < 64
    (4, 2, 8, 8, 64, True, torch.bfloat16),
    (4, 2, 8, 8, 32, False, torch.float32),
    (56, 8, 300, 300, 128, True, torch.bfloat16),    # llava: group 7
    (32, 4, 300, 300, 128, True, torch.bfloat16),    # qwen3-moe: group 8
    (32, 4, 130, 70, 128, False, torch.bfloat16),
])
def test_flash_attention_kernel_family_shapes(cuda, H, KVH, Sq, Skv, dh,
                                              causal, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref, flash_attention_plain
    q, k, v = _flash_case(cuda, 1, H, KVH, Sq, Skv, dh, dtype, seed=3)
    reset_launches()
    out = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, causal).float(),
        atol=tol, rtol=tol)
    torch.testing.assert_close(
        out.float(), attention_ref(q, k, v, causal).float(), atol=tol,
        rtol=tol)


def test_moe_layer_card_equals_cpu(cuda, monkeypatch):
    """One qwen3-moe-30b-a3b MoE layer at full width (128 experts, top 8)
    on 96 tokens: the same ids on the card and the CPU (a flip only at a
    near tie, |p_a - p_b| <= 1e-6), and the outputs allclose at 2e-2 with
    the CPU's dispatch and combine fed the card's routing, so that every
    row is compared whatever flipped."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.models.parallel import ParallelCfg
    cfg = configs.get("qwen3-moe-30b-a3b")
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    p = init_params(g, moe.moe_defs(cfg))
    x = (0.5 * torch.randn((1, 96, cfg.d_model), generator=g, device=cuda)
         ).bfloat16()
    pc = {k: v.cpu() for k, v in p.items()}
    ids, _, probs = moe._route(x.reshape(-1, cfg.d_model), p["router"],
                               cfg.experts_per_token)
    cids, _, _ = moe._route(x.cpu().reshape(-1, cfg.d_model), pc["router"],
                            cfg.experts_per_token)
    ids, probs = ids.cpu(), probs.cpu()
    for r in torch.nonzero((ids != cids).any(-1))[:, 0].tolist():
        slots = ids[r] != cids[r]
        diff = sorted(set(ids[r, slots].tolist()) | set(cids[r, slots].tolist()))
        pr = probs[r, diff]
        assert float(pr.max() - pr.min()) <= 1e-6, (r, diff, pr)
    y, aux = moe.moe_apply(p, x, cfg, ParallelCfg())
    _, auxc = moe.moe_apply(pc, x.cpu(), cfg, ParallelCfg())
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())
    torch.testing.assert_close(aux.cpu(), auxc, atol=1e-5, rtol=1e-4)
    card_route = tuple(t.cpu() for t in moe._route(
        x.reshape(-1, cfg.d_model), p["router"], cfg.experts_per_token))
    monkeypatch.setattr(moe, "_route", lambda *_: card_route)
    yc, _ = moe.moe_apply(pc, x.cpu(), cfg, ParallelCfg())
    torch.testing.assert_close(y.cpu().float(), yc.float(), atol=2e-2,
                               rtol=2e-2)


def test_reduced_families_card_equal_cpu(cuda):
    """whisper-base (encoder non-causal, cross, decoder causal: three
    launches a layer pair) and llava-next-34b (8 zero patches) reduced, the
    same weights on the card and the CPU: prefill and two decode steps
    allclose at 3e-2."""
    from repro_torch import configs
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import frontend_inputs, frontend_tokens
    for arch in ("whisper-base", "llava-next-34b"):
        cfg = configs.get(arch).reduced()
        card = build_model(cfg, cuda, seed=2)
        cpu = build_model(cfg, "cpu", seed=2)
        cpu.load_state_dict({k: v.cpu()
                             for k, v in card.state_dict().items()})
        n = 70
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (1, n)))
        batch = {"tokens": toks, **frontend_inputs(cfg, n, "cpu")}
        prefix = frontend_tokens(cfg)
        reset_launches()
        lg, cg = card.prefill({k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
        want = cfg.n_layers * (2 if cfg.n_encoder_layers else 1) \
            + cfg.n_encoder_layers
        assert LAUNCHES["flash_attention"] == want
        lc, cc = cpu.prefill(batch)
        pad = lambda c: {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))  # noqa: E731
                         if k in ("k_cache", "v_cache") else v
                         for k, v in c.items()}
        cg, cc = pad(cg), pad(cc)
        torch.testing.assert_close(lg.cpu(), lc, atol=3e-2, rtol=3e-2)
        for t in range(2):
            tok = torch.argmax(lc, -1)[:, None]
            pos = prefix + n + t
            lg, cg = card.decode({"token": tok.to(cuda),
                                  "pos": torch.tensor(pos, device=cuda),
                                  **cg})
            lc, cc = cpu.decode({"token": tok, "pos": torch.tensor(pos),
                                 **cc})
            torch.testing.assert_close(lg.cpu(), lc, atol=3e-2, rtol=3e-2)


# ---------------------------------------------------------------------------
# The stream path: the gate at the engine's two shapes, the TINY goldens on
# the card, and the TINY grid's most backlogged cell and its banded-gate
# poisson cell card vs CPU.
# ---------------------------------------------------------------------------

STREAM_GOLDEN = dict(arrivals="bursty", rate=0.08, horizon=192, n_lanes=3,
                     family="layered", width=3, depth=2, n_machines=3,
                     fleet="tiered", mean_dur=5.0, theta=0.5, window=96,
                     stretch=1.5, seed=2024)
STREAM_EXACT = ("rid", "arrival", "admitted", "queue_delay", "finished",
                "budget", "greedy_makespan", "completed", "truncated")


@pytest.mark.parametrize("banded", [False, True], ids=["day-ahead", "banded"])
def test_gate_quantile_stream_shapes_bitwise(cuda, banded):
    """``[1, 1216]`` (the day-ahead gate) and ``[51, 1216]`` (the banded
    gate, every 24) over the FULL poisson cell's window."""
    from repro_torch.forecast.rolling import rolling_forecasts
    from repro_torch.stream.engine import stream_setup
    knobs, _, _ = bench.stream_knobs()
    rate = 0.9 * knobs["n_lanes"] / bench.probe_service_epochs(
        knobs, device=cuda)
    _, _, _, trace = stream_setup(bench.stream_config(knobs, "poisson",
                                                      rate))
    inten = torch.as_tensor(trace.intensity, device=cuda)
    E = inten.shape[-1]
    if banded:
        # The engine's own noise: drawn on the CPU whatever the device.
        xi = TorchDraws(bench.STREAM_SEED, "cpu").normal(
            (n_replans(E, 24), E)).to(cuda)
        rows = rolling_forecasts(inten, xi, 1.0, 24).point.contiguous()
    else:
        rows = inten[None].contiguous()
    assert rows.shape == ((51 if banded else 1), 1216)
    theta = torch.full_like(rows, 0.5)
    window = torch.full(rows.shape[:1], 96, dtype=torch.int32, device=cuda)
    reset_launches()
    got = gate_quantile_stats(rows, theta, window, 96)
    torch.cuda.synchronize()
    assert LAUNCHES["gate_quantile"] == 1
    want = gate_quantile_stats_ref(rows, theta, window, 96)
    for name, x, y in zip("abn", got, want):
        assert _same_bits(x, y), name


@pytest.mark.parametrize("shared_fleet", [False, True],
                         ids=["partitioned", "shared"])
def test_stream_goldens_on_card(cuda, shared_fleet):
    import json
    import os
    from repro_torch.stream import StreamConfig, simulate_stream
    name = ("stream_contention_tiny.json" if shared_fleet
            else "stream_tiny.json")
    with open(os.path.join(os.path.dirname(__file__), "golden", name)) as f:
        golden = json.load(f)
    reset_launches()
    res = simulate_stream(StreamConfig(**STREAM_GOLDEN,
                                       shared_fleet=shared_fleet),
                          device=cuda)
    assert LAUNCHES["gate_quantile"] == 1
    assert {k: res.meta[k] for k in golden["meta"]} == golden["meta"]
    assert len(res.events) == len(golden["events"])
    for g, w in zip(res.events, golden["events"]):
        assert set(g) == set(w)
        for k, v in w.items():
            if k in STREAM_EXACT:
                assert g[k] == v, (w["rid"], k)
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=2e-3)


def _stream_card_equals_cpu(cuda, arrivals, shared_fleet, **gate):
    """The TINY grid's ``arrivals`` cell at load 1.2 on the card and on
    the CPU: the same jobs, schedules and counts, carbon within rtol
    1e-6."""
    knobs, loads, _ = bench.stream_knobs(tiny=True)
    rate = max(loads) * knobs["n_lanes"] / bench.probe_service_epochs(
        knobs, device="cpu")
    card = bench.run_stream_cell(knobs, arrivals, max(loads), rate,
                                 shared_fleet, device=cuda,
                                 **gate)["result"]
    cpu = bench.run_stream_cell(knobs, arrivals, max(loads), rate,
                                shared_fleet, device="cpu", **gate)["result"]
    assert len(card.jobs) == len(cpu.jobs) > 0
    for a, b in zip(card.events, cpu.events):
        assert {k: v for k, v in a.items() if k in STREAM_EXACT} == \
            {k: v for k, v in b.items() if k in STREAM_EXACT}
    for a, b in zip(card.jobs, cpu.jobs):
        if b.finished:
            np.testing.assert_array_equal(a.start, b.start)
            np.testing.assert_array_equal(a.assign, b.assign)
        np.testing.assert_allclose(a.carbon, b.carbon, rtol=1e-6)
        np.testing.assert_allclose(a.greedy_carbon, b.greedy_carbon,
                                   rtol=1e-6)


@pytest.mark.parametrize("shared_fleet", [False, True],
                         ids=["partitioned", "shared"])
def test_stream_tiny_bursty_card_equals_cpu(cuda, shared_fleet):
    """The TINY grid's bursty cell at load 1.2 (the most backlog)."""
    _stream_card_equals_cpu(cuda, "bursty", shared_fleet)


def test_stream_tiny_banded_card_equals_cpu(cuda):
    """The TINY poisson cell at load 1.2 under the forecast-banded gate
    (every 24, scale 1): one seed gives one noise, so the rolling
    forecasts, the K x E thresholds and every dispatch match the CPU's."""
    _stream_card_equals_cpu(cuda, "poisson", False, forecast_every=24,
                            forecast_scale=1.0)


# ---------------------------------------------------------------------------
# The gate-policy learner: the threshold's gradient through the kernel
# ---------------------------------------------------------------------------

LEARN_GRAD_RTOL = 1e-4      # the CPU gradient-parity test's tolerance


def test_gate_threshold_gradient_through_kernel_bitwise(cuda):
    """At the FULL learn grid's gate shape (240 rows x 2048 epochs,
    window 48, per-epoch theta): the kernel's thresholds and the gradient
    of a weighted sum in theta equal the plain sorted-window path's on
    the same card tensors, bitwise."""
    g = torch.Generator(device=cuda)
    g.manual_seed(18)
    inten = torch.rand((240, 2048), generator=g, device=cuda) * 400
    raw = torch.randn((240, 2048), generator=g, device=cuda)
    w = torch.randn((240, 2048), generator=g, device=cuda)
    grads = []
    for kernel in (True, False):
        theta = torch.sigmoid(raw).requires_grad_(True)
        if kernel:
            reset_launches()
            thr = ops.gate_threshold(inten, theta, 48, 48)
            assert LAUNCHES["gate_quantile"] == 1
        else:
            sv, n = online_torch.sorted_windows(inten, 48, 48)
            thr = online_torch.quantile_threshold(sv, n, theta)
        (thr * w).sum().backward()
        grads.append((thr.detach(), theta.grad))
    (t_k, g_k), (t_p, g_p) = grads
    assert _same_bits(t_k, t_p)
    assert _same_bits(g_k, g_p)


def test_learn_tiny_golden_on_card(cuda):
    import json
    import os
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "learn_tiny.json")) as f:
        golden = json.load(f)["learn_tiny"]
    reset_launches()
    got = bench.run_learn_tiny(cuda)
    # one launch per training step and one for the hard evaluation
    assert LAUNCHES["gate_quantile"] == bench.LEARN_TINY["steps"] + 1
    assert got["families"] == golden["families"]
    for key, rtol, atol in (("loss_curve", 1e-3, 2e-4),
                            ("final_theta", 1e-3, 2e-3),
                            ("learned_savings_pct", 1e-4, 2e-3)):
        np.testing.assert_allclose(got[key], golden[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def test_gate_loss_backward_card_equals_cpu(cuda):
    """One training step's per-row gradients on the tiny run's inputs,
    card against CPU, at the gradient-parity tolerance."""
    from repro_torch.learn import LearnConfig
    from repro_torch.learn import train as ttrain
    from repro_torch.core.solvers.online_torch import stretch_budget

    raw = torch.tensor([[0.3, 0.0], [-0.4, 0.0]])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        batch, inten, cum, group, window = bench.learn_tiny_inputs(dev)
        inten = torch.as_tensor(inten, device=dev)
        cum = torch.as_tensor(cum, device=dev)
        ms0, bc = ttrain.greedy_reference(batch, cum, inten.shape[-1])
        B = inten.shape[0]
        g, aux = ttrain.per_row_grads(
            raw.to(dev), torch.as_tensor(group, device=dev),
            lambda rows: ttrain.per_row_loss(
                rows, torch.tensor(0.3, device=dev), batch, cum, inten,
                torch.as_tensor(window, device=dev), 48,
                torch.zeros_like(inten), stretch_budget(1.5, ms0),
                torch.clamp_min(bc, 1e-6),
                torch.clamp_min(ms0.to(torch.float32), 1.0),
                torch.tensor(1.0 / B, device=dev), LearnConfig(),
                inten.shape[-1]))
        out[dev.type] = (g.cpu(), [x.cpu() for x in aux])
    g_card, g_cpu = out["cuda"][0], out["cpu"][0]
    assert bool((g_cpu != 0).any())
    np.testing.assert_allclose(g_card.numpy(), g_cpu.numpy(),
                               rtol=LEARN_GRAD_RTOL,
                               atol=1e-6 * float(g_cpu.abs().max()))
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_cluster_plan_card_equals_cpu(cuda):
    """Seed 3's flagship cluster day on the CPU and on the card, both fed
    the CPU generator's draws: the same plan and the same three execution
    reports (ints equal, floats within rtol 1e-6); the plan and the
    failure's re-solve each reach the schedule_eval kernel in every
    phase-2 fitness."""
    from repro_torch.cluster.executor import PLAN_SA, RESOLVE_SA

    def host_draws(device):
        resolve = common.HostDraws(4, device)
        return lambda kind: common.HostDraws(3, device) if kind == "plan" \
            else resolve

    cpu = bench.cluster_day(3, "cpu", draws=host_draws("cpu"))
    reset_launches()
    card = bench.cluster_day(3, cuda, draws=host_draws(cuda))
    assert LAUNCHES["schedule_eval"] == sum(
        1 + c.iters + c.iters // c.migrate_every
        for c in (PLAN_SA, RESOLVE_SA))
    for f in ("start", "assign"):
        np.testing.assert_array_equal(card[f], cpu[f])
    assert card["plan"]["makespan"] == cpu["plan"]["makespan"]
    for run in ("clean", "failure", "straggler"):
        for k, v in cpu[run].items():
            if k.endswith("seconds"):
                continue
            if isinstance(v, int):
                assert card[run][k] == v, (run, k)
            else:
                np.testing.assert_allclose(card[run][k], v, rtol=1e-6,
                                           err_msg=f"{run} {k}")
    assert card["failure"]["n_resolves"] == 1


ROW_DRAW_KINDS = ("bits", "uniform", "bernoulli", "randint", "normal",
                  "gumbel")


def _row_draw(d, kind, shape):
    if kind == "bernoulli":
        return d.bernoulli(0.35, shape)
    if kind == "randint":
        return d.randint(0, 74, shape)
    return getattr(d, kind)(shape)


@pytest.mark.parametrize("kind", ROW_DRAW_KINDS)
def test_row_draws_on_card(cuda, kind):
    """``RowDraws`` on the card at the structure cell's SA shapes (cut to
    96 rows): rows 0:48 alone bitwise the same rows of the full draw; the
    integer path (bits, uniform, bernoulli, randint) bitwise the CPU's."""
    seeds = common.row_seeds(2024, 96)
    for shape in ((96, 24, 74), (96, 24, 74, 8)):
        full = _row_draw(common.RowDraws(seeds, cuda), kind, shape)
        half = _row_draw(common.RowDraws(seeds[:48], cuda), kind,
                         (48,) + shape[1:])
        assert _same_bits(full[:48], half)
        if kind in ("bits", "uniform", "bernoulli", "randint"):
            cpu = _row_draw(common.RowDraws(seeds, "cpu"), kind, shape)
            assert _same_bits(full.cpu(), cpu)


def test_sharded_entries_on_card(cuda):
    """Two and three shards on one card: the bound, the TINY sweep and
    the tiny training run equal the unsharded runs on the card."""
    from repro_torch import shard
    from repro_torch.learn import LearnConfig, train_gate
    from repro_torch.scenarios import build_batch, sweep_structure
    from repro_torch.shard.batch import tree_map

    spec = bench.structure_spec(tiny=True)
    sb = build_batch(spec, cuda)
    b = PackedInstance(*(f[:5] for f in sb.batch))
    seeds = common.row_seeds(3, 5)
    cfg = SAConfig(pop=16, iters=8, sweeps=1)
    kw = dict(objective="carbon", stretch=1.5, cfg1=cfg, cfg2=cfg)
    ref = solve_bilevel_batch(b, sb.cum[:5], common.RowDraws(seeds, cuda),
                              **kw)
    got = shard.bilevel_sharded(b, sb.cum[:5], seeds,
                                devices=[cuda] * 2, **kw)
    refs, gots = [], []
    tree_map(lambda x, y: (refs.append(x), gots.append(y)), ref, got)
    assert all(_same_bits(x, y) for x, y in zip(refs, gots))
    single, _ = sweep_structure(spec, offline=False, device=cuda)
    rows, _ = sweep_structure(spec, offline=False, devices=[cuda] * 3)
    assert rows == single
    batch, inten, cum, group, window = bench.learn_tiny_inputs(cuda)
    args = (batch, inten, cum, group, window, 1.5, [0.5, 0.5],
            LearnConfig(steps=5))
    one = train_gate(*args, device=cuda)
    two = shard.train_sharded(*args, devices=[cuda] * 2)
    assert all(_same_bits(x, y) for x, y in zip(one[:5], two[:5]))


# ---------------------------------------------------------------------------
# The train path: the model kernels' trainable entries (the kernel forward,
# autograd through the plain version backward) and a train step card vs
# CPU.
# ---------------------------------------------------------------------------

def _grads(fn, inputs, ct):
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    out.backward(ct)
    return out.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("H,KVH,Sq,Skv,causal,window,dtype", [
    (4, 2, 300, 300, True, 100, torch.bfloat16),     # causal, window
    (4, 2, 300, 300, True, 100, torch.float32),
    (4, 4, 200, 200, False, 0, torch.bfloat16),      # non-causal encoder
    (4, 2, 120, 300, False, 0, torch.bfloat16),      # cross, Sq != Skv
])
def test_flash_attention_trainable_on_card(cuda, H, KVH, Sq, Skv, causal,
                                           window, dtype):
    """The forward launches the kernel once and is allclose to the plain
    version (2e-5 / 2e-2, float32 / bf16); the gradients in q, k and v
    are autograd's through the plain version, at the same tolerance."""
    from repro_torch.kernels.ref import flash_attention_plain
    q, k, v = _flash_case(cuda, 2, H, KVH, Sq, Skv, 64, dtype, seed=5)
    ct = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(6)).to(dtype)
    reset_launches()
    out, got = _grads(lambda *a: ops.flash_attention_trainable(
        *a, causal=causal, window=window, block=128), (q, k, v), ct)
    torch.cuda.synchronize()
    assert LAUNCHES.get("flash_attention") == 1
    want_out, want = _grads(lambda *a: flash_attention_plain(
        *a, causal, window, 128), (q, k, v), ct)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol,
                               rtol=tol)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
    assert LAUNCHES.get("flash_attention") == 1


@pytest.mark.parametrize("S,H,P,G,N,chunk,dtype", [
    (300, 4, 100, 1, 16, 128, torch.bfloat16),
    (128, 4, 32, 2, 16, 32, torch.float32),
])
def test_ssd_scan_trainable_on_card(cuda, S, H, P, G, N, chunk, dtype):
    """The forward launches the kernel once and is allclose to the plain
    version (3e-4 / 3e-2); the gradients of y in x, dt, A, B and C are
    autograd's through ``ssd_chunked``, at the same tolerance."""
    from repro_torch.models.ssm import ssd_chunked
    args = _ssd_case(cuda, 2, S, H, P, G, N, dtype, seed=7)
    ct = torch.randn(args[0].shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(8)).to(dtype)
    reset_launches()
    y, got = _grads(lambda *a: ops.ssd_scan_trainable(*a, chunk=chunk)[0],
                    args, ct)
    torch.cuda.synchronize()
    assert LAUNCHES.get("ssd_scan") == 1
    yw, want = _grads(lambda *a: ssd_chunked(*a, chunk)[0], args, ct)
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(y.float(), yw.float(), atol=tol, rtol=tol)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


def test_reduced_hymba_train_step_card_equals_cpu(cuda):
    """The reduced hybrid's loss and gradients on the card (the kernels
    forward, under full remat) against the same weights and batch on the
    CPU: the loss within 3e-2, every gradient leaf within relative
    Frobenius 5e-2; each kernel launched twice a layer."""
    from repro_torch import configs
    from repro_torch.models.api import build_model
    from repro_torch.models.common import materialize
    from repro_torch.models.parallel import ParallelCfg
    cfg = configs.get("hymba-1.5b").reduced()
    par = ParallelCfg(remat="full")
    card = build_model(cfg, cuda, seed=1, par=par)
    cpu = build_model(cfg, "cpu", seed=1, par=par)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = materialize(cfg, "train_4k", seq=128, device="cpu")
    reset_launches()
    lg, gg = card.loss({k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert LAUNCHES.get("flash_attention") == LAUNCHES.get("ssd_scan") == \
        2 * cfg.n_layers
    lc, gc = cpu.loss(batch)
    assert abs(float(lg) - float(lc)) <= 3e-2
    for k, g in gg.items():
        err = float((g.cpu() - gc[k]).norm() / gc[k].norm())
        assert err <= 5e-2, (k, err)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-moe-30b-a3b",
                                  "whisper-base"])
def test_dry_run_counts_equal_the_card(cuda, arch):
    """One train step of a reduced config counted by ``launch.op_analysis``
    on ``meta`` and on the card: FLOPs and bytes equal, op by op (ops that
    move no byte aside); the card's step launched the model kernels."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.common import ShapeCfg
    cfg = configs.get(arch).reduced()
    sc = ShapeCfg("train_4k", "train", 128, 2)
    policy = dryrun.cell_policy(cfg, sc, MeshShape.card(), {})
    meta = dryrun.count_cell(dryrun.build_cell(cfg, sc, policy))
    reset_launches()
    card = dryrun.count_cell(dryrun.build_cell(cfg, sc, policy, cuda))
    torch.cuda.synchronize()
    assert LAUNCHES.get("flash_attention", 0) > 0

    def costly(ops):
        return {k: v for k, v in ops.items() if v[1] or v[2]}
    assert costly(meta[2].ops) == costly(card[2].ops)
    assert meta[0] == card[0]
    assert meta[1]["argument_bytes"] == card[1]["argument_bytes"]


def test_probe_record_provenance(cuda, tmp_path):
    """The perf probe on the card: four cells timed, roofline columns
    finite, and a written record passes ``perf_gate.check_provenance``
    with the card's name, count and power limit."""
    import json
    import math
    from repro_torch import perf, perf_gate
    probe = perf.perf_probe(device=cuda)
    assert set(probe["cells"]) == set(perf.PROBE_CELLS)
    for c in probe["cells"].values():
        assert c["warm_s_min"] > 0
        assert all(math.isfinite(v) for v in c["roofline"].values()
                   if isinstance(v, float))
    path = perf.write_json(str(tmp_path / "probe.json"),
                           {"bench": "t", "timing": {"wall_s": 0.0,
                                                     "probe": probe}}, cuda)
    assert perf_gate.check_provenance([path]) == []
    prov = json.load(open(path))["provenance"]
    assert prov["backend"] == "cuda"
    assert prov["device_kind"] == torch.cuda.get_device_name(0)
    assert prov["device_count"] == torch.cuda.device_count()
    assert prov["power_limit"].endswith("W")


# ---------------------------------------------------------------------------
# The model over a placed mesh: a 1 x 2 fleet of gloo ranks on the card.
# ---------------------------------------------------------------------------

MESH_PAYLOAD = r"""
import json, sys
import numpy as np
import torch
from repro_torch import configs, shard
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import make_parallel
from repro_torch.models.api import build_model

shard.initialize_from_env(initialization_timeout=300)
cfg = configs.get("hymba-1.5b").reduced()
mesh = ProcessMesh.build(MeshShape.parse("data=1,model=2"))
par = make_parallel(cfg, mesh, remat="none")
model = build_model(cfg, "cpu", seed=1, par=par).to(mesh.device)
toks = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab_size, (1, 91))).to(mesh.device)
reset_launches()
logits, caches = model.prefill({"tokens": toks[:, :90]})
torch.cuda.synchronize()
launches = dict(LAUNCHES)
dlogits, _ = model.decode({"token": toks[:, 90:],
                           "pos": torch.tensor(90, device=mesh.device),
                           **caches})
loss, _ = model.loss({"tokens": toks[:, :64], "labels": toks[:, 1:65]})
print(json.dumps({"device": str(mesh.device), "launches": launches,
                  "prefill": logits.cpu().tolist(),
                  "decode": dlogits.cpu().tolist(), "loss": float(loss)}))
"""


def test_reduced_hymba_on_a_1x2_fleet_on_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card, each holding half of reduced
    hymba's heads (attention and SSM), MLP and vocabulary: the prefill,
    one decode step and the loss against one process on the CPU (the
    plain versions) at 3e-2, each rank launching both kernels once per
    layer in the prefill."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from repro_torch import configs
    from repro_torch.models.api import build_model
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank.py"
    script.write_text(MESH_PAYLOAD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 REPRO_COORDINATOR=f"127.0.0.1:{port}",
                 REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(r)))
        for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    cfg = configs.get("hymba-1.5b").reduced()
    cpu = build_model(cfg, "cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 91)))
    lc, cc = cpu.prefill({"tokens": toks[:, :90]})
    dc, _ = cpu.decode({"token": toks[:, 90:], "pos": torch.tensor(90),
                        **cc})
    loss, _ = cpu.loss({"tokens": toks[:, :64], "labels": toks[:, 1:65]})
    for r in ranks:
        assert r["device"] == "cuda:0"
        assert r["launches"].get("flash_attention") == cfg.n_layers
        assert r["launches"].get("ssd_scan") == cfg.n_layers
        torch.testing.assert_close(torch.tensor(r["prefill"]), lc,
                                   atol=3e-2, rtol=3e-2)
        torch.testing.assert_close(torch.tensor(r["decode"]), dc,
                                   atol=3e-2, rtol=3e-2)
        assert abs(r["loss"] - float(loss)) <= 3e-2
