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


@pytest.mark.parametrize("shape", [(1000, 96, 40, 1500, 0, 1400),
                                   (7, 13, 37, 333, 0, 300),
                                   (1, 1, 1, 1, -5, 5),
                                   (5, 9, 11, 100, -150, 260)])
def test_schedule_delta_bitwise(cuda, shape):
    start, dur, cum = _case(cuda, *shape)
    reset_launches()
    out = schedule_delta(start, dur, cum)
    torch.cuda.synchronize()
    assert LAUNCHES["schedule_eval"] == 1
    assert torch.equal(out, schedule_delta_ref(start, dur, cum))


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

    class Moved:
        def __init__(self, device):
            self.src, self.device = TorchDraws(1, "cpu"), device

        def __getattr__(self, kind):
            fn = getattr(self.src, kind)
            return lambda *a: fn(*a).to(self.device)

    out = {}
    for dev in ("cpu", cuda):
        b = PackedInstance(*(f.to(dev) for f in batch))
        reset_launches()
        r = solve_bilevel_batch(b, cum.to(dev), Moved(dev), stretch=1.5,
                                cfg1=cfg)
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
    window 1, E < window)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
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


@pytest.mark.parametrize("shape", ["main", "ragged", "edge"])
def test_gate_quantile_bitwise(cuda, shape):
    inten, theta, window, max_window = _gate_case(cuda, shape)
    reset_launches()
    got = gate_quantile_stats(inten, theta, window, max_window)
    torch.cuda.synchronize()
    assert LAUNCHES["gate_quantile"] == 1
    want = gate_quantile_stats_ref(inten, theta, window, max_window)
    for name, x, y in zip("abn", got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name


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
