"""Guards on the port's boundaries.

* The port (``src/repro_torch``) and ``chip_smoke.py`` import neither
  ``jax`` nor anything of the reference package ``repro``: the card's
  machine has no JAX, and the port keeps its own copies.
* Entry points run on the card unless asked for the CPU: without a card,
  calling one with no ``device`` raises instead of running on the CPU.
* A kernel's built library is named by its source, the shared headers and
  the flags, so editing any of them rebuilds it.
* The kernels are forward-only: each entry refuses an input that requires
  grad, on every device, while ``ops.gate_threshold`` keeps theta's
  gradient through its lerp.
"""
import ast
import pathlib

import pytest
import torch

from repro_torch import bench, configs
from repro_torch.core.solvers import TorchDraws, online_torch
from repro_torch.core.solvers.rolling import solve_mpc_batch
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gate_quantile import gate_quantile_stats
from repro_torch.kernels.schedule_eval import schedule_delta
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.learn import LearnConfig, evaluate_theta, train_gate
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.scenarios import sweep_structure
from repro_torch.serve import ServeEngine
from repro_torch.stream import StreamConfig, StreamEngine, simulate_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"decoder.py", "annealing.py", "bilevel.py", "schedule_eval.py",
            "online.py", "online_torch.py", "gate_quantile.py",
            "bench.py", "chip_smoke.py", "attention.py", "ssm.py",
            "engine.py", "flash_attention.py", "ssd_scan.py", "api.py",
            "convert.py", "serve.py", "exact.py", "models.py", "rolling.py",
            "families.py", "fleets.py", "generator.py", "batching.py",
            "sweep.py", "moe.py", "common.py"} <= names
    port = ROOT / "src" / "repro_torch"
    assert {port / "core" / "solvers" / "rolling.py",
            port / "forecast" / "rolling.py",
            port / "forecast" / "models.py",
            port / "stream" / "__init__.py",
            port / "stream" / "arrivals.py",
            port / "stream" / "engine.py",
            port / "learn" / "__init__.py",
            port / "learn" / "relax.py",
            port / "learn" / "loss.py",
            port / "learn" / "train.py",
            port / "optim" / "__init__.py",
            port / "optim" / "adamw.py",
            port / "cluster" / "__init__.py",
            port / "cluster" / "energy_model.py",
            port / "cluster" / "workloads.py",
            port / "cluster" / "executor.py",
            port / "shard" / "__init__.py",
            port / "shard" / "batch.py",
            port / "shard" / "distributed.py",
            port / "shard" / "dispatch.py",
            port / "shard" / "sweep.py",
            port / "shard" / "train.py",
            port / "models" / "moe.py",
            port / "models" / "common.py",
            port / "launch" / "serve.py",
            port / "launch" / "train.py",
            port / "optim" / "compress.py",
            port / "data" / "__init__.py",
            port / "data" / "pipeline.py",
            port / "checkpoint" / "__init__.py",
            port / "checkpoint" / "manager.py",
            port / "train" / "__init__.py",
            port / "train" / "loop.py"} <= set(PORT_FILES)
    assert {port / "configs" / f"{m.__name__.rsplit('.', 1)[1]}.py"
            for m in configs._MODULES} <= set(PORT_FILES)
    assert len(configs._MODULES) == 10
    assert _forbidden("jax.numpy") and _forbidden("repro.core")
    assert not _forbidden("repro_torch.core")


def test_run_batch_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_batch(bench.BenchSetup(instances=1))


def test_sweep_policies_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    batch, _ = bench.paper_batch(bench.BenchSetup(instances=2), "cpu")
    inten = torch.full((2, 16), 100.0)
    with pytest.raises(RuntimeError, match="cuda"):
        online_torch.sweep_policies(batch, inten, [0.5], [8], [1.5])


def test_solve_mpc_batch_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    batch, cum = bench.paper_batch(bench.BenchSetup(instances=2), "cpu")
    truth = torch.full((2, cum.shape[-1] - 1), 100.0)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_mpc_batch(batch, truth, cum, TorchDraws(0, "cpu"),
                        torch.zeros((1, 4, truth.shape[-1])), 0.5)


def test_sweep_structure_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        sweep_structure(bench.structure_spec(tiny=True), offline=False)


def test_forecast_cell_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_forecast(bench.ForecastSetup(instances=1))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--only", "forecast", "--instances", "1"])


def test_build_model_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(configs.get("hymba-1.5b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({}, configs.get("hymba-1.5b").reduced())


def test_materialize_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.models.common import materialize
    with pytest.raises(RuntimeError, match="cuda"):
        materialize(configs.get("whisper-base").reduced(), "prefill_32k")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(configs.get("qwen3-moe-30b-a3b").reduced())


def test_serve_engine_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = build_model(configs.get("qwen1.5-0.5b").reduced(), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(model)


def test_stream_engine_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core.carbon import constant
    with pytest.raises(RuntimeError, match="cuda"):
        StreamEngine(constant(100.0, 64), (1.0,), (1.0,), 2, 2)


def test_simulate_stream_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_stream(StreamConfig(horizon=32, n_lanes=2))


def test_stream_bench_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_stream(tiny=True)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--only", "stream", "--instances", "16"])


def test_cluster_executor_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import numpy as np
    from repro_torch.cluster import ClusterExecutor
    batch, cum = bench.paper_batch(bench.BenchSetup(instances=1), "cpu")
    inst = type(batch)(*(f[0] for f in batch))
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterExecutor(inst, cum[0].numpy().astype(np.float64))
    ClusterExecutor(inst, cum[0], device="cpu")


def test_cluster_bench_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_cluster(1)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.cluster_day(3)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--only", "cluster", "--instances", "1"])


def test_shard_entries_without_devices_want_the_card():
    """Every sharded entry with ``devices=None`` shards over the local
    cards, and raises without one; so does the bench's front door."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import numpy as np
    from repro_torch import shard
    batch, cum = bench.paper_batch(bench.BenchSetup(instances=2), "cpu")
    inten = torch.full((2, cum.shape[-1] - 1), 100.0)
    calls = [
        lambda: shard.instance_devices(),
        lambda: shard.run_rows_sharded(lambda x: x, (inten,)),
        lambda: shard.dispatch_sharded(batch, inten, [0.5], [8], [1.5]),
        lambda: shard.bilevel_sharded(batch, cum, np.zeros(2, np.uint64)),
        lambda: shard.greedy_sharded(batch, cum, inten.shape[-1]),
        lambda: shard.train_sharded(batch, inten, cum, [0, 1], [8, 8], 1.5,
                                    [0.5, 0.5], LearnConfig(steps=1)),
        lambda: shard.eval_theta_sharded(batch, inten, cum, [0.5, 0.5],
                                         [8, 8], 1.5),
        lambda: shard.sweep_sharded(bench.structure_spec(tiny=True),
                                    offline=False),
        lambda: sweep_structure(bench.structure_spec(tiny=True),
                                offline=False, processes=1),
        lambda: bench.main(["--only", "structure", "--devices", "2"]),
        lambda: bench.main(["--only", "learned_gate", "--processes", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """Editing, adding or removing a csrc/*.cuh header, or changing the
    flags, gives the kernel's library a new name: no stale build loads."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first            # stable
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "extra.cuh").write_text("// new\n")
    third = build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "extra.cuh").unlink()
    assert build.library_path("k") == second
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != second


def _learn_inputs():
    batch, cum = bench.paper_batch(bench.BenchSetup(instances=2), "cpu")
    inten = torch.full((2, cum.shape[-1] - 1), 100.0)
    return batch, inten, cum, [0, 1], [8, 8]


def test_train_gate_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    batch, inten, cum, group, window = _learn_inputs()
    with pytest.raises(RuntimeError, match="cuda"):
        train_gate(batch, inten, cum, group, window, 1.5, [0.5, 0.5],
                   LearnConfig(steps=1))


def test_evaluate_theta_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    batch, inten, cum, _, window = _learn_inputs()
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_theta(batch, inten, cum, [0.5, 0.5], window, 1.5)


def test_learned_gate_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        sweep_structure(bench.structure_spec(tiny=True), offline=False,
                        learn=LearnConfig(steps=1))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.run_learned_gate(bench.structure_spec(tiny=True), steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--only", "learned_gate", "--instances", "1"])


def _kernel_calls():
    """Each kernel entry with small CPU inputs, as (name, fn, inputs)."""
    g = torch.Generator().manual_seed(0)
    rows = torch.rand((2, 16), generator=g)
    gate = (rows, torch.full((2, 16), 0.5), torch.tensor([4, 8],
                                                          dtype=torch.int32))
    start = torch.zeros((1, 2, 3), dtype=torch.int32)
    q = torch.rand((1, 2, 8, 32), generator=g)
    kv = torch.rand((1, 1, 8, 32), generator=g)
    x = torch.rand((1, 8, 2, 4), generator=g)
    dt = torch.rand((1, 8, 2), generator=g)
    A = -torch.rand(2, generator=g)
    bc = torch.rand((1, 8, 1, 4), generator=g)
    return [
        ("gate_quantile", lambda a, t, w: gate_quantile_stats(a, t, w, 8),
         list(gate), (0, 1)),
        ("schedule_eval", schedule_delta,
         [start, start + 1, torch.rand((1, 10), generator=g)], (2,)),
        ("flash_attention", flash_attention, [q, kv, kv.clone()], (0, 1, 2)),
        ("ssd_scan", lambda *a: ssd_scan(*a, chunk=4),
         [x, dt, A, bc, bc.clone()], (0, 1, 2, 3, 4)),
    ]


@pytest.mark.parametrize("case", range(4),
                         ids=["gate_quantile", "schedule_eval",
                              "flash_attention", "ssd_scan"])
def test_kernel_entries_refuse_inputs_that_require_grad(case):
    """On the card a kernel's output has no autograd history, so every
    entry raises where a gradient would be lost, on the CPU alike; under
    no_grad the same inputs run."""
    name, fn, inputs, float_args = _kernel_calls()[case]
    fn(*inputs)
    for i in float_args:
        args = list(inputs)
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match=f"{name}: the kernel is "
                           "forward-only"):
            fn(*args)
        with torch.no_grad():
            fn(*args)


def test_gate_threshold_keeps_theta_gradient():
    """``ops.gate_threshold`` detaches theta for the selection and keeps
    it live in the lerp: its gradient is the plain path's, bitwise."""
    g = torch.Generator().manual_seed(1)
    inten = torch.rand((3, 40), generator=g) * 100
    theta = torch.rand((3, 40), generator=g).requires_grad_(True)
    w = torch.rand((3, 40), generator=g)
    (ops.gate_threshold(inten, theta, 12, 12) * w).sum().backward()
    got = theta.grad.clone()
    theta.grad = None
    sv, n = online_torch.sorted_windows(inten, 12, 12)
    (online_torch.quantile_threshold(sv, n, theta) * w).sum().backward()
    assert torch.equal(got.view(torch.int32), theta.grad.view(torch.int32))
    assert bool((got != 0).any())
