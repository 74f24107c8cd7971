"""The ``timing_sweep`` kernel's wrapper on the CPU.

The kernel itself runs only on the card (``test_torch_gpu.py`` holds it
bitwise to the plain version there); here: the wrapper's checks, its
``meta`` branch, the row layout it hands the kernel, its byte count against
the benchmark's, and that a CPU call runs the plain version and launches
nothing.  The plain version is held to the JAX reference in
``test_torch_decoder.py``.
"""
import importlib.util
import pathlib

import pytest
import torch

from repro_torch import bench
from repro_torch.core import decoder
from repro_torch.core.instance import PackedInstance
from repro_torch.core.solvers import TorchDraws, common
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import timing_sweep as tsk

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(R=12, T=7, M=3, H=50, G=3, device="cpu"):
    """Laid-out inputs of ``R`` rows over ``G`` instances and cum rows."""
    z = dict(device=device)
    return dict(start=torch.zeros((R, T), dtype=torch.int32, **z),
                assign=torch.zeros((R, T), dtype=torch.int32, **z),
                dur=torch.ones((G, T, M), dtype=torch.int32, **z),
                pred=torch.zeros((G, T, T), dtype=torch.bool, **z),
                task_mask=torch.ones((G, T), dtype=torch.bool, **z),
                cum=torch.zeros((G, H + 1), **z),
                deadline=torch.full((G,), 30, dtype=torch.int32, **z),
                frozen=None)


def _bad(kind):
    a = _rows()
    if kind == "start_dtype":
        a["start"] = a["start"].long()
    elif kind == "assign_dtype":
        a["assign"] = a["assign"].long()
    elif kind == "cum_dtype":
        a["cum"] = a["cum"].double()
    elif kind == "pred_dtype":
        a["pred"] = a["pred"].to(torch.uint8)
    elif kind == "deadline_dtype":
        a["deadline"] = a["deadline"].long()
    elif kind == "frozen_dtype":
        a["frozen"] = torch.zeros((3, 7), dtype=torch.int32)
    elif kind == "start_rank":
        a["start"] = a["start"].reshape(3, 4, 7)
    elif kind == "assign_shape":
        a["assign"] = a["assign"][:, :6]
    elif kind == "dur_tasks":
        a["dur"] = a["dur"][:, :6]
    elif kind == "pred_shape":
        a["pred"] = a["pred"][:2]
    elif kind == "cum_rank":
        a["cum"] = a["cum"][0]
    elif kind == "groups":
        a["deadline"] = a["deadline"][:1].repeat(5)
    elif kind == "nesting":
        a["dur"], a["pred"], a["task_mask"] = (a["dur"][:2], a["pred"][:2],
                                               a["task_mask"][:2])
    elif kind == "frozen_shape":
        a["frozen"] = torch.zeros((3, 6), dtype=torch.bool)
    elif kind == "device":
        a["cum"] = a["cum"].to("meta")
    elif kind == "start_contiguous":
        a["start"] = torch.zeros((7, 12), dtype=torch.int32).t()
    elif kind == "cum_contiguous":
        a["cum"] = torch.zeros((51, 3)).t()
    elif kind == "grad":
        a["cum"] = a["cum"].requires_grad_(True)
    return a


BAD = {"start_dtype": TypeError, "assign_dtype": TypeError,
       "cum_dtype": TypeError, "pred_dtype": TypeError,
       "deadline_dtype": TypeError, "frozen_dtype": TypeError,
       "start_rank": ValueError, "assign_shape": ValueError,
       "dur_tasks": ValueError, "pred_shape": ValueError,
       "cum_rank": ValueError, "groups": ValueError, "nesting": ValueError,
       "frozen_shape": ValueError, "device": ValueError,
       "start_contiguous": ValueError, "cum_contiguous": ValueError,
       "grad": ValueError}


@pytest.mark.parametrize("kind", sorted(BAD))
def test_sweep_rows_rejects_bad_inputs(kind):
    a = _bad(kind)
    with pytest.raises(BAD[kind]):
        tsk.sweep_rows(**a, sweeps=2)


def test_sweep_rows_has_no_cpu_path():
    """On CPU tensors the wrapper raises: the plain version runs there
    through ``decoder.timing_sweep``."""
    with pytest.raises(ValueError, match="plain version"):
        tsk.sweep_rows(**_rows(), sweeps=2)


@pytest.mark.parametrize("deadline", ["int", "tensor"])
def test_sweep_rows_meta_gives_shape_and_dtype(deadline):
    a = {k: v if v is None else v.to("meta") for k, v in _rows().items()}
    if deadline == "int":
        a["deadline"] = 1 << 27
    reset_launches()
    out = tsk.sweep_rows(**a, sweeps=2)
    assert (out.device.type, out.dtype, tuple(out.shape)) == \
        ("meta", torch.int32, (12, 7))
    assert LAUNCHES.get("timing_sweep", 0) == 0


def _case(instances=4, cand=(5,), seed=0):
    batch, cum = bench.paper_batch(
        bench.BenchSetup(n_jobs=3, k_tasks=3, n_machines=3,
                         instances=instances), "cpu")
    draws = TorchDraws(seed, "cpu")
    prio = draws.normal(batch.lead + cand + (batch.T,))
    assign = common.random_allowed_assign(draws, batch, cand)
    dec = decoder.sgs(batch, prio, assign, "fixed")
    return batch, cum, dec


@pytest.mark.parametrize("lead", ["instance", "batch", "nested"])
def test_decoder_meta_sweep_gives_shape(lead):
    batch, cum, dec = _case(cand=(2, 3))
    start, assign = dec.start, dec.assign
    if lead == "instance":
        batch = PackedInstance(*(f[0] for f in batch))
        cum, start, assign = cum[0], start[0, 0], assign[0, 0]
    elif lead == "batch":
        start, assign = start[:, 0, 0], assign[:, 0, 0]
    meta = PackedInstance(*(f.to("meta") for f in batch))
    out = decoder.timing_sweep(meta, start.to("meta"), assign.to("meta"),
                               cum.to("meta"), 90, 2,
                               frozen=batch.task_mask.to("meta"))
    assert (out.device.type, out.dtype, out.shape) == \
        ("meta", torch.int32, start.shape)


@pytest.mark.parametrize("frozen", [False, True])
def test_cpu_sweep_runs_the_plain_version_and_launches_nothing(frozen):
    batch, cum, dec = _case()
    fz = batch.task_mask & (torch.arange(batch.T) < 3) if frozen else None
    deadline = torch.full(batch.lead, 120, dtype=torch.int32)
    reset_launches()
    got = decoder.timing_sweep(batch, dec.start, dec.assign, cum, deadline,
                               2, frozen=fz)
    assert LAUNCHES.get("timing_sweep", 0) == 0
    want = decoder.timing_sweep_plain(batch, dec.start, dec.assign, cum,
                                      deadline, 2, frozen=fz)
    assert torch.equal(got, want)


def test_row_layout_lines_up_every_group():
    """Each per-instance tensor is laid out over its own leading axes
    (size-1 axes expanded), so row ``r`` reads group ``r // (R // G)``."""
    lead = (2, 3, 5)
    x = torch.arange(3 * 4).reshape(1, 3, 4)        # lead (1, 3), trail 4
    got = tsk._groups(x, lead, 1)
    assert got.shape == (6, 4) and got.is_contiguous()
    rows = torch.arange(30).reshape(lead)
    full = x[:, :, None].expand(2, 3, 5, 4).reshape(30, 4)
    for r in rows.reshape(-1).tolist():
        assert torch.equal(got[r // (30 // 6)], full[r])
    scalar = tsk._groups(torch.tensor(7), lead, 0)
    assert scalar.shape == (1,)
    inst = tsk._groups(torch.zeros(2, 4, 4), lead, 2, axes=2)
    assert inst.shape == (6, 4, 4)


def test_int32_wraps_as_torch():
    for x in (0, 7, 1 << 27, 2**31, 2**32 + 5, -(2**31) - 1, -3):
        assert tsk._int32(x) == torch.as_tensor(x).to(torch.int32).item()


def _benchmark_sweep_bytes():
    path = ROOT / "portbench" / "metrics" / "timing_sweep_roofline.bound.py"
    spec = importlib.util.spec_from_file_location("_sweep_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.sweep_bytes


@pytest.mark.parametrize("shape", [(250, 96, 40, 1500), (16, 24, 45, 400)])
def test_cost_equals_the_benchmarks_byte_count(shape):
    B, P, T, H = shape
    meta = dict(device="meta")
    start = torch.empty((B * P, T), dtype=torch.int32, **meta)
    pred = torch.empty((B, T, T), dtype=torch.bool, **meta)
    cum = torch.empty((B, H + 1), **meta)
    deadline = torch.empty((B,), dtype=torch.int32, **meta)
    flops, nbytes = tsk.cost(start, pred, cum, deadline)
    assert flops == 0
    assert nbytes == _benchmark_sweep_bytes()(B, P, T, H)
    if shape == (250, 96, 40, 1500):
        assert nbytes == 17_262_000
