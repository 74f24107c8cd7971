"""``timing_sweep``: the carbon timing sweep of candidate schedules, every
sweep of every row in one launch of the hand-written CUDA kernel
``csrc/timing_sweep.cu`` (its header gives the design and the bound).

It replaces no TPU kernel: the reference's sweep is plain ``jnp`` under
``lax.scan``.  It was added because the port's plain version,
:func:`repro_torch.core.decoder.timing_sweep_plain`, scores all ``H + 1``
starts of every row at each of its ``T x sweeps`` Python steps, and the
kernel scans only each task's slack window.  The two agree bitwise.

:func:`timing_sweep` takes the decoder's arguments (an instance with
leading axes ``L``, candidates ``[*lead, T]`` with ``L`` a prefix of
``lead``; ``cum``, ``deadline`` and ``frozen`` lined up the same way) and
lays them out as rows for :func:`sweep_rows`: each per-instance tensor
becomes one contiguous ``[G, ...]`` tensor over its own leading axes, and
row ``r`` of the ``R`` rows reads its group ``r // (R // G)``.
:func:`sweep_rows` checks the laid-out tensors, launches the kernel on
CUDA tensors and returns the output's shape and dtype on ``meta``; it has
no CPU path (``decoder.timing_sweep`` runs the plain version there).
:func:`cost` is the call's bytes, as the benchmark's
``timing_sweep_roofline`` reader counts them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.instance import PackedInstance, bcast_lead
from repro_torch.kernels import build, cost as kcost

NAME = "timing_sweep"


def _int32(x: int) -> int:
    """``x`` wrapped to int32, as ``torch.as_tensor(x).to(torch.int32)``."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _groups(x: torch.Tensor, lead: tuple[int, ...], trailing: int,
            axes: int | None = None) -> torch.Tensor:
    """``x`` (``axes`` leading axes, all but ``trailing`` by default, a
    prefix of ``lead`` as ``bcast_lead`` takes it) as one contiguous
    ``[G, *trail]`` tensor, ``G`` the product of those axes of ``lead``."""
    nd = x.ndim - trailing if axes is None else axes
    own = tuple(lead[:nd])
    x = bcast_lead(x, own, trailing)
    return x.reshape((math.prod(own),) + tuple(x.shape[nd:])).contiguous()


def _check(start: torch.Tensor, assign: torch.Tensor, dur: torch.Tensor,
           pred: torch.Tensor, task_mask: torch.Tensor, cum: torch.Tensor,
           deadline: torch.Tensor | int,
           frozen: torch.Tensor | None) -> None:
    ints = {"start": start, "assign": assign, "dur": dur}
    bools = {"pred": pred, "task_mask": task_mask}
    if isinstance(deadline, torch.Tensor):
        ints["deadline"] = deadline
    if frozen is not None:
        bools["frozen"] = frozen
    for name, x in ints.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    for name, x in bools.items():
        if x.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {x.dtype}")
    if cum.dtype != torch.float32:
        raise TypeError(f"cum must be float32, got {cum.dtype}")
    if start.ndim != 2 or assign.shape != start.shape:
        raise ValueError(f"start/assign must be one [R, T] shape, got "
                         f"{tuple(start.shape)}/{tuple(assign.shape)}")
    R, T = start.shape
    if dur.ndim != 3 or dur.shape[1] != T or dur.shape[2] < 1:
        raise ValueError(f"dur must be [G, T, M] with T={T}, M >= 1, got "
                         f"{tuple(dur.shape)}")
    G = dur.shape[0]
    for name, x, want in (("pred", pred, (G, T, T)),
                          ("task_mask", task_mask, (G, T))):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got "
                             f"{tuple(x.shape)}")
    if cum.ndim != 2 or cum.shape[1] < 1:
        raise ValueError(f"cum must be [Gc, H+1] with H+1 >= 1, got "
                         f"{tuple(cum.shape)}")
    groups = {"instance": G, "cum": cum.shape[0]}
    if isinstance(deadline, torch.Tensor):
        if deadline.ndim != 1:
            raise ValueError(f"deadline must be [Gd], got "
                             f"{tuple(deadline.shape)}")
        groups["deadline"] = deadline.shape[0]
    if frozen is not None:
        if frozen.ndim != 2 or frozen.shape[1] != T:
            raise ValueError(f"frozen must be [Gf, T] with T={T}, got "
                             f"{tuple(frozen.shape)}")
        groups["frozen"] = frozen.shape[0]
    if R:
        for name, g in groups.items():
            if g < 1 or R % g:
                raise ValueError(f"{R} rows do not split into {g} "
                                 f"{name} groups")
        gi, gc = R // G, R // groups["cum"]
        if gi % gc and gc % gi:
            raise ValueError(f"rows an instance ({gi}) and rows a cum row "
                             f"({gc}) must divide one another")
    tensors = {**ints, **bools, "cum": cum}
    if len({x.device for x in tensors.values()}) != 1:
        raise ValueError("every tensor must lie on one device")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    build.refuse_grad(NAME, cum=cum)


def cost(start: torch.Tensor, pred: torch.Tensor, cum: torch.Tensor,
         deadline: torch.Tensor | int) -> tuple[int, int]:
    """``(flops, bytes)`` of one call, laid out as :func:`sweep_rows`
    takes it: read once, the starts, servers and durations (``[R, T]``
    int32 each), ``pred``, ``cum`` and the deadline; written once, the new
    starts.  The operations scale with the slack in the data and are not
    counted."""
    n = start.numel()
    dl = deadline.numel() * 4 if isinstance(deadline, torch.Tensor) else 0
    return 0, 3 * n * 4 + cum.numel() * 4 + pred.numel() + dl + n * 4


def _launch(start, assign, dur, pred, task_mask, cum, deadline, frozen,
            sweeps: int) -> torch.Tensor:
    R, T = start.shape
    H = cum.shape[1] - 1
    if T >= 2**31 or H >= 2**31 - 1 or dur.shape[2] >= 2**31:
        raise ValueError("timing_sweep: sizes exceed the kernel's int range")
    lib = build.load(NAME)
    fn = lib.timing_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(start)
    scalar = isinstance(deadline, int)
    per_deadline = R if scalar else R // deadline.shape[0]
    per_frozen = R if frozen is None else R // frozen.shape[0]
    stream = torch.cuda.current_stream(start.device).cuda_stream
    err = fn(start.data_ptr(), assign.data_ptr(), out.data_ptr(),
             dur.data_ptr(), pred.data_ptr(), task_mask.data_ptr(),
             cum.data_ptr(), None if scalar else deadline.data_ptr(),
             None if frozen is None else frozen.data_ptr(), R, T,
             dur.shape[2], H, R // dur.shape[0], R // cum.shape[0],
             per_deadline, per_frozen,
             _int32(deadline) if scalar else 0, sweeps, stream)
    if err != 0:
        raise RuntimeError(f"timing_sweep kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(NAME)
    return out


def _run(start, assign, dur, pred, task_mask, cum, deadline, frozen,
         sweeps: int) -> torch.Tensor:
    if start.device.type == "meta":
        return torch.empty_like(start)
    return _launch(start, assign, dur, pred, task_mask, cum, deadline,
                   frozen, sweeps)


def sweep_rows(start: torch.Tensor, assign: torch.Tensor, dur: torch.Tensor,
               pred: torch.Tensor, task_mask: torch.Tensor,
               cum: torch.Tensor, deadline: torch.Tensor | int,
               frozen: torch.Tensor | None = None,
               sweeps: int = 2) -> torch.Tensor:
    """The sweep of ``R`` rows laid out: start/assign ``[R, T]`` int32,
    dur ``[Gi, T, M]`` int32, pred ``[Gi, T, T]`` and task_mask ``[Gi, T]``
    bool, cum ``[Gc, H+1]`` float32, deadline an int or ``[Gd]`` int32,
    frozen ``[Gf, T]`` bool or None; every ``G`` divides ``R``, all
    contiguous on one device.  Returns the new starts ``[R, T]`` int32:
    one launch on CUDA tensors, the shape and dtype on ``meta``; other
    devices raise."""
    _check(start, assign, dur, pred, task_mask, cum, deadline, frozen)
    if start.device.type not in ("cuda", "meta"):
        raise ValueError(f"timing_sweep: no kernel for device {start.device}"
                         "; decoder.timing_sweep runs the plain version on "
                         "the CPU")
    if start.numel() == 0:
        return start.clone()
    args = (start, assign, dur, pred, task_mask, cum, deadline, frozen,
            sweeps)
    if kcost.ACTIVE:
        return kcost.counted(NAME, lambda: cost(start, pred, cum, deadline),
                             _run, *args)
    return _run(*args)


def timing_sweep(inst: PackedInstance, start: torch.Tensor,
                 assign: torch.Tensor, cum: torch.Tensor,
                 deadline: torch.Tensor | int, sweeps: int = 2,
                 frozen: torch.Tensor | None = None) -> torch.Tensor:
    """``decoder.timing_sweep``'s arguments laid out as rows for
    :func:`sweep_rows`; returns the new starts ``[*lead, T]``."""
    lead = tuple(start.shape[:-1])
    T = start.shape[-1]
    nd = len(inst.lead)
    if not isinstance(deadline, int):
        deadline = _groups(torch.as_tensor(deadline, device=start.device)
                           .to(torch.int32), lead, 0)
    out = sweep_rows(
        start.reshape(-1, T).contiguous(), assign.reshape(-1, T).contiguous(),
        _groups(inst.dur, lead, 2, nd), _groups(inst.pred, lead, 2, nd),
        _groups(inst.task_mask, lead, 1, nd), _groups(cum, lead, 1),
        deadline, None if frozen is None else _groups(frozen, lead, 1),
        sweeps)
    return out.reshape(start.shape)
