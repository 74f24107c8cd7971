"""``schedule_delta``: per-task carbon-trace deltas of a candidate batch.

Replaces the TPU kernel ``repro.kernels.schedule_eval.schedule_delta_pallas``
with the hand-written CUDA kernel ``csrc/schedule_eval.cu`` (its header
gives the design and the bound): instance-major blocks, each staging its
instance's ``cum`` row in shared memory with ``cp.async`` while its
16-byte start/dur loads are in flight, then gathering from shared memory.
The wrapper takes the port's batched layout — start/dur ``[B, Pop, T]``
int32 and cum ``[B, H+1]`` float32 — and returns ``[B, Pop, T]``
float32, in one launch for the whole batch.

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
runs the plain version :func:`repro_torch.kernels.ref.schedule_delta_ref`.
The two agree bitwise: each element is one subtraction of two loaded
values.  On a ``meta`` tensor it returns the output's shape and dtype
and computes nothing.  :func:`cost` is the kernel's FLOPs and bytes: its
roofline bound, and what it adds to an active ``launch.op_analysis``
count on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost as kcost
from repro_torch.kernels.ref import schedule_delta_ref

NAME = "schedule_eval"
PEAK_FLOPS = kcost.FP32_FLOPS      # one float32 subtraction an element


def _check(start: torch.Tensor, dur: torch.Tensor, cum: torch.Tensor) -> None:
    if start.dtype != torch.int32 or dur.dtype != torch.int32:
        raise TypeError(f"start/dur must be int32, got {start.dtype}/"
                        f"{dur.dtype}")
    if cum.dtype != torch.float32:
        raise TypeError(f"cum must be float32, got {cum.dtype}")
    if start.ndim != 3 or start.shape != dur.shape:
        raise ValueError(f"start/dur must be one [B, Pop, T] shape, got "
                         f"{tuple(start.shape)}/{tuple(dur.shape)}")
    if cum.ndim != 2 or cum.shape[0] != start.shape[0] or cum.shape[1] < 1:
        raise ValueError(f"cum must be [B, H+1] with B={start.shape[0]}, "
                         f"got {tuple(cum.shape)}")
    if not (start.device == dur.device == cum.device):
        raise ValueError("start, dur and cum must lie on one device")
    build.refuse_grad(NAME, cum=cum)


def cost(start: torch.Tensor, dur: torch.Tensor, cum: torch.Tensor
         ) -> tuple[int, int]:
    """``(flops, bytes)`` of one call: one subtraction an element; start,
    dur and cum read once, the deltas written once."""
    n = start.numel()
    return n, n * (start.element_size() + dur.element_size() + 4) \
        + cum.numel() * cum.element_size()


def _launch(start: torch.Tensor, dur: torch.Tensor,
            cum: torch.Tensor) -> torch.Tensor:
    for name, x in (("start", start), ("dur", dur), ("cum", cum)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, P, T = start.shape
    if P * T >= 2**31 or cum.shape[1] >= 2**31:
        raise ValueError("schedule_delta: sizes exceed the kernel's int range")
    lib = build.load(NAME)
    fn = lib.schedule_delta_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(start.shape, dtype=torch.float32, device=start.device)
    stream = torch.cuda.current_stream(start.device).cuda_stream
    err = fn(start.data_ptr(), dur.data_ptr(), cum.data_ptr(), out.data_ptr(),
             B, P * T, cum.shape[1] - 1, stream)
    if err != 0:
        raise RuntimeError(f"schedule_delta kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(NAME)
    return out


def _run(start: torch.Tensor, dur: torch.Tensor,
         cum: torch.Tensor) -> torch.Tensor:
    if start.device.type == "cuda":
        return _launch(start, dur, cum)
    if start.device.type == "cpu":
        return schedule_delta_ref(start, dur, cum)
    return torch.empty(start.shape, dtype=torch.float32, device=start.device)


def schedule_delta(start: torch.Tensor, dur: torch.Tensor,
                   cum: torch.Tensor) -> torch.Tensor:
    """``cum[b, clip(s+d, 0, H)] - cum[b, clip(s, 0, H)]`` per element.

    start/dur ``[B, Pop, T]`` int32, cum ``[B, H+1]`` float32 ->
    ``[B, Pop, T]`` float32.  The kernel on CUDA tensors, the plain
    version on CPU tensors, the output's shape and dtype on ``meta``.
    """
    _check(start, dur, cum)
    if start.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"schedule_delta: no kernel for device "
                         f"{start.device}")
    if kcost.ACTIVE:
        return kcost.counted(NAME, lambda: cost(start, dur, cum), _run,
                             start, dur, cum)
    return _run(start, dur, cum)
