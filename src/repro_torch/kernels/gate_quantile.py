"""``gate_quantile_stats``: order statistics of the carbon gate's windows.

Replaces the TPU kernel ``repro.kernels.gate_quantile.gate_quantile_stats_pallas``
with the hand-written CUDA kernel ``csrc/gate_quantile.cu`` (its header
gives the design and the bound): a sliding-window selection, one warp per
segment of a row, which ranks the segment's first window once and then
keeps every slot's stable rank up to date as the window slides one epoch
(the slot that leaves, the slot that enters).  Windows up to 256 slots
live in registers; wider ones keep their ranks in shared memory.  The
wrapper takes rows of forecasts — intensity and theta ``[R, E]`` float32,
window ``[R]`` int32 and the static ``max_window`` — and returns
``(a, b, n)``, each ``[R, E]``, in one launch for all rows.

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
runs the plain version
:func:`repro_torch.kernels.ref.gate_quantile_stats_ref`.  The two agree
bitwise: the kernel selects values by stable rank, the plain version by a
stable sort.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import gate_quantile_stats_ref

NAME = "gate_quantile"

# Dynamic shared memory one block may use on Hopper (bytes).  A window
# wider than the registers hold keeps one warp's ranks in shared memory:
# WIDE_SEGMENT + max_window - 1 ints (the kernel's kWideSeg).
MAX_SHARED_BYTES = 232448
WIDE_SEGMENT = 32


def _check(intensity: torch.Tensor, theta: torch.Tensor,
           window: torch.Tensor, max_window: int) -> None:
    if intensity.dtype != torch.float32 or theta.dtype != torch.float32:
        raise TypeError(f"intensity/theta must be float32, got "
                        f"{intensity.dtype}/{theta.dtype}")
    if window.dtype != torch.int32:
        raise TypeError(f"window must be int32, got {window.dtype}")
    if intensity.ndim != 2 or theta.shape != intensity.shape:
        raise ValueError(f"intensity/theta must be one [R, E] shape, got "
                         f"{tuple(intensity.shape)}/{tuple(theta.shape)}")
    if window.shape != intensity.shape[:1]:
        raise ValueError(f"window must be [R] with R={intensity.shape[0]}, "
                         f"got {tuple(window.shape)}")
    if not (intensity.device == theta.device == window.device):
        raise ValueError("intensity, theta and window must lie on one device")
    if isinstance(max_window, bool) or not isinstance(max_window, int) \
            or max_window < 1:
        raise ValueError(f"max_window must be an int >= 1, got {max_window!r}")
    build.refuse_grad(NAME, intensity=intensity, theta=theta)


def _launch(intensity: torch.Tensor, theta: torch.Tensor,
            window: torch.Tensor, max_window: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    for name, x in (("intensity", intensity), ("theta", theta),
                    ("window", window)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    R, E = intensity.shape
    if 4 * (WIDE_SEGMENT + max_window - 1) > MAX_SHARED_BYTES:
        raise ValueError(f"gate_quantile: max_window={max_window} needs more "
                         "shared memory than a block has")
    if R * -(-E // WIDE_SEGMENT) >= 2**31:
        raise ValueError("gate_quantile: sizes exceed the kernel's grid")
    lib = build.load(NAME)
    fn = lib.gate_quantile_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = torch.empty_like(intensity)
    b = torch.empty_like(intensity)
    n = torch.empty(intensity.shape, dtype=torch.int32,
                    device=intensity.device)
    stream = torch.cuda.current_stream(intensity.device).cuda_stream
    err = fn(intensity.data_ptr(), theta.data_ptr(), window.data_ptr(),
             a.data_ptr(), b.data_ptr(), n.data_ptr(), R, E, max_window,
             stream)
    if err != 0:
        raise RuntimeError(f"gate_quantile kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(NAME)
    return a, b, n


def gate_quantile_stats(intensity: torch.Tensor, theta: torch.Tensor,
                        window: torch.Tensor, max_window: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(a, b, n)`` of every row's per-epoch windows.

    intensity, theta ``[R, E]`` float32, window ``[R]`` int32 (each row's
    window is capped by ``max_window``) -> a, b ``[R, E]`` float32, n
    ``[R, E]`` int32: the values at stable ranks ``floor(theta * (n-1))``
    and its successor, and the valid count.  The kernel on CUDA tensors,
    the plain version on CPU tensors.
    """
    _check(intensity, theta, window, max_window)
    if intensity.device.type == "cuda":
        return _launch(intensity, theta, window, max_window)
    if intensity.device.type == "cpu":
        return gate_quantile_stats_ref(intensity, theta, window, max_window)
    raise ValueError(f"gate_quantile: no kernel for device {intensity.device}")
