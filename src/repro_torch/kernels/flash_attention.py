"""``flash_attention``: causal, sliding-window or non-causal GQA attention
(forward).

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_pallas``
with the hand-written CUDA kernel ``csrc/flash_attention.cu`` (its header
gives the design and the bound).  The wrapper takes the reference's
layout — q ``[B, H, Sq, dh]``, k and v ``[B, KVH, Skv, dh]``, one dtype
(bfloat16 or float32), ``dh`` in {32, 64, 128} — and returns ``[B, H, Sq,
dh]`` in q's dtype, in one launch.  Ragged lengths need no padding.

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
runs the plain version :func:`repro_torch.kernels.ref.flash_attention_plain`
(the model's blockwise ``flash_unrolled``, or ``flash_scan`` for
non-causal inputs).  The two agree to a tolerance:
softmax sums reassociate.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_plain

NAME = "flash_attention"
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype of {DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, H, Sq, dh] and k, v one [B, KVH, "
                         f"Skv, dh] shape, got {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    B, H, Sq, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh or k.shape[1] < 1 \
            or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and dh, H % KVH == 0)")
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention needs Sq >= 1 and Skv >= 1")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if isinstance(window, bool) or not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")
    build.refuse_grad(NAME, q=q, k=k, v=v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if B * H > 65535 or max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("flash_attention: sizes exceed the kernel's grid")
    lib = build.load(NAME)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             KVH, Sq, Skv, dh, int(q.dtype == torch.bfloat16), int(causal),
             window, 1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    build.count_launch(NAME)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    block: int = 2048) -> torch.Tensor:
    """Attention of q ``[B, H, Sq, dh]`` over k, v ``[B, KVH, Skv, dh]``.

    ``causal`` masks keys after the query; ``window > 0`` keeps only keys
    within ``window`` positions of it.  The kernel on CUDA tensors, the
    plain version on CPU tensors (``block`` is the plain version's tile).
    """
    _check(q, k, v, window)
    with torch.profiler.record_function("repro_torch.flash_attention"):
        if q.device.type == "cuda":
            return _launch(q, k, v, causal, window)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal, window, block)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
