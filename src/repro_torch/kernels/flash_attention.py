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
softmax sums reassociate.  On a ``meta`` tensor it returns the output's
shape and dtype and computes nothing (the dry run).  :func:`cost` is the
kernel's FLOPs and bytes: its roofline bound, and what it adds to an
active ``launch.op_analysis`` count on every device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, cost as kcost
from repro_torch.kernels.ref import flash_attention_plain

NAME = "flash_attention"
PEAK_FLOPS = kcost.PEAK_FLOPS      # bf16 products on the tensor cores
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


def live_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a (batch, head) attends over: query ``i`` sees
    ``min(i + 1, window or Sq)`` keys when causal, all ``Skv`` if not."""
    if not causal:
        return Sq * Skv
    w = window or Sq
    if w >= Sq:
        return Sq * (Sq + 1) // 2
    return w * (w + 1) // 2 + (Sq - w) * w


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool = True, window: int = 0) -> tuple[int, int]:
    """``(flops, bytes)`` of one call: QK^T and PV over the live pairs, 2
    FLOPs a multiply-add; q, k and v read once, the output written once."""
    B, H, Sq, dh = q.shape
    flops = 4 * dh * live_pairs(Sq, k.shape[2], causal, window) * B * H
    moved = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return flops, moved


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


def _run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: int, block: int) -> torch.Tensor:
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, block)
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    block: int = 2048) -> torch.Tensor:
    """Attention of q ``[B, H, Sq, dh]`` over k, v ``[B, KVH, Skv, dh]``.

    ``causal`` masks keys after the query; ``window > 0`` keeps only keys
    within ``window`` positions of it.  The kernel on CUDA tensors, the
    plain version on CPU tensors (``block`` is the plain version's tile),
    the output's shape and dtype on ``meta`` tensors.
    """
    _check(q, k, v, window)
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if kcost.ACTIVE:
        return kcost.counted(NAME, lambda: cost(q, k, v, causal, window),
                             _run, q, k, v, causal, window, block)
    return _run(q, k, v, causal, window, block)
