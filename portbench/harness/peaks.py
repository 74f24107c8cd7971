"""The card's published peaks and the roofline's least time.

A frozen copy of the constants the readers use and of ``bound_s`` in
``src/repro_torch/kernels/cost.py``: NVIDIA H100 SXM, dense rates, at the
card's full power limit of 700 W.
"""
from __future__ import annotations

FP32_FLOPS = 67e12       # float32 off the tensor cores
HBM_BW = 3.35e12         # device memory, bytes/s


def bound_s(flops: float, bytes_: float, peak_flops: float = FP32_FLOPS
            ) -> tuple[float, str]:
    """The least time for ``flops`` operations at ``peak_flops`` and
    ``bytes_`` of device memory traffic, and which bound it: "operations"
    or "bytes"."""
    compute_s = flops / peak_flops
    memory_s = bytes_ / HBM_BW
    return (max(compute_s, memory_s),
            "operations" if compute_s >= memory_s else "bytes")
