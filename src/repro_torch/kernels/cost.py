"""The card's peak rates, and the hook by which kernel entries report cost.

A leaf module: the kernel entries, ``launch.op_analysis`` and
``launch.roofline`` import it, and it imports nothing of the package.

Each kernel module has a ``cost(...)`` formula, ``(flops, bytes)`` of one
call.  It serves twice: :func:`bound_s` turns it into the kernel's
roofline bound at the card's rates, and :func:`counted` adds it to every
active count (``launch.op_analysis.CostMode``, which enters itself in
:data:`ACTIVE` while it is entered).  With nothing counting, an entry
pays one test of an empty list.
"""
from __future__ import annotations

from typing import Callable

PEAK_FLOPS = 989e12      # dense bf16 tensor-core rate, H100 SXM data sheet
HBM_BW = 3.35e12         # device memory rate, H100 SXM data sheet
TF32_FLOPS = 495e12      # dense TF32 tensor-core rate, H100 SXM data sheet
FP32_FLOPS = 67e12       # float32 off the tensor cores, H100 SXM data sheet
LINK_BW = 450e9          # NVLink 4, one direction, H100 SXM data sheet
                         # (the roofline's collective term)

# The counting modes entered, outermost first.  Process-wide (autograd
# runs a CUDA backward on a thread of its own): count on one thread at a
# time.
ACTIVE: list = []


def bound_s(flops: float, bytes_: float, peak_flops: float = PEAK_FLOPS
            ) -> tuple[float, str]:
    """The least time one card could take for ``flops`` operations (at
    ``peak_flops``) and ``bytes_`` of device memory traffic, and which of
    the two bounds it: ``"operations"`` or ``"bytes"``."""
    compute_s = flops / peak_flops
    memory_s = bytes_ / HBM_BW
    return (max(compute_s, memory_s),
            "operations" if compute_s >= memory_s else "bytes")


def counted(name: str, cost: Callable[[], tuple[int, int]], fn: Callable,
            *args):
    """``fn(*args)`` with ``cost()`` (one call's kernel ``(flops,
    bytes)``) added once to every active count, which counts no aten op
    that ``cost`` or ``fn`` runs.  Call it only when :data:`ACTIVE` is not
    empty."""
    modes = tuple(ACTIVE)
    for m in modes:
        m.quiet += 1
    try:
        flops, bytes_ = cost()
        for m in modes:
            m.add(f"kernel:{name}", int(flops), int(bytes_))
        return fn(*args)
    finally:
        for m in modes:
            m.quiet -= 1
