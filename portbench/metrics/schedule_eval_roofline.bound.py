"""``schedule_eval_roofline.bound``: the ``schedule_eval`` kernel's least
time over its measured device time (%).

A frozen copy of ``cost`` in ``src/repro_torch/kernels/schedule_eval.py``:
one float32 subtraction an element of ``[B, Pop, T]``; the starts and
durations (int32) read once, ``cum`` ``[B, H+1]`` float32 read once, the
float32 deltas written once.  Every launch on this path is at the
population's shape (``ops.population_carbon`` in a phase-2 fitness call).
"""
from portbench.harness.peaks import FP32_FLOPS, bound_s

KERNEL = "schedule_delta"


def cost(B: int, Pop: int, T: int, H: int) -> tuple[int, int]:
    n = B * Pop * T
    return n, n * (4 + 4 + 4) + B * (H + 1) * 4


def read(trace, ctx):
    ns, count = trace.kernels_matching(KERNEL)
    if count == 0 or ns <= 0:
        return None
    flops, nbytes = cost(ctx["B"], ctx["Pop"], ctx["T"], ctx["H"])
    least, which = bound_s(flops, nbytes, FP32_FLOPS)
    return (100.0 * least * count / (ns / 1e9),
            f"{which} bound, {nbytes} B and {flops} float32 operations a "
            f"launch; card power limit {ctx.get('power_limit')}")
