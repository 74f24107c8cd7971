"""``timing_sweep_roofline.bound``: the population timing sweep's least
time over its measured device time (%).

The count is of the sweep's own work, made from the call's shapes and
never from what an implementation moves: read once, ``cum`` ``[B, H+1]``
float32, the starts, servers and durations ``[B, Pop, T]`` int32, ``pred``
``[B, T, T]`` bool and the deadline ``[B]`` int32; written once, the new
starts ``[B, Pop, T]`` int32.  Its operations depend on each task's slack
in the data, so they are not counted: the bound is the bytes' at the
card's memory rate.
"""
from portbench.harness.peaks import bound_s

FIT, SWEEP = "repro_torch.population_fitness", "repro_torch.timing_sweep"


def sweep_bytes(B: int, Pop: int, T: int, H: int) -> int:
    rows = B * Pop * T
    return 3 * rows * 4 + B * (H + 1) * 4 + B * T * T + B * 4 + rows * 4


def read(trace, ctx):
    calls = [i for i in trace.named(SWEEP) if trace.ancestor(i, FIT) >= 0]
    device_s = sum(trace.spans[i].device_ns for i in calls) / 1e9
    if not calls or device_s <= 0:
        return None
    nbytes = sweep_bytes(ctx["B"], ctx["Pop"], ctx["T"], ctx["H"])
    least, which = bound_s(0, nbytes)
    return (100.0 * least * len(calls) / device_s,
            f"{which} bound, {nbytes} B a call, operations not counted; "
            f"card power limit {ctx.get('power_limit')}")
