"""``timing_sweep_ms.bound``: device time of one population timing sweep.

The device operations launched inside each ``repro_torch.timing_sweep``
span that lies in a ``repro_torch.population_fitness`` span (the
``[B, Pop, T]`` sweeps; the few ``[B, T]`` sweeps of the final decodes are
left out), summed and averaged over those spans (ms).
"""

FIT, SWEEP = "repro_torch.population_fitness", "repro_torch.timing_sweep"


def calls(trace):
    return [i for i in trace.named(SWEEP) if trace.ancestor(i, FIT) >= 0]


def read(trace, ctx):
    c = calls(trace)
    device_ns = sum(trace.spans[i].device_ns for i in c)
    if device_ns <= 0:
        return None
    return device_ns / len(c) / 1e6
