"""``fitness_ms.bound``: device time of one phase-2 fitness call.

The device operations launched inside each ``repro_torch.population_fitness``
span that sweeps (phase 2's carbon or energy objective; phase 1's makespan
fitness does not), summed and averaged over those spans (ms).
"""

FIT, SWEEP = "repro_torch.population_fitness", "repro_torch.timing_sweep"


def read(trace, ctx):
    calls = [i for i in trace.named(FIT) if trace.has_child(i, SWEEP)]
    device_ns = sum(trace.spans[i].device_ns for i in calls)
    if device_ns <= 0:
        return None
    return device_ns / len(calls) / 1e6
