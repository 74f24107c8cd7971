"""``device_idle.bound``: the share of the sampled job in which no device
operation ran (%): one less the union of the device's operations over
the job's span."""


def read(trace, ctx):
    if trace.window_ns <= 0 or trace.busy_ns <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns / trace.window_ns)
