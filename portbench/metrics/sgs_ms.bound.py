"""``sgs_ms.bound``: host wall of one population SGS decode.

The wall of each ``repro_torch.sgs`` span inside a
``repro_torch.population_fitness`` span, averaged (ms), in the job the
traced run records without the profiler (``trace.host``).  The decode is
T sequential steps of small launches, so its host wall paces it.
"""

FIT, SGS = "repro_torch.population_fitness", "repro_torch.sgs"


def read(trace, ctx):
    trace = trace.host
    if trace is None:
        return None
    c = [i for i in trace.named(SGS) if trace.ancestor(i, FIT) >= 0]
    if not c:
        return None
    return sum(trace.spans[i].wall_ns for i in c) / len(c) / 1e6
