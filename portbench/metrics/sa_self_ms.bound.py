"""``sa_self_ms.bound``: the SA loop's own host time per fitness call.

The ``repro_torch.solve_sa`` spans' wall, less the wall of the
``repro_torch.population_fitness`` spans inside them, over the number of
those fitness calls (ms), in the job the traced run records without the
profiler (``trace.host``).
"""

SA, FIT = "repro_torch.solve_sa", "repro_torch.population_fitness"


def read(trace, ctx):
    trace = trace.host
    if trace is None:
        return None
    sa = trace.named(SA)
    fits = [i for i in trace.named(FIT) if trace.ancestor(i, SA) >= 0]
    if not sa or not fits:
        return None
    own = (sum(trace.spans[i].wall_ns for i in sa)
           - sum(trace.spans[i].wall_ns for i in fits))
    return own / len(fits) / 1e6
