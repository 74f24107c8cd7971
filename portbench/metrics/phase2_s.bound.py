"""``phase2_s.bound``: host wall of the bound's phase 2 (s).

The wall of the program's own ``repro_torch.phase2`` span (phase 2's SA,
its two decodes and the fallback choice) in the job the traced run
records without the profiler (``portbench/harness/program_spans.py``).
None where the program has no ring or the ring dropped part of the
window.
"""
from portbench.harness.program_spans import phase_wall


def read(trace, ctx):
    return phase_wall(trace, "repro_torch.phase2")
