"""``phase1_s.bound``: host wall of the bound's phase 1 (s).

The wall of the program's own ``repro_torch.phase1`` span (phase 1's SA
and the baseline's decode) in the job the traced run records without the
profiler (``portbench/harness/program_spans.py``).  None where the
program has no ring or the ring dropped part of the window.
"""
from portbench.harness.program_spans import phase_wall


def read(trace, ctx):
    return phase_wall(trace, "repro_torch.phase1")
