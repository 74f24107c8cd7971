"""``sgs_step_ms.bound``: host wall of one SGS placement step in phase 1
(ms), where no timing sweep on the card can hold the host back.

The wall of the program's ``repro_torch.sgs`` spans inside a
``repro_torch.population_fitness`` span inside ``repro_torch.phase1``,
summed, over the sum of their ``steps`` attribute (T each), in the job
the traced run records without the profiler
(``portbench/harness/program_spans.py``).  None where the program has no
ring or the ring dropped part of the window.
"""
from portbench.harness.program_spans import program_spans

PHASE, FIT, SGS = ("repro_torch.phase1", "repro_torch.population_fitness",
                   "repro_torch.sgs")


def _within(spans, i, name) -> bool:
    p = spans[i].parent
    while p is not None and spans[p].name != name:
        p = spans[p].parent
    return p is not None


def read(trace, ctx):
    spans = program_spans(trace) or []
    c = [s for i, s in enumerate(spans) if s.name == SGS
         and _within(spans, i, FIT) and _within(spans, i, PHASE)]
    steps = sum(s.attrs.get("steps", 0) for s in c)
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in c) / steps / 1e6
