"""Carbon-aware flexible job-shop scheduling of DAG workloads in PyTorch.

The counterpart of ``repro.core`` (the bi-level makespan -> carbon/energy
protocol as population search over SGS encodings).

Public API:
    instance   — FJSP instances (jobs, DAG tasks, machines) + generators
    carbon     — carbon-intensity traces (4 region profiles, CSV ingest)
    objectives — makespan / energy / carbon evaluators
    validate   — shared feasibility validator (Eqs. 4-8 + budget)
    decoder    — SGS decoders + carbon timing sweep
    solvers    — SA / GA / bi-level driver
"""
from repro_torch.core import carbon, decoder, instance, objectives, validate
from repro_torch.core.instance import (Instance, Job, PackedInstance,
                                       generate_instance, pack,
                                       packed_from_numpy, stack_packed)
from repro_torch.core.carbon import CarbonTrace, REGIONS, synthesize
from repro_torch.core.solvers import (BilevelResult, ScheduleResult,
                                      TorchDraws, solve_bilevel,
                                      solve_bilevel_batch, solve_ga, solve_sa)

__all__ = [
    "carbon", "decoder", "instance", "objectives", "validate",
    "Instance", "Job", "PackedInstance", "generate_instance", "pack",
    "packed_from_numpy", "stack_packed", "CarbonTrace", "REGIONS",
    "synthesize", "BilevelResult", "ScheduleResult", "TorchDraws",
    "solve_bilevel", "solve_bilevel_batch", "solve_ga", "solve_sa",
]
