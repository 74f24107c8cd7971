"""Parametric, seeded scenario generation, on the port.

The counterpart of ``repro.scenarios``: the structure space the paper's
sensitivity analysis names as decisive (job structure x server count)
with seeded generators.  The numpy modules are copies of the
reference's, so the same seeds give the same instances.

    families   — parametric DAG families (chain, fanout, diamond/series-
                 parallel, random layered, TPC-H-like query plans)
    fleets     — machine-fleet generators (homogeneous, the paper's
                 5-class tiers, randomly mixed tiers)
    generator  — ScenarioConfig (one cell) -> seeded Instance sampling
    batching   — pad mixed-shape instances to one stacked batch (inert
                 padding on the task, machine and batch axes)
    sweep      — the batched structure sweep (all cells x instances x gate
                 policies in one dispatch, plus the offline SA bound and
                 the learned gate thetas; ``learned_summary``)
"""
from repro_torch.scenarios.batching import (aligned_shape, pack_aligned,
                                            pad_stacked, padding_rows)
from repro_torch.scenarios.families import FAMILIES, FAMILY_NAMES, build_dag
from repro_torch.scenarios.fleets import FLEETS, FLEET_NAMES, build_fleet
from repro_torch.scenarios.generator import (ScenarioConfig, sample_batch,
                                             sample_instance, sample_job)
from repro_torch.scenarios.sweep import (SweepBatch, SweepSpec, build_batch,
                                         learned_summary, structure_cells,
                                         sweep_structure, trend_summary)

__all__ = [
    "FAMILIES", "FAMILY_NAMES", "build_dag",
    "FLEETS", "FLEET_NAMES", "build_fleet",
    "ScenarioConfig", "sample_batch", "sample_instance", "sample_job",
    "aligned_shape", "pack_aligned", "pad_stacked", "padding_rows",
    "SweepBatch", "SweepSpec", "build_batch", "learned_summary",
    "structure_cells", "sweep_structure", "trend_summary",
]
