"""Public wrappers around the port's kernels.

The counterpart of ``repro.kernels.ops``.  There is no kernel switch: the
tensor's device decides.  A CUDA tensor goes through the hand-written
kernel, a CPU tensor through its plain version, with no fallback from one
to the other.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.core.objectives import carbon_from_delta, task_durations
from repro_torch.kernels.schedule_eval import schedule_delta


def population_carbon(inst: PackedInstance, starts: torch.Tensor,
                      assigns: torch.Tensor, cum: torch.Tensor
                      ) -> torch.Tensor:
    """Carbon of candidate populations.

    ``starts``/``assigns`` are ``[*instance_lead, Pop, T]`` (e.g.
    ``[B, Pop, T]``), ``cum`` is ``[*instance_lead, H+1]``; returns
    ``[*instance_lead, Pop]``.  The trace integral runs in one
    ``schedule_delta`` launch for the whole batch; the power weighting and
    masked sum stay out here, in the same expression
    :func:`repro_torch.core.objectives.carbon` ends in — so this equals
    ``objectives.carbon`` on the same tensors bitwise ("select in the
    kernel, combine in the wrapper").
    """
    with torch.profiler.record_function("repro_torch.population_carbon"):
        B = math.prod(inst.lead)
        T = starts.shape[-1]
        dur = task_durations(inst, assigns)
        delta = schedule_delta(starts.reshape(B, -1, T).contiguous(),
                               dur.reshape(B, -1, T).contiguous(),
                               cum.reshape(B, cum.shape[-1]).contiguous())
        return carbon_from_delta(inst, assigns, delta.reshape(starts.shape))
