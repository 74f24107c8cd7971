"""Public wrappers around the port's kernels.

The counterpart of ``repro.kernels.ops``.  There is no kernel switch: the
tensor's device decides.  A CUDA tensor goes through the hand-written
kernel, a CPU tensor through its plain version, with no fallback from one
to the other.  ``flash_attention`` and ``ssd_scan`` are the kernels' own
entries (counterparts of the reference's ops of those names); the
scheduling ops combine their kernel's selection out here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.instance import PackedInstance
from repro_torch.core.objectives import carbon_from_delta, task_durations
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gate_quantile import gate_quantile_stats
from repro_torch.kernels.schedule_eval import schedule_delta
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["population_carbon", "gate_threshold", "flash_attention",
           "ssd_scan"]


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


def gate_threshold(intensity: torch.Tensor, theta, window,
                   max_window: int) -> torch.Tensor:
    """Per-epoch quantile gate threshold ``[*lead, E]``.

    The counterpart of ``repro.kernels.ops.gate_threshold``.
    ``intensity`` is ``[*lead, E]`` float32 (e.g. ``[E]`` for one
    forecast, ``[B, Th, W, E]`` for a sweep's gate rows); ``theta``
    broadcasts to it (a scalar, ``[E]`` or per row); ``window`` broadcasts
    to ``lead`` and is capped by ``max_window``.  All rows go through one
    ``gate_quantile`` launch, which *selects* the two order statistics and
    the valid count; the ``np.quantile`` lerp stays out here, in
    ``online_torch.quantile_threshold``'s expression ("select in the
    kernel, combine in the wrapper").

    The threshold is differentiable in ``theta``: the kernel's selection is
    piecewise constant in it and gets ``theta.detach()``, while the lerp
    below takes the live ``theta``, so the gradient ``diff * (n - 1)`` is
    the plain path's, bit for bit.
    """
    with torch.profiler.record_function("repro_torch.gate_threshold"):
        dev = intensity.device
        E = intensity.shape[-1]
        theta = torch.as_tensor(theta, dtype=torch.float32,
                                device=dev).expand(intensity.shape)
        window = torch.as_tensor(window, dtype=torch.int32,
                                 device=dev).expand(intensity.shape[:-1])
        a, b, n = (x.view(intensity.shape) for x in gate_quantile_stats(
            intensity.reshape(-1, E).contiguous(),
            theta.detach().reshape(-1, E).contiguous(),
            window.reshape(-1).contiguous(), max_window))
        vi = theta * (n - 1).to(torch.float32)
        gamma = vi - torch.floor(vi)
        diff = b - a
        # np.quantile's _lerp switches formula at gamma >= 0.5 for accuracy.
        return torch.where(gamma >= 0.5, b - diff * (1.0 - gamma),
                           a + diff * gamma)

