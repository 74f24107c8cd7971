"""Public wrappers around the port's kernels.

The counterpart of ``repro.kernels.ops``.  There is no kernel switch: the
tensor's device decides.  A CUDA tensor goes through the hand-written
kernel, a CPU tensor through its plain version, with no fallback from one
to the other.  ``flash_attention`` and ``ssd_scan`` are the kernels' own
entries (counterparts of the reference's ops of those names), forward
only; the scheduling ops combine their kernel's selection out here.

``flash_attention_trainable`` and ``ssd_scan_trainable`` are the model
kernels' differentiable entries, which the train mode calls.  The forward
runs the entry (the kernel on the card, the plain version on the CPU) and
saves only the inputs.  The backward recomputes the plain version on them
and returns autograd's gradient of it: the reference trains through
XLA's autodiff of the same blockwise functions (its Pallas kernels have
no VJP), and there is no backward kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.core.instance import PackedInstance
from repro_torch.core.objectives import carbon_from_delta, task_durations
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gate_quantile import gate_quantile_stats
from repro_torch.kernels.schedule_eval import schedule_delta
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["population_carbon", "gate_threshold", "flash_attention",
           "ssd_scan", "flash_attention_trainable", "ssd_scan_trainable"]


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
    with obs.span("repro_torch.population_carbon"):
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



def _plain_grads(fn, inputs: tuple, grad_out: torch.Tensor) -> tuple:
    """Autograd's gradient of ``fn(*inputs)`` against ``grad_out``, on
    fresh leaves of the saved inputs."""
    with torch.enable_grad():
        leaves = tuple(x.detach().requires_grad_(True) for x in inputs)
        return torch.autograd.grad(fn(*leaves), leaves, grad_out)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, block: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, block)
        with torch.no_grad():
            return flash_attention(q.detach(), k.detach(), v.detach(),
                                   causal, window, block)

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, block = ctx.args
        grads = _plain_grads(
            lambda q, k, v: ref.flash_attention_plain(q, k, v, causal,
                                                      window, block),
            ctx.saved_tensors, grad_out)
        return (*grads, None, None, None)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        with torch.no_grad():
            y, h = ssd_scan(x.detach(), dt.detach(), A.detach(),
                            Bm.detach(), Cm.detach(), chunk)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        # imported here: the model imports the kernels
        from repro_torch.models import ssm
        chunk = ctx.chunk
        grads = _plain_grads(
            lambda *a: ssm.ssd_chunked(*a, chunk)[0], ctx.saved_tensors,
            grad_y)
        return (*grads, None)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int = 0, block: int = 2048
                              ) -> torch.Tensor:
    """:func:`flash_attention` with a gradient: the kernel's output (the
    plain version's on the CPU) forward; backward, autograd through
    :func:`repro_torch.kernels.ref.flash_attention_plain` (blocks of
    ``block``) recomputed on the saved q, k, v."""
    return _FlashAttention.apply(q, k, v, causal, window, block)


def ssd_scan_trainable(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan` with a gradient in ``y``: the kernel's ``(y,
    h_final)`` (the plain version's on the CPU) forward; backward,
    autograd through :func:`repro_torch.models.ssm.ssd_chunked` recomputed
    on the saved inputs.  ``h_final`` carries no gradient: the train mode
    drops it."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
