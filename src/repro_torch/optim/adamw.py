"""AdamW with a warmup + cosine schedule and global-norm clipping.

The counterpart of ``repro.optim.adamw``, held against it by
``tests/test_torch_optim.py``.  Functional, on dicts of float32 tensors:
``state = adamw_init(params, cfg)``; ``params, state, metrics =
adamw_update(params, grads, state, cfg)``.  ``torch.optim.AdamW`` is not
a substitute: this update clips by the global norm inside the step,
divides as ``(m / bc1) / (sqrt(v / bc2) + eps)``, follows its own
schedule and decays only tensors with ``ndim >= 2``.

On a mesh each rank holds its blocks of the parameters, gradients and
moments (``placement``: a ``parallel.Placement``), and the update is
elementwise on them.  At ZeRO stages 1-2 a leaf the model holds whole
over data has its moments, and its gradient (reduce-scattered by
``parallel.sum_over_data``), as stage 3's blocks: each data rank updates
its block of the leaf and all-gathers the updated blocks.  The clipping
norm spans ranks: :func:`global_norm` sums each leaf's squares over the
mesh axes its gradient's block is split on (``model``, the data axes)
and counts each replicated leaf once, so it is the norm of the whole
gradient, as the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.parallel import (ParallelCfg, Placement, all_gather,
                                         sum_no_grad)


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor       # int32 scalar


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps`` (float32, as the reference computes it)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def adamw_init(params: dict, cfg: AdamWConfig = AdamWConfig(),
               par: ParallelCfg | None = None,
               placement: Placement = Placement()) -> OptState:
    """Zero moments of each parameter's shape, or, for a leaf in
    ``placement.scatter``, of its block over the data axes."""
    def shape(k, p):
        s = list(p.shape)
        if k in placement.scatter:
            s[placement.scatter[k]] //= par.data_size
        return s

    def zeros():
        return {k: torch.zeros(shape(k, p), dtype=cfg.moment_dtype,
                               device=p.device) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(zeros(), zeros(),
                    torch.zeros((), dtype=torch.int32, device=dev))


def _sq(xs) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.to(torch.float32))) for x in xs)


def global_norm(tree: dict, par: ParallelCfg | None = None,
                placement: Placement = Placement()) -> torch.Tensor:
    """The norm of all of ``tree``: on a mesh each leaf's squares are
    summed over the axes its block is split on (``model`` for
    ``placement.model``, the data axes for ``placement.data`` and
    ``placement.scatter``), each group once."""
    if par is None or par.mesh is None:
        return torch.sqrt(_sq(tree.values()))
    groups: dict[tuple, list] = {}
    for k, x in tree.items():
        axes = (("model",) if k in placement.model else ()) + (
            par.batch_axes if k in placement.data or k in placement.scatter
            else ())
        groups.setdefault(axes, []).append(x)
    total = _sq(groups.pop((), []))
    for axes, xs in groups.items():
        total = total + sum_no_grad(_sq(xs), par, axes)
    return torch.sqrt(total)


def _block(p: torch.Tensor, dim: int, par: ParallelCfg) -> torch.Tensor:
    """This data rank's block of ``p`` along ``dim``."""
    n = p.shape[dim] // par.data_size
    return p.narrow(dim, par.data_index * n, n)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState,
                 cfg: AdamWConfig, par: ParallelCfg | None = None,
                 placement: Placement = Placement()
                 ) -> tuple[dict, OptState, dict]:
    """One step; returns new tensors (the inputs are not changed).
    ``par`` and ``placement``: the mesh and where the leaves lie on it,
    for the clipping norm (:func:`global_norm`) and the leaves updated as
    blocks (``placement.scatter``)."""
    step = state.step + 1
    gnorm = global_norm(grads, par, placement)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = cosine_lr(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** sf
    bc2 = 1 - cfg.b2 ** sf
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        dim = placement.scatter.get(k)
        if dim is not None:
            p = _block(p, dim, par)
        g = grads[k].to(torch.float32) * scale
        m = cfg.b1 * state.m[k].to(torch.float32) + (1 - cfg.b1) * g
        v = cfg.b2 * state.v[k].to(torch.float32) + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        # Decoupled weight decay on matrices only (ndim >= 2).
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (u + wd * p32)
        new_p[k] = p32.to(p.dtype)
        if dim is not None:
            new_p[k] = all_gather(new_p[k], par, dim)
        new_m[k] = m.to(cfg.moment_dtype)
        new_v[k] = v.to(cfg.moment_dtype)
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm,
                                                   "lr": lr}
