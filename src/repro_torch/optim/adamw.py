"""AdamW with a warmup + cosine schedule and global-norm clipping.

The counterpart of ``repro.optim.adamw``, held against it by
``tests/test_torch_optim.py``.  Functional, on dicts of float32 tensors:
``state = adamw_init(params, cfg)``; ``params, state, metrics =
adamw_update(params, grads, state, cfg)``.  ``torch.optim.AdamW`` is not
a substitute: this update clips by the global norm inside the step,
divides as ``(m / bc1) / (sqrt(v / bc2) + eps)``, follows its own
schedule and decays only tensors with ``ndim >= 2``.

On a mesh each rank holds its blocks of the parameters, gradients and
moments, and the update is elementwise on them; only the clipping norm
spans ranks: :func:`global_norm` sums the squares of the model-sharded
leaves over ``model`` and counts each replicated leaf once, so it is the
norm of the whole gradient, as the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.parallel import ParallelCfg, sum_no_grad


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


def adamw_init(params: dict, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(zeros(), zeros(),
                    torch.zeros((), dtype=torch.int32, device=dev))


def _sq(xs) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.to(torch.float32))) for x in xs)


def global_norm(tree: dict, par: ParallelCfg | None = None,
                sharded: frozenset = frozenset()) -> torch.Tensor:
    """The norm of all of ``tree``; on a mesh ``sharded`` names the leaves
    split over ``model``, whose squares are summed over the model ranks."""
    if par is None or not sharded:
        return torch.sqrt(_sq(tree.values()))
    rep = _sq(x for k, x in tree.items() if k not in sharded)
    part = _sq(x for k, x in tree.items() if k in sharded)
    return torch.sqrt(rep + sum_no_grad(part, par))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: OptState,
                 cfg: AdamWConfig, par: ParallelCfg | None = None,
                 sharded: frozenset = frozenset()
                 ) -> tuple[dict, OptState, dict]:
    """One step; returns new tensors (the inputs are not changed).
    ``par`` and ``sharded``: the mesh and the model-sharded leaves, for
    the clipping norm (:func:`global_norm`)."""
    step = state.step + 1
    gnorm = global_norm(grads, par, sharded)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = cosine_lr(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** sf
    bc2 = 1 - cfg.b2 ** sf
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m = cfg.b1 * state.m[k].to(torch.float32) + (1 - cfg.b1) * g
        v = cfg.b2 * state.v[k].to(torch.float32) + (1 - cfg.b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        # Decoupled weight decay on matrices only (ndim >= 2).
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (u + wd * p32)
        new_p[k] = p32.to(p.dtype)
        new_m[k] = m.to(cfg.moment_dtype)
        new_v[k] = v.to(cfg.moment_dtype)
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm,
                                                   "lr": lr}
