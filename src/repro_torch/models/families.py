"""Per-family block assembly and the layer stack.

The counterpart of ``repro.models.families`` for the train and serve
paths:
  dense / vlm : attn -> mlp                  (pre-norm residual)
  moe         : attn -> moe ffn (+ aux loss)
  ssm         : mamba2 mixer only (mamba has no separate FFN)
  hybrid      : parallel attn + mamba heads on the same normed input
                (outputs mean-combined, Hymba-style) -> mlp
  encdec      : self-attn -> cross-attn -> mlp   (whisper decoder);
                encoder blocks are non-causal attn -> mlp.
On a mesh each sub-layer holds its rank's blocks and sums over ``model``
where it must (``parallel``); a hybrid block's attention branch runs whole
on every rank when its heads are replicated, and meets the SSM branch's
summed output.
Parameters are stacked with a leading layer axis, as in the reference;
:func:`stack_apply` is a Python loop over it (the reference's
``scan_layers=False`` path), each layer under the remat policy in train
mode (:func:`_remat`).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention, moe as moe_mod, ssm as ssm_mod
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import mlp_apply, mlp_defs, norm_apply, \
    norm_defs
from repro_torch.models.params import ParamDef, tree_map_defs
from repro_torch.models.parallel import ParallelCfg


def stack_defs(defs, n_layers: int):
    """Prepend a ``layer`` axis of size L to every ParamDef in the tree."""
    return tree_map_defs(
        lambda d: ParamDef((n_layers,) + d.shape, ("layer",) + d.logical,
                           init=d.init, dtype=d.dtype, scale=d.scale), defs)


def block_defs(cfg: ArchConfig, encoder: bool = False) -> dict:
    d = {}
    D, kind = cfg.d_model, cfg.norm
    d["norm1"] = norm_defs(D, kind)
    if cfg.family == "ssm":
        d["ssm"] = ssm_mod.ssm_defs(cfg)
        return d
    d["attn"] = attention.attn_defs(cfg)
    if cfg.family == "hybrid":
        d["ssm"] = ssm_mod.ssm_defs(cfg)
    if cfg.family == "encdec" and not encoder:
        d["norm_x"] = norm_defs(D, kind)
        d["cross"] = attention.attn_defs(cfg, cross=True)
    d["norm2"] = norm_defs(D, kind)
    if cfg.family == "moe":
        d["moe"] = moe_mod.moe_defs(cfg)
    elif cfg.d_ff:
        d["mlp"] = mlp_defs(D, cfg.d_ff, cfg.act)
    return d


def block_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, par: ParallelCfg,
                *, mode: str, pos=None, cache: dict | None = None,
                causal: bool = True, enc: torch.Tensor | None = None):
    """One decoder/encoder block. Returns (x, new_cache, aux)."""
    aux = torch.zeros((), device=x.device)
    new_cache: dict = {}
    kind, eps = cfg.norm, cfg.norm_eps
    h = norm_apply(p["norm1"], x, kind, eps)

    if cfg.family == "ssm":
        y, st = ssm_mod.ssm_apply(p["ssm"], h, cfg, par, mode=mode,
                                  state=cache)
        new_cache.update(st)
        return x + y, new_cache, aux

    attn_cache = {k: cache[k] for k in ("k", "v")} if cache and "k" in cache \
        else None
    y, ac = attention.attn_apply(p["attn"], h, cfg, par, mode=mode, pos=pos,
                                 cache=attn_cache, causal=causal)
    if ac is not None:
        new_cache.update(ac)

    if cfg.family == "hybrid":
        # Hymba: attention and mamba heads read the SAME normed input in
        # parallel; their (pre-norm) outputs are mean-combined.
        sst = {"h": cache["h"], "conv": cache["conv"]} \
            if cache and "h" in cache else None
        ys, st = ssm_mod.ssm_apply(p["ssm"], h, cfg, par, mode=mode,
                                   state=sst)
        y = 0.5 * (y + ys)
        new_cache.update(st)
    x = x + y

    if "cross" in p:
        h = norm_apply(p["norm_x"], x, kind, eps)
        if mode == "decode":
            y, _ = attention.attn_apply(
                p["cross"], h, cfg, par, mode="cross_cached",
                cache={"k": cache["ck"], "v": cache["cv"]})
            new_cache["ck"], new_cache["cv"] = cache["ck"], cache["cv"]
        else:
            y, cc = attention.attn_apply(p["cross"], h, cfg, par, mode=mode,
                                         kv_x=enc, causal=False)
            if cc is not None:
                new_cache["ck"], new_cache["cv"] = cc["k"], cc["v"]
        x = x + y

    h = norm_apply(p["norm2"], x, kind, eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_apply(p["moe"], h, cfg, par)
    elif cfg.d_ff:
        y = mlp_apply(p["mlp"], h, cfg.act, par)
    else:
        y = torch.zeros_like(x)
    return x + y, new_cache, aux


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The per-layer trees of a stacked tree, as views (one ``unbind`` a
    leaf: its gradient is one ``stack`` of the layers' gradients, where
    indexing layer by layer would add a zero-filled [L, ...] tensor a
    layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree[:n]))


# Products with no batch dimensions: what ``dots`` saves, as
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, par: ParallelCfg):
    """``fn`` under the train mode's recompute policy (the counterpart of
    the reference's ``_remat``): ``none`` keeps every activation; ``full``
    keeps only the layer's inputs and recomputes its forward in the
    backward; ``dots`` also keeps the outputs of the products with no
    batch dims.  ``tp_out`` saves the tensor-parallel all-reduce outputs,
    which one card does not have: it is not ported."""
    if par.remat == "none":
        return fn
    if par.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if par.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat {par.remat!r}: the port has none, full and "
                     "dots (tp_out saves tensor-parallel all-reduce outputs; "
                     "one card has none)")


def stack_apply(stacked: dict, x: torch.Tensor, cfg: ArchConfig,
                par: ParallelCfg, *, mode: str, n_layers: int, pos=None,
                caches: dict | None = None, causal: bool = True,
                enc: torch.Tensor | None = None):
    """Run ``n_layers`` blocks over the stacked param tree, in order, each
    under ``par.remat`` in train mode.

    ``caches``: dict of [L, ...] tensors for decode.  ``enc``: the encoder
    output every decoder layer attends to (encdec prefill).  Returns
    (x, new_caches, aux_total), the caches stacked [L, ...] again and the
    MoE aux losses summed over the layers, as the reference's scan does.
    """
    caches = caches if caches is not None else {}
    aux = torch.zeros((), device=x.device)
    outs = []
    block = functools.partial(block_apply, cfg=cfg, par=par, mode=mode,
                              pos=pos, causal=causal)
    if mode == "train":
        block = _remat(block, par)
    for i, lp in enumerate(_unstack(stacked, n_layers)):
        x, nc, a = block(lp, x, cache=_layer(caches, i) or None, enc=enc)
        aux = aux + a
        outs.append(nc)
    new_caches = ({k: torch.stack([o[k] for o in outs]) for k in outs[0]}
                  if outs and outs[0] else {})
    return x, new_caches, aux
