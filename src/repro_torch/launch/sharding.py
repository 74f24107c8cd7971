"""Per-(arch x mesh) sharding policy: rules, batch specs, the parallel
config and each rank's block of a batch.

The counterpart of ``repro.launch.sharding``, on a :class:`MeshShape`
(axis names and sizes) or a :class:`ProcessMesh` (a shape placed on a
fleet).  ``auto_rules`` adapts the logical->mesh table to an
architecture: axes that do not divide the tensor axis (e.g. 56 query
heads or 25 kv-heads on a 16-way ``"model"`` axis) fall back to
replication; ``zero_stage=3`` additionally shards every weight's
``embed`` dim over the data axes (ZeRO-3).  ``batch_pspecs`` gives every
``input_specs`` key its mesh axes per dimension (a ``PartitionSpec`` as a
tuple): batch dims over ("pod","data") when divisible, KV caches' head
dims over ``"model"`` when divisible, scalars replicated.

``make_parallel`` is the reference's, with a :class:`ProcessMesh`.
:func:`batch_shard` is the counterpart of ``batch_shardings``: where the
reference puts a global batch on the mesh under ``NamedSharding``s, it
cuts this rank's block of every key.  Its caches are the blocks the
model's layers hold: a KV cache the kv heads this rank's q heads read
(``batch_pspecs``' kv-head block when kv heads shard, the GQA slice when
only q heads do), an SSM state its head block, a conv state the rank's
``ssm_inner`` channels with the replicated B/C channels (``batch_pspecs``
replicates it: GSPMD would gather the new column each step, and the port
gathers nothing).  Not ported: ZeRO on a mesh (every stage needs
``all_gather``/``reduce_scatter``), and the sequence sharding
switches (``seq_shard``, ``kv_seq_shard``), which nothing in the port
sets, and ``moe_ep=False``: experts sharded over ``model`` always take
the expert-parallel dispatch (the reference's other branch is GSPMD's
sharding of the single-device dispatch, which needs ``all_gather``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.models.attention import head_blocks
from repro_torch.models.common import ArchConfig, SHAPES, ShapeCfg, input_specs
from repro_torch.models.params import (DEFAULT_RULES, ParamDef,
                                       ShardingRules, local_slices)
from repro_torch.models.parallel import ParallelCfg, sum_no_grad
from repro_torch.models.ssm import ssm_blocks


def _div(n: int, size: int) -> bool:
    return n > 0 and n % size == 0


def auto_rules(cfg: ArchConfig, mesh: MeshShape, zero_stage: int = 0
               ) -> ShardingRules:
    msize = mesh.shape.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    updates: dict = {}
    updates["heads"] = "model" if _div(cfg.n_heads, msize) else None
    updates["kv_heads"] = "model" if _div(cfg.n_kv_heads, msize) else None
    updates["mlp"] = "model" if _div(cfg.d_ff or 0, msize) or \
        _div(cfg.n_shared_experts * (cfg.d_ff or 0), msize) else None
    updates["expert"] = "model" if _div(cfg.n_experts, msize) else None
    updates["vocab"] = "model" if _div(cfg.padded_vocab, msize) else None
    updates["ssm_inner"] = "model" if _div(cfg.d_inner, msize) and \
        cfg.ssm_state else None
    updates["ssm_heads"] = "model" if _div(cfg.ssm_heads, msize) and \
        _div(cfg.d_inner, msize) else None
    updates["batch"] = data_axes
    updates["fsdp"] = data_axes
    if zero_stage >= 2:            # stage 2: shard only the expert bank
        updates["expert_embed"] = data_axes
    if zero_stage >= 3:            # stage 3: shard every weight's embed dim
        updates["embed"] = data_axes
    return DEFAULT_RULES.replace(**updates)


def effective_rules(cfg: ArchConfig, mesh: MeshShape | None,
                    zero_stage: int = 0) -> ShardingRules:
    """The rules a model of ``cfg`` sees on ``mesh``: ``auto_rules`` at the
    model's ZeRO stage (ZeRO-1 shards only optimizer state, so the model
    sees stage 0), adjusted as the reference's
    ``ParallelCfg.effective_rules`` adjusts them."""
    stage = 0 if zero_stage == 1 else zero_stage
    if mesh is None:
        r = DEFAULT_RULES
    else:
        r = auto_rules(cfg, mesh, stage)
        if "pod" in mesh.axis_names:
            r = r.replace(batch=("pod", "data"),
                          fsdp=("pod", "data") if stage else None)
    if stage >= 3:
        r = r.replace(embed=r.mesh_axes("fsdp"))
    return r


def make_parallel(cfg: ArchConfig, mesh: ProcessMesh | None, *,
                  zero_stage: int = 0, remat: str = "full",
                  attn_block: int = 2048) -> ParallelCfg:
    """The ``ParallelCfg`` of ``cfg`` on ``mesh`` (None: one card): the
    rules ``auto_rules`` adapts to the arch.  A mesh takes ZeRO stage 0
    only: every stage shards weights or moments over ``data``, which
    needs ``all_gather`` / ``reduce_scatter``, and the port's collectives
    are all-reduces."""
    if mesh is not None and zero_stage:
        raise NotImplementedError(
            f"zero_stage={zero_stage} on a mesh: ZeRO is not ported (it "
            "needs all_gather / reduce_scatter; the port's collectives are "
            "all-reduces)")
    rules = auto_rules(cfg, mesh) if mesh is not None else DEFAULT_RULES
    return ParallelCfg(mesh=mesh, rules=rules, remat=remat,
                       attn_block=attn_block)


# ---------------------------------------------------------------------------
# Batch specs per input_specs key.
# ---------------------------------------------------------------------------

def _batch_axes_for(B: int, mesh: MeshShape) -> tuple[str, ...] | None:
    """Largest ("pod","data") prefix combination that divides B."""
    cands = []
    if "pod" in mesh.axis_names:
        cands.append(("pod", "data"))
        cands.append(("pod",))
    cands.append(("data",))
    for axes in cands:
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if _div(B, size):
            return axes
    return None


def batch_pspecs(cfg: ArchConfig, shape: str | ShapeCfg, mesh: MeshShape,
                 rules: ShardingRules) -> dict[str, tuple]:
    """Each ``input_specs`` key's mesh axes per dimension."""
    sc = SHAPES[shape] if isinstance(shape, str) else shape
    return {k: _key_pspec(k, s.shape, mesh)
            for k, s in input_specs(cfg, sc).items()}


def _key_pspec(k: str, shape: tuple, mesh: MeshShape) -> tuple:
    msize = mesh.shape.get("model", 1)
    if not shape:                             # scalars (pos)
        return ()
    if k in ("k_cache", "v_cache", "enc_out", "enc_out_v"):
        bt = _batch_axes_for(shape[1], mesh)  # [L, B, W|S, KVH, dh]
        kv = "model" if _div(shape[3], msize) else None
        return (None, bt, None, kv, None)
    if k == "ssm_state":                      # [L, B, H, P, N]
        bt = _batch_axes_for(shape[1], mesh)
        hs = "model" if _div(shape[2], msize) else None
        return (None, bt, hs, None, None)
    if k == "conv_state":                     # [L, B, K-1, C]
        return (None, _batch_axes_for(shape[1], mesh), None, None)
    bt = _batch_axes_for(shape[0], mesh)      # [B, ...] tokens/labels/embeds
    return (bt, *([None] * (len(shape) - 1)))


def _block(t, dim: int, axes, mesh):
    """``t``'s block along ``dim`` of the mesh axes ``axes`` (None: all)."""
    if axes is None:
        return t
    n, i = 1, 0
    for a in axes:
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coord(a)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def batch_shard(batch: dict, cfg: ArchConfig, par: ParallelCfg) -> dict:
    """This rank's block of every key of a global ``batch`` (the model's
    inputs in ``input_specs`` keys), as views: batch dims by
    ``batch_pspecs``, caches as the layers hold them (the module
    docstring).  The identity without a mesh."""
    mesh = par.mesh
    if mesh is None:
        return batch
    out = {}
    for k, t in batch.items():
        spec = _key_pspec(k, tuple(t.shape), mesh)
        if not spec:
            out[k] = t
            continue
        bdim = 1 if k in ("k_cache", "v_cache", "enc_out", "enc_out_v",
                          "ssm_state", "conv_state") else 0
        t = _block(t, bdim, spec[bdim], mesh)
        if k in ("k_cache", "v_cache", "enc_out", "enc_out_v"):
            _, _, k0, k1 = head_blocks(cfg, par)
            t = t[:, :, :, k0:k1]
        elif k == "ssm_state":
            _, _, h0, h1 = ssm_blocks(cfg, par)
            t = t[:, :, h0:h1]
        elif k == "conv_state":
            c0, c1, _, _ = ssm_blocks(cfg, par)
            if (c0, c1) != (0, cfg.d_inner):
                t = torch.cat([t[..., c0:c1], t[..., cfg.d_inner:]], -1)
        out[k] = t
    return out


def gather_params(local: dict, defs: dict, par: ParallelCfg) -> dict:
    """The whole of each leaf of ``local`` (a flat dict by
    ``named_parameters`` name: parameters, gradients or moments), on every
    rank: each rank's block is put in place in zeros and summed over the
    mesh axes the leaf splits on (all-reduces only; a check, not a step)."""
    rules, mesh = par.effective_rules(), par.mesh
    out = {}

    def walk(d, name):
        if not isinstance(d, ParamDef):
            for k in sorted(d):
                walk(d[k], f"{name}.{k}" if name else k)
            return
        t = local[name]
        axes = [a for ax in rules.spec(d.logical) if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if mesh is None or not axes:
            out[name] = t
            return
        full = t.new_zeros(d.shape)
        full[local_slices(d, rules, mesh)] = t
        out[name] = sum_no_grad(full, par, tuple(axes))

    walk(defs, "")
    return out
