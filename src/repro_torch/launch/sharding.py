"""Per-(arch x mesh) sharding policy: rules and batch specs.

The counterpart of ``repro.launch.sharding``, on a :class:`MeshShape`
(axis names and sizes; no devices are placed).  ``auto_rules`` adapts the
logical->mesh table to an architecture: axes that do not divide the
tensor axis (e.g. 56 query heads or 25 kv-heads on a 16-way ``"model"``
axis) fall back to replication; ``zero_stage=3`` additionally shards
every weight's ``embed`` dim over the data axes (ZeRO-3).
``batch_pspecs`` gives every ``input_specs`` key its mesh axes per
dimension (a ``PartitionSpec`` as a tuple): batch dims over
("pod","data") when divisible, KV caches' head dims over ``"model"`` when
divisible, scalars replicated.

``make_parallel`` returns the port's one-card ``ParallelCfg`` (``remat``,
``attn_block``): the mesh fields it would carry in the reference have no
one-card meaning (``models/parallel.py``).  Not ported: ``batch_shardings``
(``NamedSharding`` over placed devices), and the reference's sequence
sharding switches (``seq_shard``, ``kv_seq_shard``), which nothing in the
port sets.
"""
from __future__ import annotations

from repro_torch.launch.mesh import MeshShape
from repro_torch.models.common import ArchConfig, SHAPES, ShapeCfg, input_specs
from repro_torch.models.params import DEFAULT_RULES, ShardingRules
from repro_torch.models.parallel import ParallelCfg


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


def make_parallel(remat: str = "full", attn_block: int = 2048
                  ) -> ParallelCfg:
    """The port's ``ParallelCfg`` of a cell's policy."""
    return ParallelCfg(remat=remat, attn_block=attn_block)


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
    specs = input_specs(cfg, sc)
    msize = mesh.shape.get("model", 1)
    out: dict[str, tuple] = {}
    for k, s in specs.items():
        if not s.shape:                       # scalars (pos)
            out[k] = ()
            continue
        if k in ("k_cache", "v_cache"):       # [L, B, W, KVH, dh]
            bt = _batch_axes_for(s.shape[1], mesh)
            kv = "model" if _div(s.shape[3], msize) else None
            out[k] = (None, bt, None, kv, None)
        elif k in ("enc_out", "enc_out_v"):   # [L, B, S, KVH, dh]
            bt = _batch_axes_for(s.shape[1], mesh)
            kv = "model" if _div(s.shape[3], msize) else None
            out[k] = (None, bt, None, kv, None)
        elif k == "ssm_state":                # [L, B, H, P, N]
            bt = _batch_axes_for(s.shape[1], mesh)
            hs = "model" if _div(s.shape[2], msize) else None
            out[k] = (None, bt, hs, None, None)
        elif k == "conv_state":               # [L, B, K-1, C]
            bt = _batch_axes_for(s.shape[1], mesh)
            out[k] = (None, bt, None, None)
        else:                                 # [B, ...] tokens/labels/embeds
            bt = _batch_axes_for(s.shape[0], mesh)
            out[k] = (bt, *([None] * (len(s.shape) - 1)))
    return out
