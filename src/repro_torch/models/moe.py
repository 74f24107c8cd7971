"""Mixture-of-Experts FFN: sort-free scatter-to-capacity dispatch.

The counterpart of ``repro.models.moe`` on one card.  Each token's router
picks its top ``k`` experts; every (token, expert) slot takes the next
free row of its expert's capacity buffer ``[E, C, D]`` in token-major
order, and slots past capacity are dropped ("dropping" MoE).  The experts'
FFNs run on the buffer and the kept slots are scattered back to token
order, weighted by the renormalised router probabilities.

On a mesh whose rules shard ``expert`` over ``model``, :func:`moe_apply`
takes the reference's expert-parallel path (``_moe_ep``): the router is
replicated, each rank holds ``E / model`` experts from ``e_first = m *
E / model`` and every token of its data shard, dispatches the slots
routed to its experts at the capacity of *one data shard's* tokens (as
the reference's ``n_shard``), and the partial outputs are summed over
``model``.  Otherwise it is the reference's single-device path (every
expert, ``e_first = 0``), whose slot ranks and capacity are over the
global batch: on a data axis each rank offsets its ranks by the slots of
the data ranks before it.  The expert products stay ``torch.matmul``, as
the reference leaves them to XLA outside any Pallas kernel.

``moe_ref`` is the dense oracle (every expert on every token); with a
capacity factor large enough to drop nothing, :func:`moe_apply` matches it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (activation, cast, matmul_f32,
                                       row_parallel)
from repro_torch.models.params import ParamDef
from repro_torch.models.parallel import (ParallelCfg, copy_to_model,
                                         reduce_from_model, sum_no_grad)

def moe_defs(cfg: ArchConfig) -> dict:
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    glu = 2 if cfg.act.endswith("_glu") else 1
    defs = {
        "router": ParamDef((D, E), ("embed", None), init="scaled"),
        "w_in": ParamDef((E, D, glu, F),
                         ("expert", "expert_embed", None, "expert_mlp"),
                         init="scaled"),
        "w_out": ParamDef((E, F, D), ("expert", "expert_mlp",
                                      "expert_embed"), init="scaled"),
    }
    if cfg.n_shared_experts:
        S = cfg.n_shared_experts
        defs["shared_in"] = ParamDef((D, glu, S * F), ("embed", None, "mlp"),
                                     init="scaled")
        defs["shared_out"] = ParamDef((S * F, D), ("mlp", "embed"),
                                      init="scaled")
    return defs


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the two operands' promoted dtype, as ``jnp.einsum`` of
    mixed dtypes computes (a float32 activation against bf16 weights runs
    in float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(factor * k * n_tokens / n_experts))
    return max(4, -(-c // 4) * 4)


def _route(x2d: torch.Tensor, router: torch.Tensor, k: int):
    """x2d [N, D] -> (ids [N,k] int32, weights [N,k] f32, probs [N,E] f32).

    The top k of a stable descending sort: on equal probabilities the
    lower expert index comes first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` makes no such promise).
    """
    logits = matmul_f32(x2d, cast(router))
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return ids.to(torch.int32), w, probs


def _expert_ffn(buf: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
                act: str) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D] through each expert's FFN."""
    E, _, D = buf.shape
    h = matmul_f32(buf, w_in.reshape(E, D, -1)).unflatten(-1, w_in.shape[2:])
    h = activation(h, act).to(buf.dtype)
    return _mm(h, w_out)


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``idx`` (int64, in ``[0, n)``) fall in each of ``n``
    bins: ``torch.bincount``'s integers as a ``scatter_add_``, whose
    output size does not depend on the values (so it runs on ``meta``)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _slots(ids: torch.Tensor, e_first: int, e_local: int, capacity: int,
           offset: torch.Tensor | None = None):
    """Each flat (token, expert) slot's token, buffer row and keep flag.

    Slots are token-major (``ids.reshape(-1)``); a slot's rank is the
    exclusive running count of earlier slots on its expert, and it is kept
    when its expert is local and its rank is below ``capacity``.  The
    reference counts with a cumulative sum over a one-hot ``[N*k, E+1]``;
    here the rank is the slot's place in its expert's group of a stable
    sort by expert (the same integers, without the ``[N*k, E+1]`` scan).
    ``offset`` [e_local] adds to each expert's ranks the slots that
    earlier tokens held elsewhere (the data ranks before this one).
    Returns ``(tok, dest, keep)``, each ``[N*k]``; dropped slots point at
    the extra row ``e_local * capacity``.
    """
    N, k = ids.shape
    dev = ids.device
    flat_e = ids.reshape(-1).to(torch.int64) - e_first
    tok = torch.arange(N, device=dev).repeat_interleave(k)
    in_range = (flat_e >= 0) & (flat_e < e_local)
    le = torch.where(in_range, flat_e, e_local)              # drop bucket
    order = torch.argsort(le, stable=True)
    counts = _counts(le, e_local + 1)
    first = torch.cumsum(counts, 0) - counts     # each group's first place
    rank = torch.empty_like(le)
    rank[order] = torch.arange(le.numel(), device=dev) - first[le[order]]
    keep = in_range & (rank < capacity)
    if offset is not None:
        keep &= rank + torch.cat([offset, offset.new_zeros(1)])[le] \
            < capacity
    dest = torch.where(keep, le * capacity + rank, e_local * capacity)
    return tok, dest, keep


def _dispatch_compute(x2d, ids, wgt, w_in, w_out, *, e_first: int,
                      e_local: int, capacity: int, act: str,
                      offset: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter the slots routed to experts [e_first, e_first+e_local) into
    a capacity buffer, run the FFNs, scatter back.  Returns [N, D].

    Kept slots have distinct buffer rows, so the scatter is an assignment;
    dropped slots all write the extra last row, which ``buf[:-1]`` leaves
    out.  So no mask selects the kept slots: a boolean index would read
    the count back to the host on the card (and has no ``meta`` kernel).
    The combine adds each token's k weighted slots in slot order, rounding
    in x's dtype after each add, as the reference's sequential
    ``zeros.at[tok].add`` does; the result does not depend on the order
    in which the card runs the adds.
    """
    N, D = x2d.shape
    k = ids.shape[1]
    tok, dest, keep = _slots(ids, e_first, e_local, capacity, offset)
    buf = torch.zeros((e_local * capacity + 1, D), dtype=x2d.dtype,
                      device=x2d.device)
    buf[dest] = x2d[tok]
    out_buf = _expert_ffn(buf[:-1].reshape(e_local, capacity, D),
                          w_in, w_out, act)
    y_slot = out_buf.reshape(e_local * capacity, D)[
        torch.clamp_max(dest, e_local * capacity - 1)]
    y_slot = torch.where(keep[:, None], y_slot, 0) * wgt.reshape(-1)[:, None]
    y_slot = y_slot.to(x2d.dtype).reshape(N, k, D)
    y = torch.zeros_like(x2d)
    for j in range(k):
        y = y + y_slot[:, j]
    return y


def aux_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int,
             par: ParallelCfg | None = None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * <f_e, p_e>, over the global
    batch.  On a data axis (every rank holding as many tokens) the counts
    are summed over the data ranks and each rank returns its share: its
    tokens' part of ``p_e``."""
    pe = probs.reshape(-1, n_experts).mean(0)
    fe = _counts(ids.reshape(-1).long(), n_experts).float()
    if par is not None and par.data_size > 1:
        pe = pe / par.data_size
        fe = sum_no_grad(fe, par, par.batch_axes)
    fe = fe / torch.clamp_min(fe.sum(), 1.0)
    return n_experts * torch.sum(pe * fe)


def _shared(p: dict, x: torch.Tensor, act: str,
            par: ParallelCfg | None = None) -> torch.Tensor:
    """The shared experts' dense FFN on every token (column- then
    row-parallel where the rules shard ``mlp``)."""
    tp = par is not None and par.tp_sharded("mlp")
    if tp:
        x = copy_to_model(x, par)
    w_in = cast(p["shared_in"])
    h = _mm(x, w_in.reshape(w_in.shape[0], -1)).unflatten(-1, w_in.shape[1:])
    h = activation(h, act).to(x.dtype)
    if tp:
        return row_parallel(h, cast(p["shared_out"]), par)
    return _mm(h, cast(p["shared_out"]))


def ep_plan(n_tokens: int, cfg: ArchConfig, par: ParallelCfg
            ) -> tuple[int, int, int]:
    """``(e_first, e_local, capacity)`` of this rank's dispatch of
    ``n_tokens`` local tokens: its block of experts, at the capacity of
    its data shard's tokens (expert parallelism), or every expert at the
    capacity of the global batch."""
    E, k, cf = cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor
    if par.tp_sharded("expert"):
        e_local = E // par.model_axis_size
        return (par.model_index * e_local, e_local,
                _capacity(n_tokens, k, E, cf))
    return 0, E, _capacity(n_tokens * par.data_size, k, E, cf)


def _data_offset(ids: torch.Tensor, E: int, par: ParallelCfg):
    """Each expert's slots on the data ranks before this one (None when
    there is one data rank)."""
    if par.data_size == 1:
        return None
    rows = ids.new_zeros((par.data_size, E), dtype=torch.int64)
    rows[par.data_index] = _counts(ids.reshape(-1).long(), E)
    return sum_no_grad(rows, par, par.batch_axes)[:par.data_index].sum(0)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, par: ParallelCfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    x2d = x.reshape(-1, D)
    ids, wgt, probs = _route(x2d, p["router"], k)
    aux = aux_loss(probs, ids, E, par)
    e_first, e_local, cap = ep_plan(x2d.shape[0], cfg, par)
    if e_local == E:
        y = _dispatch_compute(x2d, ids, wgt, cast(p["w_in"]),
                              cast(p["w_out"]), e_first=0, e_local=E,
                              capacity=cap, act=cfg.act,
                              offset=_data_offset(ids, E, par))
    else:       # the reference's _moe_ep
        y = _dispatch_compute(copy_to_model(x2d, par),
                              ids, copy_to_model(wgt, par), cast(p["w_in"]),
                              cast(p["w_out"]), e_first=e_first,
                              e_local=e_local, capacity=cap, act=cfg.act)
        y = reduce_from_model(y.float(), par).to(x2d.dtype)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + _shared(p, x, cfg.act, par)
    return y, aux


def moe_ref(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Dense oracle: every expert on every token, exact top-k combine."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    ids, wgt, _ = _route(x2d, p["router"], cfg.experts_per_token)
    w_in = cast(p["w_in"])                                    # [E, D, g, F]
    h = torch.einsum("nd,edgf->negf", *(
        t.to(torch.promote_types(x2d.dtype, w_in.dtype)) for t in (x2d, w_in)))
    h = activation(h, cfg.act).to(x2d.dtype)
    w_out = cast(p["w_out"])
    dt = torch.promote_types(h.dtype, w_out.dtype)
    y_all = torch.einsum("nef,efd->ned", h.to(dt), w_out.to(dt))  # [N, E, D]
    sel = torch.take_along_dim(y_all, ids.long()[..., None], dim=1)
    y = (sel * wgt[..., None].to(sel.dtype)).sum(1)
    if cfg.n_shared_experts:
        y = y + _shared(p, x2d, cfg.act)
    return y.reshape(B, S, D)
