"""Parallelism configuration threaded through every model apply, and the
collectives of a model placed on a mesh.

The counterpart of ``repro.models.parallel``.  ``ParallelCfg`` carries
the mesh (a :class:`~repro_torch.launch.mesh.ProcessMesh`: this rank's
place in a ``(data, model)`` fleet, or None on one card), the
logical-to-mesh ``rules`` and the perf levers: ``attn_block``
is the tile of the plain blockwise attention (``attention.flash_unrolled``),
which the CPU runs and the train mode's backward recomputes (the card's
kernel tiles itself); ``remat`` the train mode's per-layer recompute
policy (``families._remat``); ``loss_chunk`` the sequence chunk of the
cross-entropy.

Sharding is by construction, not by annotation: each rank holds only its
block of every sharded dimension (``params.shard_params``,
``launch.sharding.batch_shard``), so ``constrain`` and ``batch_spec`` stay
no-ops, and what GSPMD inserts in the reference is explicit code in the
layer that needs it, through the collectives below.  They are the only
place bytes cross ranks, each an ``all_reduce`` over one mesh axis's gloo
group (gloo reduces CUDA tensors through the host; NCCL cannot put two
ranks on one card); nothing here needs an ``all_gather`` or a
``reduce_scatter``:

* :func:`reduce_from_model`: the forward sums the partial results of a
  row-parallel product over ``model``; the backward is the identity (its
  output is used alike on every model rank);
* :func:`copy_to_model`: the forward is the identity; the backward sums
  the partial gradients of an input that a sharded region reads (the
  counterpart of GSPMD's reduce of a replicated operand's gradient);
* :func:`sum_over_model`: both ways a sum, for a statistic that every
  rank reads differently (the gated norm's sum of squares);
* :func:`all_reduce_max` and :func:`sum_no_grad`: no gradient, for the
  loss's max and counts;
* :func:`sum_over_data`: the gradients' sum over the batch axes.  The
  loss is normalised by the global count of labelled positions, so each
  data rank's loss is its share of the global loss and the shares'
  gradients add, as GSPMD's gradient reduce adds them.

Partial products are reduced in float32 and rounded once.  The
reference's ``ar_barrier`` (an XLA partitioner lever that keeps the
reduce in bf16) is not ported: the port never reduces in bf16.  Every
collective counts its calls and bytes in :data:`TRAFFIC`; on a counted
mesh (``ProcessMesh.counted``, the dry run's rank 0 on ``meta``) it
counts and moves nothing.  On a mesh of one rank, or with no mesh, each
is the identity.  Not ported: ``zero_stage`` (ZeRO needs ``all_gather``
and ``reduce_scatter``), ``seq_shard``, ``scan_layers`` and ``moe_ep``
(experts sharded over ``model`` always take the expert-parallel path).
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from repro_torch.models.params import DEFAULT_RULES, ShardingRules

if TYPE_CHECKING:
    from repro_torch.launch.mesh import ProcessMesh

BATCH_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    mesh: "ProcessMesh | None" = None   # None: one card
    rules: ShardingRules = DEFAULT_RULES
    remat: str = "full"          # full | dots | none  (per-layer recompute)
    attn_block: int = 2048       # flash block size (q and kv)
    loss_chunk: int = 1024       # CE loss seq chunk

    @property
    def batch_axes(self) -> tuple[str, ...]:
        if self.mesh is None:
            return ()
        return tuple(a for a in BATCH_AXES if a in self.mesh.axis_names)

    @property
    def model_axis_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size("model")

    @property
    def data_size(self) -> int:
        """Ranks over the batch axes."""
        n = 1
        for a in self.batch_axes:
            n *= self.mesh.axis_size(a)
        return n

    @property
    def data_index(self) -> int:
        """This rank's block of the batch axes."""
        i = 0
        for a in self.batch_axes:
            i = i * self.mesh.axis_size(a) + self.mesh.coord(a)
        return i

    @property
    def model_index(self) -> int:
        return 0 if self.mesh is None else self.mesh.coord("model")

    def tp_sharded(self, logical: str) -> bool:
        """Whether the logical axis ``logical`` is split over ``model``
        (as a weight's first model-mapped dimension, which it is in every
        weight of the port's layers at ZeRO stage 0)."""
        return (self.model_axis_size > 1
                and self.effective_rules().mesh_axes(logical) == "model")

    def effective_rules(self) -> ShardingRules:
        r = self.rules
        if self.mesh is not None and "pod" in self.mesh.axis_names:
            r = r.replace(batch=("pod", "data"), fsdp=None)
        return r


def constrain(x, par: ParallelCfg, spec=None):
    """A sharding constraint: a no-op, since each rank holds its block."""
    return x


def batch_spec(par: ParallelCfg, *rest):
    """The activation batch spec: none, since each rank holds its block."""
    return None


# ---------------------------------------------------------------------------
# Traffic counts.
# ---------------------------------------------------------------------------

# Per mesh axis: [all_reduce calls, bytes reduced, seconds].  Seconds are
# taken only while TIME_COLLECTIVES is set (each call then synchronises
# its device first, so that the time is the collective's own).
TRAFFIC: dict[str, list] = {}
TIME_COLLECTIVES = False


def reset_traffic() -> None:
    TRAFFIC.clear()


def traffic_bytes() -> int:
    return sum(v[1] for v in TRAFFIC.values())


def _all_reduce(x: torch.Tensor, par: ParallelCfg, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the mesh axis ``axis``, as a new tensor."""
    mesh = par.mesh
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    rec = TRAFFIC.setdefault(axis, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += x.numel() * x.element_size()
    if not mesh.placed:
        if x.device.type != "meta":
            raise RuntimeError(
                "a counted mesh moves no data: run it on meta tensors, or "
                "place the mesh on a fleet (ProcessMesh.build)")
        return x.clone()
    y = x.clone(memory_format=torch.contiguous_format)
    if TIME_COLLECTIVES and y.is_cuda:
        torch.cuda.synchronize(y.device)
    t0 = time.perf_counter()
    dist.all_reduce(y, op=op, group=mesh.groups[axis])
    if TIME_COLLECTIVES:
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        rec[2] += time.perf_counter() - t0
    return y


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        return _all_reduce(x, par, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.par, "model"), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _all_reduce(x, par, "model")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.par, "model"), None


def _tp(par: ParallelCfg) -> bool:
    return par.model_axis_size > 1


def reduce_from_model(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """The sum of every model rank's ``x``; the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, par) if _tp(par) else x


def copy_to_model(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the model ranks."""
    return _CopyToModel.apply(x, par) if _tp(par) else x


def sum_over_model(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """The sum of every model rank's ``x``, and so of its gradient."""
    return _SumOverModel.apply(x, par) if _tp(par) else x


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, par: ParallelCfg,
                   axis: str = "model") -> torch.Tensor:
    """The elementwise max of every rank's ``x`` over ``axis``."""
    return _all_reduce(x, par, axis, dist.ReduceOp.MAX)


@torch.no_grad()
def sum_no_grad(x: torch.Tensor, par: ParallelCfg,
                axes: tuple[str, ...] = ("model",)) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes``, outside autograd."""
    for a in axes:
        x = _all_reduce(x, par, a)
    return x


def sum_over_data(tensors: dict, par: ParallelCfg) -> dict:
    """Each tensor of ``tensors`` summed over the batch axes (the
    gradients of the ranks' shares of the loss), as new tensors."""
    if par.data_size == 1:
        return tensors
    return {k: sum_no_grad(t, par, par.batch_axes)
            for k, t in tensors.items()}
