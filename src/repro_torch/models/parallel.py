"""Parallelism configuration threaded through every model apply, and the
collectives of a model placed on a mesh.

The counterpart of ``repro.models.parallel``.  ``ParallelCfg`` carries
the mesh (a :class:`~repro_torch.launch.mesh.ProcessMesh`: this rank's
place in a ``(data, model)`` fleet, or None on one card), the
logical-to-mesh ``rules``, the ZeRO stage and the perf levers:
``attn_block`` is the tile of the plain blockwise attention
(``attention.flash_unrolled``), which the CPU runs and the train mode's
backward recomputes (the card's kernel tiles itself); ``remat`` the train
mode's per-layer recompute policy (``families._remat``); ``loss_chunk``
the sequence chunk of the cross-entropy; ``seq_shard`` cuts the residual
stream over the sequence on ``model`` in train and prefill (the
reference's ``act_seq="model"``); ``kv_seq_shard`` cuts a decode KV
cache's window over ``model`` where its kv heads do not divide it (the
reference's ``batch_pspecs(kv_seq_shard=True)``, a parameter of the
batch specs there and of the model here, whose decode must know it).

Sharding is by construction, not by annotation: each rank holds only its
block of every sharded dimension (``params.shard_params``,
``launch.sharding.batch_shard``), so ``constrain`` and ``batch_spec`` stay
no-ops, and what GSPMD inserts in the reference is explicit code in the
layer that needs it, through the collectives below.  They are the only
place bytes cross ranks, each over one mesh axis's gloo group (NCCL
cannot put two ranks on one card).  Over ``model``, all-reduces:

* :func:`reduce_from_model`: the forward sums the partial results of a
  row-parallel product over ``model``; the backward is the identity (its
  output is used alike on every model rank);
* :func:`copy_to_model`: the forward is the identity; the backward sums
  the partial gradients of an input that a sharded region reads (the
  counterpart of GSPMD's reduce of a replicated operand's gradient);
* :func:`sum_over_model`: both ways a sum, for a statistic that every
  rank reads differently (the gated norm's sum of squares);
* :func:`all_reduce_max` and :func:`sum_no_grad`: no gradient, for the
  loss's max and counts.

Over the batch axes (``data``, and ``pod`` on two pods), the ZeRO
stages' traffic (``zero_stage``; the reference's meaning of each stage:
1 shards the moments, 2 also the expert bank, 3 every weight's ``embed``
dimension, over the data axes):

* :func:`gather_from_data`: the forward all-gathers a data-sharded
  weight's blocks where a layer uses it (each layer its own, inside its
  remat: ``families.stack_apply``; the embedding, final norm and
  unembedding in ``api``; the expert bank in ``moe.moe_apply``, cast to
  bf16 first); the backward reduce-scatters its gradient in float32, so
  that each rank gets its block of the sum over data (GSPMD's
  gather-at-use and its transposed reduce);
* :func:`sum_over_data`: the gradients of the leaves the model holds
  whole over data, each an all-reduce over the batch axes, or, at stages
  1-2 for a leaf whose moments are data-sharded, a reduce-scatter to the
  moments' block.  The loss is normalised by the global count of
  labelled positions, so each data rank's loss is its share of the
  global loss and the shares' gradients add, as GSPMD's gradient reduce
  adds them;
* :func:`all_gather` and :func:`reduce_scatter`, the plain collectives
  under both (AdamW all-gathers a stage 1-2 leaf's updated blocks).

Under ``seq_shard`` (:attr:`ParallelCfg.seq_sharded`) the residual
stream holds this rank's block of the sequence, and the sublayers meet it
through four entries, each ``copy_to_model``, ``reduce_from_model`` or
the identity without the lever:

* :func:`enter_model`: where a sharded sublayer would ``copy_to_model``,
  the forward all-gathers the sequence over ``model``; the backward
  reduce-scatters the partial gradients back to the blocks, in float32;
* :func:`leave_model`: where it would ``reduce_from_model``, the forward
  reduce-scatters the float32 partial products over the sequence; the
  backward all-gathers the gradient;
* :func:`whole_seq` and :func:`own_seq`, the same all-gather with a
  slice for the other leg, for what a rank computes whole (replicated
  heads, the SSM's B/C stream, the router): its input gathered, its
  gradient (whole on every rank) sliced; its output sliced, its gradient
  gathered.

Under remat ``tp_out`` (``families._remat``) the sums over ``model`` of
the sublayer outputs (``reduce_from_model``, ``leave_model``) are kept
from the forward (:class:`TpOut`) and handed back to the recompute
instead of being summed again.

One route per collective: ``all_reduce``, ``all_gather`` and
``reduce_scatter`` of ``torch.distributed`` on the axis's gloo group,
with the tensor where it lies (gloo stages a CUDA tensor through the host
itself).  Partial products and gradients are reduced in float32 and
rounded once.  The reference's ``ar_barrier`` (an XLA partitioner lever
that keeps the reduce in bf16) is not ported: the port never reduces in
bf16.  Every collective counts its calls and bytes in :data:`TRAFFIC`, by
mesh axis and op; on a counted mesh (``ProcessMesh.counted``, the dry
run's rank 0 on ``meta``) it counts and moves nothing.  On a mesh of one
rank, or with no mesh, each is the identity.  Not ported:
``scan_layers`` and ``moe_ep`` (experts sharded over ``model`` always
take the expert-parallel path).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import TYPE_CHECKING, NamedTuple

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
    remat: str = "full"          # full | dots | tp_out | none (per layer)
    attn_block: int = 2048       # flash block size (q and kv)
    loss_chunk: int = 1024       # CE loss seq chunk
    zero_stage: int = 0          # 0: replicated over data; 1: moments,
    # 2: and the expert bank, 3: every weight's embed dim over data
    seq_shard: bool = False      # residual stream's sequence over model
    kv_seq_shard: bool = False   # decode KV window over model
    whole_batch: bool = False    # the batch is the same on every data
    # rank (the engine's one-request prefill): no data rank holds a block

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
    def batch_shards(self) -> int:
        """The data ranks the batch is split over (1 for a whole batch)."""
        return 1 if self.whole_batch else self.data_size

    @property
    def model_index(self) -> int:
        return 0 if self.mesh is None else self.mesh.coord("model")

    @property
    def seq_sharded(self) -> bool:
        """Whether the residual stream holds a block of the sequence."""
        return self.seq_shard and self.model_axis_size > 1

    @property
    def kv_window_sharded(self) -> bool:
        """Whether a decode KV cache holds a block of the window: the
        lever is set and the kv heads do not split over ``model``."""
        return (self.kv_seq_shard and self.model_axis_size > 1
                and not self.tp_sharded("kv_heads"))

    def tp_sharded(self, logical: str) -> bool:
        """Whether the logical axis ``logical`` is split over ``model``
        (as a weight's first model-mapped dimension, which it is in every
        weight of the port's layers)."""
        return (self.model_axis_size > 1
                and self.effective_rules().mesh_axes(logical) == "model")

    def rules_at(self, stage: int) -> ShardingRules:
        """``rules`` adjusted as the reference's ``effective_rules`` adjusts
        them for a model at ZeRO ``stage`` (``rules`` being ``auto_rules``
        at any stage: the expert bank's and ``embed``'s rows are set
        here)."""
        r = self.rules
        if self.mesh is not None:
            if stage >= 2:
                r = r.replace(expert_embed=self.batch_axes)
            if "pod" in self.mesh.axis_names:
                r = r.replace(batch=("pod", "data"),
                              fsdp=("pod", "data") if stage else None)
        if stage >= 3:
            r = r.replace(embed=r.mesh_axes("fsdp"))
        if self.seq_shard:
            r = r.replace(act_seq="model")
        return r

    def effective_rules(self) -> ShardingRules:
        """The model's rules: ZeRO-1 shards only the moments, so the model
        sees stage 0's."""
        return self.rules_at(0 if self.zero_stage == 1 else self.zero_stage)

    def moment_rules(self) -> ShardingRules:
        """The rules of the AdamW moments: stage 3's at stages 1-3 (the
        reference's dry run shards them so), the model's at stage 0."""
        return self.rules_at(3) if self.zero_stage else self.rules_at(0)


def data_dim(logical: tuple, rules: ShardingRules) -> int | None:
    """The dimension of a leaf with logical axes ``logical`` that
    ``rules`` split over the batch axes (None: none is)."""
    for i, ax in enumerate(rules.spec(logical)):
        if ax is not None and any(a in BATCH_AXES for a in
                                  (ax if isinstance(ax, tuple) else (ax,))):
            return i
    return None


class Placement(NamedTuple):
    """Where a model's leaves lie over the mesh, by ``named_parameters``
    name: ``model`` the leaves split over ``model``; ``data`` each leaf
    whose block the model's rules split over the data axes, and that
    dimension (ZeRO stages 2-3: its gradient comes summed, as the block);
    ``scatter`` each leaf held whole over data whose moments are split
    there (stages 1-2), and that dimension."""
    model: frozenset = frozenset()
    data: dict = {}
    scatter: dict = {}


def placement(defs: dict, par: ParallelCfg) -> Placement:
    """The :class:`Placement` of the tree ``defs`` under ``par``."""
    if par.mesh is None:
        return Placement()
    rules, moments = par.effective_rules(), par.moment_rules()
    model, data, scatter = set(), {}, {}

    def walk(t, name):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{name}.{k}" if name else k)
            return
        if par.model_axis_size > 1 and "model" in rules.spec(t.logical):
            model.add(name)
        if par.data_size > 1:
            held, dm = data_dim(t.logical, rules), data_dim(t.logical,
                                                            moments)
            if held is not None:
                data[name] = held
            elif dm is not None:
                scatter[name] = dm

    walk(defs, "")
    return Placement(frozenset(model), data, scatter)


def constrain(x, par: ParallelCfg, spec=None):
    """A sharding constraint: a no-op, since each rank holds its block."""
    return x


def batch_spec(par: ParallelCfg, *rest):
    """The activation batch spec: none, since each rank holds its block."""
    return None


# ---------------------------------------------------------------------------
# Traffic counts.
# ---------------------------------------------------------------------------

# Per mesh axis and op (all_reduce, all_gather, reduce_scatter): [calls,
# bytes, seconds].  The bytes are the whole tensor's: an all-reduce's
# input, an all-gather's output, a reduce-scatter's input.  Seconds are
# taken only while TIME_COLLECTIVES is set (each call then synchronises
# its device first, so that the time is the collective's own).
TRAFFIC: dict[str, dict[str, list]] = {}
TIME_COLLECTIVES = False


def reset_traffic() -> None:
    TRAFFIC.clear()


def traffic_table(index: int = 1) -> dict:
    """``{axis: {op: TRAFFIC's column index}}`` (1: bytes)."""
    return {a: {op: v[index] for op, v in sorted(ops.items())}
            for a, ops in sorted(TRAFFIC.items())}


def _collective(axis: str, op: str, nbytes: int, x: torch.Tensor, par,
                run) -> torch.Tensor | None:
    """Count one ``op`` of ``nbytes`` over ``axis`` and run ``run()`` on a
    placed mesh (timed under TIME_COLLECTIVES); None on a counted one,
    whose tensors must be ``meta``."""
    rec = TRAFFIC.setdefault(axis, {}).setdefault(op, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += nbytes
    if not par.mesh.placed:
        if x.device.type != "meta":
            raise RuntimeError(
                "a counted mesh moves no data: run it on meta tensors, or "
                "place the mesh on a fleet (ProcessMesh.build)")
        return None
    if TIME_COLLECTIVES and x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    y = run()
    if TIME_COLLECTIVES:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        rec[2] += time.perf_counter() - t0
    return y


def _all_reduce(x: torch.Tensor, par: ParallelCfg, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the mesh axis ``axis``, as a new tensor."""
    mesh = par.mesh
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    y = x.clone(memory_format=torch.contiguous_format)

    def run():
        dist.all_reduce(y, op=op, group=mesh.groups[axis])
        return y
    _collective(axis, "all_reduce", x.numel() * x.element_size(), x, par,
                run)
    return y


def _gather_one(x: torch.Tensor, par: ParallelCfg, axis: str, dim: int
                ) -> torch.Tensor:
    n = par.mesh.axis_size(axis)
    shape = list(x.shape)
    shape[dim] *= n
    xc = x.contiguous()
    parts = [torch.empty_like(xc) for _ in range(n)]

    def run():
        dist.all_gather(parts, xc, group=par.mesh.groups[axis])
        return torch.cat(parts, dim)
    y = _collective(axis, "all_gather", xc.numel() * n * xc.element_size(),
                    x, par, run)
    return x.new_empty(shape) if y is None else y


def _scatter_one(x: torch.Tensor, par: ParallelCfg, axis: str, dim: int
                 ) -> torch.Tensor:
    n = par.mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"a dimension of {x.shape[dim]} does not split "
                         f"into {n} blocks over {axis}")
    parts = [p.contiguous() for p in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])

    def run():
        dist.reduce_scatter(out, parts, group=par.mesh.groups[axis])
        return out
    _collective(axis, "reduce_scatter", x.numel() * x.element_size(), x,
                par, run)
    return out


def _axes(par: ParallelCfg, axes) -> list[str]:
    """The axes of ``axes`` (the batch axes when None) with more than one
    rank, outermost first."""
    if par.mesh is None:
        return []
    axes = par.batch_axes if axes is None else (
        axes if isinstance(axes, tuple) else (axes,))
    return [a for a in axes if par.mesh.axis_size(a) > 1]


@torch.no_grad()
def all_gather(x: torch.Tensor, par: ParallelCfg, dim: int,
               axes=None) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` put together in rank
    order over ``axes`` (the batch axes by default), as
    ``jax.lax.all_gather(..., tiled=True)``: over several axes the
    innermost is gathered first, so that block ``i * n_inner + j`` lands
    at its place."""
    for a in reversed(_axes(par, axes)):
        x = _gather_one(x, par, a, dim)
    return x


@torch.no_grad()
def reduce_scatter(x: torch.Tensor, par: ParallelCfg, dim: int,
                   axes=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    over ``axes`` (the batch axes by default): the transpose of
    :func:`all_gather`, the outermost axis scattered first."""
    for a in _axes(par, axes):
        x = _scatter_one(x, par, a, dim)
    return x


class TpOut:
    """The sums over ``model`` of one layer's sublayer outputs under remat
    ``tp_out``: kept as the forward makes them, and handed back in order
    to the backward's recompute, whose inputs to them are the forward's
    bit for bit, so that the recompute sums nothing again."""

    def __init__(self):
        self.saved: list[torch.Tensor] = []
        self.at: int | None = None        # the replay's place; None: saving

    @contextlib.contextmanager
    def _active(self, at):
        self.at = at
        token = _TP_OUT.set(self)
        try:
            yield
        finally:
            _TP_OUT.reset(token)

    def saving(self):
        return self._active(None)

    def replaying(self):
        return self._active(0)


# The layer being run under tp_out, and whether a sublayer's output
# product is being made: set only inside the ``with`` blocks below, in
# the thread that runs the layer (the recompute runs in autograd's).
_TP_OUT: contextvars.ContextVar = contextvars.ContextVar("tp_out",
                                                         default=None)
_OUTPUT: contextvars.ContextVar = contextvars.ContextVar("sublayer_output",
                                                         default=False)


@contextlib.contextmanager
def sublayer_output():
    """Marks the product that makes a sublayer's output (before its sum
    over ``model``): remat ``tp_out`` keeps it (``families._save_tp_out``)."""
    token = _OUTPUT.set(True)
    try:
        yield
    finally:
        _OUTPUT.reset(token)


def in_sublayer_output() -> bool:
    return _OUTPUT.get()


def _kept(run, x: torch.Tensor) -> torch.Tensor:
    """``run(x)``, a sum over ``model`` of a sublayer's output: under
    ``tp_out``'s forward kept, in its recompute the kept one (moving and
    counting nothing)."""
    memo = _TP_OUT.get()
    if memo is not None and memo.at is not None:
        memo.at += 1
        return memo.saved[memo.at - 1].detach()
    y = run(x)
    if memo is not None:
        memo.saved.append(y.detach())
    return y


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        return _kept(lambda t: _all_reduce(t, par, "model"), x)

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


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dim, dtype):
        ctx.par, ctx.dim, ctx.dtype = par, dim, x.dtype
        return all_gather(x if dtype is None else x.to(dtype), par, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.to(ctx.dtype), ctx.par, ctx.dim), None,
                None, None)


def _seq_block(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """This model rank's block of ``x``'s sequence (dim 1)."""
    n, S = par.model_axis_size, x.shape[1]
    if S % n:
        raise ValueError(f"seq_shard: a sequence of {S} does not split "
                         f"into {n} blocks over model")
    return x.narrow(1, par.model_index * (S // n), S // n)


class _GatherSeq(torch.autograd.Function):
    """Forward: the sequence all-gathered over ``model`` (or ``held[0]``,
    that gather already made); backward: the partial gradients
    reduce-scattered back to the blocks, in float32."""

    @staticmethod
    def forward(ctx, x, par, held):
        ctx.par = par
        if held:
            return held[0].detach()
        return _gather_one(x, par, "model", 1)

    @staticmethod
    def backward(ctx, g):
        return (_scatter_one(g.float(), ctx.par, "model", 1).to(g.dtype),
                None, None)


class _ScatterSeq(torch.autograd.Function):
    """Forward: the partial products summed over ``model`` and
    reduce-scattered over the sequence; backward: the gradient
    all-gathered."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _kept(lambda t: _scatter_one(t, par, "model", 1), x)

    @staticmethod
    def backward(ctx, g):
        return _gather_one(g, ctx.par, "model", 1), None


class _WholeSeq(torch.autograd.Function):
    """Forward: the sequence all-gathered over ``model``; backward: this
    rank's block of a gradient that every rank holds whole."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _gather_one(x, par, "model", 1)

    @staticmethod
    def backward(ctx, g):
        return _seq_block(g, ctx.par), None


class _OwnSeq(torch.autograd.Function):
    """Forward: this rank's block of a sequence every rank holds whole;
    backward: the blocks' gradients all-gathered."""

    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        return _seq_block(x, par)

    @staticmethod
    def backward(ctx, g):
        return _gather_one(g, ctx.par, "model", 1), None


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


def enter_model(x: torch.Tensor, par: ParallelCfg,
                gathered: torch.Tensor | None = None) -> torch.Tensor:
    """The input of a sublayer split over ``model``: ``x`` itself with its
    gradient summed over the model ranks (:func:`copy_to_model`), or
    under ``seq_shard`` the whole sequence of the blocks ``x``, its
    gradient reduce-scattered back to them (``gathered``: that sequence,
    already all-gathered by :func:`whole_seq`)."""
    if par.seq_sharded:
        return _GatherSeq.apply(x, par, [] if gathered is None
                                else [gathered])
    return copy_to_model(x, par)


def leave_model(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """The output of a sublayer split over ``model``: the sum of every
    model rank's partial ``x`` (:func:`reduce_from_model`), or under
    ``seq_shard`` this rank's block of it (a reduce-scatter over the
    sequence, its gradient all-gathered)."""
    if par.seq_sharded:
        return _ScatterSeq.apply(x, par)
    return reduce_from_model(x, par)


class _Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def whole_seq(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """The input of what a rank computes whole: under ``seq_shard`` the
    sequence all-gathered, its gradient (whole on every rank) sliced back
    to the block.  Otherwise ``x``, on a split model axis through an
    identity node where the gather's node stands under ``seq_shard``: the
    gradients then meet in the same order with and without it, and add
    up to the same bits."""
    if par.seq_sharded:
        return _WholeSeq.apply(x, par)
    return _Same.apply(x) if _tp(par) else x


def own_seq(x: torch.Tensor, par: ParallelCfg) -> torch.Tensor:
    """The output of what a rank computes whole: under ``seq_shard`` this
    rank's block, its gradient all-gathered; otherwise ``x``."""
    return _OwnSeq.apply(x, par) if par.seq_sharded else x


def gather_from_data(x: torch.Tensor, par: ParallelCfg, dim: int,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """The whole of a weight split over the batch axes along ``dim`` (cast
    to ``dtype`` first, where given, so that the gather moves its bytes);
    its gradient is this rank's block of the sum over the data ranks,
    reduced in ``x``'s dtype."""
    if not _axes(par, None):
        return x if dtype is None else x.to(dtype)
    return _GatherFromData.apply(x, par, dim, dtype)


def gather_tree(tree: dict, logical: dict, par: ParallelCfg) -> dict:
    """``tree`` (a layer's or the model's top-level weights) with every
    leaf that the model's rules split over the batch axes gathered whole
    (:func:`gather_from_data`), ``logical`` giving each leaf's logical
    axes.  The expert bank (split on ``expert_embed``) is left in blocks
    for ``moe.moe_apply``, which casts it before its gather."""
    if not _axes(par, None):
        return tree
    rules = par.effective_rules()

    def walk(t, lg):
        if isinstance(t, dict):
            return {k: walk(v, lg[k]) if k in lg else v
                    for k, v in t.items()}
        d = data_dim(lg, rules)
        if d is None or lg[d] == "expert_embed":
            return t
        return gather_from_data(t, par, d)

    return walk(tree, logical)


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


def sum_over_data(tensors: dict, par: ParallelCfg,
                  done: frozenset = frozenset(),
                  scatter: dict | None = None) -> dict:
    """Each tensor of ``tensors`` (the gradients of the ranks' shares of
    the loss) summed over the batch axes, as new tensors: those named in
    ``done`` are already (``gather_from_data``'s backward reduced them),
    those in ``scatter`` (name -> dim) are reduce-scattered to this rank's
    block along their dim, the rest all-reduced."""
    if par.data_size == 1:
        return tensors
    scatter = scatter or {}
    out = {}
    for k, t in tensors.items():
        if k in done:
            out[k] = t
        elif k in scatter:
            out[k] = reduce_scatter(t, par, scatter[k])
        else:
            out[k] = sum_no_grad(t, par, par.batch_axes)
    return out
