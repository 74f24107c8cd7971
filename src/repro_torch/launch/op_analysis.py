"""Op-level cost of one eager call: FLOPs, bytes and peak live bytes.

The counterpart of ``repro.launch.hlo_analysis``.  The reference reads the
cost of a compiled XLA program (``cost_analysis()``,
``memory_analysis()``); the port's programs run eagerly, op by op, so
:class:`CostMode` (a ``TorchDispatchMode``) watches every aten op of one
call, on any device, ``meta`` included, where nothing is computed or
allocated:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention) for aten ops, and each hand-written kernel's
  own formula for a kernel entry (``kernels.cost.counted``);
* **bytes**: every aten op's input and output bytes, unfused, as XLA's CPU
  ``bytes accessed`` counts them (an overestimate of the card's traffic,
  as the reference's roofline says of its own).  Views and allocations
  move no bytes;
* **peak live bytes**: tensor storages, each counted once across its
  views, from the op that makes it until it is freed, tensors that
  autograd saves for the backward included, on top of the ``live``
  tensors the call starts with (its arguments).

While a :class:`CostMode` is entered it stands in ``kernels.cost.ACTIVE``,
and a kernel entry then runs through ``kernels.cost.counted``: its cost
formula is added once, and the aten ops inside the entry (the plain
version on the CPU, the output allocations on the card and on ``meta``)
are not counted, so one call counts the same on ``meta``, the CPU and the
card (``gate_quantile``'s FLOPs excepted: they depend on its windows'
values, and ``meta`` charges their upper bound).  Ops that a
kernel entry's caller runs around it (reshapes, casts, the train mode's
plain recompute in the backward) are real work on the card and are
counted.

:func:`cost_dict` and :func:`memory_dict` return the reference's keys, so
``roofline.analyze`` reads the port's records as the reference's reads
its own.  :func:`collective_dict` is the counterpart of the reference's
collective parse: the bytes ``models.parallel``'s all-reduces reduced
during the call, per mesh axis (they are the only place bytes cross
ranks, and on a counted mesh they count without moving).  Not ported,
and why: the bf16-dot correction (an artifact of XLA's CPU backend) and
the probe extrapolation over a ``while`` body counted once (the port's
layer stack is a Python loop, counted L times).
"""
from __future__ import annotations

import weakref
from typing import Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.models import parallel

aten = torch.ops.aten

# Allocations: no byte of data moves.
_ALLOCATIONS = frozenset({
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default})

# Element-wise transcendental functions (XLA's ``transcendentals``).
_TRANSCENDENTAL = frozenset({
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.sin, aten.cos, aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt,
    aten.pow, aten.erf, aten.softplus, aten.silu, aten.gelu,
    aten._softmax, aten._log_softmax})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes of the ops run under it.

    ``live``: tensors alive when the call starts (its arguments, and
    parameters a closure holds); their storages make ``argument_bytes``
    and the floor of ``peak_bytes``.  ``ops`` maps each aten op (or
    ``kernel:<name>``) to ``[calls, flops, bytes]``.
    """

    def __init__(self, live: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.ops: dict[str, list[int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.output_bytes = 0            # set by count()
        self.output_alias_bytes = 0
        self._storages: dict[int, int] = {}
        self.quiet = 0
        self.collective: dict[str, int] = {}   # all-reduce bytes per axis,
        # set by count()
        self._arguments: set[int] = set()
        for t in live:
            self._arguments.add(self._track(t))
        self.argument_bytes = self.live_bytes

    def __enter__(self):
        kcost.ACTIVE.append(self)        # the kernel entries' cost hook
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        kcost.ACTIVE.remove(self)
        return out

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._storages:
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key).atexit = False
        return key

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)
        self._arguments.discard(key)

    def alias_bytes(self, outputs) -> int:
        """Bytes of ``outputs`` whose storage is an argument's (updated in
        place, XLA's donated buffers)."""
        keys = {_storage_key(t) for t in tree_leaves(outputs)
                if isinstance(t, torch.Tensor)}
        return sum(self._storages.get(k, 0) for k in keys & self._arguments)

    # -- counting -------------------------------------------------------------
    def add(self, name: str, flops: int, bytes_: int) -> None:
        rec = self.ops.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += bytes_
        self.flops += flops
        self.bytes += bytes_

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":      # record_function marks
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if not self.quiet and packet not in flop_registry:
            # As FlopCounterMode does: an op with a decomposition is
            # counted as the ops it decomposes into.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if self.quiet:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        moved = 0
        if func not in _ALLOCATIONS:
            in_keys = {_storage_key(t) for t in ins}
            view = (not func._schema.is_mutable and outs
                    and all(_storage_key(t) in in_keys for t in outs))
            if not view:
                moved = sum(_nbytes(t) for t in ins) \
                    + sum(_nbytes(t) for t in outs)
        self.add(str(func), flops, moved)
        return out


def tensors(*trees) -> list[torch.Tensor]:
    """The tensors among the leaves of nested dicts, lists and tuples."""
    return [t for t in tree_leaves(trees) if isinstance(t, torch.Tensor)]


def count(fn: Callable, *args, live: Iterable[torch.Tensor] = (), **kwargs):
    """``(fn(*args, **kwargs), mode)``: the call run under a fresh
    :class:`CostMode` whose live tensors are ``args``' and ``live``'s."""
    mode = CostMode(live=[*tensors(args, kwargs), *live])
    before = {a: v[1] for a, v in parallel.TRAFFIC.items()}
    with mode:
        out = fn(*args, **kwargs)
    mode.collective = {a: v[1] - before.get(a, 0)
                       for a, v in parallel.TRAFFIC.items()
                       if v[1] > before.get(a, 0)}
    mode.output_bytes = sum(t.untyped_storage().nbytes() for t in
                            {_storage_key(t): t
                             for t in tensors(out)}.values())
    mode.output_alias_bytes = mode.alias_bytes(out)
    return out, mode


def cost_dict(mode: CostMode) -> dict:
    """The reference's ``cost_dict`` keys of a counted call."""
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "transcendentals": float(mode.transcendentals)}


def collective_dict(mode: CostMode) -> dict:
    """The bytes the counted call all-reduced, per mesh axis."""
    return {a: int(b) for a, b in sorted(mode.collective.items())}


def memory_dict(mode: CostMode) -> dict:
    """The reference's ``memory_dict`` keys of a counted call: its
    arguments, its outputs, the peak above the arguments (``temp``) and
    the outputs that are arguments updated in place (``alias``)."""
    return {"argument_bytes": int(mode.argument_bytes),
            "output_bytes": int(mode.output_bytes),
            "temp_bytes": int(mode.peak_bytes - mode.argument_bytes),
            "alias_bytes": int(mode.output_alias_bytes)}
