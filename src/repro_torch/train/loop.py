"""Training loop: one step (forward, backward, AdamW) and a fault-tolerant
driver.

The counterpart of ``repro.train.loop``.  :func:`make_train_step` builds
one step: the loss and its gradient over ``microbatches`` slices of the
batch (losses and gradients summed, then scaled by ``1 / n``, as the
reference's scan does), optional int8 error-feedback compression, then
the AdamW update with global-norm clipping, written back into the model's
parameters.  The reference jits that step into one XLA program; here it
runs eagerly, its attention and SSM forwards through the hand-written
kernels on the card.

:class:`Trainer` is the driver: the synthetic data pipeline, checkpoints
(atomic, async, keep-k), preemption recovery (``resume()`` picks up from
the latest complete checkpoint, the data cursor included) and a fault
hook for tests to raise at any step.  The optimizer state is a flat dict
by ``Model.named_parameters()`` name (``blocks.attn.wq``, ...); a
checkpoint holds it as nested dicts in the reference's layout
(``params/blocks/attn/wq``), so either package restores the ``params``
subtree the other wrote.  The compression residual is kept, and saved,
only when ``compress_grads`` is on (the reference always carries it).

On a mesh (``model.par.mesh``) the model holds its rank's blocks: the
microbatches' local gradients are accumulated, then summed over the data
ranks (``parallel.sum_over_data``: each rank's loss is its share of the
global loss) before compression, where GSPMD's gradient reduce sits in
the reference; AdamW updates the local blocks, clipping by the norm of
the whole gradient.  The Trainer cuts its rank's block of every
pipeline batch (``launch.sharding.batch_shard``), and each rank
checkpoints its own shard as ``proc_{rank}.npz``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch.sharding import batch_shard
from repro_torch.models.api import Model, model_defs
from repro_torch.models.common import ShapeCfg
from repro_torch.models.params import init_params, leaf_block
from repro_torch.models.parallel import sum_no_grad, sum_over_data
from repro_torch.optim import (AdamWConfig, CompressState, OptState,
                               adamw_init, adamw_update, compress_init,
                               compressed_grads)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # grad-accumulation chunks per step
    ckpt_every: int = 50
    log_every: int = 10
    compress_grads: bool = False   # int8 error-feedback (cross-pod reduce)
    opt: AdamWConfig = AdamWConfig()


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` slices of the batch along dim 0 (scalars go to every slice),
    in order, as the reference's reshape to ``[n, B // n, ...]``."""
    B = next(v.shape[0] for v in batch.values() if v.ndim)
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    b = B // n
    return [{k: v[j * b:(j + 1) * b] if v.ndim else v
             for k, v in batch.items()} for j in range(n)]


def make_train_step(model: Model, tc: TrainConfig) -> Callable:
    """``(opt_state, cstate, batch) -> (opt_state, cstate, metrics)``: one
    step on ``model``, whose parameters it updates in place.  ``cstate``
    is None unless ``tc.compress_grads``; ``metrics`` holds the tensors
    ``loss``, ``grad_norm``, ``lr`` (and ``compress_residual_sq``)."""
    params = dict(model.named_parameters())
    par = model.par

    def grads_of(batch):
        if tc.microbatches <= 1:
            return model.loss(batch)
        loss = torch.zeros((), device=model.device)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        for mb in _microbatches(batch, tc.microbatches):
            l, g = model.loss(mb)
            loss = loss + l
            for k, x in g.items():
                acc[k].add_(x)
            del g
        inv = 1.0 / tc.microbatches
        return loss * inv, {k: x * inv for k, x in acc.items()}

    def step(opt_state: OptState, cstate: CompressState | None,
             batch: dict):
        loss, grads = grads_of(batch)
        if par.mesh is not None:
            loss = sum_no_grad(loss, par, par.batch_axes)
            grads = sum_over_data(grads, par)
        metrics = {"loss": loss}
        if tc.compress_grads:
            grads, cstate, cm = compressed_grads(grads, cstate)
            metrics.update(cm)
        new, opt_state, om = adamw_update(params, grads, opt_state, tc.opt,
                                          par, model.sharded)
        del grads
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        metrics.update(om)
        return opt_state, cstate, metrics

    return step


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}`` (the same tensors)."""
    out: dict = {}
    for name, x in flat.items():
        *path, leaf = name.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = x
    return out


def _unnest(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_unnest(v, name) if isinstance(v, dict) else {name: v})
    return out


class Trainer:
    """Trains ``model`` (a ready :class:`Model`: random weights from
    ``build_model``, or the reference's through
    ``convert.params_from_numpy``) on the synthetic pipeline of its config
    at ``shape``, on the model's device."""

    def __init__(self, model: Model, tc: TrainConfig,
                 shape: str | ShapeCfg = "train_4k",
                 ckpt_dir: str | None = None, scale_batch: int = 1,
                 data_cfg: DataConfig = DataConfig(),
                 fault_hook: Callable[[int], None] | None = None,
                 keep: int = 3):
        self.model, self.cfg, self.tc = model, model.cfg, tc
        self.pipeline = SyntheticPipeline(self.cfg, shape, data_cfg,
                                          scale_batch=scale_batch,
                                          device=model.device)
        mesh = model.par.mesh
        self.ckpt = CheckpointManager(
            ckpt_dir, keep,
            process_index=mesh.rank if mesh is not None else 0,
            mesh=mesh.shape if mesh is not None else None,
            processes=mesh.size if mesh is not None else 1) \
            if ckpt_dir else None
        self.fault_hook = fault_hook
        self.step_fn = make_train_step(model, tc)
        self.state: dict = {}
        self.history: list[dict] = []

    # -- state ----------------------------------------------------------------
    def init(self, seed: int | None = None) -> None:
        """Fresh optimizer state and data cursor.  With a ``seed``, the
        weights are drawn again first, from a ``torch.Generator`` on the
        model's device seeded with it (``build_model``'s draws); without,
        the model keeps the weights it has."""
        params = dict(self.model.named_parameters())
        if seed is not None:
            gen = torch.Generator(device=self.model.device)
            gen.manual_seed(seed)
            par, block = self.model.par, None
            if par.mesh is not None:
                block = functools.partial(
                    leaf_block, rules=par.effective_rules(), mesh=par.mesh,
                    device=self.model.device)
            fresh = _unnest(init_params(gen, model_defs(self.cfg),
                                        block=block))
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(fresh[k])
        self.state = {"opt": adamw_init(params, self.tc.opt),
                      "cstate": (compress_init(params)
                                 if self.tc.compress_grads else None)}
        self.pipeline.load_state_dict({"step": 0})

    def _tree(self) -> dict:
        """The state as the nested tree a checkpoint holds."""
        opt = self.state["opt"]
        tree = {"params": self.model.tree(),
                "opt": {"m": _nest(opt.m), "v": _nest(opt.v),
                        "step": opt.step},
                "data": {"step": torch.tensor(self.pipeline.step)}}
        if self.state["cstate"] is not None:
            tree["cstate"] = {"residual": _nest(self.state["cstate"].residual)}
        return tree

    def resume(self) -> int:
        """Restore the latest checkpoint; returns the step resumed from
        (0 if none).  Called on every (re)start: this is the preemption
        recovery path."""
        if not self.state:
            self.init()
        if self.ckpt is None or self.ckpt.latest() is None:
            return 0
        got = self.ckpt.restore(self._tree())
        restored = _unnest(got["params"])
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(restored[k])
        self.state["opt"] = OptState(_unnest(got["opt"]["m"]),
                                     _unnest(got["opt"]["v"]),
                                     got["opt"]["step"])
        if "cstate" in got:
            self.state["cstate"] = CompressState(
                _unnest(got["cstate"]["residual"]))
        self.pipeline.load_state_dict({"step": int(got["data"]["step"])})
        return int(got["opt"]["step"])

    # -- run ------------------------------------------------------------------
    def run(self, steps: int | None = None) -> list[dict]:
        steps = steps if steps is not None else self.tc.steps
        if not self.state:
            self.init()
        start = int(self.state["opt"].step)
        saved = None
        for i in range(start, steps):
            if self.fault_hook is not None:
                self.fault_hook(i)      # may raise to simulate preemption
            batch = batch_shard(self.pipeline.next_batch(), self.cfg,
                                self.model.par)
            t0 = time.perf_counter()
            self.state["opt"], self.state["cstate"], metrics = self.step_fn(
                self.state["opt"], self.state["cstate"], batch)
            if (i + 1) % self.tc.log_every == 0 or i == start:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=i + 1, sec=time.perf_counter() - t0)
                self.history.append(m)
            if self.ckpt and (i + 1) % self.tc.ckpt_every == 0:
                self.ckpt.save(i + 1, self._tree())
                saved = i + 1
        if self.ckpt:
            if saved == steps:
                self.ckpt.wait()
            else:
                self.ckpt.save(steps, self._tree(), blocking=True)
        return self.history
