"""Deterministic synthetic data pipeline.

The counterpart of ``repro.data.pipeline``, a copy of its numpy generator
with torch tensors out.  It produces the batch ``input_specs`` promises for
any (arch x shape) cell, drawn on the host from
``numpy.random.default_rng((seed, step, process_index))``: restartable
from any step with no state beyond the step index (what checkpoint resume
relies on), and per process: each process draws only its slice of the
global batch.  The same seed, step and process give the reference's
numbers.

The token stream is a Zipf-ish mixture with a Markov backbone (``next =
7 x cur + 3 mod V``), so the cross-entropy is learnable: uniform tokens
would hide an optimizer bug.  Batches land on the pipeline's device:
int32 ``tokens`` and ``labels`` (the next token, -1 at the end), the stub
frontends' embeddings ``0.02 x N(0, 1)`` in their dtype (bf16), and a
scalar ``pos`` for decode shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.common import (SHAPES, ArchConfig, ShapeCfg,
                                       input_specs)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2
    markov_weight: float = 0.7     # P(next = f(cur)) vs fresh zipf draw


class SyntheticPipeline:
    """Iterator of batch dicts for (cfg, shape). State = step counter."""

    def __init__(self, cfg: ArchConfig, shape: str | ShapeCfg,
                 data_cfg: DataConfig = DataConfig(), scale_batch: int = 1,
                 process_index: int = 0, process_count: int = 1,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self.shape = SHAPES[shape] if isinstance(shape, str) else shape
        self.data_cfg = data_cfg
        self.scale_batch = scale_batch
        self.process_index = process_index
        self.process_count = process_count
        self.device = resolve_device(device)
        self.step = 0
        self._specs = input_specs(cfg, self.shape, scale_batch=scale_batch)

    # -- restart support ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])

    # -- generation ----------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.data_cfg.seed, step, self.process_index))

    def _tokens(self, rng: np.random.Generator, shape: tuple[int, ...]
                ) -> np.ndarray:
        V = self.cfg.vocab_size
        fresh = np.minimum(rng.zipf(self.data_cfg.zipf_a, size=shape) - 1,
                           V - 1).astype(np.int32)
        out = np.empty(shape, np.int32)
        out[:, 0] = fresh[:, 0]
        keep = rng.random(shape) < self.data_cfg.markov_weight
        for t in range(1, shape[1]):                  # Markov: next = 7x+3
            out[:, t] = np.where(keep[:, t],
                                 (out[:, t - 1] * 7 + 3) % V, fresh[:, t])
        return out

    def next_batch(self) -> dict:
        rng = self._rng(self.step)
        self.step += 1
        batch, toks = {}, None
        for k, spec in self._specs.items():
            # Per-process slice of the global batch (dim 0).
            shape = tuple(spec.shape)
            if shape and self.process_count > 1 and k != "pos":
                shape = (shape[0] // self.process_count,) + shape[1:]
            if k in ("tokens", "token"):
                a = toks = self._tokens(rng, shape)
            elif k == "labels":        # next tokens; every spec puts tokens first
                a = np.concatenate(
                    [toks[:, 1:], np.full((toks.shape[0], 1), -1, np.int32)], 1)
            elif k == "pos":
                a = np.int32(self.shape.seq // 2)
            elif spec.dtype == torch.int32:
                a = np.zeros(shape, np.int32)
            else:
                a = 0.02 * rng.standard_normal(size=shape).astype(np.float32)
            batch[k] = torch.as_tensor(a, dtype=spec.dtype, device=self.device)
        return batch

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self.next_batch()
