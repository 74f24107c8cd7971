"""Batched serving engine: prefill + decode with continuous batching.

The counterpart of ``repro.serve.engine``.  A fixed pool of
``batch_slots`` decode lanes runs one decode step per tick over the whole
pool (caches are dicts of ``[L, B, ...]`` tensors on the model's device).
New requests are prefilled one at a time and their caches inserted into a
free lane; finished lanes (EOS or ``max_new``) are evicted and refilled.
Lane occupancy lives in :class:`repro_torch.serve.lanes.LanePool`.  This
serve path is what the cluster's ``offline_inference`` job template
stands for.

Semantics contracts (the reference's, held in ``tests/test_torch_serve.py``):

* ``max_new`` counts **decode** tokens; the prefill-sampled continuation
  token is emitted in addition (``out_tokens`` holds ``1 + max_new`` ids
  for an un-truncated, non-EOS request);
* a request evicted at the ``max_len`` KV horizon before reaching
  ``max_new``/EOS is surfaced with ``truncated=True``, never silently;
* ``run`` drains the lane pool before returning — unfinished requests come
  back ``done=False`` *and* their lanes are freed, so back-to-back ``run``
  calls on one engine never re-serve stale lanes.

A windowed model's KV ring has ``min(attn_window, max_len)`` slots, the
size the reference's decode spec gives it.  (The reference engine sizes it
from the first admitted prompt, so a short first prompt shrinks every
later request's window: ROADMAP Queue 3.)

The stub frontends get what the reference's engine gives them: an encdec
model's encoder reads ``len(prompt)`` zero frame embeddings, a vision-stub
model's prompt is prefixed by :func:`frontend_tokens` zero patch
embeddings.  Two of the reference engine's faults are repaired or refused
(ROADMAP Queue 3 items 11 and 12):

* a vision-stub lane's first decode position is ``P + len(prompt)``, the
  length of what was prefilled; the reference's is ``len(prompt)``, so its
  first decode step rotates at the wrong position and overwrites a prompt
  slot;
* the cross-attention pool (``enc_out``) holds the first request's
  encoder length, and cross-attention decode has no key mask, so a
  request of another encoder length cannot share it: the port raises a
  ``ValueError`` naming both lengths, where the reference fails with a
  broadcasting error.

Greedy sampling is ``argmax`` over the real vocabulary; temperature
sampling draws from a ``torch.Generator`` seeded with ``ServeConfig.seed``
(its stream differs from ``jax.random``'s).

Over a placed mesh the engine reads ``par`` from its ``Model`` (the
counterpart of the reference's engine, which takes a ``ParallelCfg``):

* the pool's ``batch_slots`` lanes are cut over the data ranks as
  ``launch.sharding.batch_shard`` cuts a batch: each holds ``batch_slots /
  data`` lanes' caches (a pool the data ranks do not divide raises), and,
  under ``kv_seq_shard``, its block of each lane's KV window;
* a one-request prefill runs on every data rank, whole
  (``ParallelCfg.whole_batch``: the reference's ``batch_pspecs`` gives a
  batch of one no data axis), and only the rank that holds the lane
  inserts its caches;
* each data rank decodes its lanes; the logits are all-gathered over the
  data ranks, and every rank samples the whole pool with the same seeded
  generator, so that every rank's lanes, positions and requests stay the
  same.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.api import Model
from repro_torch.models.parallel import all_gather
from repro_torch.obs import MetricsRegistry, Tracer, get_tracer
from repro_torch.serve.lanes import LanePool

KV_KEYS = ("k_cache", "v_cache")
MAX_PATCHES = 8                    # patch embeddings the engine prepends


def frontend_tokens(cfg) -> int:
    """Positions the engine prefixes to a prompt: ``min(n_frontend_tokens,
    8)`` zero patch embeddings for the vision stub, none otherwise."""
    if cfg.frontend == "vision_stub":
        return min(cfg.n_frontend_tokens, MAX_PATCHES)
    return 0


def frontend_inputs(cfg, n: int, device) -> dict:
    """The stub frontends' inputs to a prefill of an ``n``-token prompt,
    as the reference's engine builds them: ``n`` zero encoder frames for
    an encdec model, :func:`frontend_tokens` zero patches for the vision
    stub, both ``[1, ., d_model]`` bf16 on ``device``."""
    out = {}
    if cfg.n_encoder_layers:
        out["frame_embeds"] = torch.zeros((1, n, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)
    P = frontend_tokens(cfg)
    if P:
        out["patch_embeds"] = torch.zeros((1, P, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)
    return out


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new: int = 16
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False            # evicted at the max_len KV horizon


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 256                 # KV-cache horizon per lane
    temperature: float = 0.0           # 0 = greedy
    eos_id: int = -1                   # -1: never EOS (synthetic vocab)
    seed: int = 0


class ServeEngine:
    def __init__(self, model: Model, sc: ServeConfig = ServeConfig(),
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        if model.device.type != resolve_device(device).type:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"was asked for {device}")
        self.device = model.device
        self.model, self.cfg, self.sc = model, model.cfg, sc
        self.par = par = model.par
        if sc.batch_slots % par.data_size:
            raise ValueError(f"batch_slots={sc.batch_slots} does not split "
                             f"over the {par.data_size} data ranks")
        self._lanes_here = sc.batch_slots // par.data_size
        self._lane0 = par.data_index * self._lanes_here
        self._prefill_par = (dataclasses.replace(par, whole_batch=True)
                             if par.data_size > 1 else par)
        # Host-side telemetry: read around the steps, never inside them,
        # so sampled tokens are the same with tracing on or off.  The tick
        # index is the simulation clock for trace timestamps.
        self.tracer = tracer if tracer is not None else get_tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._wall_seen: set[str] = set()
        self._tick = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(sc.seed)
        self.caches: dict[str, torch.Tensor] | None = None
        self.lanes = LanePool(sc.batch_slots)
        self.lane_pos = np.zeros(sc.batch_slots, np.int64)

    # -- cache pool -----------------------------------------------------------
    def _ring(self) -> int:
        """KV slots per lane: the window (capped by max_len) or max_len."""
        W, M = self.cfg.attn_window, self.sc.max_len
        return min(W, M) if W else M

    def _window(self) -> int:
        """KV slots per lane on this rank: the ring, or its block under
        ``kv_seq_shard``."""
        W = self._ring()
        if not self.par.kv_window_sharded:
            return W
        n = self.par.model_axis_size
        if W % n:
            raise ValueError(f"kv_seq_shard: a ring of {W} slots does not "
                             f"split over model={n}")
        return W // n

    def _init_caches(self, template: dict) -> None:
        """Allocate this rank's lanes of the pool from a single-request
        prefill's caches: KV time dims take :meth:`_window` slots,
        SSM/conv and cross-attention caches keep their shapes."""
        B = self._lanes_here
        pool = {}
        for k, v in template.items():
            shape = (v.shape[0], B) + tuple(v.shape[2:])
            if k in KV_KEYS:
                shape = (v.shape[0], B, self._window()) + tuple(v.shape[3:])
            pool[k] = torch.zeros(shape, dtype=v.dtype, device=v.device)
        self.caches = pool

    def _insert(self, lane: int, caches_1: dict) -> None:
        """Puts a prefill's caches in ``lane``, on the data rank that holds
        it (its block of the lane's ring under ``kv_seq_shard``)."""
        lane -= self._lane0
        if not 0 <= lane < self._lanes_here:
            return
        for k, v in caches_1.items():
            pool = self.caches[k]
            if k in KV_KEYS:
                W = self._ring()
                row = v.new_zeros((v.shape[0], W) + tuple(v.shape[3:]))
                n = min(v.shape[2], W)
                row[:, :n] = v[:, 0, :n]
                Wl = pool.shape[2]
                pool[:, lane] = row[:, self.par.model_index * Wl:][:, :Wl] \
                    if Wl != W else row
            else:
                pool[:, lane] = v[:, 0]

    # -- telemetry ------------------------------------------------------------
    def _observe_wall(self, name: str, seconds: float) -> None:
        """first = the first call (kernel builds included); the rest are
        warm steps — the split summary() reports."""
        suffix = "_first" if name not in self._wall_seen else "_warm"
        self._wall_seen.add(name)
        self.metrics.histogram(name + suffix).observe(seconds)

    def summary(self) -> dict:
        """Aggregate view of the last ``run`` from the metrics registry."""
        snap = self.metrics.snapshot()
        return {
            "requests_admitted": snap.get("requests_admitted", 0),
            "requests_completed": snap.get("requests_completed", 0),
            "requests_truncated": snap.get("requests_truncated", 0),
            "decode_tokens": snap.get("decode_tokens", 0),
            "ticks": snap.get("ticks", 0),
            "wall": {k: v for k, v in snap.items()
                     if k.startswith(("decode_wall_s", "prefill_wall_s"))},
        }

    # -- scheduling -----------------------------------------------------------
    def prefill_batch(self, prompt, rid: int = -1) -> dict:
        """One request's prefill batch: its tokens and
        :func:`frontend_inputs`.  Raises if the encoder length differs
        from the cross-attention pool's."""
        n = len(prompt)
        if self.cfg.n_encoder_layers:
            pool = self.caches["enc_out"].shape[2] if self.caches else n
            if n != pool:
                raise ValueError(
                    f"request {rid}: encoder length {n} differs from the "
                    f"cross-attention pool's {pool} (set by the first "
                    "request); cross-attention decode has no key mask, so "
                    "one pool serves one encoder length")
        return {"tokens": torch.as_tensor(np.asarray(prompt)[None, :],
                                          dtype=torch.int64,
                                          device=self.device),
                **frontend_inputs(self.cfg, n, self.device)}

    def _admit(self, queue: list[Request]) -> None:
        for lane, req in self.lanes.admit(queue):
            t0 = time.perf_counter()
            logits, caches_1 = self.model.prefill(
                self.prefill_batch(req.prompt, req.rid),
                par=self._prefill_par)
            if self.caches is None:
                self._init_caches(caches_1)
            self._insert(lane, caches_1)
            tok = self._sample(logits)[0]     # host sync: covers the prefill
            req.out_tokens.append(int(tok))
            self.lane_pos[lane] = frontend_tokens(self.cfg) + len(req.prompt)
            self._observe_wall("prefill_wall_s", time.perf_counter() - t0)
            self.metrics.counter("requests_admitted").inc()
            self.tracer.instant("admit", self._tick, rid=req.rid, lane=lane,
                                prompt_len=len(req.prompt))

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        logits = logits[..., :self.cfg.vocab_size]
        if self.sc.temperature <= 0:
            return torch.argmax(logits, -1).cpu().numpy()
        probs = torch.softmax(logits / self.sc.temperature, -1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    # -- main loop ------------------------------------------------------------
    def run(self, requests: list[Request], max_ticks: int = 10_000
            ) -> list[Request]:
        queue = list(requests)
        done: list[Request] = []
        self.metrics.reset()
        self._wall_seen = set()
        self._tick = 0
        for _ in range(max_ticks):
            self._admit(queue)
            active = [l for l, _ in self.lanes.active()]
            if not active:
                if not queue:
                    break
                continue
            if self.tracer.enabled:
                self.tracer.counter("lanes_active", self._tick, len(active))
            t0 = time.perf_counter()
            # Pool decode tick: every lane advances one token at its own
            # position (decode_step takes per-lane positions); each data
            # rank its lanes, whose logits every rank then gathers.
            here = slice(self._lane0, self._lane0 + self._lanes_here)
            last = torch.tensor(
                [r.out_tokens[-1] if r else 0
                 for r in self.lanes.payloads()[here]],
                dtype=torch.int64, device=self.device)[:, None]
            pos = torch.as_tensor(self.lane_pos[here], device=self.device)
            logits, self.caches = self.model.decode(
                {"token": last, "pos": pos, **self.caches})
            toks = self._sample(all_gather(logits, self.par, 0))  # host sync
            self._observe_wall("decode_wall_s", time.perf_counter() - t0)
            self.metrics.counter("ticks").inc()
            self.metrics.counter("decode_tokens").inc(len(active))
            for lane in active:
                req = self.lanes.payload(lane)
                req.out_tokens.append(int(toks[lane]))
                self.lane_pos[lane] += 1
                # max_new counts *decode* tokens — the prefill-sampled token
                # (out_tokens[0]) is in addition, not one of the max_new.
                n_decode = len(req.out_tokens) - 1
                finished = (toks[lane] == self.sc.eos_id
                            or n_decode >= req.max_new)
                horizon = self.lane_pos[lane] >= self.sc.max_len - 1
                if finished or horizon:
                    req.done = True
                    req.truncated = bool(horizon and not finished)
                    done.append(req)
                    self.lanes.evict(lane)
                    self.metrics.counter("requests_completed").inc()
                    if req.truncated:
                        self.metrics.counter("requests_truncated").inc()
                    self.tracer.instant("evict", self._tick, rid=req.rid,
                                        lane=lane, tokens=len(req.out_tokens),
                                        truncated=req.truncated)
            self._tick += 1
        # Drain: whatever is still in flight comes back done=False, but its
        # lane is freed — a second run() on this engine starts clean instead
        # of double-serving stale lanes.
        leftover = self.lanes.drain()
        self.lane_pos[:] = 0
        return done + leftover
