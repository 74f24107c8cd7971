"""Public model API: ``build_model(cfg)`` -> a :class:`Model` whose
``loss`` runs the train path and ``prefill`` and ``decode`` the serve
path.

The counterpart of ``repro.models.api`` for every family (dense, moe, ssm,
hybrid, encdec) and both stub frontends.  The forwards are plain
functions of (params, batch), as in the reference; :class:`Model` is the
``nn.Module`` that holds the stacked parameter tree under the reference's
paths (``blocks.attn.wq``, with its leading layer axis), so that ``.to()``
and ``state_dict()`` work, and calls them.  Batch keys follow the
reference's ``input_specs``: ``tokens`` [B, S] for prefill, with
``patch_embeds`` [B, P, D] prepended for the vision stub and
``frame_embeds`` [B, S_enc, D] feeding the encoder of an encdec model;
the same and ``labels`` [B, S] for train; ``token`` [B, 1], ``pos``
(scalar or per-lane [B]) and the stacked caches for decode.

On a mesh (``par.mesh``) a Model holds its rank's blocks of the tree
(``params.shard_params``) and is given its rank's block of each batch
(``launch.sharding.batch_shard``).  ``loss`` then returns the rank's share
of the global loss and its blocks' gradients (``train.loop`` sums both
over the data ranks), ``prefill`` and ``decode`` the logits of the rank's
batch rows over the whole vocabulary and the rank's caches.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import families
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (cast, chunked_ce_loss, embed_apply,
                                       embed_defs, gather_vocab, logits_apply,
                                       matmul_f32, norm_apply, norm_defs,
                                       sinusoidal_pos, unembed_defs)
from repro_torch.models.params import init_params, leaf_block
from repro_torch.models.parallel import ParallelCfg


def model_defs(cfg: ArchConfig) -> dict:
    defs: dict = {"embed": embed_defs(cfg.padded_vocab, cfg.d_model)}
    defs["blocks"] = families.stack_defs(families.block_defs(cfg),
                                         cfg.n_layers)
    defs["final_norm"] = norm_defs(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_defs(cfg.d_model, cfg.padded_vocab)
    if cfg.n_encoder_layers:
        defs["encoder"] = families.stack_defs(
            families.block_defs(cfg, encoder=True), cfg.n_encoder_layers)
        defs["enc_norm"] = norm_defs(cfg.d_model, cfg.norm)
    return defs


def _logits(params: dict, cfg: ArchConfig, h: torch.Tensor,
            par: ParallelCfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = matmul_f32(h, cast(params["embed"]["table"]).T)
    else:
        out = logits_apply(params["unembed"], h)
    return gather_vocab(out, par)


def _embed_in(params, cfg: ArchConfig, batch: dict, par: ParallelCfg,
              decode: bool = False):
    """Token (+ stub-frontend) embedding -> x [B, S, D]."""
    if decode:
        return embed_apply(params["embed"], batch["token"], par)
    x = embed_apply(params["embed"], batch["tokens"], par)
    if cfg.frontend == "vision_stub":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], 1)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model, device=x.device)
    return x


def _decode_sinusoid(pos, B: int, d: int, device) -> torch.Tensor:
    """The sinusoid of each lane's position, [B, d] float32, written as the
    reference's decode writes it (``repro/models/api.py:136-143``)."""
    posv = torch.as_tensor(pos, device=device).expand(B)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-torch.log(torch.tensor(10000.0, device=device)) / d))
    ang = posv[:, None].float() * div
    pe = torch.zeros((B, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def _run_encoder(params, cfg: ArchConfig, par: ParallelCfg, frames,
                 mode: str = "prefill"):
    """The encoder over ``frames``.  The train path runs it in ``train``
    mode, so that its attention has a gradient; the reference runs it in
    ``prefill`` mode inside its loss too, where the mode only decides the
    caches (an encoder emits none)."""
    x = frames.to(torch.bfloat16)
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model, device=x.device)
    x, _, _ = families.stack_apply(
        params["encoder"], x, cfg, par, mode=mode,
        n_layers=cfg.n_encoder_layers, causal=False)
    return norm_apply(params["enc_norm"], x, cfg.norm, cfg.norm_eps)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, par: ParallelCfg
            ) -> torch.Tensor:
    """The train forward: mean next-token cross-entropy over the labelled
    text positions (``labels`` -1 are ignored), plus the MoE routers'
    load-balancing term ``router_aux_weight * aux / n_layers``.  On a data
    axis, this rank's share of it: the shares add up to the loss.  The
    aux term comes from the replicated router, so every model rank holds
    it once."""
    x = _embed_in(params, cfg, batch, par)
    enc = None
    if cfg.n_encoder_layers:
        enc = _run_encoder(params, cfg, par, batch["frame_embeds"], "train")
    x, _, aux = families.stack_apply(
        params["blocks"], x, cfg, par, mode="train", n_layers=cfg.n_layers,
        enc=enc)
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if cfg.frontend == "vision_stub":          # loss only on text positions
        x = x[:, batch["patch_embeds"].shape[1]:]
    unemb = ({"w": params["embed"]["table"].T} if cfg.tie_embeddings
             else params["unembed"])
    loss = chunked_ce_loss(unemb, x, batch["labels"], chunk=par.loss_chunk,
                           par=par)
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_weight * aux / cfg.n_layers
    return loss


def _caches_out(new_caches: dict) -> dict:
    out = {}
    if "k" in new_caches:
        out["k_cache"], out["v_cache"] = new_caches["k"], new_caches["v"]
    if "h" in new_caches:
        out["ssm_state"], out["conv_state"] = (new_caches["h"],
                                               new_caches["conv"])
    if "ck" in new_caches:
        out["enc_out"], out["enc_out_v"] = new_caches["ck"], new_caches["cv"]
    return out


def prefill_fn(params: dict, batch: dict, cfg: ArchConfig, par: ParallelCfg):
    """Full-sequence forward -> (last-position logits [B, V], caches).

    The caches (stacked [L, ...]) feed ``decode_fn`` directly; an encdec
    model's include the encoder output's cross K/V (``enc_out``,
    ``enc_out_v``).
    """
    x = _embed_in(params, cfg, batch, par)
    enc = None
    if cfg.n_encoder_layers:
        enc = _run_encoder(params, cfg, par, batch["frame_embeds"])
    x, new_caches, _ = families.stack_apply(
        params["blocks"], x, cfg, par, mode="prefill", n_layers=cfg.n_layers,
        enc=enc)
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return _logits(params, cfg, x[:, -1], par), _caches_out(new_caches)


def decode_fn(params: dict, batch: dict, cfg: ArchConfig, par: ParallelCfg):
    """One decode step. batch: token [B,1], pos (scalar or [B]), + caches
    [L, ...].  Returns (logits [B, V], new_caches dict); the input caches
    are left as they were."""
    x = _embed_in(params, cfg, batch, par, decode=True)
    if cfg.pos == "sinusoidal":
        pe = _decode_sinusoid(batch["pos"], x.shape[0], cfg.d_model,
                              x.device)
        x = x + pe[:, None].to(x.dtype)
    caches: dict = {}
    if "k_cache" in batch:
        caches["k"], caches["v"] = batch["k_cache"], batch["v_cache"]
    if "ssm_state" in batch:
        caches["h"], caches["conv"] = batch["ssm_state"], batch["conv_state"]
    if "enc_out" in batch:
        caches["ck"], caches["cv"] = batch["enc_out"], batch["enc_out_v"]
    x, new_caches, _ = families.stack_apply(
        params["blocks"], x, cfg, par, mode="decode", n_layers=cfg.n_layers,
        pos=batch["pos"], caches=caches)
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return _logits(params, cfg, x[:, 0], par), _caches_out(new_caches)


def _model_sharded(defs: dict, par: ParallelCfg,
                   prefix: str = "") -> frozenset:
    """The ``named_parameters`` names of the leaves split over ``model``."""
    if par.model_axis_size == 1:
        return frozenset()
    rules = par.effective_rules()
    out = set()
    for k, d in defs.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(d, dict):
            out |= _model_sharded(d, par, name)
        elif "model" in rules.spec(d.logical):
            out.add(name)
    return frozenset(out)


class _Tree(nn.Module):
    """A nested dict of tensors as modules and (frozen) parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> dict:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Model(_Tree):
    """The parameter tree of ``cfg``, its loss and its serve forwards.

    ``state_dict()`` and ``named_parameters()`` keys are the reference's
    tree paths (``blocks.attn.wq``, ``embed.table``, ...).  The parameters
    require no gradient outside :meth:`loss`.
    """

    def __init__(self, cfg: ArchConfig, params: dict,
                 par: ParallelCfg = ParallelCfg()):
        super().__init__(params)
        self.cfg, self.par = cfg, par
        self.sharded = _model_sharded(model_defs(cfg), par)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """``(loss, grads)`` of ``loss_fn`` on ``batch``, as
        ``jax.value_and_grad``: the loss detached, the gradients a dict by
        ``named_parameters()`` name, in its order, float32 like the
        parameters."""
        params = dict(self.named_parameters())
        try:
            for p in params.values():
                p.requires_grad_(True)
            with torch.enable_grad():
                loss = loss_fn(self.tree(), batch, self.cfg, self.par)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True,
                                            materialize_grads=True)
        finally:
            for p in params.values():
                p.requires_grad_(False)
        return loss.detach(), dict(zip(params, grads))

    @torch.no_grad()
    def prefill(self, batch: dict):
        return prefill_fn(self.tree(), batch, self.cfg, self.par)

    @torch.no_grad()
    def decode(self, batch: dict):
        return decode_fn(self.tree(), batch, self.cfg, self.par)


def build_model(cfg: ArchConfig, device: str | torch.device = DEFAULT_DEVICE,
                seed: int = 0, par: ParallelCfg = ParallelCfg()) -> Model:
    """A :class:`Model` of ``cfg`` with random weights drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``.  On a mesh every rank
    draws the same whole tree, leaf by leaf, and keeps its blocks."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    block = None
    if par.mesh is not None:
        rules, mesh = par.effective_rules(), par.mesh
        block = functools.partial(leaf_block, rules=rules, mesh=mesh,
                                  device=dev)
    return Model(cfg, init_params(gen, model_defs(cfg), block=block), par)
