"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

The counterpart of ``repro.models.layers``: ``*_defs(cfg)`` returns a
:class:`~repro_torch.models.params.ParamDef` tree, ``*_apply(params, x,
...)`` consumes the materialized tree.  Activations run in bf16 with f32
norms and softmax; parameters are stored f32 and cast at use, where the
reference casts.  A product of bf16 operands rounds its f32 sum to bf16,
as XLA's does.  ``chunked_ce_loss`` is the train mode's loss.

On a mesh (``par.mesh``) the MLP is column-parallel in and row-parallel
out, its partial products summed in f32 and rounded once
(:func:`row_parallel`); a vocab-sharded embedding looks up the rank's
ids, zeroes the others and sums over ``model``; the loss on vocab-sharded
logits takes the logsumexp from an all-reduced max and sum-exp and the
gold logit from the rank that owns the label.  The padded vocabulary
columns count in the logsumexp, as in the reference.  Under ``seq_shard``
a sharded MLP reads the sequence gathered from the ranks' blocks and
reduce-scatters its output back to them (``parallel.enter_model`` /
``leave_model``); an unsharded one reads it whole and keeps its block
(``whole_seq`` / ``own_seq``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef
from repro_torch.models.parallel import (ParallelCfg, all_reduce_max,
                                         copy_to_model, enter_model,
                                         leave_model, own_seq,
                                         reduce_from_model, sublayer_output,
                                         sum_no_grad, whole_seq)

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product of bf16 operands, its f32 sum kept unrounded.

    Where the reference converts a bf16 product straight to f32, XLA's
    compiled graph never rounds it to bf16 (the dot takes an f32 result),
    so the port takes it in f32 there: the products of bf16 values are
    exact in f32, and so is what is summed.
    """
    return x.float() @ w.float()


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def norm_defs(d: int, kind: str = "rmsnorm") -> dict:
    out = {"scale": ParamDef((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        out["bias"] = ParamDef((d,), ("embed",), init="zeros")
    return out


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        xf = xf + p["bias"].float()
    return (xf * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x [..., S, H, dh]; pos [..., S] integer absolute positions."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    ang = pos[..., None].float() * freqs                    # [..., S, dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, offset: int = 0, device=None
                   ) -> torch.Tensor:
    """Classic transformer sinusoids (whisper-style), bf16 [S, d]."""
    pos = (torch.arange(seq, device=device) + offset)[:, None].float()
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# MLP (dense FFN): silu-GLU (llama/qwen), gelu (whisper), relu^2 (nemotron).
# ---------------------------------------------------------------------------

def mlp_defs(d: int, f: int, act: str) -> dict:
    glu = act.endswith("_glu")
    out = {"w_in": ParamDef((d, (2 if glu else 1), f),
                            ("embed", None, "mlp"), init="scaled")}
    out["w_out"] = ParamDef((f, d), ("mlp", "embed"), init="scaled")
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` written as ``jax.nn.silu`` is: ``1 / (1 + exp(-x))``
    rounded op by op in x's dtype.  ``F.silu`` rounds once, which puts a
    bf16 activation an ulp away from the reference's in about a third of
    the values."""
    return x * (1 / (1 + torch.exp(-x)))


def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu_glu":
        return silu(h[..., 0, :]) * h[..., 1, :]
    if act == "gelu":
        return F.gelu(h[..., 0, :], approximate="tanh")
    if act == "relu2":
        r = F.relu(h[..., 0, :])
        return r * r
    raise ValueError(f"unknown act {act!r}")


def row_parallel(x: torch.Tensor, w: torch.Tensor, par: ParallelCfg
                 ) -> torch.Tensor:
    """A sublayer's output ``x @ w`` over a contracted dimension split
    across the model ranks: each rank's partial product in f32, summed
    over ``model`` (or reduce-scattered over the sequence under
    ``seq_shard``) and rounded once to x's dtype."""
    with sublayer_output():
        partial = matmul_f32(x, w)
    return leave_model(partial, par).to(x.dtype)


def out_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A sublayer's output ``x @ w`` where nothing is split (marked for
    remat ``tp_out``, as :func:`row_parallel`'s product is)."""
    with sublayer_output():
        return x @ w


def mlp_apply(p: dict, x: torch.Tensor, act: str,
              par: ParallelCfg | None = None) -> torch.Tensor:
    sharded = par is not None and par.tp_sharded("mlp")
    if sharded:
        x = enter_model(x, par)
    elif par is not None:
        x = whole_seq(x, par)
    w_in = cast(p["w_in"])
    h = (x @ w_in.reshape(w_in.shape[0], -1)).unflatten(-1, w_in.shape[1:])
    h = activation(h, act)
    if sharded:
        return row_parallel(h, cast(p["w_out"]), par)
    y = out_product(h, cast(p["w_out"]))
    return y if par is None else own_seq(y, par)


# ---------------------------------------------------------------------------
# Embeddings and logits.
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d: int) -> dict:
    return {"table": ParamDef((vocab, d), ("vocab", "embed"), init="normal")}


def embed_apply(p: dict, tokens: torch.Tensor,
                par: ParallelCfg | None = None) -> torch.Tensor:
    table = p["table"]
    if par is None or not par.tp_sharded("vocab"):
        return cast(table[tokens.long()])
    local = tokens.long() - par.model_index * table.shape[0]
    own = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(own, local, 0)] * own[..., None]
    return cast(reduce_from_model(rows, par))


def unembed_defs(d: int, vocab: int) -> dict:
    return {"w": ParamDef((d, vocab), ("embed", "vocab"), init="scaled")}


def logits_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul_f32(x, cast(p["w"]))


@torch.no_grad()
def gather_vocab(logits: torch.Tensor, par: ParallelCfg | None
                 ) -> torch.Tensor:
    """Every rank's block of vocab-sharded ``logits`` put together, on
    every rank (the identity when the vocabulary is not sharded)."""
    if par is None or not par.tp_sharded("vocab"):
        return logits
    V_l = logits.shape[-1]
    full = logits.new_zeros(logits.shape[:-1] + (V_l * par.model_axis_size,))
    v0 = par.model_index * V_l
    full[..., v0:v0 + V_l] = logits
    return sum_no_grad(full, par)


def chunked_ce_loss(unembed: dict, h: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor | None = None,
                    chunk: int = 1024,
                    par: ParallelCfg | None = None) -> torch.Tensor:
    """Cross-entropy without materialising [B, S, V]: a loop over sequence
    chunks, as the reference's scan.

    ``h`` [B, S, D] final hidden states; ``labels`` [B, S] integer
    next-token ids (-1 = ignore).  Returns the mean loss over unmasked
    positions, float32.  The chunk is ``S // max(S // chunk, 1)``, which
    must divide S, as the reference's reshape requires.  On a mesh the
    logits may be vocab-sharded (the module docstring), and the mean
    divides by the count over every data rank: each rank returns its
    share of the global loss.
    """
    B, S, _ = h.shape
    if mask is None:
        mask = labels >= 0
    labels = torch.clamp_min(labels, 0).long()
    n_chunks = max(S // chunk, 1)
    chunk = S // n_chunks
    if chunk * n_chunks != S:
        raise ValueError(f"chunked_ce_loss: {n_chunks} chunks of {chunk} "
                         f"do not cover S={S}")
    vocab = par is not None and par.tp_sharded("vocab")
    if vocab and not par.seq_sharded:   # under seq_shard the caller
        h = copy_to_model(h, par)       # gathered h (enter_model)
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, S, chunk):
        logits = logits_apply(unembed, h[:, c0:c0 + chunk])   # [B, c, V]
        lc = labels[:, c0:c0 + chunk]
        if vocab:
            V_l = logits.shape[-1]
            m = all_reduce_max(logits.detach().amax(-1), par)
            se = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1),
                                   par)
            lse = m + torch.log(se)
            local = lc - par.model_index * V_l
            own = (local >= 0) & (local < V_l)
            g = torch.gather(logits, -1,
                             torch.where(own, local, 0)[..., None])[..., 0]
            gold = reduce_from_model(torch.where(own, g, 0.0), par)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        mx = mask[:, c0:c0 + chunk]
        tot = tot + torch.where(mx, lse - gold, 0.0).sum()
        cnt = cnt + mx.sum()
    if par is not None:
        cnt = sum_no_grad(cnt, par, par.batch_axes)
    return tot / torch.clamp_min(cnt, 1).to(torch.float32)
