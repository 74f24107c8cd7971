"""Attention: GQA projections, blockwise attention, KV cache.

The counterpart of ``repro.models.attention``, for the train and serve
paths:

* :func:`flash_unrolled` — causal (optionally sliding-window) attention
  for prefill, a Python loop over the q x kv block triangle that skips
  fully masked block pairs;
* :func:`flash_scan` — non-causal attention (the encoder, and the
  decoder's cross attention over the encoder output), every q block
  against every kv block.

  These two are the plain versions of the ``flash_attention`` kernel: the
  CPU runs them, the card runs the kernel (``kernels.ops.flash_attention``
  picks by the tensor's device).  The train mode's gradient is autograd
  through them, recomputed in the backward
  (``kernels.ops.flash_attention_trainable``), as the reference's is
  XLA's autodiff of them;
* :func:`decode_step` — one token against a (ring-buffered) KV cache,
  with a per-lane position; and ``cross_cached``, one token against the
  stored encoder K/V.  Plain torch on both devices, as in the reference,
  where they run outside any Pallas kernel.

On a mesh whose rules shard ``heads`` over ``model`` each rank projects
its block of q heads and the kv heads they read (:func:`head_blocks`),
runs the attention of those heads only, through the same kernel entries,
and the output projection is row-parallel (``layers.row_parallel``).
Replicated weights that the local heads read (the kv projections when
only q heads shard, the qk norms) take their gradient's sum over the
model ranks (``copy_to_model``).  When ``heads`` is replicated (25 heads
on an even axis) the sub-layer runs whole on every rank.  Under
``seq_shard`` the sub-layer reads the sequence gathered from the ranks'
blocks and returns this rank's block (``parallel.enter_model`` /
``leave_model``, or ``whole_seq`` / ``own_seq`` when it runs whole).

Under ``kv_seq_shard`` where kv heads do not divide ``model``
(``ParallelCfg.kv_window_sharded``) a decode cache holds this rank's
block of the window's slots for every kv head (``launch.sharding``
cuts it), and a prefill emits every kv head's cache, whole, for the
engine or ``batch_shard`` to cut.  :func:`decode_window_block` writes
the new K/V on the rank that owns slot ``pos % W``, attends each rank's
slots for every head (the q heads all-gathered over ``model`` first when
they are split), and combines the partial softmaxes over ``model``: an
all-reduce of the max, then of the sum of the exponentials (so that the
probabilities are normalised before their bf16 rounding, as
:func:`decode_step` rounds them), then of the outputs, in float32.  That
reassociates the sums: allclose to :func:`decode_step`, not bit for
bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig
from repro_torch.models.layers import (apply_rope, cast, out_product,
                                       row_parallel)
from repro_torch.models.params import ParamDef
from repro_torch.models.parallel import (ParallelCfg, all_gather,
                                         all_reduce_max, batch_spec,
                                         constrain, copy_to_model,
                                         enter_model, own_seq, sum_no_grad,
                                         whole_seq)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter tree.
# ---------------------------------------------------------------------------

def attn_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    D, H, KVH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((D, H, dh), ("embed", "heads", "head"), init="scaled"),
        "wk": ParamDef((D, KVH, dh), ("embed", "kv_heads", "head"),
                       init="scaled"),
        "wv": ParamDef((D, KVH, dh), ("embed", "kv_heads", "head"),
                       init="scaled"),
        "wo": ParamDef((H, dh, D), ("heads", "head", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, dh), ("heads", "head"), init="zeros")
        defs["bk"] = ParamDef((KVH, dh), ("kv_heads", "head"), init="zeros")
        defs["bv"] = ParamDef((KVH, dh), ("kv_heads", "head"), init="zeros")
    if cfg.qk_norm and not cross:
        defs["q_norm"] = ParamDef((dh,), ("head",), init="ones")
        defs["k_norm"] = ParamDef((dh,), ("head",), init="ones")
    return defs


def head_blocks(cfg: ArchConfig, par: ParallelCfg
                ) -> tuple[int, int, int, int]:
    """``(q0, q1, k0, k1)``: the q heads this rank attends over and the kv
    heads they read.  Without head sharding, all of them.  With q and kv
    heads sharded, the rank's blocks of each.  With only q heads sharded
    (kv heads do not divide the axis: the Megatron GQA rule), the kv heads
    under GQA of the rank's q block, which must be a whole number of
    groups or lie in one group."""
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    n, m = par.model_axis_size, par.model_index
    if not par.tp_sharded("heads"):
        return 0, H, 0, KVH
    Hl = H // n
    if par.tp_sharded("kv_heads"):
        Kl = KVH // n
        return m * Hl, (m + 1) * Hl, m * Kl, (m + 1) * Kl
    G = H // KVH
    if Hl % G and G % Hl:
        raise ValueError(f"{Hl} q heads a rank do not map onto whole kv "
                         f"groups of {G}")
    q0 = m * Hl
    return q0, q0 + Hl, q0 // G, (q0 + Hl - 1) // G + 1


def _head_rms(x: torch.Tensor, scale: torch.Tensor, eps: float
              ) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


# ---------------------------------------------------------------------------
# Online-softmax block update.
# ---------------------------------------------------------------------------

def _block_update(carry, q_blk, k_blk, v_blk, mask, scale):
    """One (q-block, kv-block) online-softmax step.

    q_blk [B, bq, K, G, h]; k/v_blk [B, bk, K, h]; mask [bq, bk] bool or
    None.  carry = (m [B,K,G,bq], l [B,K,G,bq], acc [B,K,G,bq,h]) f32.
    The products take f32 operands (bf16 values are exact in f32) and sum
    in f32, as ``preferred_element_type=float32`` does; ``p`` is rounded
    to the value dtype before the PV product, as in the reference.
    """
    m, l, acc = carry
    s = torch.einsum("bqkgh,bvkh->bkgqv", q_blk.float(), k_blk.float()) \
        * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(-1)
    pv = torch.einsum("bkgqv,bvkh->bkgqh", p.to(v_blk.dtype).float(),
                      v_blk.float())
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def _finish(m, l, acc, dtype):
    out = acc / torch.clamp_min(l, 1e-30)[..., None]    # [B,K,G,bq,h]
    return out.permute(0, 3, 1, 2, 4).to(dtype)         # [B,bq,K,G,h]


def _init_carry(B, K, G, bq, h, device):
    return (torch.full((B, K, G, bq), NEG_INF, device=device),
            torch.zeros((B, K, G, bq), device=device),
            torch.zeros((B, K, G, bq, h), device=device))


# ---------------------------------------------------------------------------
# Causal flash with block skipping (prefill): the kernel's plain version.
# ---------------------------------------------------------------------------

def flash_unrolled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   block: int = 2048, window: int = 0, q_offset: int = 0,
                   causal: bool = True) -> torch.Tensor:
    """Blockwise attention. q [B,Sq,K,G,h]; k,v [B,Skv,K,h]; returns like q.

    ``q_offset``: absolute position of q row 0 relative to k row 0 (prefix
    tokens). ``window > 0``: sliding-window attention (keys within
    ``window`` of the query).  ``causal=False`` drops the causal mask and
    the block skipping, as the kernel's flag does (the reference keeps
    that case in its Pallas kernel; its model's non-causal path is
    ``flash_scan``).  Ragged lengths take a short last block.
    """
    B, Sq, K, G, h = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(h)
    bq = min(block, Sq)
    bk = min(block, Skv)
    nq, nk = -(-Sq // bq), -(-Skv // bk)
    outs = []
    for qi in range(nq):
        q0 = qi * bq
        cq = min(bq, Sq - q0)
        q_blk = q[:, q0:q0 + cq]
        q_lo, q_hi = q_offset + q0, q_offset + q0 + cq - 1  # abs pos range
        carry = _init_carry(B, K, G, cq, h, q.device)
        for kj in range(nk):
            k0 = kj * bk
            ck = min(bk, Skv - k0)
            k_hi = k0 + ck - 1
            if causal and k0 > q_hi:
                continue                     # fully above the diagonal
            if causal and window and k_hi < q_lo - window + 1:
                continue                     # fully below the window
            diag = causal and k_hi > q_lo    # needs causal masking
            edge = window and (k0 < q_hi - window + 1)
            mask = None
            if diag or edge:
                qpos = q_lo + torch.arange(cq, device=q.device)
                kpos = k0 + torch.arange(ck, device=q.device)
                mask = (kpos[None, :] <= qpos[:, None] if causal else
                        torch.ones((cq, ck), dtype=torch.bool,
                                   device=q.device))
                if window:
                    mask &= kpos[None, :] > qpos[:, None] - window
            carry = _block_update(carry, q_blk, k[:, k0:k0 + ck],
                                  v[:, k0:k0 + ck], mask, scale)
        outs.append(_finish(*carry, q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Non-causal flash (encoder, cross attention): the kernel's plain version.
# ---------------------------------------------------------------------------

def flash_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               block_q: int = 1024, block_k: int = 2048) -> torch.Tensor:
    """Non-causal attention, O(block^2) live memory. Shapes as in
    :func:`flash_unrolled`.  Blocks are the largest divisors of the lengths
    within ``block_q`` / ``block_k`` (``gcd``), as in the reference; each q
    block runs the online softmax over every kv block in order."""
    B, Sq, K, G, h = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(h)
    bq = math.gcd(min(block_q, Sq), Sq)
    bk = math.gcd(min(block_k, Skv), Skv)
    outs = []
    for q0 in range(0, Sq, bq):
        carry = _init_carry(B, K, G, bq, h, q.device)
        for k0 in range(0, Skv, bk):
            carry = _block_update(carry, q[:, q0:q0 + bq], k[:, k0:k0 + bk],
                                  v[:, k0:k0 + bk], None, scale)
        outs.append(_finish(*carry, q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Decode: one new token vs. a KV cache (ring buffer when windowed).
# ---------------------------------------------------------------------------

def decode_step(q: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor | int, window: int = 0):
    """q [B,1,K,G,h]; new_k/v [B,1,K,h]; caches [B,W,K,h]; pos an integer
    scalar or per-lane [B] (continuous batching: lanes at different
    depths).

    Returns (out [B,1,K,G,h], k_cache, v_cache), the caches as new tensors
    (the inputs are left as they were).  With ``window`` the cache is a
    ring buffer of W slots; otherwise W covers the full horizon.
    """
    B, W = k_cache.shape[0], k_cache.shape[1]
    dev = q.device
    h = q.shape[-1]
    scale = 1.0 / math.sqrt(h)
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).expand(B)
    idx = pos % W if window else torch.clamp_max(pos, W - 1)
    lane = torch.arange(B, device=dev)
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[lane, idx] = new_k[:, 0].to(k_cache.dtype)
    v_cache[lane, idx] = new_v[:, 0].to(v_cache.dtype)
    slots = torch.arange(W, device=dev)
    valid = slots[None, :] <= pos[:, None]               # [B, W]
    if window:
        valid = valid | (pos[:, None] >= W)              # ring full: all live
    s = torch.einsum("bqkgh,bwkh->bkgqw", q.float(), k_cache.float()) * scale
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqw,bwkh->bqkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype), k_cache, v_cache


@torch.no_grad()
def decode_window_block(q: torch.Tensor, new_k: torch.Tensor,
                        new_v: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, pos, window: int,
                        par: ParallelCfg):
    """:func:`decode_step` with the caches' window split over ``model``:
    ``k_cache`` / ``v_cache`` [B, W / model, K, h] are this rank's block
    of slots ``m * W / model ...``; q [B,1,K,G,h] every head.  Returns
    (out [B,1,K,G,h], k_cache, v_cache), the out on every rank."""
    B, Wl = k_cache.shape[0], k_cache.shape[1]
    dev = q.device
    n, m = par.model_axis_size, par.model_index
    W = Wl * n
    scale = 1.0 / math.sqrt(q.shape[-1])
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).expand(B)
    idx = pos % W if window else torch.clamp_max(pos, W - 1)
    own = (idx // Wl == m)[:, None, None]
    local = torch.clamp(idx - m * Wl, 0, Wl - 1)
    lane = torch.arange(B, device=dev)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[lane, local] = torch.where(own, new_k[:, 0].to(k_cache.dtype),
                                       k_cache[lane, local])
    v_cache[lane, local] = torch.where(own, new_v[:, 0].to(v_cache.dtype),
                                       v_cache[lane, local])
    slots = m * Wl + torch.arange(Wl, device=dev)
    valid = slots[None, :] <= pos[:, None]
    if window:
        valid = valid | (pos[:, None] >= W)
    s = torch.einsum("bqkgh,bwkh->bkgqw", q.float(), k_cache.float()) * scale
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    # The softmax over every rank's slots: the max and the sum of the
    # exponentials over model, so that p is normalised before its bf16
    # rounding, as decode_step rounds it; then the outputs' sum.
    mx = all_reduce_max(s.amax(-1), par)                   # [B,K,G,1]
    p = torch.exp(s - mx[..., None])
    p = p / sum_no_grad(p.sum(-1), par)[..., None]
    out = torch.einsum("bkgqw,bwkh->bqkgh", p.to(v_cache.dtype).float(),
                       v_cache.float())                    # [B,1,K,G,h]
    return sum_no_grad(out, par).to(q.dtype), k_cache, v_cache


# ---------------------------------------------------------------------------
# Full attention sub-layer.
# ---------------------------------------------------------------------------

def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, dh] -> the kernel's [B, H, S, dh], contiguous."""
    return t.transpose(1, 2).contiguous()


def attn_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, par: ParallelCfg,
               *, mode: str = "prefill", pos=None,
               cache: dict | None = None, kv_x: torch.Tensor | None = None,
               causal: bool = True, q_offset: int = 0):
    """GQA attention. mode: train or prefill (full sequence), decode (one
    token against ``cache`` = {"k","v"} [B,W,KVH,dh] at ``pos``) or
    ``cross_cached`` (one or more tokens against the precomputed encoder
    K/V in ``cache``, unmasked).

    ``kv_x``: the encoder output to attend to (cross attention: no rope;
    a prefill emits its K/V as the cache for decode).  ``causal=False``:
    the encoder's bidirectional attention.  ``q_offset``, the reference's
    position of query row 0, is set by no caller there (its ``_embed_in``
    returns 0); a non-zero one raises.  Prefill runs through
    ``ops.flash_attention`` (the kernel on the card); a causal
    self-attention prefill emits the KV cache, ring-ordered when windowed
    so decode's ``pos % W`` lines up.  Train runs the prefill's attention
    through ``ops.flash_attention_trainable`` and emits no cache.  Returns
    (out [B,S,D], new_cache or None).
    """
    if mode not in ("train", "prefill", "decode", "cross_cached"):
        raise ValueError(f"attn_apply: unknown mode {mode!r}")
    if q_offset:
        raise NotImplementedError(
            f"attn_apply: q_offset={q_offset}; query row 0 sits at key 0, "
            "as the reference's _embed_in always sets it")
    q0, q1, k0, k1 = head_blocks(cfg, par)
    tp = q1 - q0 != cfg.n_heads
    # kv_seq_shard: the cache holds every kv head (a block of its window)
    kv_all = (par.kv_window_sharded and kv_x is None
              and mode in ("prefill", "decode"))
    if tp:
        p = _local_weights(p, cfg, par, k0, k1, kv_all)
        x = enter_model(x, par)
        kv_x = None if kv_x is None else copy_to_model(kv_x, par)
    else:
        x = whole_seq(x, par)
    H, KVH, dh = q1 - q0, k1 - k0, cfg.head_dim
    G = H // KVH
    B, S, _ = x.shape
    cached = mode == "cross_cached"

    q = _proj(x, cast(p["wq"]))
    if "bq" in p:
        q = q + cast(p["bq"])
    src = x if kv_x is None else kv_x
    if not cached:
        k = _proj(src, cast(p["wk"]))
        v = _proj(src, cast(p["wv"]))
        if "bk" in p:
            k, v = k + cast(p["bk"]), v + cast(p["bv"])
    if "q_norm" in p:
        q = _head_rms(q, p["q_norm"], cfg.norm_eps)
        if not cached:
            k = _head_rms(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos == "rope" and kv_x is None and not cached:
        if mode == "decode":
            qpos = torch.as_tensor(pos, device=x.device).expand(B)[:, None]
        else:
            qpos = torch.arange(S, device=x.device)
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)

    hspec = batch_spec(par, None, "model", None)
    q = constrain(q, par, hspec)

    new_cache = None
    if kv_all:                         # k, v hold every kv head
        k_all, v_all = k, v
        k, v = k[:, :, k0:k1], v[:, :, k0:k1]
    if mode == "decode" and kv_all:
        qa = all_gather(q, par, 2, "model") if tp else q
        out, kc, vc = decode_window_block(
            qa.reshape(B, S, cfg.n_kv_heads, -1, dh), k_all, v_all,
            cache["k"], cache["v"], pos, cfg.attn_window, par)
        new_cache = {"k": kc, "v": vc}
        out = out.reshape(B, S, cfg.n_heads, dh)[:, :, q0:q1]
    elif mode == "decode":
        out, kc, vc = decode_step(q.reshape(B, S, KVH, G, dh), k, v,
                                  cache["k"], cache["v"], pos,
                                  window=cfg.attn_window)
        new_cache = {"k": kc, "v": vc}
        out = out.reshape(B, S, H, dh)
    elif cached:
        kc, vc = cache["k"], cache["v"]
        s = torch.einsum("bqkgh,bwkh->bkgqw", q.reshape(B, S, KVH, G, dh)
                         .float(), kc.float()) / math.sqrt(dh)
        pr = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqw,bwkh->bqkgh", pr.to(vc.dtype).float(),
                           vc.float()).to(x.dtype).reshape(B, S, H, dh)
    else:
        attend = (ops.flash_attention_trainable if mode == "train"
                  else ops.flash_attention)
        out = attend(_heads_first(q), _heads_first(k), _heads_first(v),
                     causal=causal, window=cfg.attn_window if causal else 0,
                     block=par.attn_block).transpose(1, 2)
        W = cfg.attn_window
        if kv_all:
            k, v = k_all, v_all
        if mode == "train":
            pass                                   # no cache to emit
        elif not causal:
            if kv_x is not None:
                new_cache = {"k": k, "v": v}       # cross-attn KV for decode
        elif kv_x is None and W and S >= W:
            slots = (S - W + torch.arange(W, device=x.device)) % W
            kc = torch.zeros((B, W) + k.shape[2:], dtype=k.dtype,
                             device=x.device)
            vc = torch.zeros_like(kc)
            kc[:, slots] = k[:, -W:]
            vc[:, slots] = v[:, -W:]
            new_cache = {"k": kc, "v": vc}
        elif kv_x is None:
            new_cache = {"k": k, "v": v}

    out = constrain(out.reshape(B, S, H, dh), par, hspec)
    wo = cast(p["wo"])
    if tp:
        y = row_parallel(out.reshape(B, S, H * dh), wo.reshape(H * dh, -1),
                         par)
    else:
        y = own_seq(out_product(out.reshape(B, S, H * dh),
                                wo.reshape(H * dh, -1)), par)
    return y, new_cache


def _local_weights(p: dict, cfg: ArchConfig, par: ParallelCfg, k0: int,
                   k1: int, kv_all: bool = False) -> dict:
    """The weights the rank's heads read: the q-head weights are its
    blocks already; a replicated kv projection (only q heads shard) is
    sliced to kv heads ``k0:k1`` (kept whole under ``kv_all``, where the
    cache holds every kv head); replicated weights read by the local
    heads alone take their gradient's sum over the model ranks."""
    out = dict(p)
    if not par.tp_sharded("kv_heads"):
        for name in ("wk", "wv", "bk", "bv"):
            if name in p:
                w = copy_to_model(p[name], par)
                if not kv_all:
                    w = w[:, k0:k1] if name[0] == "w" else w[k0:k1]
                out[name] = w
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = copy_to_model(p[name], par)
    return out
