"""Port vs reference: the train path's gradients on the CPU, part two.

The other half of ``tests/test_torch_train.py``'s reference gradients
(``--dist loadfile`` runs a file on one worker, so the two halves run
side by side):

* ``Model.loss`` against ``jax.value_and_grad(loss_fn)`` for three of the
  ten reduced archs (``train_reference.check_loss_and_grads``; the other
  seven in ``tests/test_torch_train.py``);
* why ``ssm.Dskip`` is held to the reference's float32 gradient: XLA's
  CPU backend sums the transpose of a bf16 broadcast in bf16;
* gradients flow through the MoE FFN (router, combine weights, expert
  banks) as the reference's do, f32 at rtol 1e-4;
* the whole model's MoE gradients in bf16 sit further from the
  reference's than any other leaf because a few tokens route to another
  expert in each package's own forward (ROADMAP Queue 3 item 14).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as j_layers
from repro.configs import ARCHS as J_ARCHS
from repro.models import moe as j_moe
from repro.models.api import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.models import layers, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCfg
from tests.train_reference import (GRAD_ARCHS, JPAR, STRICT, _flat, _rel,
                                   check_loss_and_grads)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """``Model.loss`` against ``jax.value_and_grad(loss_fn)``
    (``train_reference.check_loss_and_grads``)."""
    check_loss_and_grads(arch, monkeypatch)


def test_reference_sums_broadcast_transposes_in_bf16():
    """Why ``BF16_SUM_LEAVES``: the gradient of ``sum(w * (x * d[:, None]))``
    in a bf16 ``d`` over 4096 terms, from the reference's XLA (STRICT) and
    from torch, against float64: torch sums in float32 and rounds once
    (within one bf16 ulp), XLA's CPU backend sums in bf16 (off by more
    than 5%)."""
    rng = np.random.default_rng(0)
    x, w = (rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
            for _ in range(2))
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    xe, we = (np.asarray(a.astype(jnp.float32), np.float64) for a in (jx, jw))
    exact = (xe * we).sum((0, 1, 3))

    def f(d, x, w):
        return jnp.sum((x * d.astype(jnp.bfloat16)[:, None] * w)
                       .astype(jnp.float32))
    d = jnp.ones((4,), jnp.float32)
    g = jax.jit(jax.grad(f)).lower(d, jx, jw).compile(
        compiler_options=STRICT)(d, jx, jw)
    td = torch.ones(4, requires_grad=True)
    tx, tw = (torch.from_numpy(a).bfloat16() for a in (xe.astype(np.float32),
                                                      we.astype(np.float32)))
    (tx * td.bfloat16()[:, None] * tw).float().sum().backward()
    ulp = 2.0 ** -7 * np.abs(exact)
    assert (np.abs(td.grad.numpy() - exact) <= ulp).all()
    assert np.abs(np.asarray(g) - exact).max() > 0.05 * np.abs(exact).max()


# ---------------------------------------------------------------------------
# MoE gradients.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_moe_gradients_match_reference(arch):
    """The gradient of ``sum(w * y) + aux`` through ``moe_apply`` in the
    router, the expert banks (and the shared experts), and x, float32
    inputs, against ``jax.grad`` of the reference's within relative
    Frobenius 1e-4 per leaf (a norm: single elements near cancellation
    differ by ~4e-9 at values of ~1e-4): the router product and the
    combine weights carry gradient, the routing ids none, as in the
    reference."""
    jcfg = J_ARCHS[arch].reduced()
    cfg = configs.get(arch).reduced()
    jp = j_init_params(jax.random.key(0), j_moe.moe_defs(jcfg))
    rng = np.random.default_rng(5)
    x = (0.1 * rng.standard_normal((2, 16, cfg.d_model))).astype(np.float32)
    w = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def jf(p, x):
        y, aux = j_moe.moe_apply(p, x, jcfg, JPAR)
        return jnp.sum(y * w) + aux
    jg = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tp, tx, cfg, ParallelCfg())
    assert aux.requires_grad
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    for k, p in tp.items():
        assert bool(p.grad.abs().sum() > 0), k
        assert _rel(p.grad.numpy(), np.asarray(jg[0][k])) <= 1e-4, k
    assert _rel(tx.grad.numpy(), np.asarray(jg[1])) <= 1e-4


# ---------------------------------------------------------------------------
# The whole model's MoE gradients: routing flips (ROADMAP Queue 3 item 14).
# ---------------------------------------------------------------------------

MOE_LEAVES = ("blocks.moe.router", "blocks.moe.w_in", "blocks.moe.w_out",
              "blocks.norm2.scale")


def _routed_loss_and_grads(jm, jcfg, jp, cfg, tokens, labels):
    """Each package's loss, gradients and every router call's ``(inputs,
    ids, probs)`` in its own forward (the reference's layers unrolled,
    ``scan_layers=False``, so that its router's values leave the trace)."""
    jpar = JParallelCfg(mesh=None, remat="none", scan_layers=False)
    calls, real = [], j_moe._route

    def route(x2d, router, k):
        out = real(x2d, router, k)
        calls.append((x2d, out[0], out[2]))
        return out

    def f(p, b):
        calls.clear()
        return jm.loss(p, b, jcfg, jpar), list(calls)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    j_moe._route = route
    try:
        (jloss, jrec), jg = jax.jit(jax.value_and_grad(f, has_aux=True)).lower(
            jp, jb).compile(compiler_options=STRICT)(jp, jb)
    finally:
        j_moe._route = real
    prec, preal = [], moe._route

    def proute(x2d, router, k):
        out = preal(x2d, router, k)
        prec.append((x2d.detach().float().numpy(), out[0].numpy(),
                     out[2].detach().numpy()))
        return out
    moe._route = proute
    try:
        model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                                  ParallelCfg(remat="none"))
        loss, grads = model.loss({"tokens": torch.from_numpy(tokens),
                                  "labels": torch.from_numpy(labels)})
    finally:
        moe._route = preal
    rel = {k: _rel(g.numpy(), w) for k, (g, w) in
           ((k, (grads[k], w)) for k, w in _flat(jg).items())}
    jrec = [tuple(np.asarray(a, np.float32) for a in r) for r in jrec]
    return float(jloss), float(loss), rel, jrec, prec


def test_moe_gradient_gap_is_routing_flips(monkeypatch):
    """Reduced qwen3-moe at the no-drop capacity (``NO_DROP``, as the mesh
    fleets run it), seed 0, on the reference's weights: the MoE leaves'
    bf16 gradients lie up to 7.2e-2 from ``jax.grad``, the other leaves
    within 1e-2.  Not a fault of the port's MoE path:

    * the two routers agree on the same inputs: the reference's
      ``_route`` on the port's layer inputs gives the port's ids at every
      token of both layers;
    * in each package's own forward the layer inputs differ by bf16
      rounding (up to 2.3e-2), and 3 of the 512 tokens of layer 1 route
      to another expert, each at a near tie (its 2nd and 3rd router
      probabilities within 2e-3);
    * with those 3 positions' labels masked (layer 1 is the last: nothing
      else reads them) every leaf, the MoE's too, is within 1e-2;
    * in float32 on both sides (``COMPUTE_DTYPE``) no token flips and
      every leaf is within 1e-5."""
    jcfg = dataclasses.replace(J_ARCHS["qwen3-moe-30b-a3b"].reduced(),
                               capacity_factor=8 / 2)
    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b").reduced(),
                              capacity_factor=8 / 2)
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((8, 1), -1, np.int32)], 1)
    k = cfg.experts_per_token

    jloss, loss, rel, jrec, prec = _routed_loss_and_grads(
        jm, jcfg, jp, cfg, tokens, labels)
    assert abs(jloss - loss) < 1e-3
    moe_gap = max(rel[n] for n in MOE_LEAVES)
    assert moe_gap > 3e-2, rel
    assert max(v for n, v in rel.items() if n not in MOE_LEAVES) < 1e-2
    flipped = np.zeros(tokens.shape, bool)
    for layer, ((jx, jid, _), (px, pid, pprob)) in enumerate(
            zip(jrec, prec)):
        same_in, _, _ = j_moe._route(jnp.asarray(px, jnp.bfloat16),
                                     jp["blocks"]["moe"]["router"][layer], k)
        assert np.array_equal(np.asarray(same_in), pid), layer
        flips = (jid != pid).any(-1)
        top = -np.sort(-pprob, -1)
        assert (top[flips, k - 1] - top[flips, k] < 2e-3).all(), layer
        flipped |= flips.reshape(tokens.shape)
    assert flipped.sum() == 3 and not (jrec[0][1] != prec[0][1]).any()

    masked = np.where(flipped, -1, labels)
    _, _, rel_m, _, _ = _routed_loss_and_grads(jm, jcfg, jp, cfg, tokens,
                                               masked)
    assert max(rel_m.values()) < 1e-2, rel_m
    assert max(rel_m[n] for n in MOE_LEAVES) < moe_gap / 4

    monkeypatch.setattr(j_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    jloss, loss, rel, jrec, prec = _routed_loss_and_grads(
        jm, jcfg, jp, cfg, tokens, labels)
    assert all(np.array_equal(j[1], p[1]) for j, p in zip(jrec, prec))
    assert max(rel.values()) < 1e-5, rel
