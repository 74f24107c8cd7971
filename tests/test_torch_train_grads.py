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
  banks) as the reference's do, f32 at rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.models import moe as j_moe
from repro.models.params import init_params as j_init_params
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.parallel import ParallelCfg
from tests.train_reference import (GRAD_ARCHS, JPAR, STRICT, _rel,
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
