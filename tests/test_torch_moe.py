"""Port vs reference: the Mixture-of-Experts FFN on the CPU.

The reduced ``qwen3-moe-30b-a3b`` (8 experts, top 2) and ``kimi-k2-1t-a32b``
(8 experts, top 2, one shared expert) run through the reference's
``repro.models.moe`` and the port's ``repro_torch.models.moe`` on the same
weights (the reference's ``init_params`` tree as numpy) and the same numpy
inputs.  Held:

* routing: expert ids equal, and where the two routers' float32 sums (XLA
  and torch associate them differently) choose another expert, the two
  probabilities lie within ``FLIP_TOL`` of each other — a near tie; each
  such flip is reported, and none further apart passes;
* the capacity keep mask equal bit for bit on equal ids, including a
  capacity small enough to drop slots;
* outputs: float32 inputs at atol 1e-5, rtol 1e-4 (the reference's own
  EP-vs-dense tolerance, ``tests/test_models.py``), bf16 at 2e-2;
* the port's ``moe_apply`` against its own dense ``moe_ref`` at capacity
  factor 8 (no drops), and ``aux_loss``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.models import moe as j_moe
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.parallel import ParallelCfg

JPAR = JParallelCfg(mesh=None, remat="none")
PAR = ParallelCfg()
FLIP_TOL = 1e-6
ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    return (dataclasses.replace(J_ARCHS[arch].reduced(), **kw),
            dataclasses.replace(configs.get(arch).reduced(), **kw))


def _params(jcfg, seed=0):
    jp = j_init_params(jax.random.key(seed), j_moe.moe_defs(jcfg))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _x(cfg, seed, bf16, B=2, S=16, scale=0.1):
    a = (scale * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)
    if bf16:
        jx = jnp.asarray(a, jnp.bfloat16)
        return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))
                                    ).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_keep(ids, e_local, capacity):
    """The reference's keep mask (``repro/models/moe.py:93-100``) on its
    ids, e_first = 0."""
    flat_e = ids.reshape(-1)
    in_range = (flat_e >= 0) & (flat_e < e_local)
    le = jnp.where(in_range, flat_e, e_local)
    onehot = jax.nn.one_hot(le, e_local + 1, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(le.shape[0]), le]
    return np.asarray(in_range & (rank < capacity))


def _route_both(jp, tp, jx, tx, k):
    D = jx.shape[-1]
    jids, jw, jprobs = j_moe._route(jx.reshape(-1, D), jp["router"], k)
    ids, w, probs = moe._route(tx.reshape(-1, D), tp["router"], k)
    return (np.asarray(jids), np.asarray(jw), np.asarray(jprobs),
            ids.numpy(), w.numpy(), probs.numpy())


def _flips(jids, jprobs, ids):
    """Rows whose chosen experts differ; each must be a near tie."""
    rows = np.nonzero((jids != ids).any(-1))[0]
    for r in rows:
        slots = jids[r] != ids[r]
        a = set(jids[r, slots]) | set(ids[r, slots])
        p = jprobs[r, sorted(a)]
        assert p.max() - p.min() <= FLIP_TOL, \
            f"row {r}: experts {sorted(a)} at probabilities {p}"
    return len(rows)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bf16", [False, True])
def test_route_matches_reference(arch, bf16):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    jx, tx = _x(cfg, 1, bf16, S=64)
    jids, jw, jprobs, ids, w, probs = _route_both(
        jp, tp, jx, tx, cfg.experts_per_token)
    assert ids.dtype == np.int32 and ids.shape == jids.shape
    n = _flips(jids, jprobs, ids)
    print(f"{arch} bf16={bf16}: {n} routing flips at near ties")
    same = (jids == ids).all(-1)
    assert_allclose(probs, jprobs, atol=1e-6, rtol=1e-5)
    assert_allclose(w[same], jw[same], atol=1e-6, rtol=1e-5)


def test_route_ties_take_the_lower_index():
    """Equal probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    D, E = 4, 6
    router = torch.zeros((D, E))
    router[:, 5] = 1.0
    x = torch.ones((3, D))
    ids, w, _ = moe._route(x, router, 3)
    assert ids.tolist() == [[5, 0, 1]] * 3
    jids, _, _ = j_moe._route(jnp.ones((3, D)), jnp.asarray(router.numpy()),
                              3)
    assert np.asarray(jids).tolist() == ids.tolist()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_keep_mask_matches_reference(capacity_factor):
    """On equal ids the keep mask (capacity drops) is the reference's, bit
    for bit; at factor 0.25 slots are dropped."""
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=capacity_factor)
    jp, tp = _params(jcfg)
    jx, tx = _x(cfg, 2, False, S=40)
    jids, *_ = j_moe._route(jx.reshape(-1, cfg.d_model), jp["router"],
                            cfg.experts_per_token)
    N = jx.shape[0] * jx.shape[1]
    cap = moe._capacity(N, cfg.experts_per_token, cfg.n_experts,
                        capacity_factor)
    assert cap == j_moe._capacity(N, cfg.experts_per_token, cfg.n_experts,
                                  capacity_factor)
    tok, dest, keep = moe._slots(torch.from_numpy(np.array(jids)), 0,
                                 cfg.n_experts, cap)
    want = _ref_keep(jids, cfg.n_experts, cap)
    assert np.array_equal(keep.numpy(), want)
    assert tok.tolist() == np.repeat(np.arange(N),
                                     cfg.experts_per_token).tolist()
    assert len(set(dest[keep].tolist())) == int(keep.sum())
    if capacity_factor < 1:
        assert not want.all()                   # slots were dropped


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("bf16", [False, True])
def test_moe_apply_matches_reference(arch, capacity_factor, bf16):
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _params(jcfg, seed=3)
    jx, tx = _x(cfg, 4, bf16)
    jids, _, jprobs, ids, _, _ = _route_both(jp, tp, jx, tx,
                                             cfg.experts_per_token)
    assert _flips(jids, jprobs, ids) == 0
    y, aux = j_moe.moe_apply(jp, jx, jcfg, JPAR)
    ty, taux = moe.moe_apply(tp, tx, cfg, PAR)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    atol, rtol = (2e-2, 2e-2) if bf16 else (1e-5, 1e-4)
    assert_allclose(_f32(ty), _f32(y), atol=atol, rtol=rtol)
    assert_allclose(float(taux), float(aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_dense_ref_when_capacity_ample(arch):
    """``tests/test_models.py::test_moe_matches_dense_ref_when_capacity_ample``
    on the port's own pair, and the port's dense oracle against the
    reference's."""
    jcfg, cfg = _cfgs(arch, capacity_factor=8.0)
    jp, tp = _params(jcfg)
    jx, tx = _x(cfg, 1, False)
    y, aux = moe.moe_apply(tp, tx, cfg, PAR)
    yr = moe.moe_ref(tp, tx, cfg)
    assert_allclose(y.numpy(), yr.numpy(), atol=1e-5, rtol=1e-4)
    assert float(aux) > 0.0
    assert_allclose(yr.numpy(), _f32(j_moe.moe_ref(jp, jx, jcfg)),
                    atol=1e-5, rtol=1e-4)


def test_aux_loss_matches_reference():
    rng = np.random.default_rng(5)
    E, N, k = 8, 50, 2
    probs = rng.dirichlet(np.ones(E), N).astype(np.float32)
    ids = rng.integers(0, E, (N, k)).astype(np.int32)
    want = j_moe.aux_loss(jnp.asarray(probs), jnp.asarray(ids), E)
    got = moe.aux_loss(torch.from_numpy(probs), torch.from_numpy(ids), E)
    assert_allclose(float(got), float(want), rtol=1e-6)
    # Balanced routing on uniform probabilities: the loss's minimum, 1.
    flat = torch.full((E, E), 1.0 / E)
    assert_allclose(float(moe.aux_loss(flat, torch.arange(E)[:, None], E)),
                    1.0, rtol=1e-6)


def test_combine_adds_slots_in_order():
    """The k slots of a token add in slot order, rounding in bf16 after
    each add: the result is ``((0 + s0) + s1) + s2``, not a wider sum."""
    D = 4
    x2d = torch.ones((1, D), dtype=torch.bfloat16)
    ids = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    wgt = torch.tensor([[1.0, 2.0 ** -9, 2.0 ** -9]])
    eye = torch.eye(D, dtype=torch.bfloat16).reshape(1, D, 1, D)
    w_in = eye.expand(3, D, 1, D).contiguous()
    w_out = torch.eye(D, dtype=torch.bfloat16).expand(3, D, D).contiguous()
    y = moe._dispatch_compute(x2d, ids, wgt, w_in, w_out, e_first=0,
                              e_local=3, capacity=4, act="relu2")
    # each slot returns relu(1)^2 = 1 times its weight; 1 + 2^-9 rounds
    # back to 1 in bf16, twice
    assert torch.equal(y, torch.ones((1, D), dtype=torch.bfloat16))
