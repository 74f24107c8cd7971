"""Port vs reference: AdamW and its schedule on the CPU.

``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on the same
numpy-seeded parameters and gradients, at rtol 1e-6: the schedule in
warmup and in its cosine phase, updates with the global-norm clip active
and inactive, and the decoupled decay that applies only to tensors of
``ndim >= 2``.  Tensors are held at rtol 1e-6 with an atol of 1e-6 x
their largest magnitude: XLA's CPU backend contracts ``p - lr * u`` into
a fused multiply-add and divides by a scalar through its reciprocal, so
an element that nearly cancels (``p ~ lr * u``) differs by one ulp of
its operands, which is no relative bound on the difference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=msg)


def _cfgs(**kw):
    return jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)


@pytest.mark.parametrize("step", [0, 1, 7, 10, 11, 40, 99, 100, 150])
def test_cosine_lr_matches_reference(step):
    """Steps 0-9 are warmup, 10 starts the cosine, 100 ends it, 150 lies
    past it (clipped to the floor)."""
    jc, tc = _cfgs(lr=0.08, warmup_steps=10, total_steps=100,
                   min_lr_frac=0.1)
    want = float(jadamw.cosine_lr(jc, jnp.int32(step)))
    got = float(tadamw.cosine_lr(tc, torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (10.0, True)])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference(grad_scale, clipped, weight_decay):
    """Twelve steps through warmup into the cosine phase, with the clip
    active (global norm ~ 10 x sqrt(17) > 1) or not, and decay on the
    matrix only."""
    jc, tc = _cfgs(lr=0.05, warmup_steps=4, total_steps=12, min_lr_frac=0.1,
                   weight_decay=weight_decay, clip_norm=1.0)
    p0 = _params(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js = jadamw.adamw_init(jp, jc)
    ts = tadamw.adamw_init(tp, tc)
    rng = np.random.default_rng(1)
    for _ in range(12):
        g = {k: (grad_scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in p0.items()}
        jp, js, jm = jadamw.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jc)
        tp, ts, tm = tadamw.adamw_update(
            tp, {k: torch.tensor(v) for k, v in g.items()}, ts, tc)
        assert (float(jm["grad_norm"]) > jc.clip_norm) == clipped
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        for k in p0:
            for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                _close(got, want, k)
    assert int(ts.step) == int(js.step) == 12


def test_decay_only_on_matrices():
    """With a zero gradient the update is the decay alone: the matrix
    shrinks, the vector stays."""
    _, tc = _cfgs(lr=0.1, warmup_steps=1, total_steps=10, weight_decay=0.5)
    p0 = {k: torch.tensor(v) for k, v in _params(2).items()}
    state = tadamw.adamw_init(p0, tc)
    p1, _, _ = tadamw.adamw_update(
        p0, {k: torch.zeros_like(v) for k, v in p0.items()}, state, tc)
    assert torch.equal(p1["b"], p0["b"])
    assert bool((p1["w"].abs() < p0["w"].abs()).all())


def test_update_leaves_its_inputs_alone():
    _, tc = _cfgs()
    p0 = {k: torch.tensor(v) for k, v in _params(3).items()}
    keep = {k: v.clone() for k, v in p0.items()}
    state = tadamw.adamw_init(p0, tc)
    tadamw.adamw_update(p0, {k: torch.ones_like(v) for k, v in p0.items()},
                        state, tc)
    assert all(torch.equal(p0[k], keep[k]) for k in p0)
    assert int(state.step) == 0
