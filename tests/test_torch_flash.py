"""Port vs reference: the ``flash_attention`` kernel path on the CPU.

On CPU tensors the port's ``ops.flash_attention`` runs the kernel's plain
version, the model's blockwise ``flash_unrolled``.  Here it is held to the
reference's Pallas kernel (interpret mode) and its naive oracle at the
reference suite's shapes and tolerances (``tests/test_kernels.py``: 2e-5
in float32, 2e-2 in bfloat16, atol = rtol: softmax reassociates), and the
port's ``flash_unrolled`` to the reference's at ragged lengths.  The CUDA
kernel itself is held to the plain version on the card
(``test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.ref import attention_ref as j_attention_ref
from repro.models.attention import flash_unrolled as j_flash_unrolled
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.attention import flash_unrolled

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, shapes, bf16):
    """The same normal draws for both packages, as numpy f32 (rounded to
    bf16 first when ``bf16``)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.standard_normal(s).astype(np.float32)
        if bf16:
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out.append(a)
    return out


def _both(arrs, bf16):
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,H,KVH,S,dh,causal,window,bf16", [
    (2, 4, 2, 128, 64, True, 0, False),
    (1, 8, 8, 256, 32, True, 64, False),
    (2, 2, 1, 128, 64, False, 0, False),
    (1, 4, 4, 128, 128, True, 0, True),
    (1, 8, 2, 512, 64, True, 0, False),
])
def test_flash_attention_op_matches_reference(B, H, KVH, S, dh, causal,
                                              window, bf16):
    """The reference suite's kernel cases (test_kernels.py:454-459)."""
    arrs = _inputs(1, [(B, H, S, dh), (B, KVH, S, dh), (B, KVH, S, dh)],
                   bf16)
    (jq, jk, jv), (q, k, v) = _both(arrs, bf16)
    reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              block=64)
    assert LAUNCHES.get("flash_attention", 0) == 0   # the CPU: no launch
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    oracle = j_attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = TOL["bfloat16" if bf16 else np.float32]
    assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)
    assert_allclose(_f32(attention_ref(q, k, v, causal, window)),
                    _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,block,window,G,bf16", [
    (97, 32, 0, 1, False), (97, 32, 48, 2, False), (130, 64, 20, 4, False),
    (777, 256, 100, 5, True), (33, 2048, 0, 2, True)])
def test_flash_unrolled_ragged_matches_reference(S, block, window, G, bf16):
    """Ragged lengths (no block multiple): the port's flash_unrolled vs the
    reference's, q [B,S,K,G,h]."""
    B, K, h = 1, 2, 32
    arrs = _inputs(2, [(B, S, K, G, h), (B, S, K, h), (B, S, K, h)], bf16)
    (jq, jk, jv), (q, k, v) = _both(arrs, bf16)
    got = flash_unrolled(q, k, v, block=block, window=window)
    want = jax.jit(j_flash_unrolled, static_argnames=("block", "window"))(
        jq, jk, jv, block=block, window=window)
    tol = TOL["bfloat16" if bf16 else np.float32]
    assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # ... and the op in the kernel's layout, against the naive oracle.
    got_op = ops.flash_attention(q.flatten(2, 3).transpose(1, 2),
                                 k.transpose(1, 2), v.transpose(1, 2),
                                 window=window, block=block)
    oracle = j_attention_ref(jnp.swapaxes(jq.reshape(B, S, K * G, h), 1, 2),
                             jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2),
                             window=window)
    assert_allclose(_f32(got_op), _f32(oracle), atol=tol, rtol=tol)


def test_flash_attention_rejects_bad_inputs():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    with pytest.raises(TypeError):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv, window=-1)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 2, 0, 32), torch.zeros(1, 2, 0, 32))
