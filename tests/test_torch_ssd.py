"""Port vs reference: the ``ssd_scan`` kernel path on the CPU.

On CPU tensors the port's ``ops.ssd_scan`` runs the kernel's plain
version, the model's ``ssd_chunked``.  Here it is held to the reference's
Pallas kernel (interpret mode) and its sequential oracle at the reference
suite's shapes and tolerances (``tests/test_kernels.py``: 3e-4 in float32,
3e-2 in bfloat16, atol = rtol: the chunked recurrence reassociates), and
the port's ``ssd_chunked`` to the reference's on identical float32 inputs
at 2e-4, ragged lengths (``S % Q != 0``) and an initial state included.
The CUDA kernel itself is held to the plain version on the card
(``test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro.models.ssm import ssd_ref as j_ssd_ref
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.ssm import ssd_chunked, ssd_ref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, B, S, H, P, G, N):
    """x, dt (after softplus), A (< 0), B, C as numpy float32."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)))
    A = -np.exp(0.3 * rng.standard_normal(H))
    Bm = 0.5 * rng.standard_normal((B, S, G, N))
    Cm = 0.5 * rng.standard_normal((B, S, G, N))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,bf16", [
    (2, 128, 4, 32, 2, 16, 32, False),
    (1, 64, 2, 16, 1, 8, 16, False),
    (1, 256, 8, 64, 1, 32, 64, False),
    (2, 64, 4, 32, 4, 16, 32, True),
])
def test_ssd_scan_op_matches_reference(B, S, H, P, G, N, chunk, bf16):
    """The reference suite's kernel cases (test_kernels.py:477-481): x in
    the case's dtype, dt/A/B/C float32."""
    x, dt, A, Bm, Cm = _case(4, B, S, H, P, G, N)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    reset_launches()
    y, h = ops.ssd_scan(tx, *map(torch.from_numpy, (dt, A, Bm, Cm)),
                        chunk=chunk)
    assert LAUNCHES.get("ssd_scan", 0) == 0          # the CPU: no launch
    assert y.dtype == tx.dtype and h.dtype == torch.float32
    jy, jh = jops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A),
                           jnp.asarray(Bm), jnp.asarray(Cm), chunk=chunk,
                           interpret=True)
    yr, hr = j_ssd_ref(jx.astype(jnp.float32), jnp.asarray(dt),
                       jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(Cm))
    tol = 3e-2 if bf16 else 3e-4
    assert_allclose(_f32(y), _f32(jy), atol=tol, rtol=tol)
    assert_allclose(h.numpy(), np.asarray(jh), atol=tol, rtol=tol)
    assert_allclose(_f32(y), _f32(yr), atol=tol, rtol=tol)
    assert_allclose(h.numpy(), np.asarray(hr), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,chunk,G,with_h0", [
    (64, 16, 2, False), (77, 16, 1, False), (50, 64, 2, True),
    (100, 32, 1, True)])
def test_ssd_chunked_matches_reference(S, chunk, G, with_h0):
    """Identical float32 inputs: y and the final state at 2e-4, ragged
    lengths padded with dt = 0 steps on both sides."""
    B, H, P, N = 2, 4, 16, 8
    x, dt, A, Bm, Cm = _case(5, B, S, H, P, G, N)
    h0 = (0.3 * np.random.default_rng(6).standard_normal((B, H, P, N))
          ).astype(np.float32) if with_h0 else None
    y, h = ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
                       None if h0 is None else torch.from_numpy(h0))
    jy, jh = jax.jit(j_ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
        None if h0 is None else jnp.asarray(h0))
    assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4, rtol=2e-4)
    assert_allclose(h.numpy(), np.asarray(jh), atol=2e-4, rtol=2e-4)
    yr, hr = j_ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                       None if h0 is None else jnp.asarray(h0))
    assert_allclose(y.numpy(), np.asarray(yr), atol=2e-4, rtol=2e-4)
    assert_allclose(h.numpy(), np.asarray(hr), atol=2e-4, rtol=2e-4)


def test_ssd_ref_matches_reference():
    x, dt, A, Bm, Cm = _case(7, 1, 40, 4, 8, 2, 4)
    y, h = ssd_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    jy, jh = j_ssd_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


def test_ssd_scan_rejects_bad_inputs():
    x, dt, A, Bm, Cm = map(torch.from_numpy, _case(8, 1, 8, 4, 8, 2, 4))
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(TypeError, match="only with a bfloat16 x"):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm.bfloat16())
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm[:, :, :1].expand(1, 8, 3, 4), Cm[:, :, :1]
                 .expand(1, 8, 3, 4))
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, Bm, Cm, chunk=0)
