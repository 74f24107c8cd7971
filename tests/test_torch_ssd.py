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


# ---------------------------------------------------------------------------
# The card kernel's precision design, emulated on the CPU.  ssd_scan.cu runs
# C . B in bf16 (exact products) and every product with a float32 operand
# on TF32 tensor cores with that operand split in two TF32 parts, hi =
# tf32(a) and lo = tf32(a - hi).  Here TF32 rounding is emulated by clearing
# the low 13 mantissa bits (the kernel rounds to nearest: the emulation's
# error is at most twice the kernel's), and ssd_chunked's arithmetic is
# rerun with each product so split or rounded once.
# ---------------------------------------------------------------------------

PRODUCTS = ("cb", "mx", "states", "inflow")   # C.B, M.x, x.(wB), C.h_in


def _tf32(a):
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _product(eq, a, b, split_a, split_b):
    """einsum(eq, a, b) as the kernel's TF32 products: hi.hi, plus hi.lo
    and lo.hi for each split operand; an operand not split is rounded once
    (a bf16 value, exact in TF32, is passed with split False)."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if split_b:
        out = out + torch.einsum(eq, ah, _tf32(b - bh))
    if split_a:
        out = out + torch.einsum(eq, _tf32(a - ah), bh)
    return out


def _emulated_ssd(x, dt, A, Bm, Cm, Q, split):
    """ssd_chunked's chunk-parallel arithmetic with the kernel's products;
    ``split`` names the products whose float32 operands are split (the
    others round each operand once).  S % Q == 0, G == 1."""
    exact = x.dtype == torch.bfloat16          # x, B, C hold bf16 values
    Bsz, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // Q
    xc = x.float().reshape(Bsz, nc, Q, H, P)
    Bc, Cc = (m.float().reshape(Bsz, nc, Q, 1, N).expand(Bsz, nc, Q, H, N)
              for m in (Bm, Cm))
    dA = dt.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2) * A[:, None]
    dtc = dt.reshape(Bsz, nc, Q, H).permute(0, 1, 3, 2)
    cum = torch.cumsum(dA, -1)                               # [B,nc,H,Q]
    if exact:                                  # bf16 mma: exact products
        scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    else:
        s = "cb" in split
        scores = _product("bcihn,bcjhn->bchij", Cc, Bc, s, s)
    diff = cum[..., :, None] - cum[..., None, :]
    live = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    M = torch.where(live, scores * torch.exp(diff) * dtc[..., None, :], 0.0)
    s = "mx" in split
    y = _product("bchij,bcjhp->bcihp", M, xc, s, s and not exact)
    w = (torch.exp(cum[..., -1:] - cum) * dtc).permute(0, 1, 3, 2)
    s = "states" in split
    states = _product("bcjhp,bcjhn->bchpn", xc, Bc * w[..., None],
                      s and not exact, s)
    h, h_in = torch.zeros((Bsz, H, P, N)), []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(cum[:, c, :, -1])[..., None, None] + states[:, c]
    s = "inflow" in split
    y_in = _product("bcihn,bchpn->bcihp", Cc, torch.stack(h_in, 1),
                    s and not exact, s)
    y = y + y_in * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    return y.reshape(Bsz, S, H, P), h


def _contract_ratio(got, want, atol, rtol):
    """max |got - want| / (atol + rtol |want|): <= 1 meets the contract."""
    d = (got.float() - want.float()).abs()
    return float((d / (atol + rtol * want.float().abs())).max())


def _precision_case(bf16):
    """hymba's SSD cut to S=512, H=4 (P=100, N=16, chunk 256)."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _case(21, 1, 512, 4, 100, 1, 16))
    if bf16:
        x, Bm, Cm = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("bf16", [False, True])
def test_ssd_tf32_split_meets_the_card_contract(bf16):
    """Every float32 operand split: y and h_final within the card's
    contract of the float32 result (chip_smoke.py): 3e-4 for float32
    inputs; for bf16 inputs y within one bf16 ulp (+1e-3) of the plain
    version's, h_final at 3e-4."""
    args = _precision_case(bf16)
    y, h = _emulated_ssd(*args, 256, PRODUCTS)
    yw, hw = ssd_chunked(*args, 256)
    if bf16:
        assert _contract_ratio(y.bfloat16(), yw, 1e-3, 2.0 ** -7) <= 1.0
    else:
        assert _contract_ratio(y, yw, 3e-4, 3e-4) <= 1.0
    assert _contract_ratio(h, hw, 3e-4, 3e-4) <= 1.0


@pytest.mark.parametrize("single", PRODUCTS + ("all",))
def test_ssd_single_tf32_rounding_misses_the_f32_contract(single):
    """float32 inputs: rounding the operands of any one product (or of all)
    once to TF32 puts y or h_final outside 3e-4, so the kernel splits
    every float32 operand."""
    args = _precision_case(False)
    split = () if single == "all" else tuple(
        p for p in PRODUCTS if p != single)
    y, h = _emulated_ssd(*args, 256, split)
    yw, hw = ssd_chunked(*args, 256)
    assert max(_contract_ratio(y, yw, 3e-4, 3e-4),
               _contract_ratio(h, hw, 3e-4, 3e-4)) > 1.0


@pytest.mark.parametrize("S,single,misses", [(512, PRODUCTS, False),
                                             (4096, ("states",), True)],
                         ids=["512-all-once", "4096-states-once"])
def test_ssd_bf16_single_tf32_rounding(S, single, misses):
    """bf16 inputs (x, B, C exact in TF32): over two chunks even rounding
    every float32 operand once stays within the card's contract, but at
    hymba's serve length (16 chunks) rounding the state products' weights
    once puts h_final outside 3e-4, so the split stays."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _case(21, 1, S, 2, 100, 1, 16))
    args = (x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16())
    split = tuple(p for p in PRODUCTS if p not in single)
    y, h = _emulated_ssd(*args, 256, split)
    yw, hw = ssd_chunked(*args, 256)
    worst = max(_contract_ratio(y.bfloat16(), yw, 1e-3, 2.0 ** -7),
                _contract_ratio(h, hw, 3e-4, 3e-4))
    assert (worst > 1.0) == misses
