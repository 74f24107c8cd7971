"""Port vs reference: the train path's loss and gradients on the CPU.

The reduced configs of all ten architectures run the reference's
``loss_fn`` (``jax.value_and_grad``, compiled with XLA's
``xla_allow_excess_precision`` off, ``STRICT``, as the serve tests do) and
the port's ``Model.loss`` on the same weights (the reference's
``init_params(jax.random.key(0), ...)`` tree, carried across by
``convert.params_from_numpy``) and the same numpy batch.  Held:

* ``chunked_ce_loss`` against the reference's at rtol 1e-6
  (``tests/test_models.py:200``);
* ``loss_fn`` within 2e-2 and every gradient leaf within a relative
  Frobenius error of 5e-2 of ``jax.grad``'s, with one exception stated in
  :func:`test_loss_and_grads_match_reference`;
* the model kernels' trainable entries: on the CPU their output and
  gradients equal autograd through the plain version, bitwise, and the
  raw entries still refuse inputs that require grad;
* the remat policies ``none`` / ``full`` / ``dots`` give bitwise equal
  loss and gradients, ``dots`` recomputes fewer products than ``full``,
  and ``full`` runs each layer's kernels twice a step;
* gradients flow through the MoE FFN (router, combine weights, expert
  banks) as the reference's do, f32 at rtol 1e-4.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import repro.models.layers as j_layers
from repro.configs import ARCHS as J_ARCHS
from repro.models import moe as j_moe
from repro.models.api import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import api, moe, ssm
from repro_torch.models.api import build_model
from repro_torch.models.common import materialize
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import chunked_ce_loss, logits_apply
from repro_torch.models.parallel import ParallelCfg

STRICT = {"xla_allow_excess_precision": False}
JPAR = JParallelCfg(mesh=None, remat="none")
LOSS_TOL = 2e-2
GRAD_TOL = 5e-2
# Leaves whose reference gradient is a bf16 sum over the whole activation:
# ``Dskip`` enters as ``xh * cast(Dskip)[:, None]``, and XLA's CPU backend
# accumulates the transpose of that broadcast (a sum over B x S x P) in
# bf16 (see test_reference_sums_broadcast_transposes_in_bf16).
BF16_SUM_LEAVES = ("blocks.ssm.Dskip",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(jnp.asarray(v, jnp.float32))})
    return out


def _rel(got, want) -> float:
    """Relative Frobenius error ``|got - want| / |want|`` (0 when both
    are zero)."""
    d = np.linalg.norm(np.asarray(got, np.float64) - want)
    n = np.linalg.norm(np.asarray(want, np.float64))
    return float(d / n) if n else float(d)


def _jbatch(batch):
    return {k: (jnp.asarray(v.float().numpy(), jnp.bfloat16)
                if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
            for k, v in batch.items()}


def _reference_value_and_grad(jm, jcfg, jp, jb):
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, jcfg, JPAR)))
    return vg.lower(jp, jb).compile(compiler_options=STRICT)(jp, jb)


# ---------------------------------------------------------------------------
# The loss.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64, 1024])
def test_chunked_ce_matches_reference(chunk):
    """``chunked_ce_loss`` equals the reference's at rtol 1e-6 (f32 hidden
    states against bf16-cast weights, the last position ignored)."""
    rng = np.random.default_rng(9)
    V, D, B, S = 128, 32, 2, 64
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (0.1 * rng.standard_normal((D, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[:, -1] = -1
    want = j_layers.chunked_ce_loss({"w": jnp.asarray(w)}, jnp.asarray(h),
                                    jnp.asarray(labels), chunk=chunk)
    got = chunked_ce_loss({"w": torch.from_numpy(w)}, torch.from_numpy(h),
                          torch.from_numpy(labels), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert_allclose(float(got), float(want), rtol=1e-6)
    # ... and the direct formula over the whole [B, S, V] (rtol 1e-6).
    logits = logits_apply({"w": torch.from_numpy(w)}, torch.from_numpy(h))
    lab = torch.from_numpy(labels).long()
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, lab.clamp_min(0)[..., None])[..., 0]
    direct = torch.where(lab >= 0, nll, 0.0).sum() / (lab >= 0).sum()
    assert_allclose(float(got), float(direct), rtol=1e-6)


def test_chunked_ce_refuses_uneven_chunks():
    """S = 50 at chunk 16 is 3 chunks of 16, which miss 2 positions: the
    reference's reshape fails there, the port raises."""
    h = torch.zeros((1, 50, 4))
    with pytest.raises(ValueError, match="do not cover"):
        chunked_ce_loss({"w": torch.zeros((4, 8))}, h,
                        torch.zeros((1, 50), dtype=torch.int32), chunk=16)


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """``Model.loss`` against ``jax.value_and_grad(loss_fn)`` on the
    reference's weights, seq 64, batch 2: the loss within 2e-2 and every
    gradient leaf within relative Frobenius 5e-2 (measured worst over the
    ten archs: loss 5.0e-4 (llava), gradient 1.8e-2 (qwen1.5-0.5b's and
    codeqwen's ``attn.bk``)).

    The exception is ``ssm.Dskip`` (mamba2, hymba), whose reference
    gradient is a bf16 sum over the activation (``BF16_SUM_LEAVES``): it
    is held within 5e-2 of the reference's gradient computed in float32
    (its ``COMPUTE_DTYPE`` set to float32, the same code), and the
    reference's own bf16 gradient must lie further from that than the
    port's (measured: port 2.3e-2 / 1.8e-2, reference 4.9e-2 / 4.8e-2;
    the port is 4.3e-2 / 5.3e-2 from the reference's bf16 gradient)."""
    jcfg, cfg = J_ARCHS[arch].reduced(), configs.get(arch).reduced()
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                              ParallelCfg(remat="none"))
    batch = materialize(cfg, "train_4k", seq=64, batch=2, device="cpu")
    jb = _jbatch(batch)
    jloss, jgrads = _reference_value_and_grad(jm, jcfg, jp, jb)
    loss, grads = model.loss(batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    want = _flat(jgrads)
    assert list(grads) == [n for n, _ in model.named_parameters()]
    assert set(grads) == set(want)
    bad = {k: _rel(g.numpy(), want[k]) for k, g in grads.items()
           if k not in BF16_SUM_LEAVES
           and _rel(g.numpy(), want[k]) > GRAD_TOL}
    assert not bad, f"{arch}: gradient leaves off the reference's: {bad}"
    special = [k for k in BF16_SUM_LEAVES if k in grads]
    if special:
        monkeypatch.setattr(j_layers, "COMPUTE_DTYPE", jnp.float32)
        _, g32 = _reference_value_and_grad(jm, jcfg, jp, jb)
        exact = _flat(g32)
        for k in special:
            port, theirs = (_rel(grads[k].numpy(), exact[k]),
                            _rel(want[k], exact[k]))
            assert port <= GRAD_TOL, (k, port)
            assert theirs > port, (k, port, theirs)


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
# The kernels' trainable entries.
# ---------------------------------------------------------------------------

def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


def _flash_inputs(H, KVH, Sq, Skv, dh=32, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype)
            for s in ((2, H, Sq, dh), (2, KVH, Skv, dh), (2, KVH, Skv, dh))]


@pytest.mark.parametrize("case", [
    (4, 2, 96, 96, True, 40, 32),       # causal, sliding window, 3 blocks
    (4, 2, 80, 80, True, 0, 2048),      # causal, one block
    (4, 4, 64, 64, False, 0, 32),       # non-causal (encoder)
    (4, 2, 48, 72, False, 0, 32),       # cross attention, Sq != Skv
], ids=["causal-window", "causal", "noncausal", "cross"])
def test_flash_trainable_equals_plain_autograd(case):
    """On the CPU, ``ops.flash_attention_trainable``'s output and its
    gradients in q, k and v equal autograd through
    ``ref.flash_attention_plain`` (same blocks), bitwise."""
    H, KVH, Sq, Skv, causal, window, block = case
    q, k, v = _flash_inputs(H, KVH, Sq, Skv)
    ct = torch.randn((2, H, Sq, 32),
                     generator=torch.Generator().manual_seed(1)).bfloat16()
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention_trainable(*a, causal=causal, window=window,
                                        block=block)
    out.backward(ct)
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.flash_attention_plain(*b, causal, window, block)
    want.backward(ct)
    assert _same(out.detach(), want.detach())
    for x, y in zip(a, b):
        assert _same(x.grad, y.grad) and bool(x.grad.abs().sum() > 0)


def _ssd_inputs(S=70, H=4, P=8, G=2, N=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (0.5 * torch.randn((2, S, H, P), generator=g)).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((2, S, H), generator=g))
    A = -torch.exp(0.3 * torch.randn((H,), generator=g))
    Bm, Cm = ((0.5 * torch.randn((2, S, G, N), generator=g)).bfloat16()
              for _ in range(2))
    return [x, dt, A, Bm, Cm]


def test_ssd_trainable_equals_plain_autograd():
    """On the CPU, ``ops.ssd_scan_trainable``'s ``(y, h_final)`` and the
    gradients of ``y`` in x, dt, A, B and C equal autograd through
    ``ssm.ssd_chunked`` (ragged last chunk), bitwise; ``h_final`` carries
    no gradient."""
    inputs = _ssd_inputs()
    ct = torch.randn((2, 70, 4, 8),
                     generator=torch.Generator().manual_seed(2)).bfloat16()
    a = [t.clone().requires_grad_(True) for t in inputs]
    y, h = ops.ssd_scan_trainable(*a, chunk=32)
    assert not h.requires_grad
    y.backward(ct)
    b = [t.clone().requires_grad_(True) for t in inputs]
    yw, hw = ssm.ssd_chunked(*b, 32)
    yw.backward(ct)
    assert _same(y.detach(), yw.detach()) and _same(h, hw.detach())
    for x, w in zip(a, b):
        assert _same(x.grad, w.grad) and bool(x.grad.abs().sum() > 0)


def test_raw_entries_still_refuse_grad():
    """The forward-only entries refuse what the trainable ones take."""
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(2, 1, 16, 16))
    with pytest.raises(ValueError, match="forward-only"):
        flash_attention(q, k, v)
    x, dt, A, Bm, Cm = _ssd_inputs(S=16)
    with pytest.raises(ValueError, match="forward-only"):
        ssd_scan(x.requires_grad_(True), dt, A, Bm, Cm, 8)


# ---------------------------------------------------------------------------
# Remat and the kernels' launches.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_remat_policies_bitwise(arch):
    """``none``, ``full`` and ``dots`` give the same loss and gradients,
    bit for bit, on the CPU."""
    cfg = configs.get(arch).reduced()
    batch = materialize(cfg, "train_4k", seq=64, device="cpu")
    out = {r: build_model(cfg, "cpu", seed=0,
                          par=ParallelCfg(remat=r)).loss(batch)
           for r in ("none", "full", "dots")}
    l0, g0 = out["none"]
    for remat, (loss, grads) in out.items():
        assert _same(loss, l0), remat
        assert all(_same(grads[k], g0[k]) for k in g0), remat


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_products():
    """``dots`` keeps the products with no batch dims: its backward runs
    no more of them than ``none``'s, which keeps every activation, and
    fewer than ``full``'s, which recomputes them.  ``tp_out`` is
    refused."""
    cfg = configs.get("qwen1.5-0.5b").reduced()
    batch = materialize(cfg, "train_4k", seq=64, device="cpu")
    counts = {}
    for remat in ("none", "full", "dots"):
        model = build_model(cfg, "cpu", seed=0, par=ParallelCfg(remat=remat))
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        loss = api.loss_fn(model.tree(), batch, cfg, model.par)
        with _CountMM() as mode:
            torch.autograd.grad(loss, list(params.values()))
        counts[remat] = mode.n
    assert counts["none"] == counts["dots"] < counts["full"], counts
    model = build_model(cfg, "cpu", par=ParallelCfg(remat="tp_out"))
    with pytest.raises(ValueError, match="tp_out"):
        model.loss(batch)


@pytest.mark.parametrize("remat, runs", [("none", 1), ("full", 2)])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-base",
                                  "qwen3-moe-30b-a3b"])
def test_kernel_entries_per_layer(arch, remat, runs, monkeypatch):
    """A train step calls each model kernel's entry once a layer forward,
    twice under ``full`` remat (the recompute), and its plain version
    once a layer, in the backward.  whisper: encoder, decoder and cross
    attention."""
    cfg = configs.get(arch).reduced()
    calls = {"flash_attention": 0, "ssd_scan": 0, "plain_flash": 0,
             "plain_ssd": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(ops, "flash_attention",
                        counted("flash_attention", ops.flash_attention))
    monkeypatch.setattr(ops, "ssd_scan", counted("ssd_scan", ops.ssd_scan))
    plain_grads = ops._plain_grads

    def backward_recompute(fn, inputs, grad_out):   # q, k, v or x..C
        calls["plain_flash" if len(inputs) == 3 else "plain_ssd"] += 1
        return plain_grads(fn, inputs, grad_out)
    monkeypatch.setattr(ops, "_plain_grads", backward_recompute)
    model = build_model(cfg, "cpu", par=ParallelCfg(remat=remat))
    loss, grads = model.loss(materialize(cfg, "train_4k", seq=64,
                                         device="cpu"))
    attn = (cfg.n_layers * (2 if cfg.n_encoder_layers else 1)
            + cfg.n_encoder_layers) if cfg.n_heads else 0
    mixers = cfg.n_layers if cfg.ssm_state else 0
    assert calls == {"flash_attention": runs * attn,
                     "ssd_scan": runs * mixers, "plain_flash": attn,
                     "plain_ssd": mixers}
    assert bool(torch.isfinite(loss))
    assert all(bool(g.abs().sum() > 0) for g in grads.values())


def test_model_loss_keeps_parameters_frozen():
    """``Model.loss`` turns ``requires_grad`` on only inside itself: the
    parameters require no gradient after it, even when it raises, and
    the serve forwards still run under no_grad."""
    cfg = configs.get("hymba-1.5b").reduced()
    model = build_model(cfg, "cpu")
    batch = materialize(cfg, "train_4k", seq=64, device="cpu")
    loss, grads = model.loss(batch)
    assert not any(p.requires_grad for p in model.parameters())
    assert all(g.dtype == torch.float32 for g in grads.values())
    with pytest.raises(KeyError):
        model.loss({"tokens": batch["tokens"]})
    assert not any(p.requires_grad for p in model.parameters())
    logits, _ = model.prefill({"tokens": batch["tokens"]})
    assert not logits.requires_grad


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


def test_encoder_frames_reach_the_loss():
    """An encdec batch's frames reach the loss through the encoder's
    trainable attention: their gradient is non-zero."""
    cfg = configs.get("whisper-base").reduced()
    model = build_model(cfg, "cpu")
    batch = materialize(cfg, "train_4k", seq=32, device="cpu")
    frames = batch["frame_embeds"].float().requires_grad_(True)
    loss = api.loss_fn(model.tree(), {**batch, "frame_embeds": frames}, cfg,
                       model.par)
    (g,) = torch.autograd.grad(loss, [frames])
    assert bool(g.abs().sum() > 0)
