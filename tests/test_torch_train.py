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
  ``train_reference.check_loss_and_grads`` (seven of the ten archs here,
  the other three in ``tests/test_torch_train_grads.py``);
* the model kernels' trainable entries: on the CPU their output and
  gradients equal autograd through the plain version, bitwise, and the
  raw entries still refuse inputs that require grad;
* the remat policies ``none`` / ``full`` / ``dots`` give bitwise equal
  loss and gradients, ``dots`` recomputes fewer products than ``full``,
  and ``full`` runs each layer's kernels twice a step;
* gradients reach an encdec batch's frames.

``tests/test_torch_train_grads.py`` holds the rest: three archs' loss and
gradients, the reference's bf16 broadcast sums and the MoE gradients.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import repro.models.layers as j_layers
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import api, ssm
from repro_torch.models.api import build_model
from repro_torch.models.common import materialize
from repro_torch.models.layers import chunked_ce_loss, logits_apply
from repro_torch.models.parallel import ParallelCfg
from tests.train_reference import TRAIN_ARCHS, check_loss_and_grads

# Leaves whose reference gradient is a bf16 sum over the whole activation:
@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """``Model.loss`` against ``jax.value_and_grad(loss_fn)``
    (``train_reference.check_loss_and_grads``)."""
    check_loss_and_grads(arch, monkeypatch)


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
    """``none``, ``full``, ``dots`` and ``tp_out`` give the same loss and
    gradients, bit for bit, on the CPU."""
    cfg = configs.get(arch).reduced()
    batch = materialize(cfg, "train_4k", seq=64, device="cpu")
    out = {r: build_model(cfg, "cpu", seed=0,
                          par=ParallelCfg(remat=r)).loss(batch)
           for r in ("none", "full", "dots", "tp_out")}
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
    fewer than ``full``'s, which recomputes them.  ``tp_out`` keeps each
    sublayer's output product (on one card there is no sum over
    ``model`` to keep): it recomputes fewer than ``full`` and no fewer
    than ``none``."""
    cfg = configs.get("qwen1.5-0.5b").reduced()
    batch = materialize(cfg, "train_4k", seq=64, device="cpu")
    counts = {}
    for remat in ("none", "full", "dots", "tp_out"):
        model = build_model(cfg, "cpu", seed=0, par=ParallelCfg(remat=remat))
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        loss = api.loss_fn(model.tree(), batch, cfg, model.par)
        with _CountMM() as mode:
            torch.autograd.grad(loss, list(params.values()))
        counts[remat] = mode.n
    assert counts["none"] == counts["dots"] < counts["full"], counts
    assert counts["none"] <= counts["tp_out"] < counts["full"], counts


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
