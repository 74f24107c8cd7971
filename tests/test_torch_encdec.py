"""Port vs reference: non-causal and cross attention, and the encdec and
vision-stub serve paths, on the CPU.

* ``flash_scan`` (the ``flash_attention`` kernel's plain non-causal
  version) against the reference's ``flash_scan`` and the naive oracle at
  3e-5 in float32 (``tests/test_models.py::test_flash_scan_matches_naive_noncausal``),
  with q and kv of other lengths, and through ``ops.flash_attention``.
* ``attn_apply``'s encoder (non-causal), cross-attention prefill and
  ``cross_cached`` decode modes on the reduced whisper-base's weights (the
  reference's ``init_params`` tree) at 2e-2, both in bf16.
* ``input_specs`` equal to the reference's, and ``materialize``.
* The two reference engine faults (ROADMAP Queue 3 items 11 and 12): a
  vision-stub lane's first decode position, and a second encoder length.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.models import attention as j_attention
from repro.models.api import build_model as j_build_model
from repro.models.common import SHAPES as J_SHAPES
from repro.models.common import ShapeCfg as JShapeCfg
from repro.models.common import input_specs as j_input_specs
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention
from repro_torch.models.common import SHAPES, ShapeCfg, TensorSpec, \
    input_specs, materialize
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCfg
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import frontend_tokens

TOL = 2e-2
# A decode step against a prefill of the longer sequence: both bf16, the
# cache rounded where the prefill keeps its activations, so the two differ
# by bf16 noise (up to 0.031 on the reduced llava); the vlm position fault
# moves the logits by ~3.7.
DECODE_TOL = 5e-2
JPAR = JParallelCfg(mesh=None, remat="none")
PAR = ParallelCfg()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper():
    jcfg = J_ARCHS["whisper-base"].reduced()
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              configs.get("whisper-base").reduced(), "cpu")
    return jcfg, jm, jp, model


def _t(x):
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(x))


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    atol=tol, rtol=tol)


def _hidden(d, seed, B=2, L=24):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, L, d)), jnp.bfloat16)
    return x, _t(x)


# ---------------------------------------------------------------------------
# flash_scan: the kernel's plain non-causal version.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Skv,G,block_q,block_k", [
    (128, 128, 2, 32, 64),      # the reference's own case
    (48, 80, 2, 16, 32),        # q and kv of other lengths
    (37, 300, 1, 1024, 2048),   # one q block, a kv length with no 2^k
    (8, 8, 4, 4, 4),            # kv shorter than one kernel tile
])
def test_flash_scan_matches_reference_and_naive(Sq, Skv, G, block_q,
                                                block_k):
    B, K, h = 1, 2, 32
    keys = jax.random.split(jax.random.key(1), 3)
    q = jax.random.normal(keys[0], (B, Sq, K, G, h), jnp.float32)
    k = jax.random.normal(keys[1], (B, Skv, K, h), jnp.float32)
    v = jax.random.normal(keys[2], (B, Skv, K, h), jnp.float32)
    want = j_attention.flash_scan(q, k, v, block_q=block_q, block_k=block_k)
    tq, tk, tv = (torch.from_numpy(np.array(a)) for a in (q, k, v))
    got = attention.flash_scan(tq, tk, tv, block_q=block_q, block_k=block_k)
    assert got.shape == tq.shape
    assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=3e-5)
    naive = attention_ref(tq.flatten(2, 3).transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=False)
    assert_allclose(got.flatten(2, 3).transpose(1, 2).numpy(), naive.numpy(),
                    atol=3e-5, rtol=3e-5)
    # ... and as the kernel's plain version (blocks block // 2, block).
    reset_launches()
    op = ops.flash_attention(tq.flatten(2, 3).transpose(1, 2), tk.transpose(
        1, 2), tv.transpose(1, 2), causal=False, block=block_k)
    assert LAUNCHES.get("flash_attention", 0) == 0
    assert_allclose(op.numpy(), naive.numpy(), atol=3e-5, rtol=3e-5)


def test_flash_scan_bf16_matches_reference():
    rng = np.random.default_rng(7)
    arrs = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16) for s in
            ((1, 40, 2, 3, 64), (1, 96, 2, 64), (1, 96, 2, 64))]
    want = j_attention.flash_scan(*arrs, block_q=8, block_k=32)
    got = attention.flash_scan(*(_t(a) for a in arrs), block_q=8,
                               block_k=32)
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_attn_apply_refuses_a_q_offset(whisper):
    """The reference's ``q_offset`` is 0 wherever it is set (its
    ``_embed_in``); the port places query row 0 at key 0, as the kernel
    does, and refuses any other offset rather than ignore it."""
    jcfg, _, jp, model = whisper
    p = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    x, tx = _hidden(jcfg.d_model, 5, L=12)
    y, _ = j_attention.attn_apply(p, x, jcfg, JPAR, mode="prefill",
                                  q_offset=0)
    ty, _ = attention.attn_apply(_tree(p), tx, model.cfg, PAR,
                                 mode="prefill", q_offset=0)
    _close(ty, y)
    with pytest.raises(NotImplementedError, match="q_offset=4"):
        attention.attn_apply(_tree(p), tx, model.cfg, PAR, mode="prefill",
                             q_offset=4)


# ---------------------------------------------------------------------------
# attn_apply's encoder, cross and cross_cached modes.
# ---------------------------------------------------------------------------

def test_encoder_attention_is_noncausal(whisper):
    jcfg, _, jp, model = whisper
    p = jax.tree.map(lambda a: a[0], jp["encoder"]["attn"])
    x, tx = _hidden(jcfg.d_model, 1, L=40)
    y, c = j_attention.attn_apply(p, x, jcfg, JPAR, mode="prefill",
                                  causal=False)
    ty, tc = attention.attn_apply(_tree(p), tx, model.cfg, PAR,
                                  mode="prefill", causal=False)
    assert c is None and tc is None
    _close(ty, y)
    # the last row sees every key, the first too: not causal
    causal, _ = attention.attn_apply(_tree(p), tx, model.cfg, PAR,
                                     mode="prefill")
    assert not torch.allclose(causal[:, 0], ty[:, 0])


def test_cross_attention_prefill_and_cached_decode(whisper):
    jcfg, _, jp, model = whisper
    p = jax.tree.map(lambda a: a[1], jp["blocks"]["cross"])
    assert "q_norm" not in p
    x, tx = _hidden(jcfg.d_model, 2, L=24)
    enc, tenc = _hidden(jcfg.d_model, 3, L=56)
    y, c = j_attention.attn_apply(p, x, jcfg, JPAR, mode="prefill",
                                  kv_x=enc, causal=False)
    ty, tc = attention.attn_apply(_tree(p), tx, model.cfg, PAR,
                                  mode="prefill", kv_x=tenc, causal=False)
    _close(ty, y)
    assert set(tc) == {"k", "v"}
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == c[k].shape == (2, 56, jcfg.n_kv_heads,
                                                    jcfg.head_dim)
        _close(tc[k], c[k])
    x1, tx1 = _hidden(jcfg.d_model, 4, L=1)
    y1, c1 = j_attention.attn_apply(p, x1, jcfg, JPAR, mode="cross_cached",
                                    cache=c)
    ty1, tc1 = attention.attn_apply(_tree(p), tx1, model.cfg, PAR,
                                    mode="cross_cached", cache=_tree(c))
    assert c1 is None and tc1 is None
    _close(ty1, y1)


# ---------------------------------------------------------------------------
# input_specs and materialize.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_reference(arch, shape):
    for cfg, jcfg in ((configs.get(arch), J_ARCHS[arch]),
                      (configs.get(arch).reduced(), J_ARCHS[arch].reduced())):
        got = input_specs(cfg, shape, scale_batch=4)
        want = j_input_specs(jcfg, shape, scale_batch=4)
        assert list(got) == list(want)
        for k, s in want.items():
            assert got[k] == TensorSpec(s.shape, getattr(torch, str(s.dtype)))


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_materialize_runs_the_model(arch):
    """The reference test helper's inputs, built on a device, feed prefill
    and decode (``tests/test_models.py::test_arch_smoke_prefill``)."""
    from repro_torch.models.api import build_model
    cfg = configs.get(arch).reduced()
    model = build_model(cfg, "cpu")
    bp = materialize(cfg, "prefill_32k", seq=32, device="cpu")
    assert bp["tokens"].dtype == torch.int32
    assert bp["tokens"].shape[1] == 32 - (cfg.n_frontend_tokens
                                          if cfg.frontend == "vision_stub"
                                          else 0)
    logits, caches = model.prefill(bp)
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and caches
    bd = materialize(cfg, "decode_32k", seq=32, device="cpu")
    assert bd["pos"].shape == () and int(bd["pos"]) == 16
    logits, out = model.decode(bd)
    assert bool(torch.isfinite(logits).all())
    for k, v in out.items():
        assert v.shape == bd[k].shape, k
    # the same numbers the reference's helper draws, in its key order
    sc = ShapeCfg("decode_32k", SHAPES["decode_32k"].kind, 32, 2)
    jsc = JShapeCfg("decode_32k", J_SHAPES["decode_32k"].kind, 32, 2)
    assert list(input_specs(cfg, sc)) == list(
        j_input_specs(J_ARCHS[arch].reduced(), jsc))


# ---------------------------------------------------------------------------
# The reference engine's faults (ROADMAP Queue 3 items 11 and 12).
# ---------------------------------------------------------------------------

def _reqs(cfg, lens, max_new, seed, cls):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, L)
                .astype(np.int32), max_new=max_new)
            for i, L in enumerate(lens)]


def test_vlm_first_decode_position():
    """Reduced llava-next-34b, 8 zero patches, a 12-token prompt: the
    port's lane starts decoding at P + 12 = 20 and its first decode step
    equals a prefill of the P + 12 + 1 sequence; the reference's lane
    starts at 12, and its decode there does not."""
    jcfg = J_ARCHS["llava-next-34b"].reduced()
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              configs.get("llava-next-34b").reduced(), "cpu")
    cfg = model.cfg
    P = frontend_tokens(cfg)
    assert P == 8
    sc = dict(batch_slots=1, max_len=64)
    (req,) = _reqs(cfg, [12], 4, 5, Request)
    eng = ServeEngine(model, ServeConfig(**sc), device="cpu")
    eng._admit([req])
    assert int(eng.lane_pos[0]) == P + 12
    tok = req.out_tokens[0]
    logits, _ = model.decode({"token": torch.tensor([[tok]]),
                              "pos": torch.as_tensor(eng.lane_pos),
                              **eng.caches})
    patches = torch.zeros((1, P, cfg.d_model), dtype=torch.bfloat16)
    full, _ = model.prefill({"tokens": torch.from_numpy(
        np.append(req.prompt, tok)[None]), "patch_embeds": patches})
    assert_allclose(logits[0].numpy(), full[0].numpy(), atol=DECODE_TOL,
                    rtol=DECODE_TOL)

    (jreq,) = _reqs(cfg, [12], 4, 5, JRequest)
    jeng = JServeEngine(jm, jp, jcfg, JPAR, JServeConfig(**sc))
    jeng._admit([jreq])
    assert int(jeng.lane_pos[0]) == 12                  # the fault
    assert jreq.out_tokens[0] == tok
    jlogits, _ = jeng._decode(jp, {"token": jnp.asarray([[tok]], jnp.int32),
                                   "pos": jnp.asarray(jeng.lane_pos),
                                   **jeng.caches})
    assert np.abs(np.asarray(jlogits[0]) - full[0].numpy()).max() \
        > 20 * DECODE_TOL


def test_second_encoder_length_raises(whisper):
    """Reduced whisper-base, prompts of 8, 12 and 8 tokens, 2 lanes,
    max_len 64: the second request's encoder length is not the pool's.
    The reference engine fails with a broadcasting error; the port raises
    a ValueError naming both lengths, and serves equal lengths."""
    jcfg, jm, jp, model = whisper
    sc = dict(batch_slots=2, max_len=64)
    eng = ServeEngine(model, ServeConfig(**sc), device="cpu")
    with pytest.raises(ValueError, match="encoder length 12 differs from "
                       "the cross-attention pool's 8"):
        eng.run(_reqs(model.cfg, [8, 12, 8], 3, 0, Request))
    jeng = JServeEngine(jm, jp, jcfg, JPAR, JServeConfig(**sc))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jeng.run(_reqs(model.cfg, [8, 12, 8], 3, 0, JRequest))
    done = ServeEngine(model, ServeConfig(**sc), device="cpu").run(
        _reqs(model.cfg, [8, 8, 8], 3, 0, Request))
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
