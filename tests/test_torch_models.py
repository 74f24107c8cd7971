"""Port vs reference: the model substrate's serve path on the CPU.

The reduced ``qwen1.5-0.5b`` (dense: attention only), ``mamba2-370m``
(ssm: SSD only) and ``hymba-1.5b`` (hybrid: both, sliding window) run
through the reference's JAX functions and the port's torch functions on
the same weights (the reference's ``init_params`` tree, carried across by
``convert.params_from_numpy``) and the same numpy inputs.  Sublayers,
one block, ``prefill_fn`` and ``decode_fn`` are held at atol = rtol =
2e-2, the reference's own prefill/decode tolerance
(``tests/test_models.py:97``).  Both run bf16 activations.  The
reference's compiled prefill and decode are built with XLA's
``xla_allow_excess_precision`` off (``STRICT``), so that each bf16 op
rounds as its code says, as the port's ops do; left on, XLA keeps f32
between fused bf16 ops, and the reduced hybrid's logits, which reach
|4|, then differ from the port's by up to 0.99 x 2e-2.  The reference's
prefill-to-decode consistency checks are ported as they are.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.models import attention as j_attention
from repro.models import families as j_families
from repro.models import ssm as j_ssm
from repro.models.api import build_model as j_build_model
from repro.models.params import count_params as j_count_params
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.models import attention, families, ssm
from repro_torch.models.api import build_model, model_defs
from repro_torch.models.common import ArchConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import count_params
from repro_torch.models.parallel import ParallelCfg

TOL = 2e-2
STRICT = {"xla_allow_excess_precision": False}
JPAR = JParallelCfg(mesh=None, remat="none")
PAR = ParallelCfg()
ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b"]
S = 70                       # > hymba-reduced's window of 64: the ring wraps


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """arch -> (reference cfg, its model, its params, the port's Model)."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg = J_ARCHS[arch].reduced()
            jm = j_build_model(jcfg)
            jp = j_init_params(jax.random.key(0), jm.defs)
            model = params_from_numpy(jax.tree.map(np.asarray, jp),
                                      configs.get(arch).reduced(), "cpu")
            out[arch] = (jcfg, jm, jp, model)
        return out[arch]
    return get


def _t(x):
    """A JAX array as a torch tensor of the same dtype."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(x))


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(got, want):
    assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    atol=TOL, rtol=TOL)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _hidden(cfg, seed, B=2, L=S):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((B, L, cfg.d_model)), jnp.bfloat16)
    return x, _t(x)


# ---------------------------------------------------------------------------
# Configs and parameter trees.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for full in (True, False):
        cfg = configs.get(arch) if full else configs.get(arch).reduced()
        ref = J_ARCHS[arch] if full else J_ARCHS[arch].reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count() == ref.param_count()
        assert count_params(model_defs(cfg)) == j_count_params(
            j_build_model(ref).defs)


def test_hymba_full_width_size():
    """The chip's serve phase runs hymba-1.5b at 1.642 B parameters."""
    assert configs.get("hymba-1.5b").param_count() == 1_642_297_344


def test_state_dict_paths_are_the_reference_tree(pair):
    jcfg, jm, jp, model = pair("hymba-1.5b")
    flat = {"/".join(str(k.key) for k in path): v.shape for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = {k.replace(".", "/"): tuple(v.shape)
          for k, v in model.state_dict().items()}
    assert sd == {k: tuple(s) for k, s in flat.items()}
    assert "blocks.attn.wq" in model.state_dict()
    assert model.blocks.attn.wq.shape[0] == jcfg.n_layers


def test_params_from_numpy_rejects_a_wrong_tree(pair):
    jcfg, jm, jp, model = pair("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray, jp)
    cfg = configs.get("qwen1.5-0.5b").reduced()
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                          cfg, "cpu")


def test_build_model_is_seeded():
    cfg = configs.get("mamba2-370m").reduced()
    a, b = build_model(cfg, "cpu", seed=3), build_model(cfg, "cpu", seed=3)
    c = build_model(cfg, "cpu", seed=4)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.embed.table, c.embed.table)


def test_every_family_builds():
    """A config of each family and frontend builds and prefills (the
    refusal of the moe and encdec families and the stub frontends is
    gone)."""
    base = dict(name="m", n_layers=1, d_model=8, n_heads=2, n_kv_heads=2,
                head_dim=4, d_ff=8, vocab_size=16, vocab_pad_multiple=16)
    cfgs = [ArchConfig(family="moe", n_experts=2, experts_per_token=1,
                       **base),
            ArchConfig(family="encdec", n_encoder_layers=1, pos="sinusoidal",
                       frontend="audio_stub", **base),
            ArchConfig(family="dense", frontend="vision_stub",
                       n_frontend_tokens=2, **base)]
    for cfg in cfgs:
        model = build_model(cfg, "cpu")
        batch = {"tokens": torch.zeros((1, 3), dtype=torch.int64)}
        if cfg.n_encoder_layers:
            batch["frame_embeds"] = torch.zeros((1, 5, 8))
        if cfg.frontend == "vision_stub":
            batch["patch_embeds"] = torch.zeros((1, 2, 8))
        logits, caches = model.prefill(batch)
        assert logits.shape == (1, 16) and bool(torch.isfinite(logits).all())
        prefix = 2 if cfg.frontend == "vision_stub" else 0
        assert caches["k_cache"].shape[2] == 3 + prefix


# ---------------------------------------------------------------------------
# Sublayers and one block, same weights and inputs.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b"])
def test_attention_sublayer(arch, pair):
    jcfg, _, jp, model = pair(arch)
    cfg = model.cfg
    p = _layer(jp["blocks"]["attn"])
    x, tx = _hidden(cfg, 1)
    y, c = j_attention.attn_apply(p, x, jcfg, JPAR, mode="prefill")
    ty, tc = attention.attn_apply(_tree(p), tx, cfg, PAR, mode="prefill")
    _close(ty, y)
    for k in ("k", "v"):
        assert tc[k].shape == c[k].shape and tc[k].dtype == torch.bfloat16
        _close(tc[k], c[k])
    # Decode against that cache (padded to a free slot when not windowed),
    # the two lanes at different depths.
    if not cfg.attn_window:
        c = {k: jnp.pad(v, [(0, 0), (0, 8), (0, 0), (0, 0)])
             for k, v in c.items()}
    x1, tx1 = _hidden(cfg, 2, L=1)
    pos = np.array([S, S - 9], np.int32)
    y, c2 = j_attention.attn_apply(p, x1, jcfg, JPAR, mode="decode",
                                   pos=jnp.asarray(pos), cache=c)
    ty, tc2 = attention.attn_apply(_tree(p), tx1, cfg, PAR, mode="decode",
                                   pos=torch.from_numpy(pos), cache=_tree(c))
    _close(ty, y)
    for k in ("k", "v"):
        _close(tc2[k], c2[k])


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_mixer(arch, pair):
    jcfg, _, jp, model = pair(arch)
    cfg = model.cfg
    p = _layer(jp["blocks"]["ssm"])
    x, tx = _hidden(cfg, 3)
    y, st = j_ssm.ssm_apply(p, x, jcfg, JPAR, mode="prefill")
    ty, tst = ssm.ssm_apply(_tree(p), tx, cfg, PAR, mode="prefill")
    _close(ty, y)
    _close(tst["h"], st["h"])
    _close(tst["conv"], st["conv"])
    x1, tx1 = _hidden(cfg, 4, L=1)
    y, st2 = j_ssm.ssm_apply(p, x1, jcfg, JPAR, mode="decode", state=st)
    ty, tst2 = ssm.ssm_apply(_tree(p), tx1, cfg, PAR, mode="decode",
                             state=_tree(st))
    _close(ty, y)
    _close(tst2["h"], st2["h"])
    _close(tst2["conv"], st2["conv"])


@pytest.mark.parametrize("arch", ARCHS)
def test_block(arch, pair):
    jcfg, _, jp, model = pair(arch)
    p = _layer(jp["blocks"], 1)
    x, tx = _hidden(model.cfg, 5)
    y, c, _ = j_families.block_apply(p, x, jcfg, JPAR, mode="prefill")
    ty, tc, _ = families.block_apply(_tree(p), tx, model.cfg, PAR,
                                     mode="prefill")
    _close(ty, y)
    assert set(tc) == set(c)
    for k in c:
        _close(tc[k], c[k])


# ---------------------------------------------------------------------------
# prefill_fn / decode_fn.
# ---------------------------------------------------------------------------

def _tokens(cfg, seed, B, L):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_fn(arch, pair):
    """Prefill logits and caches, then two decode steps fed the same
    caches and tokens (two lanes at different depths)."""
    jcfg, jm, jp, model = pair(arch)
    cfg = model.cfg
    toks = _tokens(cfg, 6, 2, S + 2)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, jcfg, JPAR),
                     compiler_options=STRICT)(
        jp, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = model.prefill({"tokens": torch.from_numpy(toks[:, :S])})
    assert tl.shape == (2, cfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k])
    if "k_cache" in jc and not cfg.attn_window:
        jc = {k: jnp.pad(v, [(0, 0), (0, 0), (0, 8), (0, 0), (0, 0)])
              if k in ("k_cache", "v_cache") else v for k, v in jc.items()}
    decode = jax.jit(lambda p, b: jm.decode(p, b, jcfg, JPAR),
                     compiler_options=STRICT)
    for t in range(2):
        pos = np.array([S + t, S - 5 + t], np.int32)
        tok = toks[:, S + t:S + t + 1]
        jl, jc2 = decode(jp, {"token": jnp.asarray(tok),
                              "pos": jnp.asarray(pos), **jc})
        tl, tc2 = model.decode({"token": torch.from_numpy(tok),
                                "pos": torch.from_numpy(pos), **_tree(jc)})
        _close(tl, jl)
        for k in jc2:
            _close(tc2[k], jc2[k])
        jc = jc2


def test_decode_fn_leaves_its_inputs():
    cfg = configs.get("hymba-1.5b").reduced()
    model = build_model(cfg, "cpu")
    _, caches = model.prefill({"tokens": torch.zeros((1, 66),
                                                     dtype=torch.int64)})
    before = {k: v.clone() for k, v in caches.items()}
    model.decode({"token": torch.zeros((1, 1), dtype=torch.int64),
                  "pos": torch.tensor(66), **caches})
    for k, v in caches.items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# The reference's prefill-to-decode consistency checks, ported.
# ---------------------------------------------------------------------------

def test_prefill_then_decode_consistent(pair):
    """Greedy next token from prefill == decode step fed the same prefix
    (tests/test_models.py:77)."""
    _, _, _, model = pair("qwen1.5-0.5b")
    cfg = model.cfg
    n = 32
    toks = torch.from_numpy(_tokens(cfg, 0, 1, n))
    logits_p, caches = model.prefill({"tokens": toks})
    nxt = torch.argmax(logits_p, -1)
    # one free slot for the new token (the serve engine pads to max_len)
    batch = {"token": nxt[:, None], "pos": torch.tensor(n),
             "k_cache": torch.nn.functional.pad(caches["k_cache"],
                                                (0, 0, 0, 0, 0, 4)),
             "v_cache": torch.nn.functional.pad(caches["v_cache"],
                                                (0, 0, 0, 0, 0, 4))}
    logits_d, _ = model.decode(batch)
    logits_f, _ = model.prefill({"tokens": torch.cat([toks, nxt[:, None]],
                                                     1)})
    assert_allclose(logits_d.numpy(), logits_f.numpy(), atol=TOL, rtol=TOL)


def test_ssm_prefill_state_matches_decode_continuation(pair):
    """Prefill's emitted state continues like step-by-step
    (tests/test_models.py:179)."""
    _, _, _, model = pair("mamba2-370m")
    n = 32
    toks = torch.from_numpy(_tokens(model.cfg, 1, 1, n + 1))
    logits_full, _ = model.prefill({"tokens": toks})
    _, caches = model.prefill({"tokens": toks[:, :n]})
    logits_d, _ = model.decode({"token": toks[:, n:], "pos": torch.tensor(n),
                                "ssm_state": caches["ssm_state"],
                                "conv_state": caches["conv_state"]})
    assert_allclose(logits_d.numpy(), logits_full.numpy(), atol=TOL,
                    rtol=TOL)
