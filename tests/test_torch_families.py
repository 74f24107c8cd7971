"""Port vs reference: the moe, encdec and vlm families at inference, on
the CPU.

The reduced ``whisper-base`` (encdec, audio stub), ``qwen3-moe-30b-a3b``
(moe, qk-norm), ``kimi-k2-1t-a32b`` (moe with a shared expert) and
``llava-next-34b`` (dense with the vision stub) run through the
reference's JAX functions and the port's torch functions on the same
weights (the reference's ``init_params`` tree, carried across by
``convert.params_from_numpy``) and the same numpy inputs: one block, then
``prefill_fn`` and two ``decode_fn`` steps (two lanes at different
depths), at atol = rtol = 2e-2 with the reference's prefill and decode
compiled under ``STRICT`` (XLA's excess precision off, ROADMAP Queue 3
item 5), as ``test_torch_models.py`` holds the other families.  Then the
prefill-to-decode consistency of each new family on the port alone, and
each architecture served reduced through the launcher.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.models import families as j_families
from repro.models.api import build_model as j_build_model
from repro.models.params import count_params as j_count_params
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import families
from repro_torch.models.api import Model, build_model, model_defs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import count_params
from repro_torch.models.parallel import ParallelCfg

TOL = 2e-2
# Prefill of n + 1 tokens against prefill of n then one decode step: both
# bf16, the decode reading a rounded cache where the prefill keeps its
# activations; they differ by bf16 noise (0.028-0.031 on the reduced
# llava), as in the reference.
DECODE_TOL = 5e-2
STRICT = {"xla_allow_excess_precision": False}
JPAR = JParallelCfg(mesh=None, remat="none")
PAR = ParallelCfg()
ARCHS = ["whisper-base", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
         "llava-next-34b"]
S = 24                       # prompt tokens
S_ENC = 40                   # whisper's encoder frames (!= S)


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
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(x))


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    atol=tol, rtol=tol)


def _embeds(cfg, seed, n):
    """Frame or patch embeddings [2, n, D] bf16, both packages."""
    a = 0.5 * np.random.default_rng(seed).standard_normal((2, n, cfg.d_model))
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _t(j)


def _prefill_batch(cfg, toks):
    """The prefill batch of ``toks`` [2, n] in both packages, with the
    stub frontend's embeddings; returns (jax batch, torch batch, prefix)."""
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    prefix = 0
    if cfg.n_encoder_layers:
        jb["frame_embeds"], tb["frame_embeds"] = _embeds(cfg, 11, S_ENC)
    if cfg.frontend == "vision_stub":
        prefix = cfg.n_frontend_tokens
        jb["patch_embeds"], tb["patch_embeds"] = _embeds(cfg, 12, prefix)
    return jb, tb, prefix


def _tokens(cfg, seed, B, L):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_trees_match_reference(arch, pair):
    """The parameter trees (encoder, cross attention, experts, shared
    expert) carried across unchanged."""
    jcfg, jm, jp, model = pair(arch)
    assert count_params(model_defs(model.cfg)) == j_count_params(jm.defs)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = {k.replace(".", "/"): v for k, v in model.state_dict().items()}
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(sd[k].numpy(), v), k
    full = configs.get(arch)
    assert count_params(model_defs(full)) == j_count_params(
        j_build_model(J_ARCHS[arch]).defs)


@pytest.mark.parametrize("arch", ARCHS)
def test_block(arch, pair):
    jcfg, _, jp, model = pair(arch)
    cfg = model.cfg
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, S, cfg.d_model)), jnp.bfloat16)
    enc = None
    if cfg.n_encoder_layers:
        enc, tenc = _embeds(cfg, 6, S_ENC)
    p = jax.tree.map(lambda a: a[1], jp["blocks"])
    y, c, aux = j_families.block_apply(p, x, jcfg, JPAR, mode="prefill",
                                       enc=enc)
    ty, tc, taux = families.block_apply(
        _tree(p), _t(x), cfg, PAR, mode="prefill",
        enc=None if enc is None else tenc)
    _close(ty, y)
    assert set(tc) == set(c)
    for k in c:
        assert tuple(tc[k].shape) == c[k].shape, k
        _close(tc[k], c[k])
    assert_allclose(float(taux), float(aux), rtol=1e-4)
    if cfg.family == "moe":
        assert float(taux) > 0.0
    if cfg.n_encoder_layers:             # one encoder block: no cache
        pe = jax.tree.map(lambda a: a[0], jp["encoder"])
        y, c, _ = j_families.block_apply(pe, x, jcfg, JPAR, mode="prefill",
                                         causal=False)
        ty, tc, _ = families.block_apply(_tree(pe), _t(x), cfg, PAR,
                                         mode="prefill", causal=False)
        assert c == {} and tc == {}
        _close(ty, y)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_fn(arch, pair):
    """Prefill logits and caches, then two decode steps fed the same
    caches and tokens (two lanes at different depths)."""
    jcfg, jm, jp, model = pair(arch)
    cfg = model.cfg
    toks = _tokens(cfg, 6, 2, S + 2)
    jb, tb, prefix = _prefill_batch(cfg, toks[:, :S])
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, jcfg, JPAR),
                     compiler_options=STRICT)(jp, jb)
    tl, tc = model.prefill(tb)
    assert tl.shape == (2, cfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    assert set(tc) == set(jc)
    if cfg.n_encoder_layers:
        assert jc["enc_out"].shape[2] == S_ENC
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k])
    jc = {k: jnp.pad(v, [(0, 0), (0, 0), (0, 8), (0, 0), (0, 0)])
          if k in ("k_cache", "v_cache") else v for k, v in jc.items()}
    decode = jax.jit(lambda p, b: jm.decode(p, b, jcfg, JPAR),
                     compiler_options=STRICT)
    n = prefix + S
    for t in range(2):
        pos = np.array([n + t, n - 5 + t], np.int32)
        tok = toks[:, S + t:S + t + 1]
        jl, jc2 = decode(jp, {"token": jnp.asarray(tok),
                              "pos": jnp.asarray(pos), **jc})
        tl, tc2 = model.decode({"token": torch.from_numpy(tok),
                                "pos": torch.from_numpy(pos), **_tree(jc)})
        _close(tl, jl)
        assert set(tc2) == set(jc2)
        for k in jc2:
            _close(tc2[k], jc2[k])
        jc = jc2


def test_sinusoidal_decode_scalar_and_per_lane_pos(pair):
    """whisper's decode adds the sinusoid of each lane's position: a
    scalar ``pos`` equals the per-lane vector of that value."""
    _, _, _, model = pair("whisper-base")
    cfg = model.cfg
    toks = _tokens(cfg, 8, 2, S + 1)
    _, tb, _ = _prefill_batch(cfg, toks[:, :S])
    _, c = model.prefill(tb)
    c = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
         if k in ("k_cache", "v_cache") else v for k, v in c.items()}
    tok = torch.from_numpy(toks[:, S:])
    a, _ = model.decode({"token": tok, "pos": torch.tensor(S), **c})
    b, _ = model.decode({"token": tok, "pos": torch.tensor([S, S]), **c})
    assert torch.equal(a, b)
    d, _ = model.decode({"token": tok, "pos": torch.tensor(S + 1), **c})
    assert not torch.equal(a, d)


# ---------------------------------------------------------------------------
# Prefill-to-decode consistency (tests/test_models.py:77), each family.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["whisper-base", "qwen3-moe-30b-a3b",
                                  "llava-next-34b"])
def test_prefill_then_decode_consistent(arch, pair):
    """The logits of one decode step after a prefill of n tokens equal a
    prefill of the n + 1 tokens.  The MoE runs at capacity factor 8: a
    prefill of n + 1 tokens may drop slots that a one-token decode keeps,
    which is the dropping MoE's semantics, not an inconsistency."""
    _, _, _, model = pair(arch)
    cfg = model.cfg
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
        model = Model(cfg, model.tree())
    toks = torch.from_numpy(_tokens(cfg, 0, 2, 32))
    _, tb, prefix = _prefill_batch(cfg, toks.numpy())
    logits_p, caches = model.prefill(tb)
    nxt = torch.argmax(logits_p, -1)
    caches = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
              if k in ("k_cache", "v_cache") else v
              for k, v in caches.items()}
    logits_d, _ = model.decode({"token": nxt[:, None],
                                "pos": torch.tensor(prefix + 32), **caches})
    tb["tokens"] = torch.cat([toks, nxt[:, None]], 1)
    logits_f, _ = model.prefill(tb)
    assert_allclose(logits_d.numpy(), logits_f.numpy(), atol=DECODE_TOL,
                    rtol=DECODE_TOL)


# ---------------------------------------------------------------------------
# Every architecture builds and serves (the refusal of the unported
# families is gone).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_new_family_archs_serve(name):
    done = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "8",
                       "--max-new", "3", "--slots", "2"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(r.done and not r.truncated and len(r.out_tokens) == 4
               for r in done)


def test_all_ten_archs_build_reduced():
    for name in configs.ALL_ARCHS:
        cfg = configs.get(name).reduced()
        model = build_model(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == \
            count_params(model_defs(cfg)), name
