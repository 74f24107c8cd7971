"""The port's serving engine: the reference's contracts, and parity.

* The semantics contracts of ``tests/test_serve.py``, ported: ``max_new``
  counts decode tokens, truncation at the ``max_len`` horizon is surfaced,
  ``run`` drains and is re-entrant, and the ``LanePool`` contracts.
* Parity with the reference's engine on the same weights, for the reduced
  dense, ssm and hybrid configs: per-step logits under teacher forcing
  (each request replayed through both packages' prefill/decode, fed the
  reference engine's tokens, its replay compiled with XLA's excess
  precision off as in test_torch_models.py) at atol = rtol = 2e-2, and
  the greedy token streams equal up to the first step where the
  reference's top-2 logit margin is below 4x that tolerance.  For the windowed config every prompt is at least one window
  long.
* The reference engine's ring fault (ROADMAP Queue 3): a short first
  prompt sizes its KV ring; the port's ring keeps the window.
"""
import collections

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.models.api import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.launch import serve as launch_serve
from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import Tracer
from repro_torch.serve import LanePool, Request, ServeConfig, ServeEngine

TOL = 2e-2
# Each bf16 op of the reference's replay rounds as its code says, as the
# port's do (test_torch_models.py).
STRICT = {"xla_allow_excess_precision": False}
JPAR = JParallelCfg(mesh=None, remat="none")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    return build_model(configs.get("qwen1.5-0.5b").reduced(), "cpu")


def _reqs(cfg, n, prompt_len=8, max_new=5, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    lens = [prompt_len] * n if np.isscalar(prompt_len) else prompt_len
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, L)
                .astype(np.int32), max_new=max_new)
            for i, L in enumerate(lens)]


def _engine(model, **sc):
    sc.setdefault("batch_slots", 2)
    sc.setdefault("max_len", 64)
    return ServeEngine(model, ServeConfig(**sc), device="cpu")


# ---------------------------------------------------------------------------
# max_new / truncation semantics (tests/test_serve.py, ported).
# ---------------------------------------------------------------------------

def test_max_new_counts_decode_tokens(lm):
    eng = _engine(lm)
    done = eng.run(_reqs(lm.cfg, 3, max_new=5))
    assert len(done) == 3
    for r in done:
        assert r.done and not r.truncated
        assert len(r.out_tokens) == 1 + r.max_new
    s = eng.summary()
    assert s["requests_admitted"] == s["requests_completed"] == 3
    assert s["decode_tokens"] == 15 and s["requests_truncated"] == 0


def test_max_len_horizon_surfaces_truncation(lm):
    eng = _engine(lm, max_len=12)
    (r,) = eng.run(_reqs(lm.cfg, 1, prompt_len=8, max_new=50))
    assert r.done and r.truncated
    assert len(r.out_tokens) < 1 + r.max_new


def test_truncated_flag_false_on_exact_finish(lm):
    # pos after prefill = 8; decode ticks at pos 8,9,10 -> horizon at
    # max_len-1 = 11 coincides with n_decode == max_new == 3
    eng = _engine(lm, max_len=12)
    (r,) = eng.run(_reqs(lm.cfg, 1, prompt_len=8, max_new=3))
    assert r.done and not r.truncated
    assert len(r.out_tokens) == 1 + r.max_new


def test_run_reentry_serves_fresh_requests(lm):
    eng = _engine(lm)
    a = eng.run(_reqs(lm.cfg, 3, max_new=4, seed=1))
    b = eng.run(_reqs(lm.cfg, 2, max_new=4, seed=2))
    assert sorted(r.rid for r in a) == [0, 1, 2]
    assert sorted(r.rid for r in b) == [0, 1]
    fresh = _engine(lm).run(_reqs(lm.cfg, 2, max_new=4, seed=2))
    for got, want in zip(sorted(b, key=lambda r: r.rid),
                         sorted(fresh, key=lambda r: r.rid)):
        assert got.out_tokens == want.out_tokens


def test_run_drains_unfinished_and_stays_reentrant(lm):
    eng = _engine(lm)
    out = eng.run(_reqs(lm.cfg, 2, max_new=30), max_ticks=3)
    assert len(out) == 2 and all(not r.done for r in out)
    again = eng.run(_reqs(lm.cfg, 2, max_new=4))
    assert all(r.done and len(r.out_tokens) == 5 for r in again)


def test_temperature_sampling_is_seeded(lm):
    def run(seed):
        eng = _engine(lm, temperature=1.0, seed=seed)
        return [r.out_tokens for r in eng.run(_reqs(lm.cfg, 2, max_new=6))]
    assert run(7) == run(7)
    assert run(7) != run(8)


def test_tracer_records_without_changing_tokens(lm):
    plain = _engine(lm).run(_reqs(lm.cfg, 2, max_new=3))
    tracer = Tracer()
    eng = ServeEngine(lm, ServeConfig(batch_slots=2, max_len=64),
                      tracer=tracer, device="cpu")
    traced = eng.run(_reqs(lm.cfg, 2, max_new=3))
    assert [r.out_tokens for r in traced] == [r.out_tokens for r in plain]
    names = collections.Counter(e["name"] for e in tracer.events)
    assert names["admit"] == 2 and names["evict"] == 2
    assert names["lanes_active"] == 3


def test_engine_refuses_a_model_on_another_device(lm):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(lm, ServeConfig())


# ---------------------------------------------------------------------------
# LanePool (tests/test_serve.py, ported).
# ---------------------------------------------------------------------------

def test_lane_pool_contracts():
    pool = LanePool(2)
    assert pool.free_lanes() == [0, 1] and not pool.any_active()
    queue = ["a", "b", "c"]
    placed = pool.admit(queue)
    assert placed == [(0, "a"), (1, "b")] and queue == ["c"]
    with pytest.raises(ValueError, match="occupied"):
        pool.insert(0, "x")
    assert pool.payload(1) == "b"
    assert pool.evict(0) == "a"
    with pytest.raises(ValueError, match="already free"):
        pool.evict(0)
    assert pool.admit(queue, ready=lambda _: False) == []
    assert queue == ["c"]
    assert pool.drain() == ["b"]
    assert not pool.any_active() and pool.free_lanes() == [0, 1]
    with pytest.raises(ValueError):
        LanePool(0)


def test_lane_pool_admit_accepts_deque():
    pool = LanePool(2)
    queue = collections.deque(["a", "b", "c"])
    assert pool.admit(queue) == [(0, "a"), (1, "b")]
    assert list(queue) == ["c"]
    assert pool.evict(0) == "a"
    assert pool.admit(queue, ready=lambda _: False) == []
    assert list(queue) == ["c"]
    assert pool.admit(queue, ready=lambda _: True) == [(0, "c")]
    assert not queue


def test_lane_pool_admission_policy_hook():
    pool = LanePool(2)
    queue = collections.deque([("x", 9), ("y", 1), ("z", 0)])
    placed = pool.admit(queue, ready=lambda p: p[0] in ("x", "y"),
                        select=lambda ready: min(
                            range(len(ready)), key=lambda i: ready[i][1]))
    assert placed == [(0, ("y", 1)), (1, ("x", 9))]
    assert list(queue) == [("z", 0)]
    pool.drain()
    bad = LanePool(1)
    with pytest.raises(ValueError, match="outside the ready prefix"):
        bad.admit(collections.deque([1, 2]), ready=lambda p: p == 1,
                  select=lambda ready: 1)


# ---------------------------------------------------------------------------
# Parity with the reference engine on the same weights.
# ---------------------------------------------------------------------------

def _pair(arch):
    jcfg = J_ARCHS[arch].reduced()
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    model = params_from_numpy(jax.tree.map(np.asarray, jp),
                              configs.get(arch).reduced(), "cpu")
    return jcfg, jm, jp, model


def _fit_ring(caches, ring, pad):
    """One request's prefill caches with the KV time axis cut or padded to
    the engine's ring, as the engines insert them."""
    out = {}
    for k, v in caches.items():
        if k in ("k_cache", "v_cache"):
            v = v[:, :, :ring] if v.shape[2] >= ring else pad(v, ring)
        out[k] = v
    return out


def _replay_ref(jcfg, jm, jp, prompt, tokens, ring):
    """Reference logits at every step of one request, fed ``tokens``."""
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, jcfg, JPAR),
                      compiler_options=STRICT)
    decode = jax.jit(lambda p, b: jm.decode(p, b, jcfg, JPAR),
                     compiler_options=STRICT)
    logits, c = prefill(jp, {"tokens": jnp.asarray(prompt[None])})
    c = _fit_ring(c, ring, lambda v, W: jnp.pad(
        v, [(0, 0), (0, 0), (0, W - v.shape[2]), (0, 0), (0, 0)]))
    out = [np.asarray(logits[0])]
    for i, tok in enumerate(tokens[:-1]):
        logits, c = decode(jp, {"token": jnp.asarray([[tok]], jnp.int32),
                                "pos": jnp.int32(len(prompt) + i), **c})
        out.append(np.asarray(logits[0]))
    return out


def _replay_port(model, prompt, tokens, ring):
    logits, c = model.prefill({"tokens": torch.from_numpy(prompt[None])})
    c = _fit_ring(c, ring, lambda v, W: torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, W - v.shape[2])))
    out = [logits[0].numpy()]
    for i, tok in enumerate(tokens[:-1]):
        logits, c = model.decode({"token": torch.tensor([[tok]]),
                                  "pos": torch.tensor(len(prompt) + i), **c})
        out.append(logits[0].numpy())
    return out


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m",
                                  "hymba-1.5b"])
def test_engine_matches_reference(arch, record_property):
    jcfg, jm, jp, model = _pair(arch)
    cfg = model.cfg
    lens = [66, 72, 64] if cfg.attn_window else [8, 12, 10]
    max_new, max_len = 6, max(lens) + 16
    ring = min(cfg.attn_window, max_len) if cfg.attn_window else max_len
    ref = JServeEngine(jm, jp, jcfg, JPAR, JServeConfig(
        batch_slots=2, max_len=max_len)).run(
            _reqs(cfg, 3, lens, max_new, seed=9, cls=JRequest))
    got = _engine(model, max_len=max_len).run(
        _reqs(cfg, 3, lens, max_new, seed=9))
    ref = {r.rid: r for r in ref}
    compared = 0
    for r in got:
        want = ref[r.rid]
        assert r.done and not r.truncated and want.done
        assert len(r.out_tokens) == len(want.out_tokens) == 1 + max_new
        # Teacher forcing: both packages fed the reference's tokens.
        jl = _replay_ref(jcfg, jm, jp, want.prompt, want.out_tokens, ring)
        tl = _replay_port(model, r.prompt, want.out_tokens, ring)
        for step, (a, b) in enumerate(zip(tl, jl)):
            assert_allclose(a, b, atol=TOL, rtol=TOL,
                            err_msg=f"rid {r.rid} step {step}")
        # Greedy streams equal while the reference's choice is clear.
        for step, b in enumerate(jl):
            top2 = np.sort(b[:cfg.vocab_size])[-2:]
            if top2[1] - top2[0] < 4 * TOL:
                break
            assert r.out_tokens[step] == want.out_tokens[step], \
                f"rid {r.rid} step {step}"
            compared += 1
    record_property("tokens_compared", compared)
    print(f"{arch}: {compared} of {3 * (1 + max_new)} greedy tokens "
          "compared")
    assert compared > 0


def test_short_first_prompt_keeps_the_window():
    """Reduced hymba (window 64), 2 lanes, max_len 128: a first prompt of
    8 tokens, then one of 100.  The port's ring has 64 slots and the
    second request's first decode equals a full prefill over its tokens;
    the reference engine's ring has 8 slots and its decode does not."""
    jcfg, jm, jp, model = _pair("hymba-1.5b")
    cfg = model.cfg
    reqs = _reqs(cfg, 2, [8, 100], 4, seed=3)
    jreqs = _reqs(cfg, 2, [8, 100], 4, seed=3, cls=JRequest)
    sc = dict(batch_slots=2, max_len=128)

    eng = _engine(model, **sc)
    eng._admit(list(reqs))
    assert eng.caches["k_cache"].shape[2] == cfg.attn_window
    last = torch.tensor([[r.out_tokens[-1]] for r in reqs])
    logits, _ = model.decode({"token": last,
                              "pos": torch.as_tensor(eng.lane_pos),
                              **eng.caches})
    full, _ = model.prefill({"tokens": torch.from_numpy(np.append(
        reqs[1].prompt, reqs[1].out_tokens[0])[None])})
    assert_allclose(logits[1].numpy(), full[0].numpy(), atol=TOL, rtol=TOL)

    jeng = JServeEngine(jm, jp, jcfg, JPAR, JServeConfig(**sc))
    jeng._admit(list(jreqs))
    assert jeng.caches["k_cache"].shape[2] == 8        # the fault
    jlast = jnp.asarray([[r.out_tokens[-1]] for r in jreqs], jnp.int32)
    jlogits, _ = jeng._decode(jp, {"token": jlast,
                                   "pos": jnp.asarray(jeng.lane_pos),
                                   **jeng.caches})
    jfull, _ = jm.prefill(jp, {"tokens": jnp.asarray(np.append(
        jreqs[1].prompt, jreqs[1].out_tokens[0])[None])}, jcfg, JPAR)
    assert not np.allclose(np.asarray(jlogits[1]), np.asarray(jfull[0]),
                           atol=TOL, rtol=TOL)


def test_launcher_runs_reduced_on_the_cpu():
    done = launch_serve.main(["--arch", "mamba2-370m", "--reduced",
                              "--device", "cpu", "--requests", "3",
                              "--max-new", "2", "--prompt-len", "6"])
    assert len(done) == 3
    assert all(r.done and len(r.out_tokens) == 3 for r in done)


def test_launcher_defaults_to_full_width_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "hymba-1.5b"])
