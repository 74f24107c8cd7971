"""The last one-card mesh levers on gloo fleets of the CPU, against the
port's own baselines and the reference.

Two fleets, each one payload run once per module
(``tests.harness.run_distributed``; every rank's last stdout line must be
the same JSON):

* **1 x 2** (``model=2``, 2 ranks): reduced hymba (its 4 q heads, 2 kv
  heads, SSM, MLP and vocabulary split; and with 5 q heads over 1 kv
  head, replicated as hymba-1.5b's 25 are) and reduced qwen3-moe (experts,
  heads and vocabulary split, at the no-drop capacity) on the reference's
  weights: the loss and gradients under remat ``none``, ``full`` and
  ``tp_out`` and under ``seq_shard``, the model axis's traffic of each,
  and one train step under ``seq_shard`` for the dry run to count;
* **1 x 4** (``model=4``, 4 ranks): reduced llava and reduced hymba, whose
  2 kv heads do not split four ways while their 4 q heads do: a prefill
  and 8 decode ticks with and without ``kv_seq_shard`` (hymba's window of
  64 is 16 slots a rank, and the ticks wrap its ring).

The payloads import only ``repro_torch``; this process computes the
reference's numbers and the port's single-process ones.  A placement
test holds ``batch_pspecs(kv_seq_shard=True)`` and the rules under
``seq_shard`` to the reference's for the ten configs.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.configs import ARCHS as J_ARCHS
from repro.launch.sharding import auto_rules as j_auto_rules
from repro.launch.sharding import batch_pspecs as j_batch_pspecs
from repro.launch.sharding import make_parallel as j_make_parallel
from repro.models.api import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import (auto_rules, batch_pspecs,
                                         batch_shard, make_parallel)
from repro_torch.models.common import SHAPES, ShapeCfg, supports_shape
from repro_torch.models.parallel import ParallelCfg
from tests.harness import run_distributed
from tests.test_torch_launch import _canon
from tests.test_torch_mesh_fleet import (COMMON, GRAD_TOL, JPAR, LOGIT_TOL,
                                         NO_DROP, PRELUDE, _np, _port_single)
from tests.train_reference import STRICT, _flat, _rel

# Under seq_shard a norm's scale takes the sum over the two ranks of its
# gradient over each rank's half of the sequence, where one rank sums the
# whole sequence at once: the same terms in another order (measured
# 6.0e-8 to 7.1e-8, relative Frobenius).
NORM_SUM_TOL = 1e-6
NORMS = ("blocks.norm1.scale", "blocks.norm2.scale", "final_norm.scale")
RUNS = (("none", False), ("full", False), ("tp_out", False),
        ("full", True), ("tp_out", True))
# hymba5: 5 q heads over 1 kv head, replicated over model=2 as hymba-1.5b's
# 25 are: the attention runs whole on each rank.
LEVER_ARCHS = {"hymba": ("hymba-1.5b", {}),
               "hymba5": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 1}),
               "moe": ("qwen3-moe-30b-a3b", {"capacity_factor": NO_DROP})}
# (arch, prompt, patch embeddings): llava's 16 zero patches and 40 tokens
# fill 56 slots, 64 with the ticks; hymba's 71 tokens fill its ring of 64.
KV_ARCHS = {"llava": ("llava-next-34b", 40, 16), "hymba": ("hymba-1.5b", 71, 0)}
TICKS = 8

PAYLOAD_LEVERS = PRELUDE + COMMON + r"""
import dataclasses
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainConfig
from repro_torch.train.loop import make_train_step

NO_DROP = @NO_DROP@
ARCHS = {"hymba": ("hymba-1.5b", {}),
         "hymba5": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 1}),
         "moe": ("qwen3-moe-30b-a3b", {"capacity_factor": NO_DROP})}
RUNS = (("none", False), ("full", False), ("tp_out", False),
        ("full", True), ("tp_out", True))
mesh = ProcessMesh.build(MeshShape.parse("data=1,model=2"), "cpu")
out, save = {}, {}
for name, (arch, kw) in ARCHS.items():
    cfg = dataclasses.replace(configs.get(arch).reduced(), **kw)
    defs = model_defs(cfg)
    batch = {k: torch.from_numpy(DATA[name + "." + k])
             for k in ("tokens", "labels")}
    out[name] = {}
    for remat, seq in RUNS:
        par = make_parallel(cfg, mesh, remat=remat, seq_shard=seq,
                            seq=batch["tokens"].shape[1])
        rules = par.effective_rules()
        model = Model(cfg, shard_params(nest(name + ".p."), defs, rules,
                                        mesh), par)
        parallel.reset_traffic()
        loss, grads = model.loss(batch)
        key = f"{remat}.{int(seq)}"
        out[name][key] = {"loss": float(loss), "act_seq": rules.mesh_axes(
            "act_seq"), "traffic": {a: {op: v[:2] for op, v in ops.items()}
                                    for a, ops in parallel.TRAFFIC.items()}}
        save.update(arrays(f"{name}.{key}.g.", gather_params(grads, defs,
                                                             par)))
    # One train step under seq_shard, for the dry run to count.
    par = make_parallel(cfg, mesh, remat="none", seq_shard=True)
    model = Model(cfg, shard_params(nest(name + ".p."), defs,
                                    par.effective_rules(), mesh), par)
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=10))
    opt = adamw_init(dict(model.named_parameters()), tc.opt)
    parallel.reset_traffic()
    make_train_step(model, tc)(opt, None, batch)
    out[name]["step_traffic"] = {a: {op: v[1] for op, v in ops.items()}
                                 for a, ops in parallel.TRAFFIC.items()}
    try:
        make_parallel(cfg, mesh, seq_shard=True, seq=63)
        out[name]["odd_seq"] = "accepted"
    except ValueError as e:
        out[name]["odd_seq"] = str(e)
if mesh.rank == 0:
    np.savez(DIR + "/out.npz", **save)
torch.distributed.barrier()            # the ranks leave together
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""

PAYLOAD_KV = PRELUDE + COMMON + r"""
import dataclasses
import torch.nn.functional as F
ARCHS = {"llava": ("llava-next-34b", 40, 16), "hymba": ("hymba-1.5b", 71, 0)}
TICKS = @TICKS@
mesh = ProcessMesh.build(MeshShape.parse("data=1,model=4"), "cpu")
out, save = {}, {}
for name, (arch, S, P) in ARCHS.items():
    cfg = configs.get(arch).reduced()
    defs = model_defs(cfg)
    toks = torch.from_numpy(DATA[name + ".prompt"])
    first = {"tokens": toks[:, :S]}
    if P:
        first["patch_embeds"] = torch.zeros((2, P, cfg.d_model),
                                            dtype=torch.bfloat16)
    out[name] = {}
    for lever in (False, True):
        par = make_parallel(cfg, mesh, kv_seq_shard=lever)
        model = Model(cfg, shard_params(nest(name + ".p."), defs,
                                        par.effective_rules(), mesh), par)
        logits, caches = model.prefill(first)
        steps = [logits]
        if caches["k_cache"].shape[2] == P + S:   # room for the ticks
            for k in ("k_cache", "v_cache"):
                caches[k] = F.pad(caches[k], (0, 0, 0, 0, 0, TICKS))
        if lever:       # the prefill's caches hold every kv head, whole
            caches.update(batch_shard({k: caches[k] for k in
                                       ("k_cache", "v_cache")}, cfg, par))
        parallel.reset_traffic()
        for t in range(TICKS):
            logits, caches = model.decode({"token": toks[:, S + t:S + t + 1],
                                           "pos": torch.tensor(P + S + t),
                                           **caches})
            steps.append(logits)
        key = "lever" if lever else "plain"
        out[name][key] = {
            "kv_shape": list(caches["k_cache"].shape),
            "kv_bytes": sum(caches[k].numel() * caches[k].element_size()
                            for k in ("k_cache", "v_cache")),
            "window_sharded": par.kv_window_sharded,
            "traffic": {a: {op: v[:2] for op, v in ops.items()}
                        for a, ops in parallel.TRAFFIC.items()}}
        save[f"{name}.{key}.logits"] = torch.stack(steps).numpy()
        for k in ("k_cache", "v_cache"):    # put back together
            whole = (parallel.all_gather(caches[k], par, 2, "model") if lever
                     else parallel.all_gather(caches[k], par, 3, "model")[
                         :, :, :, ::2])     # ranks 2j, 2j+1 hold kv head j
            save[f"{name}.{key}.{k}"] = whole.float().numpy()
if mesh.rank == 0:
    np.savez(DIR + "/out.npz", **save)
torch.distributed.barrier()            # the ranks leave together
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(payload, tmp, inputs, processes):
    np.savez(tmp / "inputs.npz", **inputs)
    res = run_distributed(payload.replace("@DIR@", str(tmp))
                          .replace("@NO_DROP@", repr(NO_DROP))
                          .replace("@TICKS@", str(TICKS)),
                          processes=processes, devices=1, timeout=600)
    with np.load(tmp / "out.npz") as z:
        return res[0], {k: z[k] for k in z.files}


def _leaves(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# tp_out and seq_shard: the 1 x 2 fleet.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lever_fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("levers1x2")
    inputs, ref = {}, {}
    for name, (arch, kw) in LEVER_ARCHS.items():
        jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), **kw)
        cfg = dataclasses.replace(configs.get(arch).reduced(), **kw)
        jm = j_build_model(jcfg)
        jp = j_init_params(jax.random.key(0), jm.defs)
        rng = np.random.default_rng(26)
        tokens = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((2, 1), -1, np.int32)], 1)
        inputs.update({**_np(jp, name + ".p."), name + ".tokens": tokens,
                       name + ".labels": labels})
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, jcfg, JPAR))).lower(jp, jb).compile(
                compiler_options=STRICT)(jp, jb)
        loss, grads = _port_single(cfg, jp).loss(
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})
        ref[name] = {"cfg": cfg, "jloss": float(jloss),
                     "jgrads": _flat(jgrads), "loss": float(loss),
                     "grads": {k: g.numpy() for k, g in grads.items()}}
    res, arrays = _run(PAYLOAD_LEVERS, tmp, inputs, 2)
    return res, arrays, ref


@pytest.mark.parametrize("name", list(LEVER_ARCHS))
def test_tp_out_is_full_bit_for_bit(lever_fleet, name):
    """Remat ``tp_out`` on ``model=2``: the loss and every gradient leaf
    are ``full``'s (and ``none``'s) bit for bit; its backward replays no
    sublayer output's sum over ``model``, so its model-axis all-reduces
    are ``none``'s plus only those inside a sublayer that it recomputes,
    as the reference's ``save_only_these_names("tp_out")`` does (hymba's
    gated norm, one a layer both ways), and fewer than ``full``'s, whose
    recompute sums every sublayer output again but the last of each
    layer (torch's recompute stops once the saved tensors are back)."""
    res, a, ref = lever_fleet
    r = res[name]
    want = _leaves(a, f"{name}.full.0.g.")
    for key in ("none.0", "tp_out.0"):
        assert r[key]["loss"] == r["full.0"]["loss"], key
        got = _leaves(a, f"{name}.{key}.g.")
        bad = [k for k in want if not np.array_equal(got[k], want[k])]
        assert set(got) == set(want) and not bad, (key, bad)
    ar = {k: r[k]["traffic"]["model"]["all_reduce"][0]
          for k in ("none.0", "full.0", "tp_out.0")}
    cfg = ref[name]["cfg"]
    inside = cfg.n_layers if cfg.family == "hybrid" else 0
    assert ar["tp_out.0"] == ar["none.0"] + inside < ar["full.0"], ar
    # the sublayer outputs full's recompute sums again: a split attention
    # and the SSM mixer, but not the layer's last, its MLP or MoE
    again = (cfg.n_heads % 2 == 0) + (cfg.family == "hybrid")
    assert ar["full.0"] - ar["tp_out.0"] == again * cfg.n_layers, ar


@pytest.mark.parametrize("name", list(LEVER_ARCHS))
def test_seq_shard_matches_whole_sequence(lever_fleet, name):
    """``seq_shard`` on ``model=2`` (``act_seq`` over model): the loss is
    ``seq_shard=False``'s bit for bit, and so is every gradient leaf but
    the norms' scales, which sum the two ranks' halves of the sequence
    (within NORM_SUM_TOL); under ``tp_out`` too.  Each leaf lies no
    further from the reference's single-device ``jax.grad`` than the
    port's single process does, plus GRAD_TOL (the single process's own
    distance: ``tests/test_torch_train_grads.py``, and for the MoE
    ``test_moe_gradient_gap_is_routing_flips``)."""
    res, a, ref = lever_fleet
    r, want = res[name], ref[name]
    base = _leaves(a, f"{name}.full.0.g.")
    for key in ("full.1", "tp_out.1"):
        assert r[key]["act_seq"] == "model"
        assert r[key]["loss"] == r["full.0"]["loss"], key
        got = _leaves(a, f"{name}.{key}.g.")
        assert set(got) == set(base)
        bad = [k for k in base if k not in NORMS
               and not np.array_equal(got[k], base[k])]
        assert not bad, (key, bad)
        assert all(_rel(got[k], base[k]) <= NORM_SUM_TOL for k in NORMS)
    assert abs(r["full.1"]["loss"] - want["loss"]) <= 2e-3
    assert abs(r["full.1"]["loss"] - want["jloss"]) <= LOGIT_TOL
    got = _leaves(a, f"{name}.full.1.g.")
    bad = {k: (_rel(got[k], j), _rel(want["grads"][k], j))
           for k, j in want["jgrads"].items()
           if _rel(got[k], j) > _rel(want["grads"][k], j) + GRAD_TOL}
    assert not bad, bad
    # the sequence's blocks move by all-gather and reduce-scatter
    ops = r["full.1"]["traffic"]["model"]
    assert ops["all_gather"][0] > 0 and ops["reduce_scatter"][0] > 0
    assert r["tp_out.1"]["traffic"]["model"]["reduce_scatter"][0] < \
        ops["reduce_scatter"][0]
    assert "63" in r["odd_seq"] and "model=2" in r["odd_seq"]


@pytest.mark.parametrize("name", list(LEVER_ARCHS))
def test_seq_shard_traffic_equals_the_dry_runs(lever_fleet, name):
    """The bytes a train step under ``seq_shard`` moved over ``model``,
    op by op, equal the dry run's count of rank 0's step on a counted
    mesh with the ``seq_shard`` override."""
    res, _, ref = lever_fleet
    cfg = ref[name]["cfg"]
    mesh = MeshShape.parse("data=1,model=2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "get", lambda arch: cfg)
        rec = dryrun.run_cell(LEVER_ARCHS[name][0],
                              ShapeCfg("t", "train", 64, 2), mesh,
                              {"remat": "none", "zero_stage": 0,
                               "seq_shard": True})
    assert rec["status"] == "ok", rec.get("error")
    assert rec["policy"]["seq_shard"] == "True"
    assert res[name]["step_traffic"] == rec["coll_ops"]
    assert set(rec["coll_ops"]["model"]) == {"all_reduce", "all_gather",
                                             "reduce_scatter"}


# ---------------------------------------------------------------------------
# kv_seq_shard: the 1 x 4 fleet.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kv_fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kv1x4")
    inputs, ref = {}, {}
    for name, (arch, S, P) in KV_ARCHS.items():
        jcfg, cfg = J_ARCHS[arch].reduced(), configs.get(arch).reduced()
        jm = j_build_model(jcfg)
        jp = j_init_params(jax.random.key(0), jm.defs)
        prompt = np.random.default_rng(26).integers(
            0, cfg.vocab_size, (2, S + TICKS)).astype(np.int32)
        inputs.update({**_np(jp, name + ".p."), name + ".prompt": prompt})
        # The reference's and the port's single-process prefill and ticks.
        first = {"tokens": torch.from_numpy(prompt[:, :S])}
        if P:
            first["patch_embeds"] = torch.zeros((2, P, cfg.d_model),
                                                dtype=torch.bfloat16)
        jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, jcfg, JPAR),
                         compiler_options=STRICT)(
            jp, {k: jnp.asarray(v.float().numpy(), v.dtype == torch.bfloat16
                                and jnp.bfloat16 or jnp.int32)
                 for k, v in first.items()})
        model = _port_single(cfg, jp)
        tl, tc = model.prefill(first)
        if tc["k_cache"].shape[2] == P + S:
            pad = ((0, 0), (0, 0), (0, TICKS), (0, 0), (0, 0))
            jc = {**jc, **{k: jnp.pad(jc[k], pad)
                           for k in ("k_cache", "v_cache")}}
            tc = {**tc, **{k: torch.nn.functional.pad(
                tc[k], (0, 0, 0, 0, 0, TICKS))
                for k in ("k_cache", "v_cache")}}
        jdec = jax.jit(lambda p, b: jm.decode(p, b, jcfg, JPAR),
                       compiler_options=STRICT)
        js, ts = [np.asarray(jl)], [tl.numpy()]
        for t in range(TICKS):
            tok = prompt[:, S + t:S + t + 1]
            out, jc = jdec(jp, {"token": jnp.asarray(tok),
                                "pos": jnp.asarray(P + S + t, jnp.int32),
                                **jc})
            js.append(np.asarray(out))
            out, tc = model.decode({"token": torch.from_numpy(tok),
                                    "pos": torch.tensor(P + S + t), **tc})
            ts.append(out.numpy())
        ref[name] = {"cfg": cfg, "ref": np.stack(js), "single": np.stack(ts),
                     "caches": {k: tc[k].float().numpy()
                                for k in ("k_cache", "v_cache")}}
    res, arrays = _run(PAYLOAD_KV, tmp, inputs, 4)
    return res, arrays, ref


@pytest.mark.parametrize("name", list(KV_ARCHS))
def test_kv_seq_shard_decode(kv_fleet, name):
    """Under ``kv_seq_shard`` on ``model=4`` (the q heads split, the kv
    heads not) each rank holds a quarter of the window for both kv heads
    (hymba: 16 of its 64 ring slots): the prefill's logits and 8 decode
    ticks' are within LOGIT_TOL of the port's unsharded decode on the
    same fleet, of one process's and of the reference's (compiled with
    the excess-precision flag off); the caches put back together are the
    unsharded decode's bit for bit, and within LOGIT_TOL of one process's
    (layer 0's, which reads the embedding alone, bit for bit); the
    partial softmaxes meet in all-reduces over ``model`` and the q heads
    in all-gathers."""
    res, a, ref = kv_fleet
    r, want = res[name], ref[name]
    cfg = want["cfg"]
    W = want["caches"]["k_cache"].shape[2]
    plain, lever = r["plain"], r["lever"]
    assert lever["window_sharded"] and not plain["window_sharded"]
    assert lever["kv_shape"][2:4] == [W // 4, cfg.n_kv_heads]
    assert plain["kv_shape"][2:4] == [W, 1]       # the GQA slice
    assert W // 4 == 16
    got = a[f"{name}.lever.logits"]
    for other in (a[f"{name}.plain.logits"], want["single"], want["ref"]):
        assert_allclose(got, other, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for k in ("k_cache", "v_cache"):
        got = a[f"{name}.lever.{k}"]
        assert got.shape == want["caches"][k].shape
        assert np.array_equal(got, a[f"{name}.plain.{k}"]), k
        assert_allclose(got, want["caches"][k], atol=LOGIT_TOL,
                        rtol=LOGIT_TOL)
        assert np.array_equal(got[0], want["caches"][k][0]), k
    ops = lever["traffic"]["model"]
    per_tick = ops["all_reduce"][0] / TICKS
    assert per_tick >= 2 * cfg.n_layers          # the max, then the sums
    assert ops["all_gather"][0] >= TICKS * cfg.n_layers   # q heads


@pytest.mark.parametrize("name", list(KV_ARCHS))
def test_kv_seq_shard_traffic_equals_the_dry_runs(kv_fleet, name):
    """A decode tick under ``kv_seq_shard`` moves over ``model``, op by
    op, what the dry run counts for rank 0's decode cell of the same
    cache (64 slots, 2 lanes) and weights (float32: the embedding's sum
    moves the table's dtype) with the ``kv_seq_shard`` override, whose
    cache is the window's block."""
    res, _, ref = kv_fleet
    cfg = ref[name]["cfg"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "get", lambda arch: cfg)
        rec = dryrun.run_cell(KV_ARCHS[name][0],
                              ShapeCfg("t", "decode", 64, 2),
                              MeshShape.parse("data=1,model=4"),
                              {"kv_seq_shard": True,
                               "param_dtype": "float32"})
    assert rec["status"] == "ok", rec.get("error")
    tick = {op: b // TICKS for op, (_, b) in
            res[name]["lever"]["traffic"]["model"].items()}
    assert tick == rec["coll_ops"]["model"]


# ---------------------------------------------------------------------------
# Placement.
# ---------------------------------------------------------------------------

MESHES = {"2x4": MeshShape.parse("data=2,model=4"),
          "16x16": MeshShape.production()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_lever_placement_matches_reference(arch, mesh):
    """``batch_pspecs(kv_seq_shard=True)`` and the rules under
    ``seq_shard`` are the reference's; ``batch_shard`` of a decode cache
    cuts the window where the spec puts it over ``model``."""
    mesh = MESHES[mesh]
    cfg, jcfg = configs.get(arch), j_configs.get(arch)
    par = make_parallel(cfg, ProcessMesh.counted(mesh), seq_shard=True,
                        kv_seq_shard=True)
    jrules = j_make_parallel(jcfg, mesh, seq_shard=True).effective_rules()
    assert dict(par.effective_rules().rules) == dict(jrules.rules)
    assert par.effective_rules().mesh_axes("act_seq") == "model"
    assert dict(auto_rules(cfg, mesh, seq_shard=True).rules) == \
        dict(auto_rules(cfg, mesh).replace(act_seq="model").rules)
    r = auto_rules(cfg, mesh)
    for shape in SHAPES:
        if not supports_shape(cfg, shape)[0]:
            continue
        got = batch_pspecs(cfg, shape, mesh, r, kv_seq_shard=True)
        want = j_batch_pspecs(jcfg, shape, mesh, j_auto_rules(jcfg, mesh),
                              kv_seq_shard=True)
        assert {k: _canon(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, shape
        if "k_cache" in got and got["k_cache"][2] == "model":
            assert par.kv_window_sharded
            L, B, W, K, dh = 1, 2 * mesh.shape["data"], 4 * mesh.shape[
                "model"], cfg.n_kv_heads, 2
            kc = torch.empty((L, B, W, K, dh), device="meta")
            cut = batch_shard({"k_cache": kc}, cfg, par)["k_cache"]
            assert tuple(cut.shape) == (L, 2, 4, K, dh)
    with pytest.raises(ValueError, match="does not split"):
        batch_shard({"k_cache": torch.empty(
            (1, 2, mesh.shape["model"] + 1, cfg.n_kv_heads or 1, 2),
            device="meta")}, cfg, dataclasses.replace(
                par, rules=par.rules.replace(kv_heads=None)))
