"""The port's model over a placed mesh of gloo ranks on the CPU, against
the reference.

Two fleets, each one payload run once per module
(``tests.harness.run_distributed``; every rank's last stdout line must be
the same JSON, so every rank reports the same losses):

* **2 x 2** (``data=2, model=2``, 4 ranks), reduced qwen3-moe on the
  reference's weights (``init_params(jax.random.key(0))``) and the
  batch of ``tests/test_multidevice.py``: the loss and gradients, one
  train step and its collective traffic, the MoE layer alone
  (expert-parallel, the counterpart of the reference's ``_moe_ep``), a
  sharded checkpoint restored and a wrong mesh refused;
* **1 x 2** (``model=2``, 2 ranks), reduced hymba, and a variant with 5 q
  heads over 1 kv head whose attention runs whole on every rank (hymba's
  25 heads on an even axis): loss, gradients, prefill and one decode
  step.

The payloads import only ``repro_torch``; this process computes the
reference's numbers and the port's single-process ones, and reads the
fleets' arrays from ``out.npz`` (written by rank 0).
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import repro.models.moe as j_moe
from repro.configs import ARCHS as J_ARCHS
from repro.models.api import build_model as j_build_model
from repro.models.layers import cast as j_cast
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.common import ShapeCfg
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCfg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainConfig
from repro_torch.train.loop import make_train_step
from tests.harness import DISTRIBUTED_PRELUDE, run_distributed
from tests.train_reference import STRICT, _flat, _rel

JPAR = JParallelCfg(mesh=None, remat="none")
# Tolerances, with what they measured on the CPU:
LOSS_REF_TOL = 0.05     # the reference's own bound (test_multidevice.py);
                        # the 2x2 loss is 3.2e-4 off the reference's
LOSS_PORT_TOL = 2e-3    # the 2x2 loss against the port's one process:
                        # 1.8e-4 (partial sums reduced in f32 and rounded
                        # once, where one process rounds each product)
GRAD_TOL = 2e-2         # relative Frobenius, each leaf, sharded against
                        # one process: worst 8.0e-3 (2x2), 1.2e-2 (1x2)
STEP_TOL = 1e-2         # the parameters after one AdamW step: 4.0e-3
LOGIT_TOL = 2e-2        # hymba against the reference: loss 3.5e-4, logits
                        # 1.8e-2 (prefill and decode; the single process's
                        # own tolerance, tests/test_torch_models.py)
MOE_Y_TOL = 2e-2        # the MoE layer's y against the _moe_ep
                        # emulation: 3.1e-5
# A capacity factor of E / k gives every expert room for every token: no
# slot drops, in one process or in a data shard.
NO_DROP = 8 / 2

PRELUDE = DISTRIBUTED_PRELUDE.replace("repro.shard", "repro_torch.shard")

COMMON = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import batch_shard, gather_params, make_parallel
from repro_torch.models import moe, parallel
from repro_torch.models.api import Model, model_defs
from repro_torch.models.params import shard_params

DIR = "@DIR@"
with np.load(DIR + "/inputs.npz") as z:
    DATA = {k: z[k] for k in z.files}


def nest(prefix):
    out = {}
    for name, x in DATA.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = x
    return out


def arrays(prefix, tensors):
    return {prefix + k: v.detach().float().numpy() for k, v in tensors.items()}
"""

PAYLOAD_2X2 = PRELUDE + COMMON + r"""
import dataclasses
NO_DROP = @NO_DROP@
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.common import ShapeCfg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.loop import make_train_step

cfg = configs.get("qwen3-moe-30b-a3b").reduced()
CF = cfg.capacity_factor
mesh = ProcessMesh.build(MeshShape.parse("data=2,model=2"), "cpu")
par = make_parallel(cfg, mesh, remat="none")
rules, defs = par.effective_rules(), model_defs(cfg)
full = nest("p.")
batch = batch_shard({"tokens": torch.from_numpy(DATA["tokens"]),
                     "labels": torch.from_numpy(DATA["labels"])}, cfg, par)
out, save = {}, {}

# The loss, summed over the data ranks.
model = Model(cfg, shard_params(full, defs, rules, mesh), par)
loss, _ = model.loss(batch)
out["loss"] = float(parallel.sum_no_grad(loss, par, par.batch_axes))

# At a capacity that drops no slot (each data shard's capacity is its own,
# so drops differ from one process's), the gradients summed over the data
# ranks, one train step, and the bytes its collectives reduced.
cfg = dataclasses.replace(cfg, capacity_factor=NO_DROP)
model = Model(cfg, shard_params(full, defs, rules, mesh), par)
_, grads = model.loss(batch)
save.update(arrays("g.", gather_params(parallel.sum_over_data(grads, par),
                                       defs, par)))
tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
step = make_train_step(model, tc)
opt = adamw_init(dict(model.named_parameters()), tc.opt)
parallel.reset_traffic()
opt, _, m = step(opt, None, batch)
out["traffic"] = {a: {op: v[:2] for op, v in sorted(ops.items())}
                  for a, ops in sorted(parallel.TRAFFIC.items())}
out["step_loss"], out["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
save.update(arrays("s.", gather_params(dict(model.named_parameters()), defs,
                                       par)))

# The MoE layer alone: this rank's data shard, its experts.
cfg = dataclasses.replace(cfg, capacity_factor=CF)
mp = shard_params(nest("m."), moe.moe_defs(cfg), rules, mesh)
x = torch.from_numpy(DATA["x"]).bfloat16()
bl = x.shape[0] // par.data_size
xl = x[par.data_index * bl:(par.data_index + 1) * bl]
real_route, routes = moe._route, []


def recording(x2d, router, k):             # keeps the router's ids
    routed = real_route(x2d, router, k)
    routes.append(routed[0])
    return routed


moe._route = recording
try:
    y, aux = moe.moe_apply(mp, xl, cfg, par)
finally:
    moe._route = real_route
ids = routes.pop()
e_first, e_local, cap = moe.ep_plan(ids.shape[0], cfg, par)
keep = moe._slots(ids, e_first, e_local, cap)[2].to(torch.int64)
keep = parallel.sum_no_grad(keep, par)           # each slot's owner
out["moe"] = {"e_local": e_local, "capacity": cap,
              "aux": float(parallel.sum_no_grad(aux, par, ("data",)))}


def over_data(t):
    rows = t.new_zeros((par.data_size,) + t.shape)
    rows[par.data_index] = t
    return parallel.sum_no_grad(rows, par, ("data",))


save["moe.y"] = over_data(y.float()).numpy()
save["moe.ids"] = over_data(ids.to(torch.int64)).numpy()
save["moe.keep"] = over_data(keep).numpy()

# Checkpoints: each rank saves its shard; a new Trainer restores it bit for
# bit and its next step's loss is the first's; another mesh is refused.
shape = ShapeCfg("t", "train", 32, 8)
tc = TrainConfig(steps=2, ckpt_every=1, log_every=1,
                 opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))


def trainer():
    m = Model(cfg, shard_params(full, defs, rules, mesh), par)
    return Trainer(m, tc, shape=shape, ckpt_dir=DIR + "/ckpt")


t1 = trainer()
t1.run(1)
after1 = {k: p.clone() for k, p in t1.model.named_parameters()}
t1.ckpt = None
t1.run(2)
t2 = trainer()
resumed = t2.resume()
same = all(torch.equal(p, after1[k]) for k, p in t2.model.named_parameters())
same = same and t2.pipeline.step == t1.pipeline.step - 1
t2.run(2)
out["ckpt"] = {"resumed_at": resumed,
               "restored_equal": int(parallel.sum_no_grad(
                   torch.tensor(int(same)), par, ("data", "model"))),
               "loss1": t1.history[-1]["loss"], "loss2": t2.history[-1]["loss"],
               "files": sorted(__import__("os").listdir(
                   DIR + "/ckpt/step_00000001"))}
try:
    CheckpointManager(DIR + "/ckpt", process_index=mesh.rank,
                      mesh={"data": 4, "model": 1},
                      processes=4).restore(t2._tree())
    out["wrong_mesh"] = "restored"
except ValueError as e:
    out["wrong_mesh"] = str(e)
if mesh.rank == 0:
    np.savez(DIR + "/out.npz", **save)
print(json.dumps(out))
"""

PAYLOAD_1X2 = PRELUDE + COMMON + r"""
import dataclasses
mesh = ProcessMesh.build(MeshShape.parse("data=1,model=2"), "cpu")
out, save = {}, {}
for name, kw in (("hymba", {}), ("hymba5", {"n_heads": 5, "n_kv_heads": 1})):
    cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(), **kw)
    par = make_parallel(cfg, mesh, remat="none")
    defs = model_defs(cfg)
    model = Model(cfg, shard_params(nest(name + ".p."), defs,
                                    par.effective_rules(), mesh), par)
    loss, grads = model.loss({k: torch.from_numpy(DATA[name + "." + k])
                              for k in ("tokens", "labels")})
    out[name] = {"loss": float(loss), "local_heads": int(
        model.tree()["blocks"]["attn"]["wq"].shape[2]),
        "local_ssm_heads": int(model.tree()["blocks"]["ssm"]["A_log"].shape[1])}
    save.update(arrays(name + ".g.", gather_params(grads, defs, par)))
    toks = torch.from_numpy(DATA[name + ".prompt"])
    S = toks.shape[1] - 1
    logits, caches = model.prefill({"tokens": toks[:, :S]})
    dlogits, _ = model.decode({"token": toks[:, S:], "pos": torch.tensor(S),
                               **caches})
    out[name]["cache_shapes"] = {k: list(v.shape) for k, v in caches.items()}
    save[name + ".prefill"] = logits.numpy()
    save[name + ".decode"] = dlogits.numpy()
if mesh.rank == 0:
    np.savez(DIR + "/out.npz", **save)
print(json.dumps(out))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, prefix):
    return {prefix + k: v for k, v in _flat(tree).items()}


def _port_single(cfg, jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                             ParallelCfg(remat="none"))


def _run(payload, tmp, inputs, processes):
    np.savez(tmp / "inputs.npz", **inputs)
    res = run_distributed(payload.replace("@DIR@", str(tmp))
                          .replace("@NO_DROP@", repr(NO_DROP)),
                          processes=processes, devices=1, timeout=600)
    with np.load(tmp / "out.npz") as z:
        return res[0], {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# The 2 x 2 fleet: reduced qwen3-moe.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_fleet(tmp_path_factory):
    """The 2 x 2 fleet's results, the reference's and the port's single
    process numbers on the same weights and batch."""
    tmp = tmp_path_factory.mktemp("mesh2x2")
    jcfg = J_ARCHS["qwen3-moe-30b-a3b"].reduced()
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((8, 1), -1, np.int32)], 1)
    mjp = j_init_params(jax.random.key(1), j_moe.moe_defs(jcfg))
    x = jnp.asarray(0.5 * np.random.default_rng(3).standard_normal(
        (4, 16, cfg.d_model)), jnp.bfloat16)
    inputs = {**_np(jp, "p."), **_np(mjp, "m."), "tokens": tokens,
              "labels": labels, "x": np.asarray(x.astype(jnp.float32))}
    res, arrays = _run(PAYLOAD_2X2, tmp, inputs, 4)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    jloss = jax.jit(lambda p, b: jm.loss(p, b, jcfg, JPAR)).lower(
        jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    ).compile(compiler_options=STRICT)(
        jp, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    loss, _ = _port_single(cfg, jp).loss(batch)
    cfg = dataclasses.replace(cfg, capacity_factor=NO_DROP)
    model = _port_single(cfg, jp)
    _, grads = model.loss(batch)
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    opt = adamw_init(dict(model.named_parameters()), tc.opt)
    _, _, m = make_train_step(model, tc)(opt, None, batch)
    return {"res": res, "arrays": arrays, "jloss": float(jloss),
            "loss": float(loss), "grads": grads, "step": m,
            "stepped": dict(model.named_parameters()), "cfg": cfg,
            "moe_cfg": configs.get("qwen3-moe-30b-a3b").reduced(),
            "jcfg": jcfg, "mjp": mjp, "x": x}


def test_moe_train_loss_on_2x2_fleet(moe_fleet):
    """The loss of a 2 x 2 fleet (every rank prints the same: the harness
    holds the ranks' JSON equal) is within 0.05 of the reference's
    single-device loss, as ``test_moe_train_step_on_8_devices`` holds the
    reference's own mesh, and within LOSS_PORT_TOL of the port's single
    process; at NO_DROP capacity, the train step's global norm is the
    single process's."""
    r = moe_fleet["res"]
    assert abs(r["loss"] - moe_fleet["jloss"]) < LOSS_REF_TOL
    assert abs(r["loss"] - moe_fleet["loss"]) < LOSS_PORT_TOL
    assert abs(r["grad_norm"] - float(moe_fleet["step"]["grad_norm"])) \
        < 1e-2 * float(moe_fleet["step"]["grad_norm"])


def test_moe_train_grads_on_2x2_fleet(moe_fleet):
    """At a capacity that drops no slot (NO_DROP), the gradients, summed
    over the data ranks and put back together, and the parameters after
    one AdamW step, against the port's single process (each leaf within
    GRAD_TOL relative Frobenius)."""
    a = moe_fleet["arrays"]
    bad = {k: _rel(a["g." + k], g.numpy())
           for k, g in moe_fleet["grads"].items()
           if _rel(a["g." + k], g.numpy()) > GRAD_TOL}
    assert not bad, bad
    bad = {k: _rel(a["s." + k], p.numpy())
           for k, p in moe_fleet["stepped"].items()
           if _rel(a["s." + k], p.numpy()) > STEP_TOL}
    assert not bad, bad


def _ref_keep(ids, e_first, e_local, capacity):
    """The reference's keep mask (``repro/models/moe.py:93-100``)."""
    flat_e = ids.reshape(-1) - e_first
    in_range = (flat_e >= 0) & (flat_e < e_local)
    le = jnp.where(in_range, flat_e, e_local)
    onehot = jax.nn.one_hot(le, e_local + 1, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(le.shape[0]), le]
    return np.asarray(in_range & (rank < capacity))


def test_moe_layer_matches_moe_ep_emulation(moe_fleet):
    """The MoE layer on the 2 x 2 fleet against an emulation of the
    reference's ``_moe_ep`` built from its own functions: per data shard,
    the capacity of the shard's tokens, and the sum over the model ranks
    of ``_dispatch_compute`` at each rank's ``e_first``.  ids and keep
    masks equal, ``y`` allclose, the aux loss the reference's over the
    whole batch."""
    cfg, jcfg, p = moe_fleet["moe_cfg"], moe_fleet["jcfg"], moe_fleet["mjp"]
    res, a = moe_fleet["res"]["moe"], moe_fleet["arrays"]
    E, k, n_model, n_data = cfg.n_experts, cfg.experts_per_token, 2, 2
    e_local = E // n_model
    x = moe_fleet["x"]
    xs = x.reshape(n_data, -1, cfg.d_model)         # the data shards' tokens
    cap = j_moe._capacity(xs.shape[1], k, E, cfg.capacity_factor)
    assert (res["capacity"], res["e_local"]) == (cap, e_local)
    # The single-device capacity is over all tokens: a different one.
    assert j_moe._capacity(2 * xs.shape[1], k, E, cfg.capacity_factor) != cap
    for d in range(n_data):
        ids, wgt, _ = j_moe._route(xs[d], p["router"], k)
        assert np.array_equal(a["moe.ids"][d], np.asarray(ids))
        keep = sum(_ref_keep(ids, m * e_local, e_local, cap).astype(int)
                   for m in range(n_model))
        assert keep.max() <= 1
        assert np.array_equal(a["moe.keep"][d], keep)
        y = sum(j_moe._dispatch_compute(
            xs[d], ids, wgt, j_cast(p["w_in"][m * e_local:(m + 1) * e_local]),
            j_cast(p["w_out"][m * e_local:(m + 1) * e_local]),
            e_first=jnp.int32(m * e_local), e_local=e_local, capacity=cap,
            act=cfg.act).astype(jnp.float32) for m in range(n_model))
        assert_allclose(a["moe.y"][d].reshape(-1, cfg.d_model),
                        np.asarray(y), atol=MOE_Y_TOL, rtol=MOE_Y_TOL)
    # Some slots are dropped at this capacity: the test sees drops.
    assert a["moe.keep"].sum() < a["moe.keep"].size
    jids, _, jprobs = j_moe._route(x.reshape(-1, cfg.d_model), p["router"], k)
    assert_allclose(res["aux"], float(j_moe.aux_loss(jprobs, jids, E)),
                    rtol=1e-5)


def test_sharded_checkpoint_restores_on_2x2_fleet(moe_fleet):
    """Each rank wrote ``proc_{rank}.npz`` with the mesh in the manifest;
    a new Trainer restored its shard bit for bit (every rank) and its next
    step's loss equals the first run's; a restore on a 4 x 1 mesh raised,
    naming both meshes."""
    c = moe_fleet["res"]["ckpt"]
    assert c["files"] == ["manifest.json"] + [f"proc_{r}.npz"
                                              for r in range(4)]
    assert c["resumed_at"] == 1 and c["restored_equal"] == 4
    assert c["loss2"] == c["loss1"]
    w = moe_fleet["res"]["wrong_mesh"]
    assert "{'data': 2, 'model': 2}" in w and "{'data': 4, 'model': 1}" in w


def test_collective_bytes_equal_the_dry_runs(moe_fleet):
    """The bytes the fleet's train step moved over each axis, op by op,
    equal the dry run's count of rank 0's local step on a counted mesh
    at the same ZeRO stage (0: all-reduces only)."""
    cfg = moe_fleet["cfg"]
    mesh = MeshShape.parse("data=2,model=2")
    sc = ShapeCfg("t", "train", 64, 8)
    policy = dryrun.cell_policy(cfg, sc, mesh, {"remat": "none",
                                                "zero_stage": 0})
    assert policy["microbatches"] == 1
    cost, _, _ = dryrun.count_cell(dryrun.build_cell(cfg, sc, policy,
                                                     mesh=mesh))
    got = {a: {op: v[1] for op, v in ops.items()}
           for a, ops in moe_fleet["res"]["traffic"].items()}
    assert got == cost["coll_ops"] and set(got) == {"data", "model"}
    assert all(set(ops) == {"all_reduce"} for ops in got.values())


# ---------------------------------------------------------------------------
# The 1 x 2 fleet: reduced hymba.
# ---------------------------------------------------------------------------

HYMBA = {"hymba": {}, "hymba5": {"n_heads": 5, "n_kv_heads": 1}}


@pytest.fixture(scope="module")
def hymba_fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh1x2")
    inputs, ref = {}, {}
    for name, kw in HYMBA.items():
        jcfg = dataclasses.replace(J_ARCHS["hymba-1.5b"].reduced(), **kw)
        cfg = dataclasses.replace(configs.get("hymba-1.5b").reduced(), **kw)
        jm = j_build_model(jcfg)
        jp = j_init_params(jax.random.key(0), jm.defs)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:],
                                 np.full((2, 1), -1, np.int32)], 1)
        prompt = rng.integers(0, cfg.vocab_size, (2, 71)).astype(np.int32)
        inputs.update({**_np(jp, name + ".p."), name + ".tokens": tokens,
                       name + ".labels": labels, name + ".prompt": prompt})
        jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        jloss = jax.jit(lambda p, b: jm.loss(p, b, jcfg, JPAR)).lower(
            jp, jb).compile(compiler_options=STRICT)(jp, jb)
        S = prompt.shape[1] - 1
        jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, jcfg, JPAR),
                         compiler_options=STRICT)(
            jp, {"tokens": jnp.asarray(prompt[:, :S])})
        jd, _ = jax.jit(lambda p, b: jm.decode(p, b, jcfg, JPAR),
                        compiler_options=STRICT)(
            jp, {"token": jnp.asarray(prompt[:, S:]),
                 "pos": jnp.asarray(S, jnp.int32), **jc})
        _, grads = _port_single(cfg, jp).loss(
            {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)})
        ref[name] = {"loss": float(jloss), "prefill": np.asarray(jl),
                     "decode": np.asarray(jd), "grads": grads,
                     "cfg": cfg}
    res, arrays = _run(PAYLOAD_1X2, tmp, inputs, 2)
    return res, arrays, ref


@pytest.mark.parametrize("name", list(HYMBA))
def test_hymba_on_1x2_fleet_matches_reference(hymba_fleet, name):
    """Reduced hymba over ``model=2`` (its SSM sharded on ``ssm_inner`` /
    ``ssm_heads``, the gated norm's sum of squares summed over the ranks;
    ``hymba``'s 4 q heads sharded too, ``hymba5``'s 5 replicated: that
    branch runs whole on each rank): the loss, the prefill's logits and
    one decode step's within 2e-2 of the reference's single-device ones
    (compiled with ``xla_allow_excess_precision`` off), and the
    gradients, put back together, against the port's single process."""
    res, a, ref = hymba_fleet
    r, want = res[name], ref[name]
    cfg = want["cfg"]
    assert r["local_heads"] == (cfg.n_heads // 2 if name == "hymba"
                                else cfg.n_heads)
    assert r["local_ssm_heads"] == cfg.ssm_heads // 2
    assert r["cache_shapes"]["ssm_state"][2] == cfg.ssm_heads // 2
    assert r["cache_shapes"]["conv_state"][3] == (cfg.d_inner // 2
                                                  + 2 * cfg.ssm_state)
    assert abs(r["loss"] - want["loss"]) <= LOGIT_TOL
    for kind in ("prefill", "decode"):
        assert_allclose(a[f"{name}.{kind}"], want[kind], atol=LOGIT_TOL,
                        rtol=LOGIT_TOL)
    bad = {k: _rel(a[f"{name}.g.{k}"], g.numpy())
           for k, g in want["grads"].items()
           if _rel(a[f"{name}.g.{k}"], g.numpy()) > GRAD_TOL}
    assert not bad, bad
