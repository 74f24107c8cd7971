"""ZeRO stages 1-3 over a placed mesh of gloo ranks on the CPU.

* **Placement**: for all ten configs, on a 2 x 2 and on the 16 x 16
  mesh, at stages 1-3, the port's rules (the model's and the moments')
  are the reference's ``make_parallel(...).effective_rules()`` and every
  leaf's block is the one the reference's ``param_pspecs`` gives a device.
* **The 2 x 2 fleet** (``data=2, model=2``, 4 ranks, one launch), reduced
  qwen3-moe on the reference's weights at a capacity that drops no slot,
  at stages 0-3 on the same weights and batch: the loss and every
  gradient leaf at stages 1-3 bit for bit those of stage 0 (two data
  ranks: every sum over data is ``a + b``), stage 0 against the
  reference's single-device ``jax.value_and_grad``, the parameters after
  one step at rtol 1e-6 of stage 0's (``global_norm`` sums its squares
  in another order), each rank's parameter and moment bytes and the
  step's traffic by axis and op equal to the dry run's at the stage, and
  a stage-3 checkpoint restored bit for bit while a stage-0 restore of it
  raises.
* **Gather and scatter** (``data=2``, 2 ranks): ``gather_from_data``'s
  forward and backward against the whole tensor's, in float32 and cast to
  bf16 before the gather.

The payloads import only ``repro_torch``; this process computes the
reference's numbers and reads the fleets' arrays from ``out.npz``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as J_ARCHS
from repro.launch.sharding import make_parallel as j_make_parallel
from repro.models.api import build_model as j_build_model
from repro.models.api import model_defs as j_model_defs
from repro.models.params import init_params as j_init_params
from repro.models.params import param_pspecs as j_param_pspecs
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import effective_rules, make_parallel
from repro_torch.models.api import model_defs
from repro_torch.models.common import ShapeCfg
from repro_torch.models.params import param_local_shapes, tree_leaves
from tests.test_torch_mesh_fleet import (COMMON, GRAD_TOL, JPAR,
                                         LOSS_PORT_TOL, LOSS_REF_TOL,
                                         NO_DROP, PRELUDE, _np, _port_single,
                                         _run)
from tests.train_reference import STRICT, _flat, _rel

STAGES = (0, 1, 2, 3)
STEP_RTOL = 1e-6        # the parameters after one step against stage 0's,
                        # each leaf's relative Frobenius distance: the CPU
                        # reads 0, an H100 6.7e-9 (the clipping norm's
                        # squares are summed in another order, 1 ulp off)
MESHES = {"2x2": MeshShape(("data", "model"), (2, 2)),
          "16x16": MeshShape.production()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Placement.
# ---------------------------------------------------------------------------

def _j_leaves(tree):
    """The reference's PartitionSpec leaves as tuples, sorted-key order."""
    from jax.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return [tuple(tree)]
    return [x for k in sorted(tree) for x in _j_leaves(tree[k])]


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_zero_placement_matches_reference(arch, mesh, stage):
    """The model's rules at ``stage`` and the moments' (stage 3's) are the
    reference's, and each leaf's block on the mesh is the one the
    reference's ``PartitionSpec`` gives a device."""
    mesh = MESHES[mesh]
    cfg, jcfg = configs.get(arch), J_ARCHS[arch]
    par = make_parallel(cfg, ProcessMesh.counted(mesh), zero_stage=stage)
    jrules = j_make_parallel(jcfg, mesh, zero_stage=stage).effective_rules()
    jmoments = j_make_parallel(jcfg, mesh, zero_stage=3).effective_rules()
    assert dict(par.effective_rules().rules) == dict(jrules.rules)
    assert dict(effective_rules(cfg, mesh, stage).rules) == dict(jrules.rules)
    assert dict(par.moment_rules().rules) == dict(jmoments.rules)
    defs = model_defs(cfg)
    for rules, jr in ((par.effective_rules(), jrules),
                      (par.moment_rules(), jmoments)):
        local = tree_leaves(param_local_shapes(defs, rules, mesh))
        specs = _j_leaves(j_param_pspecs(j_model_defs(jcfg), jr))
        assert len(local) == len(specs) == len(tree_leaves(defs))
        for d, shape, spec in zip(tree_leaves(defs), local, specs):
            want = []
            for n, ax in zip(d.shape, spec + (None,) * len(d.shape)):
                axes = () if ax is None else (
                    ax if isinstance(ax, tuple) else (ax,))
                k = math.prod(mesh.shape[a] for a in axes)
                assert n % k == 0
                want.append(n // k)
            assert shape == tuple(want), (d.logical, spec)


# ---------------------------------------------------------------------------
# The 2 x 2 fleet: reduced qwen3-moe at stages 0-3.
# ---------------------------------------------------------------------------

PAYLOAD_ZERO = PRELUDE + COMMON + r"""
import dataclasses
NO_DROP = @NO_DROP@
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.common import ShapeCfg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.loop import make_train_step

cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b").reduced(),
                          capacity_factor=NO_DROP)
mesh = ProcessMesh.build(MeshShape.parse("data=2,model=2"), "cpu")
defs, full = model_defs(cfg), nest("p.")
whole = {"tokens": torch.from_numpy(DATA["tokens"]),
         "labels": torch.from_numpy(DATA["labels"])}
opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
out, save = {}, {}


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


for stage in (0, 1, 2, 3):
    par = make_parallel(cfg, mesh, zero_stage=stage, remat="none")
    batch = batch_shard(whole, cfg, par)
    model = Model(cfg, shard_params(full, defs, par.effective_rules(), mesh),
                  par)
    pl = model.placement
    loss0, grads = model.loss(batch)
    summed = parallel.sum_over_data(grads, par, pl.data, pl.scatter)
    summed = {k: parallel.all_gather(g, par, pl.scatter[k])
              if k in pl.scatter else g for k, g in summed.items()}
    save.update(arrays(f"{stage}.g.", gather_params(summed, defs, par)))
    if stage in (0, 3):
        # The serve forwards, and the loss under remat full (each layer
        # gathering its weights again in the backward's recompute).
        logits, caches = model.prefill({"tokens": batch["tokens"][:, :63]})
        dlogits, _ = model.decode({"token": batch["tokens"][:, 63:],
                                   "pos": torch.tensor(63), **caches})
        save[f"{stage}.prefill"] = logits.float().numpy()
        save[f"{stage}.decode"] = dlogits.float().numpy()
        if stage == 3:
            remat = make_parallel(cfg, mesh, zero_stage=3, remat="full")
            loss, grads = Model(cfg, dict(model.tree()), remat).loss(batch)
            remat_loss = float(parallel.sum_no_grad(loss, par,
                                                    par.batch_axes))
            summed = parallel.sum_over_data(grads, par, pl.data, pl.scatter)
            save.update(arrays("3r.g.", gather_params(summed, defs, par)))
    opt = adamw_init(dict(model.named_parameters()), opt_cfg, par, pl)
    r = {"loss": float(parallel.sum_no_grad(loss0, par, par.batch_axes)),
         "data": sorted(pl.data), "scatter": sorted(pl.scatter),
         "param_bytes": nbytes(model.parameters()),
         "moment_bytes": nbytes([*opt.m.values(), *opt.v.values()])}
    if stage == 3:
        r["remat_loss"] = remat_loss
    parallel.reset_traffic()
    opt, _, m = make_train_step(model, TrainConfig(opt=opt_cfg))(opt, None,
                                                                 batch)
    r["traffic"] = {a: {op: v[:2] for op, v in sorted(ops.items())}
                    for a, ops in sorted(parallel.TRAFFIC.items())}
    r["step_loss"], r["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    save.update(arrays(f"{stage}.s.", gather_params(
        dict(model.named_parameters()), defs, par)))
    save.update(arrays(f"{stage}.m.", gather_params(
        opt.m, defs, par, par.moment_rules())))
    out[stage] = r

# A stage-3 checkpoint: a new Trainer restores the blocks and moments bit
# for bit; a stage-0 manager refuses it, naming both stages.
shape = ShapeCfg("t", "train", 32, 8)
tc = TrainConfig(steps=1, ckpt_every=1, log_every=1, opt=opt_cfg)


def trainer():
    m = Model(cfg, shard_params(full, defs, par.effective_rules(), mesh), par)
    return Trainer(m, tc, shape=shape, ckpt_dir=DIR + "/ckpt")


t1 = trainer()
t1.run(1)
t2 = trainer()
resumed = t2.resume()
same = all(torch.equal(p, dict(t1.model.named_parameters())[k])
           for k, p in t2.model.named_parameters())
for a, b in ((t1.state["opt"].m, t2.state["opt"].m),
             (t1.state["opt"].v, t2.state["opt"].v)):
    same = same and all(torch.equal(a[k], b[k]) for k in a)
out["ckpt"] = {"resumed_at": resumed,
               "restored_equal": int(parallel.sum_no_grad(
                   torch.tensor(int(same)), par, ("data", "model"))),
               "moment_shapes": sorted({k: list(v.shape) for k, v in
                                        t2.state["opt"].m.items()}.items())}
try:
    CheckpointManager(DIR + "/ckpt", process_index=mesh.rank,
                      mesh=mesh.shape, processes=4,
                      zero_stage=0).restore(t2._tree())
    out["wrong_stage"] = "restored"
except ValueError as e:
    out["wrong_stage"] = str(e)
if mesh.rank == 0:
    np.savez(DIR + "/out.npz", **save)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def zero_fleet(tmp_path_factory):
    """The fleet's results; the reference's single-device loss and
    gradients, the port's single-process loss, and the dry run's record
    at each stage, on the same weights and batch."""
    tmp = tmp_path_factory.mktemp("zero2x2")
    jcfg = dataclasses.replace(J_ARCHS["qwen3-moe-30b-a3b"].reduced(),
                               capacity_factor=NO_DROP)
    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b").reduced(),
                              capacity_factor=NO_DROP)
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((8, 1), -1, np.int32)], 1)
    res, arrays = _run(PAYLOAD_ZERO, tmp, {**_np(jp, "p."), "tokens": tokens,
                                           "labels": labels}, 4)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, jcfg, JPAR))).lower(jp, jb).compile(
            compiler_options=STRICT)(jp, jb)
    loss, grads = _port_single(cfg, jp).loss(
        {"tokens": torch.from_numpy(tokens),
         "labels": torch.from_numpy(labels)})
    # The dry run of the same reduced config, batch and stage.
    mesh = MeshShape.parse("data=2,model=2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "get", lambda arch: cfg)
        recs = {s: dryrun.run_cell("qwen3-moe-30b-a3b", ShapeCfg(
            "t", "train", 64, 8), mesh, {"zero_stage": s, "remat": "none"})
            for s in STAGES}
    return {"res": {int(k): v for k, v in res.items() if k.isdigit()},
            "ckpt": res["ckpt"], "wrong_stage": res["wrong_stage"],
            "arrays": arrays, "jloss": float(jloss), "loss": float(loss),
            "jgrads": _flat(jgrads), "recs": recs,
            "grads": {k: g.numpy() for k, g in grads.items()}}


def _leaves(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_loss_and_grads_are_stage_0s_bit_for_bit(zero_fleet, stage):
    """The loss and every gradient leaf (summed over data and put back
    together) at ``stage`` are stage 0's, bit for bit; stage 2 gathers
    the expert bank, stage 3 every weight, stages 1-2 reduce-scatter the
    leaves they hold whole."""
    r, a = zero_fleet["res"], zero_fleet["arrays"]
    assert r[stage]["loss"] == r[0]["loss"]
    want, got = _leaves(a, "0.g."), _leaves(a, f"{stage}.g.")
    assert set(got) == set(want) and len(want) > 10
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert not bad, bad
    bank = {"blocks.moe.w_in", "blocks.moe.w_out"}
    held = set(r[stage]["data"])
    if stage == 1:
        assert not held and bank <= set(r[stage]["scatter"])
    elif stage == 2:
        assert held == bank and "blocks.attn.wq" in r[stage]["scatter"]
    else:
        assert bank | {"blocks.attn.wq", "embed.table"} <= held
        assert not r[stage]["scatter"]


def test_zero_stage_0_matches_reference(zero_fleet):
    """Stage 0's loss within LOSS_REF_TOL of the reference's single-device
    loss and LOSS_PORT_TOL of the port's single process; its gradients,
    put back together (and so those of stages 1-3, equal to them bit for
    bit), within GRAD_TOL (relative Frobenius, each leaf) of the port's
    single process, and no further from the reference's ``jax.grad`` on
    the same weights than the single process is, plus GRAD_TOL.  (The
    single process is itself up to 7.2e-2 from ``jax.grad`` on the MoE
    router at this capacity, 4.7e-2 on ``norm2.scale``: in each package's
    own bf16 forward 3 of the 512 tokens of layer 1 route to another
    expert at a near tie, and a routing that moves moves a whole token's
    gradient; with those tokens masked every leaf is within 1e-2, and in
    float32 no token flips and every leaf is within 1e-5:
    ``tests/test_torch_train_grads.py::test_moe_gradient_gap_is_routing_flips``.)"""
    loss = zero_fleet["res"][0]["loss"]
    assert abs(loss - zero_fleet["jloss"]) < LOSS_REF_TOL
    assert abs(loss - zero_fleet["loss"]) < LOSS_PORT_TOL
    got, one = _leaves(zero_fleet["arrays"], "0.g."), zero_fleet["grads"]
    assert set(got) == set(one) == set(zero_fleet["jgrads"])
    bad = {k: _rel(got[k], g) for k, g in one.items()
           if _rel(got[k], g) > GRAD_TOL}
    assert not bad, bad
    bad = {k: (_rel(got[k], g), _rel(one[k], g))
           for k, g in zero_fleet["jgrads"].items()
           if _rel(got[k], g) > _rel(one[k], g) + GRAD_TOL}
    assert not bad, bad


def test_zero3_serves_and_remats_as_stage_0(zero_fleet):
    """At stage 3 the prefill's and a decode step's logits are stage 0's,
    and under remat ``full`` (each layer's weights gathered again in the
    backward's recompute) the loss and gradients are too, bit for bit."""
    r, a = zero_fleet["res"], zero_fleet["arrays"]
    for kind in ("prefill", "decode"):
        assert np.isfinite(a[f"0.{kind}"]).all()
        assert np.array_equal(a[f"3.{kind}"], a[f"0.{kind}"]), kind
    assert r[3]["remat_loss"] == r[0]["loss"]
    want, got = _leaves(a, "0.g."), _leaves(a, "3r.g.")
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    assert set(got) == set(want) and not bad, bad


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_step_matches_stage_0(zero_fleet, stage):
    """One AdamW step at ``stage``: the step's loss is stage 0's, the
    gradient norm within STEP_RTOL of stage 0's, and the parameters after
    the step (put back together) and the first moments each leaf within
    a relative Frobenius distance of STEP_RTOL."""
    r, a = zero_fleet["res"], zero_fleet["arrays"]
    assert r[stage]["step_loss"] == r[0]["step_loss"]
    assert r[stage]["grad_norm"] == pytest.approx(r[0]["grad_norm"],
                                                  rel=STEP_RTOL)
    for kind in ("s", "m"):
        want, got = _leaves(a, f"0.{kind}."), _leaves(a, f"{stage}.{kind}.")
        assert set(got) == set(want)
        bad = {k: _rel(got[k], want[k]) for k in want
               if _rel(got[k], want[k]) > STEP_RTOL}
        assert not bad, bad


@pytest.mark.parametrize("stage", STAGES)
def test_zero_state_bytes_equal_the_dry_runs(zero_fleet, stage):
    """Each rank's parameter and moment bytes are the dry run's per
    device at the stage, and its record has a fit verdict.  The moments
    are stage 3's blocks at stages 1-3 (smaller than stage 0's), the
    parameters shrink from stage 0 (= 1) to 2 to 3, and so the state
    (parameters and moments) from 0 to 1 to 3."""
    r, rec = zero_fleet["res"][stage], zero_fleet["recs"][stage]
    assert rec["status"] == "ok" and rec["policy"]["zero_stage"] == str(stage)
    assert r["param_bytes"] == rec["param_bytes_per_device"]
    assert r["moment_bytes"] == rec["moment_bytes_per_device"]
    assert isinstance(rec["fits"], bool)
    res = zero_fleet["res"]
    assert res[3]["moment_bytes"] == res[2]["moment_bytes"] \
        == res[1]["moment_bytes"] < res[0]["moment_bytes"]
    assert res[3]["param_bytes"] < res[2]["param_bytes"] \
        < res[0]["param_bytes"] == res[1]["param_bytes"]
    state = [res[s]["param_bytes"] + res[s]["moment_bytes"] for s in STAGES]
    assert state[3] < state[1] < state[0]


@pytest.mark.parametrize("stage", STAGES)
def test_zero_traffic_equals_the_dry_runs(zero_fleet, stage):
    """The bytes the fleet's step moved, by axis and op, are the dry run's
    count of rank 0's step at the same stage: stage 0 all-reduces only,
    stages 1-3 also all-gather and reduce-scatter over data."""
    got = {a: {op: v[1] for op, v in ops.items()}
           for a, ops in zero_fleet["res"][stage]["traffic"].items()}
    rec = zero_fleet["recs"][stage]
    assert got == rec["coll_ops"]
    ops = set(got["data"])
    assert ops == ({"all_reduce"} if stage == 0 else
                   {"all_reduce", "all_gather", "reduce_scatter"})
    assert rec["wire_bytes"] == pytest.approx(sum(
        b * (2 if op == "all_reduce" else 1) / 2
        for o in got.values() for op, b in o.items()))


def test_zero3_checkpoint_restores_and_refuses_another_stage(zero_fleet):
    """A stage-3 Trainer's checkpoint restores its blocks and moments bit
    for bit on every rank (the moments in stage 3's blocks); a restore at
    stage 0 raises, naming both stages."""
    c = zero_fleet["ckpt"]
    assert c["resumed_at"] == 1 and c["restored_equal"] == 4
    shapes = dict(c["moment_shapes"])
    assert shapes["embed.table"] == [512 // 2, 128 // 2]   # vocab, embed
    w = zero_fleet["wrong_stage"]
    assert "ZeRO stage 3" in w and "stage is 0" in w


def test_zero3_dry_run_counts_each_microbatch():
    """At stage 3 each microbatch's forward gathers every weight and its
    backward reduce-scatters every gradient: two microbatches count twice
    one's gathers and scatters over data, and the record still has a fit
    verdict."""
    sc, mesh = ShapeCfg("t", "train", 64, 4), MESHES["2x2"]
    one, two = (dryrun.run_cell("qwen1.5-0.5b", sc, mesh,
                                {"microbatches": n}) for n in (1, 2))
    assert one["status"] == two["status"] == "ok"
    assert two["policy"]["zero_stage"] == "3" and isinstance(two["fits"],
                                                             bool)
    for op in ("all_gather", "reduce_scatter"):
        assert two["coll_ops"]["data"][op] == 2 * one["coll_ops"]["data"][op]


# ---------------------------------------------------------------------------
# gather_from_data on a 1 x 2 data fleet.
# ---------------------------------------------------------------------------

PAYLOAD_GATHER = PRELUDE + COMMON + r"""
mesh = ProcessMesh.build(MeshShape.parse("data=2,model=1"), "cpu")
par = parallel.ParallelCfg(mesh=mesh)
x, g = torch.from_numpy(DATA["x"]), torch.from_numpy(DATA["g"])
rank, out, save = mesh.coord("data"), {}, {}
for dim in (0, 1):
    for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
        parallel.reset_traffic()
        blk = x.chunk(2, dim)[rank].clone().requires_grad_(True)
        y = parallel.gather_from_data(blk, par, dim, dt)
        (gx,) = torch.autograd.grad(y, blk, g[rank].to(y.dtype))
        key = f"{name}.{dim}"
        out[key] = {"dtypes": [str(y.dtype), str(gx.dtype)],
                    "traffic": parallel.traffic_table()}
        save[key + ".y"] = y.detach().float().numpy()
        save[key + ".g"] = parallel.all_gather(gx, par, dim).numpy()
if rank == 0:
    np.savez(DIR + "/out.npz", **save)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def gather_fleet(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    g = rng.standard_normal((2, 6, 8)).astype(np.float32)
    res, arrays = _run(PAYLOAD_GATHER, tmp_path_factory.mktemp("gather"),
                       {"x": x, "g": g}, 2)
    return res, arrays, x, g


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("dim", [0, 1])
def test_gather_from_data_forward_and_backward(gather_fleet, dim, name):
    """Each rank's block gathered is the whole tensor (cast to bf16 before
    the gather where asked), and the gradients of the two ranks' uses of
    it are reduce-scattered in float32: put back together, the sum of the
    two upstream gradients, bit for bit.  The gather counts the whole
    tensor's bytes in its dtype, the scatter in float32."""
    res, a, x, g = gather_fleet
    r, key = res[f"{name}.{dim}"], f"{name}.{dim}"
    if name == "bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
        g = torch.from_numpy(g).bfloat16().float().numpy()
    assert np.array_equal(a[key + ".y"], x)
    assert np.array_equal(a[key + ".g"], g[0] + g[1])
    assert r["dtypes"] == ["torch.bfloat16" if name == "bf16"
                           else "torch.float32", "torch.float32"]
    assert r["traffic"] == {"data": {
        "all_gather": x.size * (2 if name == "bf16" else 4),
        "reduce_scatter": x.size * 4}}
