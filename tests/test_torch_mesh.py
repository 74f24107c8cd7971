"""The mesh layer in one process: placement, the collectives on one rank,
and the local program on a counted mesh.

* every arch's local parameter shapes at model 2, 4 and 16 under
  ``auto_rules``: sharded dimensions split, the bytes the reference's
  ``sharded_size_bytes``;
* ``shard_params`` blocks against ``param_pspecs`` (and the reference's
  ``PartitionSpec``s), every rank's blocks putting the leaf back
  together;
* each collective of ``models.parallel`` is the identity on a one-rank
  mesh, forward and backward, and a one-rank mesh's model computes what
  the unplaced one does, bit for bit;
* the production meshes and an undersized fleet raise;
* rank 0's local step on a counted mesh (``launch.dryrun``) for every
  family and kind, and ``batch_shard``'s blocks of a decode batch;
* sharded checkpoints from two writers, and the build lock.
The fleets themselves are in ``tests/test_torch_mesh_fleet.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.launch.sharding import auto_rules as j_auto_rules
from repro.models.api import model_defs as j_model_defs
from repro.models.params import param_pspecs as j_param_pspecs
from repro.configs import ARCHS as J_ARCHS
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import build
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (MeshShape, ProcessMesh,
                                     make_production_mesh, make_smoke_mesh)
from repro_torch.launch.sharding import (auto_rules, batch_shard,
                                         gather_params, make_parallel)
from repro_torch.models import parallel
from repro_torch.models.api import Model, build_model, model_defs
from repro_torch.models.common import ShapeCfg, materialize
from repro_torch.models.params import (init_params, param_local_shapes,
                                       param_pspecs, shard_params,
                                       sharded_size_bytes, tree_leaves)
from repro_torch.models.parallel import ParallelCfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(data, model):
    return MeshShape(("data", "model"), (data, model))


def _pairs(defs, other):
    """(ParamDef, other's leaf) over a tree, in sorted-key order."""
    return list(zip(tree_leaves(defs), tree_leaves(other)))


# ---------------------------------------------------------------------------
# Placement.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", [2, 4, 16])
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_local_shapes_by_auto_rules(arch, model):
    """Each leaf's block at ``model`` ranks: a dimension the rules put on
    ``model`` holds ``1 / model`` of it, the others all of it; the blocks'
    bytes are ``sharded_size_bytes``, and the rules the reference's."""
    cfg, mesh = configs.get(arch), _mesh(1, model)
    rules = auto_rules(cfg, mesh)
    assert rules.rules == j_auto_rules(J_ARCHS[arch], mesh).rules
    defs = model_defs(cfg)
    local = param_local_shapes(defs, rules, mesh)
    total = 0
    for d, shape in _pairs(defs, local):
        spec = rules.spec(d.logical)
        assert shape == tuple(n // model if ax == "model" else n
                              for n, ax in zip(d.shape, spec))
        total += int(np.prod(shape)) * d.dtype.itemsize
    assert total == sharded_size_bytes(defs, rules, mesh.shape)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "hymba-1.5b",
                                  "whisper-base"])
def test_shard_params_blocks_follow_pspecs(arch):
    """On a 2 x 2 mesh every rank's block of a leaf is the slice its
    ``PartitionSpec`` (the reference's, from its own ``param_pspecs``)
    gives device (d, m), and the four blocks put the leaf together."""
    cfg = configs.get(arch).reduced()
    mesh = _mesh(2, 2)
    rules = auto_rules(cfg, mesh)
    defs = model_defs(cfg)
    full = init_params(torch.Generator().manual_seed(0), defs)
    jcfg = J_ARCHS[arch].reduced()
    jspecs = j_param_pspecs(j_model_defs(jcfg), j_auto_rules(jcfg, mesh))
    assert tree_leaves_j(jspecs) == tree_leaves(
        _spec_tree(param_pspecs(defs, rules)))
    blocks = {}
    for d in range(2):
        for m in range(2):
            pm = ProcessMesh.counted(mesh, (d, m), "cpu")
            blocks[d, m] = shard_params(full, defs, rules, pm)
    for i, (pd, leaf) in enumerate(_pairs(defs, full)):
        spec = rules.spec(pd.logical)
        got = {dm: tree_leaves(b)[i] for dm, b in blocks.items()}
        rebuilt = torch.zeros_like(leaf)
        for (d, m), block in got.items():
            idx = []
            for n, ax in zip(pd.shape, spec):
                k = {"model": m, ("data",): d}.get(ax, 0)
                parts = 1 if ax is None else 2
                idx.append(slice(k * n // parts, (k + 1) * n // parts))
            assert torch.equal(block, leaf[tuple(idx)])
            rebuilt[tuple(idx)] = block
        assert torch.equal(rebuilt, leaf)


def tree_leaves_j(tree):
    """The reference's PartitionSpec leaves, in sorted-key order."""
    from jax.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return [tuple(tree)]
    return [x for k in sorted(tree) for x in tree_leaves_j(tree[k])]


def _spec_tree(tree):
    """Specs as the reference's PartitionSpec tuples (a one-axis tuple is
    the axis name)."""
    if isinstance(tree, tuple):
        return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in tree)
    return {k: _spec_tree(v) for k, v in tree.items()}


def test_build_model_on_a_mesh_keeps_its_blocks():
    """``build_model`` on a mesh draws the whole tree leaf by leaf and
    keeps the rank's blocks: ``shard_params`` of the unplaced model's."""
    cfg = configs.get("hymba-1.5b").reduced()
    pm = ProcessMesh.counted(_mesh(2, 2), (1, 1), "cpu")
    par = make_parallel(cfg, pm)
    got = dict(build_model(cfg, "cpu", seed=3, par=par).named_parameters())
    whole = build_model(cfg, "cpu", seed=3)
    want = shard_params(whole.tree(), model_defs(cfg), par.effective_rules(),
                        pm)
    assert tree_leaves(want) and [tuple(t.shape) for t in tree_leaves(want)] \
        == [tuple(t.shape) for _, t in sorted(got.items())]
    assert all(torch.equal(a, b) for a, (_, b) in
               zip(tree_leaves(want), sorted(got.items())))
    assert whole.sharded == frozenset() and "blocks.ssm.wx" in \
        Model(cfg, want, par).sharded


def test_production_meshes_raise_on_one_process():
    """The reference raises where its mesh needs more devices than it
    has; the port where the fleet has fewer ranks."""
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} ranks"):
            make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ProcessMesh.build(_mesh(2, 2), "cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        launch_train.main(["--arch", "hymba-1.5b", "--reduced", "--device",
                           "cpu", "--mesh", "data=2,model=2"])
    with pytest.raises(ValueError, match="do not lie on the mesh"):
        ProcessMesh.counted(_mesh(2, 2), (0, 2))


def test_zero_is_refused_on_a_mesh():
    """ZeRO stages 1-3 build on a mesh; stage 4, and a data axis that does
    not split a dimension the stage shards over it, raise."""
    cfg = configs.get("hymba-1.5b").reduced()
    pm = ProcessMesh.counted(_mesh(2, 2))
    for stage in (1, 2, 3):
        par = make_parallel(cfg, pm, zero_stage=stage)
        assert par.zero_stage == stage and par.mesh is pm
    with pytest.raises(ValueError, match="stages are 0-3"):
        make_parallel(cfg, pm, zero_stage=4)
    odd = ProcessMesh.counted(_mesh(3, 1))      # d_model 64 over 3 ranks
    assert make_parallel(cfg, odd).zero_stage == 0
    for stage in (1, 3):                       # the moments, the weights
        with pytest.raises(ValueError, match="does not split into 3"):
            make_parallel(cfg, odd, zero_stage=stage)
    assert make_parallel(cfg, None, zero_stage=3).mesh is None


def test_dry_run_leaves_the_fit_open_under_zero_on_a_mesh():
    """A train cell's policy takes ZeRO-3, and the counted step holds it:
    on a mesh the record has a fit verdict and counts the all-gathers and
    reduce-scatters of stage 3 over data beside the all-reduces; on one
    card it has a verdict too, with no collective."""
    sc = ShapeCfg("t", "train", 64, 4)
    rec = dryrun.run_cell("qwen1.5-0.5b", sc, _mesh(2, 2))
    assert rec["status"] == "ok" and rec["policy"]["zero_stage"] == "3"
    assert isinstance(rec["fits"], bool) and "fits_note" not in rec
    ops = rec["coll_ops"]
    assert ops["data"]["all_gather"] > 0 and ops["data"]["reduce_scatter"] > 0
    assert rec["collective_bytes"] == sum(rec["coll_mix"].values()) == sum(
        b for o in ops.values() for b in o.values())
    card = dryrun.run_cell("qwen1.5-0.5b", sc)
    assert card["fits"] is True and "fits_note" not in card
    assert "coll_ops" not in card


def test_smoke_mesh_is_one_rank():
    mesh = make_smoke_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.placed and mesh.device == torch.device("cpu")
    assert ProcessMesh.counted(_mesh(2, 4), (1, 3)).rank == 7


# ---------------------------------------------------------------------------
# The collectives.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("par", [ParallelCfg(), "smoke"])
def test_collectives_are_the_identity_on_one_rank(par):
    if par == "smoke":
        par = ParallelCfg(mesh=make_smoke_mesh("cpu"))
    parallel.reset_traffic()
    x = torch.randn(3, 5, requires_grad=True)
    g = torch.randn(3, 5)
    for fn in (parallel.reduce_from_model, parallel.copy_to_model,
               parallel.sum_over_model):
        y = fn(x, par)
        assert torch.equal(y, x)
        (gx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(gx, g)
    assert torch.equal(parallel.all_reduce_max(x, par), x)
    assert torch.equal(parallel.sum_no_grad(x, par, ("data", "model")), x)
    d = {"a": x.detach()}
    assert parallel.sum_over_data(d, par) is d
    assert not parallel.TRAFFIC or par.mesh is None


def test_counted_mesh_counts_and_refuses_real_tensors():
    """A counted mesh counts each all-reduce's bytes per axis and moves no
    data: a real tensor through it raises."""
    par = ParallelCfg(mesh=ProcessMesh.counted(_mesh(2, 2)))
    parallel.reset_traffic()
    y = parallel.reduce_from_model(torch.empty(4, 8, device="meta"), par)
    parallel.sum_no_grad(torch.empty(3, device="meta"), par, ("data",))
    assert y.shape == (4, 8)
    assert parallel.TRAFFIC == {"model": {"all_reduce": [1, 128, 0.0]},
                                "data": {"all_reduce": [1, 12, 0.0]}}
    with pytest.raises(RuntimeError, match="moves no data"):
        parallel.reduce_from_model(torch.ones(2), par)
    parallel.reset_traffic()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "hymba-1.5b"])
def test_one_rank_mesh_is_the_unplaced_model(arch):
    """On a 1 x 1 mesh the model's loss, gradients, prefill and decode
    are bit for bit those without a mesh, and ``gather_params`` is the
    identity."""
    cfg = configs.get(arch).reduced()
    a = build_model(cfg, "cpu", seed=0, par=ParallelCfg(remat="none"))
    par = make_parallel(cfg, make_smoke_mesh("cpu"), remat="none")
    b = build_model(cfg, "cpu", seed=0, par=par)
    batch = materialize(cfg, "train_4k", seq=32, batch=2, device="cpu")
    (la, ga), (lb, gb) = a.loss(batch), b.loss(batch_shard(batch, cfg, par))
    assert torch.equal(la, lb)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
    whole = gather_params(gb, model_defs(cfg), par)
    assert all(torch.equal(whole[k], g) for k, g in gb.items())
    pa, ca = a.prefill({"tokens": batch["tokens"]})
    pb, cb = b.prefill({"tokens": batch["tokens"]})
    assert torch.equal(pa, pb) and all(torch.equal(ca[k], cb[k]) for k in ca)


# ---------------------------------------------------------------------------
# The local program on a counted mesh.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_local_step_on_a_counted_mesh(arch, kind):
    """Rank 0's local step of every family and kind on a 2 x 2 counted
    mesh runs on ``meta``: its parameters are their blocks at the
    policy's ZeRO stage (3 for training), and it all-reduces over
    ``model`` (and, training, moves gradients over ``data``)."""
    cfg = configs.get(arch).reduced()
    mesh = _mesh(2, 2)
    sc = ShapeCfg("t", kind, 64, 4)
    policy = dryrun.cell_policy(cfg, sc, mesh, {"remat": "none"})
    cell = dryrun.build_cell(cfg, sc, policy, mesh=mesh)
    assert sum(p.numel() * p.element_size() for p in cell.live) \
        == sharded_size_bytes(dryrun._cast_defs(
            model_defs(cfg), dryrun.dtype_of(policy["param_dtype"])),
            dryrun.effective_rules(cfg, mesh, int(policy["zero_stage"])),
            mesh.shape)
    cost, _, _ = dryrun.count_cell(cell)
    assert cost["coll_mix"]["model"] > 0
    # Training sums the gradients over data; serving sums only the MoE
    # aux loss's expert counts there (E floats a layer).
    if kind == "train":
        assert cost["coll_mix"]["data"] > 0
    else:
        assert cost["coll_mix"].get("data", 0) \
            <= 4 * cfg.n_experts * cfg.n_layers


def test_batch_shard_cuts_a_decode_batch():
    """Rank (1, 1) of a 2 x 2 mesh gets the second half of the lanes, the
    kv heads its q heads read, its SSM heads, and its inner conv channels
    with the B/C ones."""
    cfg = configs.get("hymba-1.5b").reduced()
    par = make_parallel(cfg, ProcessMesh.counted(_mesh(2, 2), (1, 1), "cpu"))
    batch = materialize(cfg, "decode_32k", seq=64, batch=4, device="cpu")
    batch["pos"] = torch.arange(4)
    got = batch_shard(batch, cfg, par)
    assert torch.equal(got["token"], batch["token"][2:])
    assert torch.equal(got["pos"], batch["pos"][2:])
    kv = cfg.n_kv_heads // 2
    assert torch.equal(got["k_cache"], batch["k_cache"][:, 2:, :, kv:])
    H = cfg.ssm_heads // 2
    assert torch.equal(got["ssm_state"], batch["ssm_state"][:, 2:, H:])
    di = cfg.d_inner
    assert torch.equal(got["conv_state"], torch.cat(
        [batch["conv_state"][:, 2:, :, di // 2:di],
         batch["conv_state"][:, 2:, :, di:]], -1))


def test_gqa_slice_when_only_q_heads_shard():
    """qwen3-moe-reduced's 4 q heads over 2 kv heads on model=4: each rank
    holds one q head and reads the kv head of its group."""
    from repro_torch.models.attention import head_blocks
    cfg = configs.get("qwen3-moe-30b-a3b").reduced()
    blocks = [head_blocks(cfg, make_parallel(
        cfg, ProcessMesh.counted(_mesh(1, 4), (0, m)))) for m in range(4)]
    assert blocks == [(0, 1, 0, 1), (1, 2, 0, 1), (2, 3, 1, 2), (3, 4, 1, 2)]


# ---------------------------------------------------------------------------
# Checkpoints and the build lock.
# ---------------------------------------------------------------------------

def test_checkpoint_shards_from_two_writers(tmp_path):
    """Two ranks' managers save the same step from two threads: one
    directory holds both shards and the mesh; each restores its own; a
    restore on another mesh raises, naming both."""
    mesh = {"data": 1, "model": 2}
    mgrs = [CheckpointManager(str(tmp_path), process_index=r, mesh=mesh,
                              processes=2) for r in range(2)]
    trees = [{"w": torch.full((2, 3), float(r))} for r in range(2)]
    threads = [threading.Thread(target=m.save, args=(5, t),
                                kwargs={"blocking": True})
               for m, t in zip(mgrs, trees)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(p.name for p in (tmp_path / "step_00000005").iterdir()) \
        == ["manifest.json", "proc_0.npz", "proc_1.npz"]
    for m, t in zip(mgrs, trees):
        assert torch.equal(m.restore(t)["w"], t["w"])
    with pytest.raises(ValueError, match="model': 2.*model': 4"):
        CheckpointManager(str(tmp_path), mesh={"data": 1, "model": 4},
                          processes=4).restore(trees[0])
    with pytest.raises(ValueError, match="None"):
        CheckpointManager(str(tmp_path)).restore(trees[0])


def test_build_compiles_once_under_concurrent_callers(tmp_path, monkeypatch):
    """Two callers of ``build`` for an unbuilt kernel: one compiles under
    the lock, the other waits and loads its library."""
    out = tmp_path / "libk.so"
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path", lambda name: out)
    calls = []

    def compile_(name, path, verbose):
        calls.append(name)
        time.sleep(0.3)
        path.write_bytes(b"lib")
        return path

    monkeypatch.setattr(build, "_compile", compile_)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.build("k")))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["k"] and got == [out, out]
