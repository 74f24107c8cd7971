"""Port vs reference: the sharding policy, the dry run and the roofline.

* ``ShardingRules``, ``param_pspecs``, ``sharded_size_bytes``,
  ``auto_rules`` and ``batch_pspecs`` (tuples vs ``PartitionSpec``) equal
  the reference's for all ten configs, every supported shape, on the
  16 x 16 and 2 x 16 x 16 meshes;
* ``cell_policy`` at the reference's constants (16 GB, 6 GB) equals the
  reference's, and ``analytic_hbm_bytes``, ``model_flops``,
  ``achieved_vs_roofline``, ``analyze``, ``to_markdown`` and
  ``pick_hillclimb_cells`` equal the reference's on the same records
  (the reference's module with the port's card constants patched in);
* ``launch.op_analysis``: a step counted on ``meta`` equals the same step
  counted on the CPU exactly (FLOPs and bytes), for reduced configs of
  every family; the kernels' ``meta`` routes and cost formulas;
* the MoE dispatch's repair (no ``bincount``, no boolean-mask scatter) is
  bitwise the code before it.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported (512 host
devices); the tests import it only after JAX's backend is up, and put the
variable back, so no later test in the worker sees 512 devices.
"""
import dataclasses
import json
import math
import os
import sys

import pytest
import torch

import jax

from repro import configs as j_configs
from repro.launch import roofline as j_roofline
from repro.launch.sharding import auto_rules as j_auto_rules
from repro.launch.sharding import batch_pspecs as j_batch_pspecs
from repro.models.api import model_defs as j_model_defs
from repro.models.common import supports_shape as j_supports_shape
from repro.models.params import param_pspecs as j_param_pspecs
from repro.models.params import sharded_size_bytes as j_sharded_size_bytes
from repro_torch import configs
from repro_torch.kernels import cost as kcost
import repro_torch.kernels.flash_attention  # noqa: F401 (the module)
from repro_torch.kernels import gate_quantile as gq
from repro_torch.kernels import schedule_eval as se
import repro_torch.kernels.ssd_scan  # noqa: F401 (the module)
from repro_torch.launch import dryrun, op_analysis, roofline
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import auto_rules, batch_pspecs
from repro_torch.models import moe
from repro_torch.models.api import model_defs
from repro_torch.models.common import SHAPES, ShapeCfg, supports_shape
from repro_torch.models.params import (ShardingRules, param_pspecs,
                                       param_specs, sharded_size_bytes,
                                       tree_leaves)

# the kernel modules (the package's names ``flash_attention`` and ``ssd_scan``
# are the entries)
fa = sys.modules["repro_torch.kernels.flash_attention"]
ssd = sys.modules["repro_torch.kernels.ssd_scan"]
MESHES = {False: MeshShape.production(), True: MeshShape.production(True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_dryrun():
    """``repro.launch.dryrun``, imported with JAX's backend already up and
    ``XLA_FLAGS`` restored after."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return j_dryrun


@pytest.fixture
def card_constants(monkeypatch):
    """The reference's roofline at the port's card constants."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(j_roofline, name, getattr(roofline, name))


def _canon(spec):
    """A spec as ``PartitionSpec`` holds it: a one-axis tuple is the
    axis name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _rules_tuple(r):
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in r.rules)


# ---------------------------------------------------------------------------
# Sharding rules, pspecs and sharded bytes.
# ---------------------------------------------------------------------------

def test_mesh_shapes_name_the_reference_meshes():
    assert MESHES[False].name == "pod16x16"
    assert MESHES[True].name == "pod2x16x16"
    for multi in (False, True):
        ref = j_roofline._MeshLike(multi)
        assert MESHES[multi].axis_names == ref.axis_names
        assert MESHES[multi].shape == ref.shape
        assert MeshShape.from_name(MESHES[multi].name) == MESHES[multi]
    assert MeshShape.parse("data=1,model=1") == MeshShape.card()
    assert MeshShape.card().name == "pod1x1" and MeshShape.card().size == 1
    with pytest.raises(ValueError):
        MeshShape.parse("data:1")


def test_default_rules_and_spec_match_reference():
    from repro.models.params import DEFAULT_RULES as J_RULES
    from repro_torch.models.params import DEFAULT_RULES
    assert DEFAULT_RULES.rules == J_RULES.rules
    for r, jr in ((DEFAULT_RULES.for_multipod(), J_RULES.for_multipod()),
                  (DEFAULT_RULES.replace(embed=("data",), heads=None),
                   J_RULES.replace(embed=("data",), heads=None))):
        assert r.rules == jr.rules
        for axes in (("embed", "heads", None), ("fsdp", "batch"),
                     ("vocab", "mlp"), ("expert", "expert_mlp", "embed")):
            assert _canon(r.spec(axes)) == tuple(jr.spec(axes))


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_sharding_matches_reference(arch, multi_pod):
    cfg, jcfg = configs.get(arch), j_configs.get(arch)
    mesh, jmesh = MESHES[multi_pod], j_roofline._MeshLike(multi_pod)
    defs, jdefs = model_defs(cfg), j_model_defs(jcfg)
    for stage in (0, 2, 3):
        r = auto_rules(cfg, mesh, stage)
        jr = j_auto_rules(jcfg, jmesh, stage)
        assert _rules_tuple(r) == _rules_tuple(jr), stage
        assert sharded_size_bytes(defs, r, mesh.shape) == \
            j_sharded_size_bytes(jdefs, jr, jmesh.shape)
        got = tree_leaves(param_pspecs(defs, r))
        want = jax.tree.leaves(
            j_param_pspecs(jdefs, jr),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [_canon(p) for p in got] == [tuple(p) for p in want]
    r = auto_rules(cfg, mesh)
    jr = j_auto_rules(jcfg, jmesh)
    for shape in SHAPES:
        if not supports_shape(cfg, shape)[0]:
            assert not j_supports_shape(jcfg, shape)[0]
            continue
        got = batch_pspecs(cfg, shape, mesh, r)
        want = j_batch_pspecs(jcfg, shape, jmesh, jr)
        assert {k: _canon(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, shape


def test_reference_divisibility_cases():
    """``tests/test_cluster_and_launch.py``'s cases on the port."""
    mesh = MESHES[False]
    r = auto_rules(configs.get("deepseek-67b"), mesh)
    assert r.mesh_axes("heads") == "model"
    assert r.mesh_axes("kv_heads") is None
    assert auto_rules(configs.get("llava-next-34b"),
                      mesh).mesh_axes("heads") is None
    r3 = auto_rules(configs.get("qwen3-moe-30b-a3b"), mesh, zero_stage=3)
    assert r3.mesh_axes("expert") == "model"
    assert r3.mesh_axes("embed") == ("data",)


def test_param_specs_are_meta_tensors():
    cfg = configs.get("kimi-k2-1t-a32b")       # 1.04 T parameters
    specs = param_specs(model_defs(cfg))
    leaves = tree_leaves(specs)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == sum(
        math.prod(d.shape) for d in tree_leaves(model_defs(cfg)))
    assert sharded_size_bytes(model_defs(cfg), ShardingRules(),
                              {"data": 1, "model": 1}) == \
        sum(t.numel() * t.element_size() for t in leaves)


# ---------------------------------------------------------------------------
# Cell policy and the roofline's arithmetic.
# ---------------------------------------------------------------------------

def _cells():
    for arch in configs.ALL_ARCHS:
        for shape in SHAPES:
            if supports_shape(configs.get(arch), shape)[0]:
                for multi in (False, True):
                    yield arch, shape, multi


def test_cell_policy_matches_reference_at_its_constants():
    j_dryrun = _ref_dryrun()
    for arch, shape, multi in _cells():
        got = dryrun.cell_policy(configs.get(arch), shape, MESHES[multi],
                                 {}, hbm_bytes=16e9, act_budget=6e9)
        want = j_dryrun.cell_policy(j_configs.get(arch), shape,
                                    j_roofline._MeshLike(multi), {})
        assert got == want, (arch, shape, multi)
    # the card's defaults: 80 GB and the same 6/16 share of it
    cfg = configs.get("hymba-1.5b")
    pol = dryrun.cell_policy(cfg, "train_4k", MeshShape.card(), {})
    carry = cfg.n_layers * 256 * 4096 * cfg.d_model * 2.0
    assert pol["microbatches"] == 4 and carry / 4 <= 30e9 < carry / 2


def _record(arch, shape, multi, policy, i):
    """A synthetic dry-run record: the reference's keys and the cell's
    reference policy, with made-up costs."""
    return {"arch": arch, "shape": shape, "status": "ok", "tag": "baseline",
            "mesh": MESHES[multi].name,
            "policy": {k: str(v) for k, v in policy.items()},
            "flops": 1e12 * (1 + i % 7) * (1 + 3 * multi),
            "bytes": 5e10 * (1 + i % 5),
            "wire_bytes": 2e9 * (i % 4),
            "memory": {"argument_bytes": 3e9 + 1e8 * i,
                       "temp_bytes": 2e9 + 1e7 * i},
            "coll_mix": {"all-reduce": 1e9}, "compile_s": 1.0}


def test_roofline_matches_reference_at_card_constants(card_constants):
    j_dryrun = _ref_dryrun()
    recs = []
    for i, (arch, shape, multi) in enumerate(_cells()):
        pol = j_dryrun.cell_policy(j_configs.get(arch), shape,
                                   j_roofline._MeshLike(multi), {})
        if i % 3 == 0:
            pol["kv_seq_shard"] = True
        recs.append(_record(arch, shape, multi, pol, i))
        assert roofline.model_flops(arch, shape) == \
            j_roofline.model_flops(arch, shape)
    rows, jrows = [], []
    for rec in recs:
        assert roofline.analytic_hbm_bytes(rec) == \
            j_roofline.analytic_hbm_bytes(rec), (rec["arch"], rec["shape"])
        got, want = roofline.analyze(rec), j_roofline.analyze(rec)
        assert got.pop("collective_modelled") is True
        assert got == want
        rows.append(roofline.analyze(rec))
        jrows.append(want)
    assert roofline.to_markdown(rows) == j_roofline.to_markdown(jrows)
    for mesh in ("pod16x16", "pod2x16x16"):
        got = roofline.pick_hillclimb_cells(rows, mesh)
        if mesh == "pod16x16":
            want = j_roofline.pick_hillclimb_cells(jrows)
            assert {k: (v["arch"], v["shape"]) for k, v in got.items()} == \
                {k: (v["arch"], v["shape"]) for k, v in want.items()}
    assert roofline.analyze({"status": "error"}) is None
    for flops, bytes_, warm in ((2 * roofline.PEAK_FLOPS,
                                 roofline.HBM_BW / 2, 4.0),
                                (1e9, 1e12, 1e-3), (0.0, 0.0, 0.0)):
        cost = {"flops": flops, "bytes": bytes_}
        assert roofline.achieved_vs_roofline(cost, warm) == \
            j_roofline.achieved_vs_roofline(cost, warm)


def test_achieved_vs_roofline_case():
    """``tests/test_obs.py``'s case at the card's constants."""
    cost = {"flops": 2 * roofline.PEAK_FLOPS, "bytes": roofline.HBM_BW / 2}
    out = roofline.achieved_vs_roofline(cost, warm_s=4.0)
    assert out["roofline_compute_s"] == pytest.approx(2.0)
    assert out["roofline_memory_s"] == pytest.approx(0.5)
    assert out["dominant"] == "compute"
    assert out["roofline_bound_s"] == pytest.approx(2.0)
    assert out["roofline_frac"] == pytest.approx(0.5)
    assert out["achieved_flops_per_s"] == pytest.approx(
        roofline.PEAK_FLOPS / 2)
    assert kcost.bound_s(2 * roofline.PEAK_FLOPS, 0) == (2.0, "operations")
    assert kcost.bound_s(0, roofline.HBM_BW) == (1.0, "bytes")


# ---------------------------------------------------------------------------
# op_analysis and the kernels' meta routes.
# ---------------------------------------------------------------------------

def test_cost_mode_counts_bytes_flops_and_live_storages():
    a = torch.ones(64, 32)
    b = torch.ones(32, 16)

    def fn(a, b):
        v = a.view(32, 64).t()               # a view: no bytes
        c = v.t().reshape(64, 32) @ b        # mm: 2*64*32*16 FLOPs
        d = c.sin()                          # transcendental
        del c
        return d.add_(1.0)                   # in place: its output aliases d

    out, mode = op_analysis.count(fn, a, b)
    assert mode.flops == 2 * 64 * 32 * 16
    assert mode.transcendentals == 64 * 16
    assert mode.ops["aten.view.default"][2] == 0
    assert mode.ops["aten.mm.default"][2] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert mode.ops["aten.add_.Tensor"][2] == 2 * 4 * 64 * 16
    assert mode.argument_bytes == 4 * (64 * 32 + 32 * 16)
    assert mode.peak_bytes == mode.argument_bytes + 2 * 4 * 64 * 16
    mem = op_analysis.memory_dict(mode)
    assert mem["output_bytes"] == 4 * 64 * 16 and mem["alias_bytes"] == 0
    _, mode = op_analysis.count(lambda x: x.mul_(2.0), a)
    assert op_analysis.memory_dict(mode)["alias_bytes"] == 4 * 64 * 32
    assert op_analysis.cost_dict(mode) == {
        "flops": 0.0, "bytes": float(2 * 4 * 64 * 32),
        "transcendentals": 0.0}


def _kernel_args(dev, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 70, 32, generator=g).to(dtype)
    kv = torch.randn(2, 2, 70, 32, generator=g).to(dtype)
    x = torch.randn(2, 70, 4, 16, generator=g).to(dtype)
    dt = torch.rand(2, 70, 4, generator=g)
    A = -torch.rand(4, generator=g)
    Bm = torch.randn(2, 70, 2, 8, generator=g).to(dtype)
    start = torch.randint(-3, 60, (3, 5, 7), generator=g, dtype=torch.int32)
    dur = torch.randint(0, 9, (3, 5, 7), generator=g, dtype=torch.int32)
    cum = torch.cumsum(torch.rand(3, 51, generator=g), 1)
    inten = torch.rand(6, 40, generator=g)
    window = torch.tensor([1, 5, 12, 40, 50, 0], dtype=torch.int32)
    args = {
        "flash_attention": (fa, (q, kv, kv.clone(), True, 16)),
        "ssd_scan": (ssd, (x, dt, A, Bm, Bm.clone(), 32)),
        "schedule_eval": (se, (start, dur, cum)),
        "gate_quantile": (gq, (inten, torch.full_like(inten, 0.3), window,
                               16)),
    }
    move = (lambda t: t.to(dev)) if dev != "cpu" else (lambda t: t)
    return {k: (m, tuple(move(a) if isinstance(a, torch.Tensor) else a
                         for a in xs)) for k, (m, xs) in args.items()}


ENTRIES = {"flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan,
           "schedule_eval": se.schedule_delta,
           "gate_quantile": gq.gate_quantile_stats}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_kernel_meta_route_and_cost(name):
    """On ``meta`` an entry returns its outputs' shapes and dtypes; under
    a count it adds its own cost formula once on every device and counts
    none of the plain version's ops on the CPU."""
    mod, cpu_args = _kernel_args("cpu")[name]
    _, meta_args = _kernel_args("meta")[name]
    cpu_out, cpu_mode = op_analysis.count(ENTRIES[name], *cpu_args)
    meta_out, meta_mode = op_analysis.count(ENTRIES[name], *meta_args)
    for c, m in zip(jax.tree.leaves(cpu_out), jax.tree.leaves(meta_out)):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (c.shape, c.dtype)
    flops, moved = mod.cost(*cpu_args)
    assert list(cpu_mode.ops) == [f"kernel:{mod.NAME}"]
    assert cpu_mode.ops[f"kernel:{mod.NAME}"] == [1, flops, moved]
    if name != "gate_quantile":
        assert meta_mode.ops == cpu_mode.ops
    else:      # meta has no window values: every row takes max_window
        assert meta_mode.bytes == moved and meta_mode.flops >= flops
    assert not op_analysis.CostMode().ops      # no count, no cost call
    with op_analysis.CostMode() as outer:      # nested counts: once each
        _, inner = op_analysis.count(ENTRIES[name], *cpu_args)
    assert outer.ops == inner.ops == cpu_mode.ops
    assert kcost.ACTIVE == []


def test_kernel_costs_are_the_table_bounds():
    """The cost formulas equal the bound arithmetic the kernel table used
    before it moved into the kernel modules (the card's numbers stay)."""
    args = _kernel_args("cpu")
    q, k, v, causal, window = args["flash_attention"][1]
    B, H, Sq, dh = q.shape
    i = torch.arange(Sq)
    live = torch.minimum(i + 1, torch.full_like(i, window or Sq))
    assert fa.cost(q, k, v, causal, window) == (
        4 * dh * int(live.sum()) * B * H, 2 * (2 * q.numel() + 2 * k.numel()))
    assert fa.cost(q, k, v, False, 0)[0] == 4 * dh * Sq * k.shape[2] * B * H
    for S_q, w in ((4096, 2048), (1824, 0), (416, 0), (5, 9)):
        ii = torch.arange(S_q)
        want = int(torch.minimum(ii + 1, torch.full_like(ii, w or S_q)).sum())
        assert fa.live_pairs(S_q, S_q, True, w) == want
    x, dt, A, Bm, Cm, chunk = args["ssd_scan"][1]
    Bsz, S, Hs, P = x.shape
    G, N = Bm.shape[2:]
    Q = min(chunk, S)
    full, rest = divmod(S, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    assert ssd.cost(x, dt, A, Bm, Cm, chunk) == (
        Bsz * (G * 2 * pairs * N + Hs * (2 * pairs * P + 4 * S * P * N)),
        2 * x.numel() * 2 + dt.numel() * 4 + 2 * Bm.numel() * 2
        + A.numel() * 4 + Bsz * Hs * P * N * 4)
    start, dur, cum = args["schedule_eval"][1]
    assert se.cost(start, dur, cum)[1] == start.numel() * 12 + cum.numel() * 4
    inten, theta, window, mw = args["gate_quantile"][1]
    _, _, n = gq.gate_quantile_stats(inten, theta, window, mw)
    R, E = inten.shape
    assert gq.cost(inten, theta, window, mw) == (
        2 * int(n.sum()), R * E * (4 + 4) + R * 4 + R * E * (4 + 4 + 4))


FAMILY_ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b",
                "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "whisper-base",
                "llava-next-34b"]


@pytest.mark.parametrize("kind,seq", [("train", 64), ("prefill", 64),
                                      ("decode", 64)])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_counts_equal_cpu_counts(arch, kind, seq):
    """One step of a reduced config counted on ``meta`` and on the CPU:
    FLOPs and bytes equal, op by op."""
    cfg = configs.get(arch).reduced()
    sc = ShapeCfg(kind, kind, seq, 2)
    policy = dryrun.cell_policy(cfg, sc, MeshShape.card(), {})
    meta = dryrun.count_cell(dryrun.build_cell(cfg, sc, policy))
    cpu = dryrun.count_cell(dryrun.build_cell(cfg, sc, policy, "cpu"))

    def costly(ops):          # ops that move bytes or do FLOPs
        return {k: v for k, v in ops.items() if v[1] or v[2]}
    assert costly(meta[2].ops) == costly(cpu[2].ops)
    assert meta[0] == cpu[0]
    for k in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert meta[1][k] == cpu[1][k]
    # The peaks differ a little: the CPU's adds the plain versions'
    # temporaries inside the kernel entries (meta allocates only the
    # kernels' outputs there), and autograd's engine may run independent
    # gradient nodes in another order on another device.  The card's
    # check holds them within 10% (chip_smoke.py phase 19).
    peak = {k: v[1]["argument_bytes"] + v[1]["temp_bytes"]
            for k, v in (("meta", meta), ("cpu", cpu))}
    if kind == "train":
        assert abs(peak["meta"] / peak["cpu"] - 1.0) <= 0.10, peak
    else:                     # one pass: no gradient nodes to reorder
        assert peak["meta"] <= peak["cpu"], peak


# ---------------------------------------------------------------------------
# The dry run end to end.
# ---------------------------------------------------------------------------

def test_run_cell_records(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--mesh", "data=16,model=16"]) == 0
    assert dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k"]) == 0
    assert dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                        "--tag", "t"]) == 0
    rec = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__pod16x16.json")
                     .read_text())
    # A mesh's record is rank 0's local step with its collectives counted.
    assert rec["status"] == "ok" and rec["fits"] is True
    assert "collective" not in rec and rec["collective_bytes"] > 0
    assert rec["collective_bytes"] == sum(rec["coll_mix"].values())
    assert rec["wire_bytes"] == pytest.approx(sum(
        b * 2 * 15 / 16 for b in rec["coll_mix"].values()))
    assert rec["flops"] == rec["cost_total"]["flops"] / 256
    cfg = configs.get("qwen1.5-0.5b")
    rules = dryrun.effective_rules(cfg, MESHES[False])
    assert rec["param_bytes_per_device"] == sharded_size_bytes(
        dryrun._cast_defs(model_defs(cfg), torch.bfloat16), rules,
        MESHES[False].shape)
    ok = json.loads((tmp_path / "mamba2-370m__long_500k__pod1x1.json")
                    .read_text())
    assert ok["status"] == "ok" and ok["fits"] is True
    skipped = json.loads(
        (tmp_path / "whisper-base__long_500k__pod1x1__t.json").read_text())
    assert skipped["status"] == "skipped" and skipped["reason"]
    rows = roofline.load_all("baseline", str(tmp_path))
    assert {r["mesh"] for r in rows} == {"pod16x16", "pod1x1"}
    # no collective term anywhere: no collective-bound pick
    picks = roofline.pick_hillclimb_cells(
        [roofline.analyze(ok), {**roofline.analyze(ok), "shape": "train_4k"}],
        "pod1x1")
    assert set(picks) == {"worst_roofline", "paper_representative"}
    md = roofline.to_markdown(rows)
    assert "not modelled" not in md and "mamba2-370m" in md
    row = next(r for r in rows if r["mesh"] == "pod16x16")
    assert row["collective_modelled"] and row["collective_s"] > 0


def test_overrides_take_only_keys_the_port_reads(capsys):
    """The reference's policy keys that nothing in the port reads are
    recorded, but an override of one is refused, by the API and the CLI;
    the sequence levers ``seq_shard`` and ``kv_seq_shard`` are read, and
    overridden."""
    cfg = configs.get("qwen1.5-0.5b")
    pol = dryrun.cell_policy(cfg, "train_4k", MeshShape.card(),
                             {"attn_block": 1024, "kv_seq_shard": True,
                              "seq_shard": True})
    assert pol["attn_block"] == 1024 and pol["seq_shard"] is True
    assert pol["kv_seq_shard"] is True
    for key in ("scan_layers", "moe_ep", "ar_barrier", "kind"):
        with pytest.raises(ValueError, match=key):
            dryrun.cell_policy(cfg, "train_4k", MeshShape.card(),
                               {key: True})
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-0.5b", "--override", "moe_ep=False"])
    assert e.value.code == 2 and "moe_ep" in capsys.readouterr().err


def test_train_cell_counts_microbatches():
    """A train cell the policy splits: one microbatch's step, plus the
    other microbatches' loss and gradient, plus the float32 accumulator
    at the peak."""
    cfg = configs.get("qwen1.5-0.5b").reduced()
    sc = ShapeCfg("train_4k", "train", 64, 8)
    pol = dryrun.cell_policy(cfg, sc, MeshShape.card(), {"microbatches": 4})
    cell = dryrun.build_cell(cfg, sc, pol)
    assert cell.micro == 4 and cell.args[2]["tokens"].shape == (2, 64)
    cost, mem, mode = dryrun.count_cell(cell)
    _, loss = op_analysis.count(cell.loss, cell.args[2], live=cell.live)
    assert cost["flops"] == mode.flops + 3 * loss.flops
    assert mem["temp_bytes"] == mode.peak_bytes - mode.argument_bytes + sum(
        4 * p.numel() for p in cell.live)


# ---------------------------------------------------------------------------
# The MoE repair: bitwise the code before it.
# ---------------------------------------------------------------------------

def _slots_before(ids, e_first, e_local, capacity):
    """``moe._slots`` before the repair (``torch.bincount``)."""
    N, k = ids.shape
    flat_e = ids.reshape(-1).to(torch.int64) - e_first
    tok = torch.arange(N).repeat_interleave(k)
    in_range = (flat_e >= 0) & (flat_e < e_local)
    le = torch.where(in_range, flat_e, e_local)
    order = torch.argsort(le, stable=True)
    counts = torch.bincount(le, minlength=e_local + 1)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(le)
    rank[order] = torch.arange(le.numel()) - first[le[order]]
    keep = in_range & (rank < capacity)
    dest = torch.where(keep, le * capacity + rank, e_local * capacity)
    return tok, dest, keep


def _dispatch_before(x2d, ids, wgt, w_in, w_out, e_local, capacity, act):
    """``moe._dispatch_compute`` before the repair (the boolean-mask
    scatter)."""
    N, D = x2d.shape
    k = ids.shape[1]
    tok, dest, keep = _slots_before(ids, 0, e_local, capacity)
    buf = torch.zeros((e_local * capacity + 1, D), dtype=x2d.dtype)
    buf[dest[keep]] = x2d[tok[keep]]
    out_buf = moe._expert_ffn(buf[:-1].reshape(e_local, capacity, D),
                              w_in, w_out, act)
    y_slot = out_buf.reshape(e_local * capacity, D)[
        torch.clamp_max(dest, e_local * capacity - 1)]
    y_slot = torch.where(keep[:, None], y_slot, 0) * wgt.reshape(-1)[:, None]
    y_slot = y_slot.to(x2d.dtype).reshape(N, k, D)
    y = torch.zeros_like(x2d)
    for j in range(k):
        y = y + y_slot[:, j]
    return y


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("factor", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_repair_is_bitwise(arch, factor, dtype):
    from repro_torch.models.layers import cast
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(configs.get(arch).reduced(),
                              capacity_factor=factor)
    g = torch.Generator().manual_seed(3)
    p = init_params(g, moe.moe_defs(cfg))
    x = torch.randn(3, 29, cfg.d_model, generator=g).to(dtype)
    x2d = x.reshape(-1, cfg.d_model)
    ids, wgt, probs = moe._route(x2d, p["router"], cfg.experts_per_token)
    cap = moe._capacity(x2d.shape[0], cfg.experts_per_token,
                        cfg.n_experts, factor)
    for e_first, e_local in ((0, cfg.n_experts), (2, 3)):
        got = moe._slots(ids, e_first, e_local, cap)
        want = _slots_before(ids, e_first, e_local, cap)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    y = moe._dispatch_compute(x2d, ids, wgt, cast(p["w_in"]),
                              cast(p["w_out"]), e_first=0,
                              e_local=cfg.n_experts, capacity=cap,
                              act=cfg.act)
    y0 = _dispatch_before(x2d, ids, wgt, cast(p["w_in"]), cast(p["w_out"]),
                          cfg.n_experts, cap, cfg.act)
    assert torch.equal(_bits(y), _bits(y0))
    fe = torch.bincount(ids.reshape(-1).long(),
                        minlength=cfg.n_experts).float()
    fe = fe / torch.clamp_min(fe.sum(), 1.0)
    aux0 = cfg.n_experts * torch.sum(probs.reshape(-1, cfg.n_experts)
                                     .mean(0) * fe)
    assert torch.equal(_bits(moe.aux_loss(probs, ids, cfg.n_experts)),
                       _bits(aux0))
