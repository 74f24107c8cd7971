"""Meta-device dry run: count every (arch x shape x mesh) cell's program.

The counterpart of ``repro.launch.dryrun``.  For each cell this script:
  1. sets the cell's policy (dtypes, ZeRO stage, microbatches) from the
     card's memory (:func:`cell_policy`);
  2. builds the port's own program on ``meta`` tensors: one
     ``train.loop.make_train_step`` step for ``train`` shapes (AdamW
     moments in the policy's dtype), ``Model.prefill`` or
     ``Model.decode`` on ``input_specs`` tensors otherwise;
  3. runs it once under ``launch.op_analysis.CostMode``: FLOPs (aten
     formulas plus each kernel's own), op bytes and peak live bytes, the
     layer stack counted L times;
  4. records them per device, with the analytic per-device parameter
     bytes under the mesh's rules, and writes one JSON per cell under
     ``experiments/dryrun_torch/`` (not the reference's
     ``experiments/dryrun/``, which both packages' cluster energy models
     read).

It asks for no card and allocates nothing: ``meta`` tensors carry shapes
and dtypes only, and the kernel entries return their outputs' shapes
there.  The same ``build_cell`` runs on a real device
(``device="cuda"``): that is how ``chip_smoke.py`` holds the counts to a
step on the card.  On a mesh of more than one device the counted program
is rank 0's local step: its blocks of the parameters
(``params.param_local_shapes``) and of the batch
(``sharding.batch_shard``) under a counted mesh
(``ProcessMesh.counted``), on which ``models.parallel``'s collectives
count the bytes they would reduce and move none.  The record then holds
``collective_bytes`` (per mesh axis in ``coll_mix``) and ``wire_bytes``,
a ring all-reduce's ``2 (n - 1) / n`` of them, which ``roofline`` turns
into the collective term.  A placed run holds ZeRO stage 0 (ZeRO is not
ported), so the counted step does too whatever the policy's stage; the
analytic parameter bytes keep the policy's, and where that stage is above
0 the record's ``fits`` is None (not modelled), with ``fits_note``.  Where the policy asks for
microbatches, one microbatch's step is counted, plus the loss and
gradient of the other ``n - 1`` (their shapes are identical), and the
peak adds the accumulated float32 gradient.

Usage:
  python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh data=16,model=16]
      [--skip-done] [--tag T] [--override k=v]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Callable, NamedTuple

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import (batch_shard, effective_rules,
                                         make_parallel)
from repro_torch.models.api import Model, model_defs
from repro_torch.models.common import (ArchConfig, SHAPES, ShapeCfg,
                                       input_specs, materialize,
                                       supports_shape)
from repro_torch.models.params import (init_params, local_shape,
                                       param_specs, sharded_size_bytes,
                                       tree_map_defs)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.loop import TrainConfig, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

HBM_BYTES = 80e9               # H100 80GB device memory (data sheet)
ACT_SHARE = 6e9 / 16e9         # the reference's activation budget share
                               # of a device's memory (6 of 16 GB)


def dtype_of(name: str) -> torch.dtype:
    """``"float32"`` -> ``torch.float32`` (a policy's dtype strings)."""
    dt = getattr(torch, name.removeprefix("torch."), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# The policy keys the port reads (``build_cell``, ``run_cell`` and
# ``roofline.analytic_hbm_bytes``).  The reference's others (``kind``,
# ``scan_layers``, ``seq_shard``, ``moe_ep``, ``ar_barrier``) are recorded
# at its values and cannot be overridden: nothing here would act on them.
OVERRIDABLE = ("param_dtype", "moment_dtype", "zero_stage", "microbatches",
               "remat", "attn_block", "kv_seq_shard")


def check_overrides(overrides: dict) -> None:
    """Raise ``ValueError`` for an override the port would not read."""
    unknown = sorted(set(overrides) - set(OVERRIDABLE))
    if unknown:
        raise ValueError(f"policy overrides {unknown}: the port reads only "
                         f"{list(OVERRIDABLE)}")


def _shape_cfg(shape: str | ShapeCfg) -> ShapeCfg:
    return SHAPES[shape] if isinstance(shape, str) else shape


# ---------------------------------------------------------------------------
# Cell policy: dtypes, ZeRO stage, microbatches.
# ---------------------------------------------------------------------------

def cell_policy(cfg: ArchConfig, shape: str | ShapeCfg, mesh: MeshShape,
                overrides: dict, hbm_bytes: float = HBM_BYTES,
                act_budget: float | None = None) -> dict:
    """The reference's policy with the device's memory as a parameter
    (``hbm_bytes``; ``act_budget`` defaults to the reference's share of
    it): serving shards weights (ZeRO-3) only when bf16 weights under
    tensor parallelism pass 85% of a device; training splits the local
    batch into microbatches until the layer carries fit the budget.
    ``overrides`` may set only the keys in :data:`OVERRIDABLE`."""
    check_overrides(overrides)
    sc = _shape_cfg(shape)
    if act_budget is None:
        act_budget = ACT_SHARE * hbm_bytes
    kind = sc.kind
    n_param = cfg.param_count()
    policy = {
        "kind": kind,
        "param_dtype": "float32" if kind == "train" else "bfloat16",
        "zero_stage": 3 if kind == "train" else 0,
        "moment_dtype": "bfloat16" if n_param > 2e11 else "float32",
        "remat": "full",
        "attn_block": 2048,
        "scan_layers": True,
        "microbatches": 1,
        "seq_shard": False,
        "moe_ep": True,
        "ar_barrier": False,
        "kv_seq_shard": False,
    }
    if kind != "train":
        # Serving: TP-only unless bf16 weights don't fit a device.
        per_chip = sharded_size_bytes(
            tree_map_defs(lambda d: dataclasses.replace(d,
                                                        dtype=torch.bfloat16),
                          model_defs(cfg)),
            effective_rules(cfg, mesh), mesh.shape)
        if per_chip > 0.85 * hbm_bytes:
            policy["zero_stage"] = 3
    if kind == "train":
        data = 1
        for a in ("pod", "data"):
            data *= mesh.shape.get(a, 1)
        b_loc = max(sc.batch // data, 1)
        carry = cfg.n_layers * b_loc * sc.seq * cfg.d_model * 2.0
        micro = 1
        while carry / micro > act_budget and micro < b_loc:
            micro *= 2
        policy["microbatches"] = micro
    policy.update(overrides)
    return policy


# ---------------------------------------------------------------------------
# The cell's program.
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One cell's program: ``fn(*args)`` is the step; ``live`` the
    tensors it starts with (arguments and the model's parameters);
    ``loss`` one microbatch's loss and gradient (train, else None);
    ``micro`` the microbatches of a step."""
    fn: Callable
    args: tuple
    live: list
    loss: Callable | None
    micro: int
    model: Model
    opt_state: object


def _cast_defs(defs, dtype: torch.dtype):
    return tree_map_defs(
        lambda d: dataclasses.replace(
            d, dtype=dtype if d.dtype.is_floating_point else d.dtype), defs)


def _kind_shape(kind: str) -> str:
    return next(n for n, s in SHAPES.items() if s.kind == kind)


def build_cell(cfg: ArchConfig, shape: str | ShapeCfg, policy: dict,
               device: str | torch.device = "meta", seed: int = 0,
               mesh: MeshShape | None = None) -> Cell:
    """The cell's program on ``device``.  On ``meta`` the parameters and
    inputs are empty ``meta`` tensors; on a real device the weights are
    drawn from a ``torch.Generator`` seeded with ``seed`` and the inputs
    by ``materialize`` (so the step computes on finite numbers).  With a
    ``mesh`` of more than one device (``meta`` only), rank 0's local step
    on a counted mesh."""
    sc = _shape_cfg(shape)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    micro = int(policy["microbatches"]) if sc.kind == "train" else 1
    if sc.batch % micro:
        raise ValueError(f"batch {sc.batch} does not split into {micro} "
                         "microbatches")
    if micro > 1:
        sc = dataclasses.replace(sc, batch=sc.batch // micro)
    defs = _cast_defs(model_defs(cfg), dtype_of(policy["param_dtype"]))
    par = make_parallel(cfg, None, remat=str(policy["remat"]),
                        attn_block=int(policy["attn_block"]))
    if mesh is not None and mesh.size > 1:
        if dev.type != "meta":
            raise ValueError("a mesh's local step is counted on meta only")
        par = make_parallel(cfg, ProcessMesh.counted(mesh),
                            remat=par.remat, attn_block=par.attn_block)
        rules = par.effective_rules()
        defs = tree_map_defs(lambda d: dataclasses.replace(
            d, shape=local_shape(d, rules, par.mesh)), defs)
    if dev.type == "meta":
        params = param_specs(defs, dev)
        # Each key's block as a tensor of its own (a view would hold, and
        # count, the whole batch's storage).
        batch = {k: t.clone() for k, t in batch_shard(
            {k: torch.empty(s.shape, dtype=s.dtype, device=dev)
             for k, s in input_specs(cfg, sc).items()}, cfg, par).items()}
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_params(gen, defs)
        batch = materialize(cfg, _kind_shape(sc.kind), seq=sc.seq,
                            batch=sc.batch, seed=seed, device=dev)
    model = Model(cfg, params, par)
    live = list(model.parameters())
    if sc.kind == "train":
        opt_cfg = AdamWConfig(moment_dtype=dtype_of(policy["moment_dtype"]))
        step = make_train_step(model, TrainConfig(microbatches=1,
                                                  opt=opt_cfg))
        opt_state = adamw_init(dict(model.named_parameters()), opt_cfg)
        return Cell(step, (opt_state, None, batch), live, model.loss,
                    micro, model, opt_state)
    fn = model.prefill if sc.kind == "prefill" else model.decode
    return Cell(fn, (batch,), live, None, 1, model, None)


def count_cell(cell: Cell) -> tuple[dict, dict, op_analysis.CostMode]:
    """``(cost, memory, mode)`` of one step of ``cell``: the counted step,
    plus ``micro - 1`` more microbatches' loss and gradient; the peak adds
    the float32 gradient they accumulate into.  ``cost`` adds the
    collectives' ``collective_bytes`` and ``coll_mix`` (per axis)."""
    _, mode = op_analysis.count(cell.fn, *cell.args, live=cell.live)
    cost = op_analysis.cost_dict(mode)
    coll = op_analysis.collective_dict(mode)
    memory = op_analysis.memory_dict(mode)
    if cell.micro > 1:
        _, extra = op_analysis.count(cell.loss, cell.args[2],
                                     live=cell.live)
        for k in cost:
            cost[k] += (cell.micro - 1) * op_analysis.cost_dict(extra)[k]
        for axis, b in op_analysis.collective_dict(extra).items():
            coll[axis] = coll.get(axis, 0) + (cell.micro - 1) * b
        memory["temp_bytes"] += sum(4 * p.numel() for p in cell.live)
    cost["collective_bytes"] = float(sum(coll.values()))
    cost["coll_mix"] = coll
    return cost, memory, mode


def wire_bytes(coll_mix: dict, mesh: MeshShape) -> float:
    """The bytes a rank sends for ``coll_mix``'s all-reduces (bytes per
    axis) as rings: ``2 (n - 1) / n`` of each axis's bytes."""
    return float(sum(b * 2 * (mesh.shape[a] - 1) / mesh.shape[a]
                     for a, b in coll_mix.items()))


def _param_bytes(cfg: ArchConfig, dtype: torch.dtype, rules,
                 mesh: MeshShape) -> int:
    return sharded_size_bytes(_cast_defs(model_defs(cfg), dtype), rules,
                              mesh.shape)


# ---------------------------------------------------------------------------
# One cell end to end.
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str | ShapeCfg,
             mesh: MeshShape | None = None, overrides: dict | None = None,
             tag: str = "", hbm_bytes: float = HBM_BYTES) -> dict:
    """The cell's record.  ``shape`` is a shape name or a ``ShapeCfg``
    (recorded under ``shape_cfg``); ``mesh`` defaults to one card."""
    cfg = configs.get(arch)
    mesh = mesh or MeshShape.card()
    sc = _shape_cfg(shape)
    rec: dict = {"arch": arch, "shape": sc.name, "mesh": mesh.name,
                 "mesh_shape": mesh.shape, "tag": tag or "baseline",
                 "device": "meta"}
    if not isinstance(shape, str):
        rec["shape_cfg"] = dataclasses.asdict(sc)
    ok, reason = (supports_shape(cfg, sc.name) if sc.name in SHAPES
                  else (True, ""))
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    policy = cell_policy(cfg, sc, mesh, overrides or {}, hbm_bytes)
    rec["policy"] = {k: str(v) for k, v in policy.items()}
    t0 = time.time()
    try:
        cost, memory, _ = count_cell(build_cell(cfg, sc, policy,
                                                mesh=mesh))
        coll = cost.pop("coll_mix")
        devices = mesh.size
        rules = effective_rules(cfg, mesh, int(policy["zero_stage"]))
        rec["cost_total"] = {k: v * devices for k, v in cost.items()}
        rec["memory"] = memory
        rec["flops"] = cost["flops"]
        rec["bytes"] = cost["bytes"]
        if devices > 1:
            rec["local_step"] = ("rank 0's blocks at ZeRO stage 0 on a "
                                 "counted mesh; cost_total is it times "
                                 "the devices")
            rec["collective_bytes"] = cost["collective_bytes"]
            rec["coll_mix"] = coll
            rec["wire_bytes"] = wire_bytes(coll, mesh)
        rec["param_bytes_per_device"] = _param_bytes(
            cfg, dtype_of(policy["param_dtype"]), rules, mesh)
        if sc.kind == "train":
            rec["moment_bytes_per_device"] = 2 * _param_bytes(
                cfg, dtype_of(policy["moment_dtype"]), rules, mesh)
        peak = memory["argument_bytes"] + memory["temp_bytes"]
        stage = int(policy["zero_stage"])
        if devices > 1 and stage:
            # The counted step holds whole blocks (stage 0); the policy's
            # program shards them further over data.
            rec["fits"] = None
            rec["fits_note"] = (f"not modelled: the policy's ZeRO stage "
                                f"{stage} is not ported, and the counted "
                                "step is stage 0's")
        else:
            rec["fits"] = peak <= hbm_bytes
        rec["hbm_bytes"] = hbm_bytes
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 - cell failures are data
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def cell_path(arch: str, shape: str, mesh_name: str, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_name}{suffix}.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="data=1,model=1",
                    help="mesh axes and sizes, e.g. data=16,model=16 "
                         "(rank 0's local step is counted)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="policy override key=value (e.g. attn_block=4096)"
                         f"; keys: {', '.join(OVERRIDABLE)}")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")

    overrides: dict = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        overrides[k] = (int(v) if v.isdigit()
                        else v == "True" if v in ("True", "False") else v)
    try:
        check_overrides(overrides)
    except ValueError as e:
        ap.error(str(e))

    mesh = MeshShape.parse(args.mesh)
    os.makedirs(OUT_DIR, exist_ok=True)
    archs = [args.arch] if args.arch else list(configs.ALL_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            path = cell_path(arch, shape, mesh.name, args.tag)
            if args.skip_done and os.path.exists(path):
                continue
            rec = run_cell(arch, shape, mesh, overrides=overrides,
                           tag=args.tag)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            n_fail += status == "error"
            mem = rec.get("memory", {})
            extra = (f" flops/device={rec['flops']:.3e} peak "
                     f"{(mem['argument_bytes'] + mem['temp_bytes']) / 1e9:.1f}"
                     f" GB fits={rec['fits']}"
                     if status == "ok" else
                     f" {rec.get('reason', rec.get('error', ''))[:90]}")
            print(f"[{status:7s}] {arch:22s} {shape:12s} {mesh.name:10s}"
                  f" {rec.get('total_s', 0):7.1f}s{extra}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
