"""Roofline analysis over the dry run's records, at the card's constants.

The counterpart of ``repro.launch.roofline``.  Per (arch x shape x mesh)
cell, one NVIDIA H100 SXM per device:

    compute_s    = FLOPs_per_device / PEAK_FLOPS   (dense bf16)
    memory_s     = analytic_bytes_per_device / HBM_BW
    collective_s = wire_bytes_per_device / LINK_BW

FLOPs and op bytes come from ``launch.op_analysis`` (every aten op and
every kernel's own formula, the layer stack counted L times), per
device: on a mesh, rank 0's local step.  ``wire_bytes`` are the bytes a
rank sends for the all-reduces ``models.parallel`` counted in that step
(a ring's ``2 (n - 1) / n`` of them, per mesh axis), and ``LINK_BW`` is
NVLink 4's one-direction rate from the H100 SXM data sheet, not a
measured rate (the port's fleets on one card reduce through gloo's host
staging, far slower).  ``memory_hlo_s`` is the op bytes' time (unfused:
an overestimate); the bottleneck decision uses the analytic post-fusion
model, as the reference's does.

``MODEL_FLOPS`` is the useful-work floor: 6·N_active·tokens for training,
2·N_active·tokens for inference; its ratio to the counted FLOPs x devices
flags remat and dispatch waste.

The card's peak rates live in ``kernels.cost`` (a leaf module the kernel
entries import) and nowhere else; this module takes them from there: the
kernels' bounds (``chip_smoke.py``'s kernel table) and
:func:`achieved_vs_roofline` read the same numbers.

Usage:  python -m repro_torch.launch.roofline [--write-md] [--tag T]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch import configs
from repro_torch.kernels.cost import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.common import SHAPES, ShapeCfg

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


# ---------------------------------------------------------------------------
# Analytic post-fusion HBM model (the reference's): only the traffic that
# must cross device memory — parameter reads (per microbatch pass),
# gradient and optimizer state traffic, layer-boundary activations
# (written forward, read backward under full remat), and KV-cache reads.
# ---------------------------------------------------------------------------

def _mesh(rec: dict) -> MeshShape:
    if "mesh_shape" in rec:
        return MeshShape(tuple(rec["mesh_shape"]),
                         tuple(rec["mesh_shape"].values()))
    return MeshShape.from_name(rec["mesh"])


def _shape(rec: dict) -> ShapeCfg:
    if "shape_cfg" in rec:
        return ShapeCfg(**rec["shape_cfg"])
    return SHAPES[rec["shape"]]


def analytic_hbm_bytes(rec: dict) -> float:
    import dataclasses

    from repro_torch.launch.dryrun import dtype_of
    from repro_torch.launch.sharding import auto_rules
    from repro_torch.models.api import model_defs
    from repro_torch.models.common import input_specs
    from repro_torch.models.params import sharded_size_bytes, tree_map_defs

    cfg = configs.get(rec["arch"])
    sc = _shape(rec)
    pol = rec["policy"]
    mesh = _mesh(rec)
    msize = mesh.shape.get("model", 1)
    rules = auto_rules(cfg, mesh, zero_stage=int(pol["zero_stage"]))
    pdt = dtype_of(pol["param_dtype"])
    defs = tree_map_defs(
        lambda d: dataclasses.replace(
            d, dtype=pdt if d.dtype.is_floating_point else d.dtype),
        model_defs(cfg))
    p_chip = sharded_size_bytes(defs, rules, mesh.shape)

    data = mesh.shape["data"] * mesh.shape.get("pod", 1)
    b_loc = max(sc.batch // data, 1)
    micro = int(pol["microbatches"])
    layers = cfg.n_layers + cfg.n_encoder_layers

    # Per-device batch and cache bytes (sharded over the batch axes and,
    # for caches, kv-heads over model when divisible).
    kv_seq = pol.get("kv_seq_shard") in (True, "True")
    cache_chip = 0.0
    for k, s in input_specs(cfg, sc).items():
        n = 1
        for d in s.shape:
            n *= d
        bytes_ = n * s.dtype.itemsize
        if s.shape and s.shape[0] == sc.batch:
            bytes_ /= data
        elif len(s.shape) > 1 and s.shape[1] == sc.batch:   # [L, B, ...]
            bytes_ /= data
            if len(s.shape) > 3 and s.shape[3] == cfg.n_kv_heads and \
                    cfg.n_kv_heads % msize == 0:
                bytes_ /= msize
            elif kv_seq and k in ("k_cache", "v_cache") and \
                    s.shape[2] % msize == 0:   # window sharded over "model"
                bytes_ /= msize
        cache_chip += bytes_

    if sc.kind == "train":
        mdt = dtype_of(pol["moment_dtype"]).itemsize
        o_base = p_chip
        if int(pol["zero_stage"]) == 1:      # moments sharded over data
            o_base = sharded_size_bytes(
                defs, auto_rules(cfg, mesh, zero_stage=3), mesh.shape)
        o_chip = 2 * o_base / pdt.itemsize * mdt
        carry = layers * (b_loc / micro) * sc.seq * cfg.d_model * 2.0
        return (3.0 * micro * p_chip          # fwd+bwd+remat weight reads
                + 2.0 * micro * p_chip        # grad accum write+read (fp32)
                + 2.0 * (p_chip + o_chip)     # optimizer read+write
                + 2.0 * micro * carry         # layer carries (fwd w, bwd r)
                + cache_chip)
    if sc.kind == "prefill":
        act = layers * b_loc * sc.seq * cfg.d_model * 2.0
        return p_chip + act + cache_chip      # weights + stream + kv write
    # decode: weights once + cache read/write
    return p_chip + 2.0 * cache_chip


def model_flops(arch: str, shape) -> float:
    """6·N_active·tokens (train) or 2·N_active·tokens (prefill, decode);
    ``shape`` is a shape name or a ``ShapeCfg``."""
    cfg = configs.get(arch)
    sc = SHAPES[shape] if isinstance(shape, str) else shape
    n = cfg.active_param_count()
    if sc.kind == "train":
        return 6.0 * n * sc.batch * sc.seq
    tokens = sc.batch * (sc.seq if sc.kind == "prefill" else 1)
    return 2.0 * n * tokens


def achieved_vs_roofline(cost: dict, warm_s: float) -> dict:
    """Achieved vs roofline for one measured call.

    ``cost`` is :func:`repro_torch.launch.op_analysis.cost_dict` of the
    call; ``warm_s`` its measured warm wall-clock.  Returns the
    achieved-FLOP/s and achieved-bytes/s columns, and the roofline bound
    at the card's constants (``PEAK_FLOPS`` / ``HBM_BW``).
    ``roofline_frac`` is bound-time / measured-time: the fraction of the
    roofline achieved (the op bytes are unfused, so the memory term is an
    overestimate, as on the reference's CPU backend).
    """
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes", 0.0))
    warm_s = max(float(warm_s), 1e-12)
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_ / HBM_BW
    bound = max(compute_s, memory_s)
    return {
        "hlo_flops": flops,
        "hlo_bytes": bytes_,
        "achieved_flops_per_s": flops / warm_s,
        "achieved_bytes_per_s": bytes_ / warm_s,
        "roofline_compute_s": compute_s,
        "roofline_memory_s": memory_s,
        "roofline_bound_s": bound,
        "roofline_frac": bound / warm_s,
        "dominant": "compute" if compute_s >= memory_s else "memory",
    }


def analyze(rec: dict) -> dict | None:
    if rec.get("status") != "ok" or "flops" not in rec:
        return None
    mesh = _mesh(rec)
    chips = mesh.size
    compute_s = rec["flops"] / PEAK_FLOPS
    memory_hlo_s = rec["bytes"] / HBM_BW
    memory_s = analytic_hbm_bytes(rec) / HBM_BW
    coll_s = rec.get("wire_bytes", 0.0) / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    sc = _shape(rec)
    mf = model_flops(rec["arch"], sc)
    useful = mf / max(rec["flops"] * chips, 1.0)
    # Roofline fraction: useful-model-work time at peak vs. bound time.
    ideal_s = mf / chips / PEAK_FLOPS
    frac = ideal_s / max(bound, 1e-30)
    mem = rec.get("memory", {})
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", "baseline"),
        "compute_s": compute_s, "memory_s": memory_s,
        "memory_hlo_s": memory_hlo_s,
        "collective_s": coll_s, "dominant": dominant,
        "collective_modelled": chips == 1 or "wire_bytes" in rec,
        "step_s_bound": bound,
        "model_flops": mf, "hlo_flops_chip": rec["flops"],
        "useful_ratio": useful, "roofline_frac": frac,
        "mem_per_chip_gb": mem.get("argument_bytes", 0) / 1e9
        + mem.get("temp_bytes", 0) / 1e9,
        "arg_gb": mem.get("argument_bytes", 0) / 1e9,
        "temp_gb": mem.get("temp_bytes", 0) / 1e9,
        "coll_mix": rec.get("coll_mix", {}),
        "compile_s": rec.get("compile_s", 0),
    }


def load_all(tag: str | None = None, directory: str = DRYRUN_DIR
             ) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if tag is not None and rec.get("tag", "baseline") != tag:
            continue
        a = analyze(rec)
        if a is not None:
            out.append(a)
    return out


def hint(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_ratio"] < 0.5:
            return ("compute-bound with low useful ratio: cut remat "
                    "recompute or dead attention FLOPs")
        return "compute-bound near the useful floor: good place to be"
    if d == "memory":
        return ("HBM-bound: raise arithmetic intensity (bigger batch/"
                "fusion) or shrink weight traffic (quantize, cache-resident"
                " tiles)")
    return ("collective-bound: reshard to cut gather/reduce volume or "
            "overlap collectives with compute")


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | hlo_mem_s | "
           "collective_s | bound | MODEL_FLOPS | useful | roofline | "
           "mem/chip GB | next lever |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        coll = (f"{r['collective_s']:.3e}"
                if r.get("collective_modelled", True) else "not modelled")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['memory_hlo_s']:.3e} "
            f"| {coll} | {r['dominant']} "
            f"| {r['model_flops']:.2e} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_frac']:.2f} "
            f"| {r['mem_per_chip_gb']:.1f} | {hint(r)} |")
    return hdr + "\n".join(lines) + "\n"


def pick_hillclimb_cells(rows: list[dict], mesh: str = "pod16x16"
                         ) -> dict[str, dict]:
    """worst roofline fraction / most collective-bound / paper-representative
    (the biggest train cell) among ``mesh``'s rows, long_500k aside; no
    most collective-bound cell where no row has a collective term (one
    card, or records without wire bytes)."""
    pod = [r for r in rows if r["mesh"] == mesh
           and r["shape"] != "long_500k"]
    picks = {"worst_roofline": min(pod, key=lambda r: r["roofline_frac"])}
    if any(r["collective_s"] > 0 for r in pod):
        picks["most_collective"] = max(
            pod, key=lambda r: r["collective_s"]
            / max(r["step_s_bound"], 1e-30))
    train = [r for r in pod if r["shape"] == "train_4k"]
    picks["paper_representative"] = max(train, key=lambda r: r["model_flops"])
    return picks


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write-md", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--mesh", default="pod1x1",
                    help="the mesh whose cells the hillclimb picks read")
    args = ap.parse_args(argv)
    rows = load_all(args.tag)
    print(to_markdown(rows))
    if any(r["mesh"] == args.mesh and r["shape"] == "train_4k"
           for r in rows):
        for name, r in pick_hillclimb_cells(rows, args.mesh).items():
            print(f"{name}: {r['arch']} x {r['shape']} (dominant="
                  f"{r['dominant']}, roofline={r['roofline_frac']:.2f}) — "
                  f"{hint(r)}")
    if args.write_md:
        out = os.path.join(DRYRUN_DIR, "roofline.md")
        with open(out, "w") as f:
            f.write(to_markdown(rows))
        print("wrote", os.path.abspath(out))


if __name__ == "__main__":
    main()
