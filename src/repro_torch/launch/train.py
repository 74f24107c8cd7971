"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains one architecture on the synthetic pipeline with AdamW, at its
published width (``--reduced`` for the CPU-sized config), random weights
from seed 0, on the card unless ``--device cpu``; remat is ``none`` for
the reduced config and ``full`` otherwise, as the reference picks.
Rerunning the same command with ``--ckpt-dir`` continues from the latest
checkpoint there.  The counterpart of ``repro.launch.train``, whose
``--reduced`` cannot be turned off (ROADMAP Queue 3; the port's is off by
default, as ``launch.serve``'s), and of the reference's
``examples/train_lm.py`` and ``examples/quickstart.py``.

Over a mesh: under a fleet (``python -m tests.harness --processes P --
python -m repro_torch.launch.train --mesh data=D,model=M ...``, D x M =
P ranks on gloo), each rank holds its shard of the model and of every
batch and writes its own checkpoint shard; ``--production-mesh`` is the
reference's 16 x 16 mesh (256 ranks; it raises on fewer, as the
reference's does).  Rank ``r`` runs on ``cuda:(r % device_count)`` (or
``--device``); rank 0 prints the log.
"""
from __future__ import annotations

import argparse

from repro_torch import configs, shard
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.launch.mesh import (MeshShape, ProcessMesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import make_parallel
from repro_torch.models.api import build_model
from repro_torch.models.common import ShapeCfg
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv: list[str] | None = None) -> Trainer:
    """Runs the command line ``argv``; returns the Trainer (its
    ``history``, state and model)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help=f"default {DEFAULT_DEVICE}; on a mesh "
                         "cuda:(rank % device_count)")
    ap.add_argument("--mesh", default=None,
                    help="train over a mesh of the fleet's ranks, e.g. "
                         "data=2,model=2")
    ap.add_argument("--production-mesh", action="store_true",
                    help="shard over the 16x16 mesh (needs 256 ranks)")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = None
    if args.mesh or args.production_mesh:
        shard.initialize_from_env()
        mesh = (make_production_mesh(device=args.device)
                if args.production_mesh else
                ProcessMesh.build(MeshShape.parse(args.mesh), args.device))
    par = make_parallel(cfg, mesh, remat="none" if args.reduced else "full")
    device = mesh.device if mesh is not None else (args.device
                                                  or DEFAULT_DEVICE)
    model = build_model(cfg, device, seed=0, par=par)
    tc = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, log_every=max(args.steps // 20, 1),
        compress_grads=args.compress_grads,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps))
    shape = ShapeCfg("cli", "train", args.seq, args.batch)
    tr = Trainer(model, tc, shape=shape, ckpt_dir=args.ckpt_dir)
    start = tr.resume()
    log = mesh is None or mesh.rank == 0
    if log:
        where = f" mesh={mesh.shape}" if mesh is not None else ""
        print(f"arch={cfg.name} params={cfg.param_count():,} "
              f"device={model.device}{where} remat={par.remat} "
              f"resumed_at={start}")
    for m in tr.run():
        if not log:
            continue
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}  "
              f"{m['sec']:.2f}s", flush=True)
    return tr


if __name__ == "__main__":
    main()
