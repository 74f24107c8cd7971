"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Trains one architecture on the synthetic pipeline with AdamW, at its
published width (``--reduced`` for the CPU-sized config), random weights
from seed 0, on the card unless ``--device cpu``; remat is ``none`` for
the reduced config and ``full`` otherwise, as the reference picks.
Rerunning the same command with ``--ckpt-dir`` continues from the latest
checkpoint there.  The counterpart of ``repro.launch.train``, whose
``--reduced`` cannot be turned off (ROADMAP Queue 3; the port's is off by
default, as ``launch.serve``'s), and of the reference's
``examples/train_lm.py`` and ``examples/quickstart.py``.  The reference's
``--production-mesh`` (a 16 x 16 TPU mesh) is not ported.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models.api import build_model
from repro_torch.models.common import ShapeCfg
from repro_torch.models.parallel import ParallelCfg
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
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    par = ParallelCfg(remat="none" if args.reduced else "full")
    model = build_model(cfg, args.device, seed=0, par=par)
    tc = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, log_every=max(args.steps // 20, 1),
        compress_grads=args.compress_grads,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps))
    shape = ShapeCfg("cli", "train", args.seq, args.batch)
    tr = Trainer(model, tc, shape=shape, ckpt_dir=args.ckpt_dir)
    start = tr.resume()
    print(f"arch={cfg.name} params={cfg.param_count():,} "
          f"device={model.device} remat={par.remat} resumed_at={start}")
    for m in tr.run():
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}  "
              f"{m['sec']:.2f}s", flush=True)
    return tr


if __name__ == "__main__":
    main()
