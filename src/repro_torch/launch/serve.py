"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the continuous-batching engine over synthetic prompts, at the
architecture's published width (``--reduced`` for the CPU-sized config)
with random weights drawn from seed 0, as the reference's are, on the card
unless ``--device cpu``.  Every architecture of ``configs`` serves: an
encdec model's encoder reads zero frames of the prompt's length, a
vision-stub model's prompt follows the engine's zero patch embeddings
(the KV horizon makes room for them).  The counterpart of
``repro.launch.serve``, whose ``--reduced`` cannot be turned off (ROADMAP
Queue 3), and of the reference's ``examples/serve_lm.py``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.models.api import build_model
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import frontend_tokens


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(model,
                      ServeConfig(batch_slots=args.slots,
                                  max_len=frontend_tokens(cfg)
                                  + args.prompt_len + args.max_new + 8,
                                  temperature=args.temperature),
                      device=args.device)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"arch={cfg.name} on {model.device}: served {len(done)} requests, "
          f"{n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:10]}")
    return done


if __name__ == "__main__":
    main()
