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

Over a mesh: under a fleet (``python -m tests.harness --processes P --
python -m repro_torch.launch.serve --mesh data=D,model=M ...``, D x M = P
ranks on gloo), each rank holds its shard of the model and its data
block of the lane pool (``serve.engine``); ``--kv-seq-shard`` cuts each
lane's KV window over ``model`` where the kv heads do not divide it.  The
reference's docstring names its production mesh, which its parser never
reaches.  Rank ``r`` runs on ``cuda:(r % device_count)`` (or
``--device``); rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, shard
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.launch.mesh import MeshShape, ProcessMesh
from repro_torch.launch.sharding import make_parallel
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
    ap.add_argument("--device", default=None,
                    help=f"default {DEFAULT_DEVICE}; on a mesh "
                         "cuda:(rank % device_count)")
    ap.add_argument("--mesh", default=None,
                    help="serve over a mesh of the fleet's ranks, e.g. "
                         "data=2,model=2")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="cut the KV window over model where the kv heads "
                         "do not divide it")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = None
    if args.mesh:
        shard.initialize_from_env()
        mesh = ProcessMesh.build(MeshShape.parse(args.mesh), args.device)
    par = make_parallel(cfg, mesh, kv_seq_shard=args.kv_seq_shard)
    device = mesh.device if mesh is not None else (args.device
                                                  or DEFAULT_DEVICE)
    model = build_model(cfg, device, par=par)
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
                      device=device)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    if mesh is None or mesh.rank == 0:
        where = f" mesh={mesh.shape}" if mesh is not None else ""
        print(f"arch={cfg.name} on {model.device}{where}: served "
              f"{len(done)} requests, {n_tok} tokens in {dt:.1f}s "
              f"({n_tok / dt:.1f} tok/s)")
        for r in done[:4]:
            print(f"  req {r.rid}: {r.out_tokens[:10]}")
    if mesh is not None:        # the ranks leave the groups together
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    return done


if __name__ == "__main__":
    main()
