#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself and
imports only ``repro_torch``).  Phases, each of which ends the run with a
non-zero exit code if it fails:

1. card and build — CUDA must be present; prints the card's name and power
   limit and builds every CUDA kernel from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together; the model kernels' SASS
   must hold ``HGMMA`` and ``UTMALDG`` (attention) and ``HMMA`` (SSD);
2. kernels — each kernel's wrapper against its plain PyTorch version on the
   card, bitwise (bit patterns, so -0.0 != +0.0): ``schedule_delta`` at the
   main path's shape, a ragged shape, overrunning starts, unaligned
   instance slices (P*T = 35), one instance over 257 blocks (B=1,
   P*T >= 2**20), a horizon beyond shared memory (H = 60000) and views
   not 16-byte aligned; ``gate_quantile`` at the online sweep's shape
   (6000 rows x 768 epochs), a ragged shape (max_window 200 > 128, ties),
   an edge shape (theta 0 and 1, window 1, E < window), and the sliding
   kernel's edges (segment boundaries inside hourly rows, max_window 256
   and 257 on each side of the register / shared-memory split, a
   1000-slot window, -0.0/+0.0 ties, an all-equal trace, thetas outside
   [0, 1]; these also held to the plain version on the CPU).  Times the
   main shapes (and the gate's ragged and edge shapes) with CUDA events
   (L2 flushed) beside each kernel's bound and a one-call library
   yardstick where there is one;
3. main path — ``repro_torch.bench.run_batch`` on the paper's default cell
   (n=10 jobs x k=4 tasks, M=5 homogeneous, AU-SA, S=1, carbon objective,
   1500-epoch windows, SA pop 96 x 150 iterations) at 1000 instances, with
   the launch counts read around it; every schedule must be validator-clean
   and every saving >= 0;
4. online path — ``repro_torch.bench.run_online`` (the online cell without
   its bound) at 1000 instances x 12 gate policies x 768 epochs, with the
   launch counts read around it: ``gate_quantile`` launched once, every
   greedy and gated row fully scheduled and validator-clean, the first 16
   instances equal to the numpy oracle in all 16 x 13 cells and to the
   port run on the CPU;
5. layers — where the main path's time goes, per layer, with CUDA events,
   and the device's busy share over one fitness evaluation from
   ``torch.profiler``;
6. reference — the same small solve on the card and on the CPU, fed the
   same random draws, must agree;
7. model kernels — ``flash_attention`` (bf16 on wgmma with TMA-staged
   K/V; float32 on FFMA) and ``ssd_scan`` (chunk states, the carry over
   chunks and the outputs, on mma.sync) against their plain versions on
   the card (allclose: both reassociate) at hymba-1.5b's prefill shapes, a
   ragged length (S=777) and the other family's shapes (qwen1.5-0.5b's
   full causal attention, mamba2-370m's SSD), and against the naive
   oracles at one small shape; each timed (CUDA events, L2 flushed) beside
   its bound, its plain version and, for attention,
   ``scaled_dot_product_attention``, with attention's achieved TFLOP/s and
   the SSD's three kernels' times from one profiled run of 10 calls;
8. serve — hymba-1.5b at its published width (1.642 B parameters, random
   weights from seed 0) serves 8 offline-inference requests of 2-4k
   tokens through ``repro_torch.serve.ServeEngine`` (4 lanes, greedy,
   32 new tokens each), with the launch counts read around it: every
   request done with 33 tokens, all logits finite, each kernel launched
   once per layer per prefill (256);
9. serve reference — hymba at full width cut to 2 layers, the same weights
   on the card and on the CPU: prefill and 4 decode steps allclose;
10. forecast kernels — ``gate_quantile`` at the rolling gate's shape
    (1000 instances x 3 seeds x 22 issues x 512 epochs, window 96, theta
    0.3) and ``schedule_delta`` at the MPC's (2000 (instance, seed) rows,
    each with its own forecast ``cum`` of 513), bitwise against their
    plain versions, timed;
11. forecast path — ``repro_torch.bench.run_forecast`` (the
    forecast-robustness cell: day-ahead gate, rolling gate and MPC
    replanner at scales 0/0.5/1 x every 24/48/96, the perfect gate and the
    offline bound) at 1000 instances, with the launch counts read around
    it: every schedule complete and validator-clean; at scale 0 the
    rolling and day-ahead masks equal ``dirty_mask`` on the truth, bitwise,
    and the card's equal the CPU's on 8 instances; every MPC replan keeps
    its frozen prefix, meets its deadline and, at scale 0, never ends above
    its baseline;
12. structure path — the structure sweep's full grid (60 cells x 16 =
    960 instances, horizon 2048, with the offline SA bound), launch counts
    read around it, then the dispatch-only TINY grid on the card against
    ``tests/golden/structure_tiny.json``;
13. stream — ``gate_quantile`` at the stream engine's two shapes (the
    day-ahead gate ``[1, 1216]`` and the banded gate ``[51, 1216]`` over
    the FULL poisson cell's AU-SA window, window 96, theta 0.5) bitwise
    and timed; both TINY stream goldens on the card; the TINY grid's
    bursty cell at load 1.2 in both fleet modes, card against CPU (event
    logs: ints exact, each job's carbon within rtol 1e-6); then three
    cells at the stream bench's FULL knobs (horizon 1024, 8 lanes,
    layered 3 x 3 jobs, 3 tiered machines, load 0.9, seed 2024) —
    poisson partitioned, bursty on the shared fleet, poisson with the
    forecast-banded gate (every 24, scale 1) — through
    ``bench.run_stream_cell``, launch counts read around each:
    ``gate_quantile`` once per engine, every finished schedule
    validator-clean (the engine's check and ``check_feasible_np``), no
    cross-lane overlap on the shared fleet, the two day-ahead cells'
    counts, queue delays and savings equal to the reference harness's
    cells in ``BENCH_stream.json``, and the banded cell's event log equal
    to the same cell's on the CPU (as the TINY cell is held); then one
    pool tick in each fleet mode and one admission solve under
    ``torch.profiler``;
14. learn — the gate-policy learner: ``ops.gate_threshold`` at the
    ``learned_gate`` FULL grid's gate shape (240 rows x 2048 epochs,
    window 48, per-epoch theta from a seeded raw) against the plain
    sorted-window path on the same card tensors, thresholds and the
    gradient of a weighted sum in theta bitwise, the launch timed beside
    its bound; the tiny golden training run on the card against
    ``tests/golden/learn_tiny.json`` at its tolerances (one
    ``gate_quantile`` launch a step); then ``bench.run_learned_gate``'s
    FULL grid (60 cells x 4 instances, horizon 2048, both stretches) cut
    to 2 training steps a stretch, launch counts read around it
    (``gate_quantile`` once for the fixed sweep, once a step, once a hard
    evaluation): every schedule complete and validator-clean, learned >=
    fixed everywhere, the fixed-grid fields equal to ``BENCH_learn.json``'s
    within its rounding; each step's wall, and one training step under
    ``torch.profiler`` (the card's kernels only);
15. cluster — ``schedule_delta`` at the cluster executor's shapes (the
    flagship day of seed 3: one instance, a plan's [64, T] and a
    re-solve's [32, T] populations, H = 2000) bitwise and timed; then
    ``bench.run_cluster`` (the flagship scenario of
    ``examples/cluster_sim.py``) cut to two days, seeds 3-4, launch counts
    read around it (``schedule_eval`` in every plan's and re-solve's phase
    2): every plan validator-clean, the clean run equal to the plan's
    makespan and within rel 1e-3 of its carbon, the failure run one
    re-solve (validated in-line) within twice the plan's makespan, the
    straggler run no re-solve and under three times the plan's makespan,
    and at least one of the two straggler runs a speculative copy (a copy
    needs an idle machine at the time, which depends on the plan); one
    plan under
    ``torch.profiler``; and seed 3's day on the CPU and on the card, both
    fed the CPU generator's draws: the same plan, the three reports' ints
    equal and floats within rtol 1e-6;
16. shard — the shard layer (``repro_torch.shard``), each phase's wall
    printed beside the unsharded one: ``RowDraws`` at the structure
    cell's SA shapes (``[960, 24, 74]`` and ``[960, 24, 74, 8]``), every
    draw kind's rows 0:480 drawn alone bitwise the full draw's, the
    integer kinds bitwise the CPU's, each draw timed beside
    ``TorchDraws``'s; the FULL structure batch's offline bound through
    ``bilevel_sharded`` at 2 shards on the one card, every field bitwise
    the unsharded bound's, whose per-cell means are the structure path's
    rows; the dispatch-only TINY grid at 3 shards against the unsharded
    rows and the golden; the learn TINY golden run through
    ``train_sharded`` / ``eval_theta_sharded`` at 2 shards against the
    unsharded run and the golden; then a 2-process fleet on the one card
    (this script run as ``--fleet-worker``, ranks spawned in reversed
    order with the ``REPRO_*`` env, gloo) sweeping the TINY grid with the
    offline bound, every rank's rows equal to one process's.  Launch
    counts read around each sharded run;
17. families — the moe, encdec and vlm families at inference:
    (a) ``flash_attention`` at their shapes (bf16) against its plain
    version, timed (L2 flushed, median of 20) beside its bound and
    ``scaled_dot_product_attention`` (``is_causal``): whisper's encoder
    ``[1, 8, 1500, 64]`` and its cross attention (448 queries against
    1500 frames), both non-causal, qwen3-moe's causal prefill
    ``[1, 32, 4096, 128]`` on 4 kv heads and llava's ``[1, 56, 3904,
    128]`` on 8; (b) whisper-base at full width and depth (prompts of 448
    tokens), then qwen3-moe-30b-a3b and llava-next-34b at full width cut
    to 8 layers (prompts of 1024-2048 tokens; llava's after 8 zero
    patches), 8 requests each through ``ServeEngine`` as in phase 8, with
    18 ``flash_attention`` launches a whisper prefill (6 encoder, 6
    decoder, 6 cross) and one a layer for the other two, each run's
    tokens/s, walls, peak memory and busy shares; (c) the same weights on
    the card and on the CPU (whisper-base whole, qwen3-moe at full width
    and 2 layers, llava at full width, 1 layer and 8 patches, kimi-k2
    reduced): a short prompt, prefill and 4 decode steps allclose at
    3e-2, the MoE routes compared layer by layer (a flip only at a near
    tie, |p_a - p_b| <= 1e-6, and counted);
18. train — (a) hymba-1.5b at full width and depth (1.642 B parameters,
    f32 with f32 AdamW moments) trains 6 steps at seq 4096 x batch 2
    (the reference's ``train_4k`` sequence; its batch of 256 cut so one
    card holds it), remat full, through ``repro_torch.launch.train``:
    every loss and grad norm finite, the last loss below the first, each
    model kernel launched exactly 64 times a step (twice a layer: the
    forward and the remat recompute) and the plain versions called only
    in autograd's backward, once a layer; s a step, tokens/s, peak
    memory, one step split into forward, backward (of which the plain
    recompute of attention and of the scan) and optimizer, and one step's
    busy share; then, at full width cut to 8 layers (5.4 GB checkpoints),
    6 uninterrupted steps and the same 6 steps with a checkpoint every 3,
    a preemption as step 4 starts and a fresh Trainer resumed from the
    latest complete checkpoint, its final loss within rel 1e-3 of the
    uninterrupted run's; (b) whisper-base at full width and depth, two
    steps at seq 448 x batch 4 (the encoder's and the cross attention
    through the trainable entry; 36 launches a step); (c) the same
    weights and batch on the card and on the CPU — hymba at full width
    cut to 2 layers (seq 512), reduced qwen1.5-0.5b, mamba2-370m,
    qwen3-moe-30b-a3b, whisper-base and llava-next-34b (seq 128): the
    loss within 3e-2, every gradient leaf within relative Frobenius 5e-2
    (the worst printed), the parameters after one AdamW step allclose at
    3e-2; (d) both kernels at the train shapes (batch 2 x 4096) against
    their plain versions, timed beside their bounds, the plain versions,
    SDPA with the window mask, and the trainable entries' backward;
19. dryrun — the meta-device dry run (``launch.dryrun``) against the
    card: phase 18's cell (hymba-1.5b at full width and depth, seq 4096 x
    2, remat full), one step counted by ``launch.op_analysis`` on
    ``meta`` and on the card, FLOPs and bytes equal (the ops that differ
    printed if not), parameter and moment bytes equal to the dry run's,
    the meta peak within 10% of ``max_memory_allocated`` (64 launches of
    each model kernel counted); a warm step's achieved vs roofline; then
    qwen3-moe-30b-a3b decode_32k on ``meta`` alone: status ok, and it
    does not fit the card; and the kernel entries' cost hook timed with
    nothing counting;
20. probe — ``perf.perf_probe`` on the card: the four pinned cells
    (dispatch sweep, gate learner, fitness, gate) timed cold and warm,
    each roofline column finite; the record passes
    ``perf_gate.check_provenance``; the verdict against the committed
    ``torch_perf_baseline.json`` is printed, not acted on;
21. mesh — the model over a placed mesh: ``torch.distributed`` ranks on
    gloo that share the one card (this script spawned as
    ``--mesh-worker``), each holding its block of every sharded weight
    and batch, talking only through ``models.parallel``'s all-reduces:
    (a) reduced qwen3-moe's loss and gradients on a ``data=2, model=2``
    fleet on the card against the same fleet on the CPU (every rank the
    same loss; loss 5e-3, each leaf 3e-2); (b) qwen3-moe-30b-a3b at full
    width and 8 layers over ``model=4`` (experts, heads and vocabulary
    split): a prefill of 2 x 1024 tokens and 16 decode steps, the logits
    within 3e-2 of one card's on the same weights, and, as in phase 17,
    rank 0's router inputs of every call through one card's router: the
    ids equal but at ties within 1e-6; (c) hymba-1.5b at full width and
    depth over ``model=2`` (the SSM, MLP and vocabulary split, the 25 heads
    replicated): one loss and gradient and one train step at seq 1024 x 2
    through both trainable entries, against one card's (loss 3e-2, each
    gradient leaf 5e-2, 64 launches of each kernel a rank), and a float32
    witness of the loss and gradient on both sides (mesh vs one card
    5e-3; each bf16 run's distance to it, the mesh's within twice one
    card's plus 5e-3); each
    rank's walls, peak memory, launches and all-reduce calls, bytes and
    seconds printed.

Every kernel bound comes from the kernel module's own ``cost`` formula at
the card's rates (``kernels.cost``).  A line gives each phase's seconds.
The last four lines are each kernel's launches on each path, the
``kernels`` JSON record (launches:
the main path's, the dry run's and the probe's; ``gate_quantile``'s the
online path's and the probe's; ``flash_attention``'s the serve path's,
the families', the train path's, the dry run's and the mesh ranks';
``ssd_scan``'s the serve path's, the train path's, the dry run's and the
mesh ranks'), the card's name and power limit, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

INSTANCES = 1000                # the paper's batch size
KERNEL_REPS = 20
ORACLE_INSTANCES = 16           # online cells held to the numpy oracle
FLASH_TOL = 2e-2                # bf16 attention: max |diff|, and rtol
FLASH_ATOL = 5e-3               # ... atol, below its outputs' typical 0.03
SSD_TOL = 3e-2                  # bf16 SSD y, atol = rtol
BF16_ULP = 2.0 ** -7            # one bf16 ulp of |v| is at most this x |v|
ULP_ATOL = 1e-3                 # SSD y: within one ulp of the plain's, or this
STATE_TOL = 3e-4                # SSD h_final (float32), atol = rtol
SERVE_REQUESTS = 8
SERVE_SLOTS = 4
SERVE_NEW = 32
SERVE_REF_TOL = 3e-2            # card vs CPU logits, atol = rtol


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def same_bits(x, y) -> bool:
    """Equal shape, dtype and bit patterns (torch.equal takes -0.0 ==
    +0.0)."""
    import torch
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.is_floating_point():
        x, y = x.view(torch.int32), y.view(torch.int32)
    return torch.equal(x, y)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_ops(lib: str, nvcc: str, ops: tuple) -> dict:
    """How many instructions of each opcode in ``ops`` the library's
    machine code (``cuobjdump --dump-sass``, beside ``nvcc``) holds."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    return {op: sum(f" {op}" in line for line in out.splitlines())
            for op in ops}


def time_cuda(fn, reps: int, flush=None) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between two CUDA
    events, after two warm-up runs; ``flush()`` runs before each."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def l2_flush(dev):
    """A function that evicts the 50 MB L2 by writing 200 MB."""
    import torch
    scratch = torch.empty(200 * 2**20, dtype=torch.uint8, device=dev)
    return scratch.zero_


def kernel_bound(kernel, *args) -> tuple[float, str, int]:
    """``(ms, bound_by, bytes)``: the least time the card could take for
    one call of ``kernel`` (a module of ``repro_torch.kernels``) on
    ``args``, from the kernel's own ``cost`` formula at its peak rate and
    the card's memory rate (``kernels.cost``)."""
    from repro_torch.kernels.cost import bound_s
    flops, moved = kernel.cost(*args)
    seconds, by = bound_s(flops, moved, kernel.PEAK_FLOPS)
    return seconds * 1e3, by, moved


def kernel_phase(dev) -> dict:
    """schedule_delta vs schedule_delta_ref, bitwise, and their times."""
    import torch
    from repro_torch.kernels import schedule_eval
    from repro_torch.kernels.ref import schedule_delta_ref
    from repro_torch.kernels.schedule_eval import schedule_delta

    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def case(B, P, T, H, lo, hi):
        start = torch.randint(lo, hi, (B, P, T), generator=g, device=dev,
                              dtype=torch.int32)
        dur = torch.randint(0, 60, (B, P, T), generator=g, device=dev,
                            dtype=torch.int32)
        inten = torch.rand((B, H), generator=g, device=dev) * 400.0
        cum = torch.zeros((B, H + 1), device=dev)
        cum[:, 1:] = torch.cumsum(inten * 0.25, dim=1)
        return start, dur, cum

    shapes = {
        "main": (INSTANCES, 96, 40, 1500, 0, 1400),
        "ragged": (7, 13, 37, 333, 0, 300),
        "overrun": (5, 9, 11, 100, -150, 260),
        "unaligned": (3, 5, 7, 200, 0, 210),        # P*T = 35
        "split": (1, 256, 4100, 1500, -20, 1520),   # P*T >= 2**20
        "long": (3, 17, 19, 60000, -100, 60100),    # H+1 > shared memory
        "offset": (3, 7, 9, 50, -5, 60),            # views 4 bytes in
    }
    max_err = 0.0
    for name, shape in shapes.items():
        start, dur, cum = case(*shape)
        if name == "offset":
            buf = torch.empty(start.numel() + 1, dtype=torch.int32,
                              device=dev)
            buf[1:] = start.reshape(-1)
            start = buf[1:].view(start.shape)
        out = schedule_delta(start, dur, cum)
        ref = schedule_delta_ref(start, dur, cum)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        check(same_bits(out, ref),
              f"schedule_delta != schedule_delta_ref at the {name} shape "
              f"{shape[:4]} (max |diff| {err})")
        print(f"kernel schedule_delta {name} {tuple(shape[:4])}: bitwise "
              "equal to the plain version", flush=True)

    start, dur, cum = case(*shapes["main"])
    flush = l2_flush(dev)
    ms = time_cuda(lambda: schedule_delta(start, dur, cum), KERNEL_REPS,
                   flush)
    plain_ms = time_cuda(lambda: schedule_delta_ref(start, dur, cum),
                         KERNEL_REPS, flush)
    bound_ms, bound_by, moved = kernel_bound(schedule_eval, start, dur, cum)
    print(f"kernel schedule_delta main shape: {ms:.4f} ms (L2 flushed), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({moved / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
    print_device_ms("schedule_delta main shape",
                    lambda: schedule_delta(start, dur, cum), "schedule_delta")
    return {"name": "schedule_delta", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/schedule_eval.cu",
            "replaces": "src/repro/kernels/schedule_eval.py:76",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def gate_cases(dev) -> dict:
    """gate_quantile inputs ``(intensity, theta, window, max_window)``.

    main: the online sweep's gate rows — the 1000 paper forecasts of
    ``bench.online_batch`` x thetas 0.3/0.4/0.5 x windows 48/96, laid out
    as ``sweep_policies`` lays them out; ragged: 7 rows x 257 epochs,
    windows up to max_window 200 > 128, per-epoch thetas, ties injected;
    edge: theta 0 and 1, window 1, and windows wider than E; then the
    sliding kernel's edges (check only, not timed): segment boundaries
    inside hourly rows of 300 epochs; max_window 256 and 257, each side of
    the register / shared-memory split; a 1000-slot window over 1500
    epochs; -0.0/+0.0 ties; an all-equal trace; thetas outside [0, 1].
    """
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers import online_torch

    _, _, inten, _ = bench.online_batch(
        bench.BenchSetup(stretch=1.5, instances=INSTANCES), dev)
    rows = online_torch.gate_rows(
        inten, torch.tensor(bench.ONLINE_THETAS, device=dev),
        torch.tensor(bench.ONLINE_WINDOWS, dtype=torch.int32, device=dev))
    E = inten.shape[-1]
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    ragged = torch.rand((7, 257), generator=g) * 800 + 50
    ragged[:, ::5] = ragged[:, :1]
    edge = torch.rand((4, 40), generator=g) * 800 + 50

    def sliding(E, max_window, windows, kind="hourly"):
        R = len(windows)
        hours = torch.rand((R, -(-E // 4)), generator=g) * 800 + 50
        x = hours.repeat_interleave(4, dim=1)[:, :E].contiguous()
        if kind == "zeros":
            x = torch.where(torch.rand((R, E), generator=g) < 0.5, -0.0, 0.0)
            x[torch.rand((R, E), generator=g) < 0.2] = 1.0
        elif kind == "flat":
            x = torch.full((R, E), 371.25)
        th = torch.rand((R, E), generator=g)
        th[:, ::7] = 0.0
        th[:, 3::7] = 1.0
        if kind == "theta_out":
            th = th * 3.0 - 1.0
        return (x.to(dev), th.to(dev),
                torch.tensor(windows, dtype=torch.int32, device=dev),
                max_window)
    return {
        "main": (rows[0].reshape(-1, E).contiguous(),
                 rows[1].reshape(-1, E).contiguous(),
                 rows[2].reshape(-1).contiguous(),
                 max(bench.ONLINE_WINDOWS)),
        "ragged": (ragged.to(dev), torch.rand((7, 257), generator=g).to(dev),
                   torch.tensor([1, 17, 48, 96, 128, 150, 200],
                                dtype=torch.int32, device=dev), 200),
        "edge": (edge.to(dev),
                 torch.tensor([0.0, 1.0, 0.0, 1.0])[:, None]
                 .expand(4, 40).contiguous().to(dev),
                 torch.tensor([1, 1, 64, 64], dtype=torch.int32, device=dev),
                 64),
        "segment": sliding(300, 96, [96, 48, 33, 32, 1, 0]),
        "reg_widest": sliding(300, 256, [256, 255, 129, 97, 400, 2]),
        "shared_narrowest": sliding(300, 257, [257, 256, 1, 300]),
        "shared_wide": sliding(1500, 1000, [1000, 700, 3]),
        "zeros": sliding(300, 96, [96, 48, 7, 1], "zeros"),
        "flat": sliding(300, 200, [200, 96, 5, 1], "flat"),
        "theta_out": sliding(300, 96, [96, 48, 7, 1], "theta_out"),
    }


def nan_windows(intensity, window, max_window):
    """The windows of every epoch, NaN past their end: ``[R, E, W]``."""
    import torch
    R, E = intensity.shape
    off = torch.arange(max_window, device=intensity.device)
    idx = torch.arange(E, device=intensity.device)[:, None] + off
    valid = (off < window[:, None, None]) & (idx < E)
    return torch.where(valid, intensity[:, idx.clamp_max(E - 1)],
                       float("nan"))


def gate_kernel_phase(dev) -> dict:
    """gate_quantile_stats vs gate_quantile_stats_ref, bitwise, and times
    of the kernel, the plain version and torch.nanquantile."""
    import torch
    from repro_torch.kernels.gate_quantile import gate_quantile_stats
    from repro_torch.kernels.ref import gate_quantile_stats_ref

    flush = l2_flush(dev)
    record = None
    for name, (inten, theta, window, mw) in gate_cases(dev).items():
        got = gate_quantile_stats(inten, theta, window, mw)
        want = gate_quantile_stats_ref(inten, theta, window, mw)
        torch.cuda.synchronize()
        same = all(same_bits(x, y) for x, y in zip(got, want))
        fin = torch.isfinite(want[0]) & torch.isfinite(want[1])
        err = max(float(torch.where(fin, (got[i] - want[i]).abs(), 0.0).max())
                  for i in (0, 1))
        check(same, f"gate_quantile != gate_quantile_stats_ref at the {name} "
              f"shape {tuple(inten.shape)} (max |diff| {err})")
        R, E = inten.shape
        if name not in ("main", "ragged", "edge"):
            cpu = gate_quantile_stats_ref(inten.cpu(), theta.cpu(),
                                          window.cpu(), mw)
            check(all(same_bits(x.cpu(), y) for x, y in zip(got, cpu)),
                  f"gate_quantile != the plain version on the CPU at the "
                  f"{name} shape {tuple(inten.shape)}")
            print(f"kernel gate_quantile {name} (R={R}, E={E}, max_window="
                  f"{mw}, windows {window.tolist()}): bitwise equal to the "
                  "plain version on the card and on the CPU", flush=True)
            continue
        t = gate_timing(name, inten, theta, window, mw, flush,
                        KERNEL_REPS if name == "main" else 5)
        if name == "main":
            print_device_ms("gate_quantile main", lambda: gate_quantile_stats(
                inten, theta, window, mw), "gate_slide")
            record = {"name": "gate_quantile", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/gate_quantile.cu",
                      "replaces": "src/repro/kernels/gate_quantile.py:96",
                      "max_abs_err": err, **t}
    return record


def gate_timing(name, inten, theta, window, mw, flush, reps) -> dict:
    """Times of gate_quantile, its plain version and torch.nanquantile over
    NaN-padded windows (CUDA events, L2 flushed) beside the kernel's bound
    (``gate_quantile.cost``): the bytes it moves at 3.35 TB/s, or a
    linear-time selection's compares (2 per valid slot) at 67 T/s."""
    import torch
    from repro_torch.kernels import gate_quantile
    from repro_torch.kernels.gate_quantile import gate_quantile_stats
    from repro_torch.kernels.cost import HBM_BW
    from repro_torch.kernels.ref import gate_quantile_stats_ref

    R, E = inten.shape
    ms = time_cuda(lambda: gate_quantile_stats(inten, theta, window, mw),
                   reps, flush)
    plain_ms = time_cuda(
        lambda: gate_quantile_stats_ref(inten, theta, window, mw),
        reps, flush)
    qs = torch.unique(theta)
    q = qs if qs.numel() <= 8 else torch.tensor(0.5, device=inten.device)
    padded = nan_windows(inten, window, mw)
    library_ms = time_cuda(lambda: torch.nanquantile(padded, q, dim=-1),
                           reps, flush)
    del padded
    ops, moved = gate_quantile.cost(inten, theta, window, mw)
    bytes_ms = moved / HBM_BW * 1e3
    ops_ms = ops / gate_quantile.PEAK_FLOPS * 1e3
    bound_ms, bound_by, _ = kernel_bound(gate_quantile, inten, theta,
                                         window, mw)
    print(f"kernel gate_quantile {name} (R={R}, E={E}, max_window={mw}): "
          f"bitwise equal to the plain version; {ms:.4f} ms (L2 "
          f"flushed), plain {plain_ms:.4f} ms, torch.nanquantile over "
          f"NaN-padded windows (q={q.tolist()}) {library_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({moved / 1e6:.3f} MB at 3.35 TB/s "
          f"= {bytes_ms:.6f} ms; {ops / 1e9:.6f} G compares at 67 T/s "
          f"= {ops_ms:.6f} ms)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main_path(dev) -> dict:
    """run_batch on the paper cell; launch counts read around it."""
    import numpy as np
    import torch
    from repro_torch import bench
    from repro_torch.kernels import LAUNCHES, reset_launches

    setup = bench.BenchSetup(instances=INSTANCES)
    cfg = bench.SA_FAST
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    r = bench.run_batch(setup, device=dev)
    launches = dict(LAUNCHES)
    want = 1 + cfg.iters + cfg.iters // cfg.migrate_every
    check(launches.get("schedule_eval", 0) == want,
          f"schedule_eval launched {launches.get('schedule_eval', 0)} times "
          f"on the main path, expected {want} (phase 2: init + "
          f"{cfg.iters} iterations + migrations)")
    for k in ("opt_makespan", "carbon_savings", "energy_savings",
              "baseline_carbon", "optimized_carbon", "utilization"):
        check(r[k].shape == (INSTANCES,) and np.all(np.isfinite(r[k])),
              f"{k}: shape {r[k].shape} or non-finite values")
    check(not r["baseline_violations"].any(),
          f"{int((r['baseline_violations'] != 0).sum())} baseline schedules "
          "violate the validator")
    check(not r["optimized_violations"].any(),
          f"{int((r['optimized_violations'] != 0).sum())} optimized "
          "schedules violate the validator or the deadline")
    check(bool(np.all(r["carbon_savings"] >= 0)), "negative carbon savings")
    peak = torch.cuda.max_memory_allocated(dev)
    row = bench.summarize(r)
    print(f"main path: run_batch {INSTANCES} instances, {cfg}: "
          f"{r['seconds']:.3f} s wall; schedule_eval launches "
          f"{launches.get('schedule_eval', 0)}; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print("main path summary: " + json.dumps(row), flush=True)
    stamp = {**bench.device_stamp(dev), "triton":
             importlib.util.find_spec("triton") is not None}
    print("main path distribution: " + json.dumps(
        {"carbon_savings": bench.savings_distribution(r["carbon_savings"]),
         "seconds": r["seconds"], "stamp": stamp}), flush=True)
    return {"launches": launches, "seconds": r["seconds"]}


def online_path(dev) -> dict:
    """run_online at 1000 instances x 12 policies; launch counts read
    around it; the first instances held to the numpy oracle and to the
    port on the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers.online import (online_carbon_gated,
                                                 online_greedy)
    from repro_torch.kernels import LAUNCHES, reset_launches

    setup = bench.BenchSetup(stretch=1.5, instances=INSTANCES)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    r = bench.run_online(setup, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches.get("gate_quantile", 0) == 1,
          f"gate_quantile launched {launches.get('gate_quantile', 0)} times "
          "in the online sweep, expected once")
    P = r["policies"][0].shape[0]
    check(P == 12, f"{P} policies, expected 12")
    check(r["unscheduled_greedy"] == 0 and r["unscheduled_gated"] == 0,
          f"{r['unscheduled_greedy']} greedy and {r['unscheduled_gated']} "
          "gated tasks not scheduled within the horizon")
    check(not r["greedy_violations"].any(),
          f"{int((r['greedy_violations'] != 0).sum())} greedy schedules "
          "violate the validator")
    check(not r["gated_violations"].any(),
          f"{int((r['gated_violations'] != 0).sum())} gated schedules "
          "violate the validator")
    check(r["savings"].shape == (INSTANCES, P)
          and bool(np.all(np.isfinite(r["savings"]))),
          f"savings: shape {r['savings'].shape} or non-finite values")
    print(f"online path: run_online {INSTANCES} instances x {P} policies x "
          f"{bench.SIM_HORIZON} epochs: sweep {r['seconds']:.3f} s "
          f"(synchronised), whole call {wall:.3f} s; gate_quantile launches "
          f"{launches.get('gate_quantile', 0)}; all rows scheduled and "
          f"validator-clean; peak device memory {peak / 2**30:.3f} GiB",
          flush=True)

    # The numpy oracle, cell by cell, on the first instances.
    res = r["result"]
    th, wi, sx = r["policies"]
    k = ORACLE_INSTANCES
    card = {name: getattr(part, field)[:k].cpu().numpy()
            for name, part, field in (
                ("gs", res.greedy, "start"), ("ga", res.greedy, "assign"),
                ("cs", res.gated, "start"), ("ca", res.gated, "assign"))}
    budget = res.budget[:k].cpu().numpy()
    inten = r["intensity"][:k].cpu().numpy()
    t0 = time.perf_counter()
    for b in range(k):
        p, w = r["packs"][b], inten[b]
        s0, a0 = online_greedy(p)
        check(np.array_equal(s0, card["gs"][b])
              and np.array_equal(a0, card["ga"][b]),
              f"greedy schedule of instance {b} != the numpy oracle")
        dur = p.dur.numpy()
        ms0 = int(max(s0[t] + dur[t, a0[t]] for t in range(p.T)
                      if bool(p.task_mask[t])))
        for j in range(P):
            bud = int(float(sx[j]) * ms0)
            check(bud == budget[b, j], f"budget of ({b}, {j}): card "
                  f"{budget[b, j]}, oracle {bud}")
            sg, ag = online_carbon_gated(p, w, theta=float(th[j]),
                                         window=int(wi[j]), budget=bud)
            check(np.array_equal(sg, card["cs"][b, j])
                  and np.array_equal(ag, card["ca"][b, j]),
                  f"gated schedule of ({b}, policy {j}) != the numpy oracle")
    oracle_s = time.perf_counter() - t0

    # The same instances through the port on the CPU.
    cpu = bench.run_online(dataclasses.replace(setup, instances=k), "cpu")
    for part in ("greedy", "gated"):
        for field in ("start", "assign", "scheduled"):
            x = getattr(getattr(res, part), field)[:k].cpu()
            check(torch.equal(x, getattr(getattr(cpu["result"], part),
                                         field)),
                  f"card != CPU on the {part} {field} of {k} instances")
    check(np.array_equal(budget, cpu["result"].budget.numpy()),
          "card != CPU on the budgets")
    print(f"online path: {k} instances x {P + 1} cells equal the numpy "
          f"oracle ({oracle_s:.1f} s) and the port on the CPU", flush=True)
    # Where the sweep's time goes: one more sweep under the profiler.
    from repro_torch.core.solvers import online_torch
    profile_busy(f"one online sweep ({INSTANCES} x {P})",
                 lambda: online_torch.sweep_policies(
                     r["batch"], r["intensity"], bench.ONLINE_THETAS,
                     bench.ONLINE_WINDOWS, bench.ONLINE_STRETCHES,
                     device=dev))
    rows = bench.online_summary(r)
    for row in rows:
        print("online summary: " + json.dumps(
            {key: row[key] for key in ("theta", "window", "stretch",
                                       "online_gated_savings_pct",
                                       "online_makespan_ratio")}),
            flush=True)
    return {"launches": launches, "seconds": r["seconds"]}


def layer_phase(dev, wall_s: float) -> None:
    """Per-layer times at the main path's shape, scaled by their calls."""
    import torch
    from repro_torch import bench
    from repro_torch.core import decoder, validate
    from repro_torch.core.solvers import TorchDraws, common
    from repro_torch.kernels import ops

    cfg = bench.SA_FAST
    batch, cum = bench.paper_batch(bench.BenchSetup(instances=INSTANCES), dev)
    draws = TorchDraws(1, dev)
    L = batch.lead + (cfg.pop,)
    prio = draws.normal(L + (batch.T,))
    assign = common.random_allowed_assign(draws, batch, (cfg.pop,))
    deadline = torch.full(batch.lead, 200, dtype=torch.int32, device=dev)
    dec = decoder.sgs(batch, prio, assign, "fixed")
    swept = decoder.timing_sweep(batch, dec.start, dec.assign, cum, deadline,
                                 cfg.sweeps)
    evals = 1 + cfg.iters + cfg.iters // cfg.migrate_every
    layers = [
        ("phase 1 fitness (sgs earliest_finish + makespan)", evals,
         lambda: common.population_fitness(batch, cum, 1 << 27, prio, assign,
                                           "makespan", "earliest_finish", 0)),
        ("phase 2 fitness (all of it)", evals,
         lambda: common.population_fitness(batch, cum, deadline, prio, assign,
                                           "carbon", "fixed", cfg.sweeps)),
        ("  sgs fixed", evals,
         lambda: decoder.sgs(batch, prio, assign, "fixed")),
        ("  timing_sweep (2 sweeps)", evals,
         lambda: decoder.timing_sweep(batch, dec.start, dec.assign, cum,
                                      deadline, cfg.sweeps)),
        ("  population_carbon (schedule_eval + combine)", evals,
         lambda: ops.population_carbon(batch, swept, dec.assign, cum)),
        ("  validator (total_violations)", evals,
         lambda: validate.total_violations(batch, swept, dec.assign,
                                           deadline)),
    ]
    print(f"layers at B={INSTANCES}, Pop={cfg.pop}, T={batch.T}, "
          f"H={cum.shape[-1] - 1} (CUDA events, median of 3):", flush=True)
    total = 0.0
    for name, calls, fn in layers:
        ms = time_cuda(fn, 3)
        if not name.startswith("  "):
            total += ms * calls
        print(f"  {name}: {ms:.3f} ms x {calls} calls = "
              f"{ms * calls / 1e3:.3f} s", flush=True)
    print(f"  sum of the two fitness layers {total / 1e3:.3f} s of the "
          f"{wall_s:.3f} s run_batch wall; the rest is the SA loop, the "
          "final decodes and host overhead", flush=True)

    # Device busy share over one evaluation of each phase, from the trace.
    profile_busy("one phase-1 fitness evaluation",
                 lambda: common.population_fitness(
                     batch, cum, 1 << 27, prio, assign, "makespan",
                     "earliest_finish", 0))
    profile_busy("one phase-2 fitness evaluation",
                 lambda: common.population_fitness(
                     batch, cum, deadline, prio, assign, "carbon", "fixed",
                     cfg.sweeps))


def profile_busy(label: str, fn) -> None:
    """Wall time, device busy time and the heaviest kernels of one call of
    ``fn``, from a ``torch.profiler`` trace (kernels only, overlapping
    intervals merged), and the host and device time of its
    ``repro_torch.*`` ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("repro_torch.")]
    if not report_kernels(label, kernels, wall_ms):
        return
    for e in prof.key_averages():
        if e.key.startswith("repro_torch.") and e.cpu_time_total > 0:
            dev_ms = (getattr(e, "device_time_total", None)
                      or getattr(e, "cuda_time_total", 0)) / 1e3
            print(f"  {e.key}: {dev_ms:.3f} ms device, "
                  f"{e.cpu_time_total / 1e3:.3f} ms host", flush=True)


def report_kernels(label: str, kernels: list, wall_ms: float,
                   note: str = "") -> bool:
    """Print the device busy share (overlapping kernel intervals merged),
    the kernel count, the five heaviest kernels and the port's own; False
    (busy share not measured) when the trace holds no device time.
    ``kernels``: the trace's device events, each ``(name, start_us,
    end_us)``."""
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((lo, hi) for _, lo, hi in kernels):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    if busy_us <= 0:
        print(f"profiler, {label}: no device time recorded; busy share "
              f"not measured{note}", flush=True)
        return False
    print(f"profiler, {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e3 / wall_ms:.1f}%), "
          f"{len(kernels)} kernels{note}", flush=True)
    by_name: dict[str, list] = {}
    for name, lo, hi in kernels:
        by_name.setdefault(name, []).append(hi - lo)
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]:
        print(f"  kernel {name[:70]}: {sum(ts) / 1e3:.3f} ms, "
              f"{len(ts)} launches", flush=True)
    for name, ts in by_name.items():        # the port's own kernels
        if any(k in name for k in ("gate_slide", "schedule_delta",
                                   "flash_", "ssd_")):
            print(f"  port kernel {name[:70]}: {sum(ts) / 1e3:.3f} ms, "
                  f"{len(ts)} launches", flush=True)
    return True


def device_kernel_ms(fn, prefix: str, calls: int = 10) -> dict:
    """Device time per call of each kernel whose name starts with
    ``prefix`` (template arguments dropped), from one trace of ``calls``
    calls of ``fn``: ``{name: (ms per launch, launches kept)}``.  On the
    card a trace loses the port's last few launches (a trace of one call
    kept none of its three kernels, one of ten calls the first eight
    calls' kernels), so the mean is over the launches the trace kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            words = e.name.replace("(anonymous namespace)::", "") \
                .split("<")[0].split("(")[0].split()
            name = words[-1] if words else ""
            if name.startswith(prefix):
                times.setdefault(name, []).append(
                    e.time_range.elapsed_us() / 1e3)
    return {k: (statistics.mean(v), len(v)) for k, v in times.items()}


def print_device_ms(label: str, fn, prefix: str) -> None:
    """The kernel's own device time per launch, from a trace of 10 calls
    (L2 not flushed between them).  The event times above run from the
    end of the L2 flush to the kernel's end, so they also hold any time
    the device waits for the host to enqueue the kernel."""
    parts = device_kernel_ms(fn, prefix)
    print(f"kernel {label}, device time per launch from one profiled run of "
          "10 calls: " + (", ".join(f"{k} {ms:.4f} ms ({n} launches kept)"
                                    for k, (ms, n) in parts.items())
                          or "no kernel in the trace (not measured)"),
          flush=True)


def reference_phase(dev) -> None:
    """Small inputs on the card against the same inputs on the CPU.

    Decoded schedules must be equal and fitness allclose (rtol 1e-6: the
    two devices sum in different orders).  A whole small solve fed the
    same draws must give the same phase-1 result (its fitness is an
    integer makespan, so no rounding can steer it); phase 2 compares
    floats and may part on a one-ulp tie, so it is held to the validator
    and to savings >= 0 on both devices.
    """
    import torch
    from repro_torch import bench
    from repro_torch.core import decoder
    from repro_torch.core.instance import PackedInstance
    from repro_torch.core.solvers import (SAConfig, TorchDraws, common,
                                          solve_bilevel_batch)
    from repro_torch.core.validate import total_violations

    setup = bench.BenchSetup(n_jobs=4, k_tasks=3, n_machines=3, instances=6,
                             stretch=1.5, seed=5)
    cfg = SAConfig(pop=16, iters=12, migrate_every=5)
    batch, cum = bench.paper_batch(setup, "cpu")
    draws = TorchDraws(3, "cpu")
    prio = draws.normal(batch.lead + (cfg.pop, batch.T))
    assign = common.random_allowed_assign(draws, batch, (cfg.pop,))
    deadline = torch.full(batch.lead, 90, dtype=torch.int32)
    res = {}
    for d in ("cpu", dev):
        b = PackedInstance(*(f.to(d) for f in batch))
        args = (b, cum.to(d), deadline.to(d), prio.to(d), assign.to(d))
        dec = decoder.sgs(b, prio.to(d), assign.to(d), "fixed")
        swept = decoder.timing_sweep(b, dec.start, dec.assign, cum.to(d),
                                     deadline.to(d), cfg.sweeps)
        fit = common.population_fitness(*args, "carbon", "fixed", cfg.sweeps)
        sol = solve_bilevel_batch(b, cum.to(d), common.HostDraws(7, d),
                                  stretch=setup.stretch, cfg1=cfg)
        for name, r in (("baseline", sol.baseline),
                        ("optimized", sol.optimized)):
            dl = sol.deadline if name == "optimized" else None
            check(not total_violations(b, r.start, r.assign, dl).any(),
                  f"{name} schedules on {d} violate the validator")
        check(bool((sol.carbon_savings >= 0).all()),
              f"negative savings on {d}")
        res[str(d)] = [x.cpu() for x in (swept, fit, sol.opt_makespan,
                                         sol.deadline, sol.baseline.start,
                                         sol.baseline.assign,
                                         sol.carbon_savings)]
    cpu, card = res["cpu"], res[str(dev)]
    names = ("timing-swept starts", "fitness", "phase-1 OPT", "deadline",
             "baseline starts", "baseline assignment")
    for name, a, b in zip(names, cpu, card):
        same = (torch.allclose(a, b, rtol=1e-6, atol=0)
                if a.is_floating_point() else torch.equal(a, b))
        check(same, f"card != CPU on {name}")
    print("reference: decode, fitness and phase 1 on the card equal the CPU "
          "on 6 small instances; phase-2 savings |card - CPU| max "
          f"{float((cpu[-1] - card[-1]).abs().max()):.3g}", flush=True)


def allclose_ratio(got, want, atol: float, rtol: float | None = None
                   ) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol |want|)): the
    second is <= 1 exactly when allclose(atol, rtol) holds; rtol defaults
    to atol."""
    rtol = atol if rtol is None else rtol
    d = (got.float() - want.float()).abs()
    return (float(d.max()),
            float((d / (atol + rtol * want.float().abs())).max()))


def flash_cases(dev) -> dict:
    """flash_attention inputs ``(q, k, v, causal, window)``, bf16.

    hymba: hymba-1.5b's prefill of a 4096-token prompt (25 heads on 5 kv
    heads, dh 64, window 2048); ragged: S=777, window 100; qwen: the other
    family, qwen1.5-0.5b's full causal attention (16 heads, dh 64,
    S=2048)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(11)

    def qkv(H, KVH, S, dh):
        return [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                for s in ((1, H, S, dh), (1, KVH, S, dh), (1, KVH, S, dh))]
    return {"hymba": (*qkv(25, 5, 4096, 64), True, 2048),
            "ragged": (*qkv(6, 2, 777, 64), True, 100),
            "qwen": (*qkv(16, 16, 2048, 64), True, 0)}


def flash_measure(name: str, q, k, v, causal: bool, window: int,
                  reps: int, flush, sdpa_mask: bool = True) -> dict:
    """flash_attention against its plain version at one shape, then its
    time (CUDA events, L2 flushed, median of ``reps``) beside its bound,
    the plain version's and ``scaled_dot_product_attention``'s (with an
    explicit mask when ``sdpa_mask``, else ``is_causal``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain
    from repro_torch.kernels.cost import HBM_BW

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = q.device
    got = flash_attention(q, k, v, causal, window)
    want = flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    err, ratio = allclose_ratio(got, want, FLASH_ATOL, FLASH_TOL)
    check(got.shape == want.shape and err <= FLASH_TOL and ratio <= 1.0,
          f"flash_attention != its plain version at the {name} shape "
          f"{tuple(q.shape)} x {tuple(k.shape)} (max |diff| {err} of "
          f"{FLASH_TOL}; {ratio:.3f} of the allclose bound at "
          f"atol={FLASH_ATOL}, rtol={FLASH_TOL})")
    B, H, Sq, dh = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    i = torch.arange(Sq, device=dev)
    live = fa.live_pairs(Sq, Skv, causal, window)
    ops, moved = fa.cost(q, k, v, causal, window)
    ops_ms = ops / fa.PEAK_FLOPS * 1e3
    bytes_ms = moved / HBM_BW * 1e3
    bound_ms, bound_by, _ = kernel_bound(fa, q, k, v, causal, window)
    ms = time_cuda(lambda: flash_attention(q, k, v, causal, window),
                   reps, flush)
    plain_ms = time_cuda(
        lambda: flash_attention_plain(q, k, v, causal, window), reps,
        flush)
    if sdpa_mask:
        mask = i[None, :] <= i[:, None] if causal else None
        if window:
            mask = mask & (i[None, :] > i[:, None] - window)
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), reps, flush)
        how = "GQA, mask"
    else:
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), reps, flush)
        how = f"GQA, is_causal={causal}"
    print(f"kernel flash_attention {name} (B={B}, H={H}, KVH={KVH}, "
          f"Sq={Sq}, Skv={Skv}, dh={dh}, causal={causal}, window={window}): "
          f"allclose to the plain version (max |diff| {err:.6g}, "
          f"{ratio:.3f} of the bound at atol={FLASH_ATOL}, rtol={FLASH_TOL}; "
          f"median |out| {float(want.float().abs().median()):.4g}); "
          f"{ms:.4f} ms (L2 flushed, median of {reps}), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention ({how}) "
          f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({ops / 1e9:.3f} GFLOP over {live * B * H / 1e6:.3f}"
          f" M live pairs at 989 TFLOP/s = {ops_ms:.6f} ms; "
          f"{moved / 1e6:.3f} MB at 3.35 TB/s = {bytes_ms:.6f} ms); "
          f"achieved {ops / ms / 1e9:.1f} TFLOP/s against the bound's "
          f"{ops / bound_ms / 1e9:.1f} ({bound_ms / ms:.3f} of it)",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms,
            "bound_by": bound_by}


def flash_kernel_phase(dev) -> dict:
    """flash_attention vs its plain version (and SDPA's time) on the card."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    flush = l2_flush(dev)
    record, max_err = None, 0.0
    for name, (q, k, v, causal, window) in flash_cases(dev).items():
        reps = KERNEL_REPS if name == "hymba" else 5
        m = flash_measure(name, q, k, v, causal, window, reps, flush)
        max_err = max(max_err, m["max_abs_err"])
        if name == "hymba":
            record = {"name": "flash_attention", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                      "replaces": "src/repro/kernels/flash_attention.py:85",
                      **m}
    # The naive oracle at one small shape, float32.
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    q, k, v = (torch.randn(s, generator=g, device=dev) for s in
               ((2, 4, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64)))
    for causal, window in ((True, 0), (True, 48), (False, 0)):
        err, ratio = allclose_ratio(flash_attention(q, k, v, causal, window),
                                    attention_ref(q, k, v, causal, window),
                                    2e-5)
        check(ratio <= 1.0, f"flash_attention != attention_ref (causal="
              f"{causal}, window={window}; max |diff| {err})")
    print("kernel flash_attention: allclose to attention_ref at (2, 4, 200, "
          "64) float32 (causal, window 48, non-causal; 2e-5)", flush=True)
    record["max_abs_err"] = max_err
    return record


def ssd_cases(dev) -> dict:
    """ssd_scan inputs ``(x, dt, A, B, C, chunk)``: x, B, C bf16.

    hymba: hymba-1.5b's prefill of 4096 tokens (32 heads of P=100, G=1,
    N=16, chunk 256); ragged: S=777; mamba: the other family,
    mamba2-370m's SSD (32 heads of P=64, N=128, S=2048)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(13)

    def case(S, H, P, G, N, chunk):
        x = (0.5 * torch.randn((1, S, H, P), generator=g, device=dev)
             ).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(
            torch.randn((1, S, H), generator=g, device=dev))
        A = -torch.exp(0.3 * torch.randn((H,), generator=g, device=dev))
        Bm, Cm = ((0.5 * torch.randn((1, S, G, N), generator=g, device=dev)
                   ).to(torch.bfloat16) for _ in range(2))
        return x, dt, A, Bm, Cm, chunk
    return {"hymba": case(4096, 32, 100, 1, 16, 256),
            "ragged": case(777, 8, 100, 1, 16, 256),
            "mamba": case(2048, 32, 64, 1, 128, 256)}


def ssd_measure(name: str, x, dt, A, Bm, Cm, chunk: int, reps: int,
                flush) -> dict:
    """ssd_scan against its plain version at one shape, then its time
    (CUDA events, L2 flushed, median of ``reps``) beside its bound and the
    plain version's; no one PyTorch call computes the scan, so there is
    no library time."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.cost import HBM_BW
    from repro_torch.models.ssm import ssd_chunked

    ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan")
    y, h = ssd_scan(x, dt, A, Bm, Cm, chunk)
    yr, hr = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    err, ratio = allclose_ratio(y, yr, SSD_TOL)
    _, uratio = allclose_ratio(y, yr, ULP_ATOL, BF16_ULP)
    herr, hratio = allclose_ratio(h, hr, STATE_TOL)
    check(ratio <= 1.0 and uratio <= 1.0 and hratio <= 1.0,
          f"ssd_scan != its plain version at the {name} shape "
          f"{tuple(x.shape)}: y max |diff| {err} ({ratio:.3f} of the "
          f"{SSD_TOL} bound, {uratio:.3f} of one bf16 ulp + "
          f"{ULP_ATOL}), h_final {herr} ({hratio:.3f} of {STATE_TOL})")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    ops, moved = ssd_mod.cost(x, dt, A, Bm, Cm, chunk)
    ops_ms = ops / ssd_mod.PEAK_FLOPS * 1e3
    bytes_ms = moved / HBM_BW * 1e3
    bound_ms, bound_by, _ = kernel_bound(ssd_mod, x, dt, A, Bm, Cm, chunk)
    ms = time_cuda(lambda: ssd_scan(x, dt, A, Bm, Cm, chunk), reps, flush)
    plain_ms = time_cuda(lambda: ssd_chunked(x, dt, A, Bm, Cm, chunk),
                         reps, flush)
    print(f"kernel ssd_scan {name} (B={B}, S={S}, H={H}, P={P}, G={G}, "
          f"N={N}, chunk={Q}): allclose to the plain version (y max "
          f"|diff| {err:.6g}, {ratio:.3f} of the bound at atol=rtol="
          f"{SSD_TOL}, {uratio:.3f} of one bf16 ulp + {ULP_ATOL}, max "
          f"|y| {float(yr.float().abs().max()):.4g}; h_final "
          f"{herr:.6g}, {hratio:.3f} of {STATE_TOL});"
          f" {ms:.4f} ms (L2 flushed), plain {plain_ms:.4f} ms, no "
          f"library call; bound {bound_ms:.6f} ms ({ops / 1e9:.3f} GFLOP"
          f" at 495 TFLOP/s TF32 = {ops_ms:.6f} ms; {moved / 1e6:.3f} MB"
          f" at 3.35 TB/s = {bytes_ms:.6f} ms); {B * H} (b, h) pairs",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": None,
            "bound_by": bound_by}


def ssd_kernel_phase(dev) -> dict:
    """ssd_scan vs its plain version on the card."""
    from repro_torch.models.ssm import ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    flush = l2_flush(dev)
    record, max_err = None, 0.0
    for name, (x, dt, A, Bm, Cm, chunk) in ssd_cases(dev).items():
        reps = KERNEL_REPS if name == "hymba" else 5
        m = ssd_measure(name, x, dt, A, Bm, Cm, chunk, reps, flush)
        max_err = max(max_err, m["max_abs_err"])
        if name == "hymba":
            parts = device_kernel_ms(
                lambda: ssd_scan(x, dt, A, Bm, Cm, chunk), "ssd_")
            print("kernel ssd_scan hymba, its three kernels from one "
                  "profiled run of 10 calls: " + (", ".join(
                      f"{k} {ms:.4f} ms a call ({n} launches kept)"
                      for k, (ms, n) in parts.items())
                      or "no kernel in the trace (not measured)"),
                  flush=True)
            record = {"name": "ssd_scan", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                      "replaces": "src/repro/kernels/ssd_scan.py:73", **m}
    x, dt, A, Bm, Cm, _ = ssd_cases(dev)["ragged"]
    small = (x[:, :96, :2].float().contiguous(), dt[:, :96, :2].contiguous(),
             A[:2].contiguous(), Bm[:, :96].float().contiguous(),
             Cm[:, :96].float().contiguous())
    y, h = ssd_scan(*small, 32)
    ys, hs = ssd_ref(*small)
    err, ratio = allclose_ratio(y, ys, 3e-4)
    herr, hratio = allclose_ratio(h, hs, 3e-4)
    check(ratio <= 1.0 and hratio <= 1.0,
          f"ssd_scan != ssd_ref at (1, 96, 2, 100) float32 (y {err}, "
          f"h {herr})")
    print("kernel ssd_scan: allclose to ssd_ref (sequential) at (1, 96, 2, "
          "100) float32, chunk 32 (3e-4)", flush=True)
    record["max_abs_err"] = max_err
    return record


def forecast_kernel_phase(dev) -> None:
    """gate_quantile and schedule_delta at the forecast path's shapes,
    bitwise (bit patterns) against their plain versions, and timed.

    The rolling gate's rows: 1000 forecast instances x 3 seeds x K = 22
    issues (every = 24) x 512 epochs, window 96, theta 0.3.  The MPC's
    fitness: B*S = 2000 (instance, seed) rows, each with its own forecast
    ``cum`` of 513 epochs, 24 candidates of 18 tasks."""
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers.common import TorchDraws
    from repro_torch.core.solvers.rolling import forecast_cum
    from repro_torch.forecast.rolling import n_replans, rolling_forecasts
    from repro_torch.kernels import gate_quantile, schedule_eval
    from repro_torch.kernels.gate_quantile import gate_quantile_stats
    from repro_torch.kernels.ref import (gate_quantile_stats_ref,
                                         schedule_delta_ref)
    from repro_torch.kernels.schedule_eval import schedule_delta

    setup = bench.ForecastSetup(instances=INSTANCES)
    _, truths, _ = bench.forecast_batch(setup, dev)
    E = truths.shape[-1]
    K = n_replans(E, min(bench.FC_EVERYS))
    xi = TorchDraws(setup.seed + 1, dev).normal((setup.seeds, K, E))
    points = rolling_forecasts(truths[:, None], xi, 1.0,
                               min(bench.FC_EVERYS)).point
    flush = l2_flush(dev)

    inten = points.reshape(-1, E).contiguous()
    theta = torch.full_like(inten, bench.FC_THETA)
    mw = bench.FC_WINDOW
    window = torch.full(inten.shape[:1], mw, dtype=torch.int32, device=dev)
    got = gate_quantile_stats(inten, theta, window, mw)
    want = gate_quantile_stats_ref(inten, theta, window, mw)
    torch.cuda.synchronize()
    check(all(same_bits(x, y) for x, y in zip(got, want)),
          f"gate_quantile != gate_quantile_stats_ref at the rolling shape "
          f"{tuple(points.shape)}")
    R = inten.shape[0]
    ms = time_cuda(lambda: gate_quantile_stats(inten, theta, window, mw), 5,
                   flush)
    plain_ms = time_cuda(
        lambda: gate_quantile_stats_ref(inten, theta, window, mw), 5, flush)
    bound_ms, _, moved = kernel_bound(gate_quantile, inten, theta, window,
                                      mw)
    print(f"kernel gate_quantile rolling shape {tuple(points.shape)} (R={R}"
          f", E={E}, window {mw}, theta {bench.FC_THETA}): bitwise equal to "
          f"the plain version; {ms:.4f} ms (L2 flushed), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({moved / 1e6:.1f} MB"
          " at 3.35 TB/s)", flush=True)

    cum = forecast_cum(points[:, :setup.mpc_seeds, 0]) \
        .reshape(-1, E + 1).contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    shape = (cum.shape[0], setup.sa_pop, setup.n_jobs * setup.k_tasks)
    start = torch.randint(-5, E + 8, shape, generator=g, device=dev,
                          dtype=torch.int32)
    dur = torch.randint(0, 40, shape, generator=g, device=dev,
                        dtype=torch.int32)
    out = schedule_delta(start, dur, cum)
    ref = schedule_delta_ref(start, dur, cum)
    torch.cuda.synchronize()
    check(same_bits(out, ref), f"schedule_delta != schedule_delta_ref at "
          f"the MPC shape {shape}, H={E}")
    ms = time_cuda(lambda: schedule_delta(start, dur, cum), KERNEL_REPS,
                   flush)
    plain_ms = time_cuda(lambda: schedule_delta_ref(start, dur, cum),
                         KERNEL_REPS, flush)
    bound_ms, _, moved = kernel_bound(schedule_eval, start, dur, cum)
    print(f"kernel schedule_delta MPC shape {shape} (one forecast cum of "
          f"{E + 1} per (instance, seed)): bitwise equal to the plain "
          f"version; {ms:.4f} ms (L2 flushed), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms "
          f"({moved / 1e6:.2f} MB at 3.35 TB/s)", flush=True)


def forecast_path(dev) -> dict:
    """bench.run_forecast at 1000 instances; launch counts read around it;
    the scale-0 masks, the MPC invariants and the CPU checked."""
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers.common import TorchDraws
    from repro_torch.core.solvers.online_torch import simulate_online
    from repro_torch.core.solvers.rolling import (SeedShared, forecast_cum,
                                                  replan_step)
    from repro_torch.forecast.models import issue
    from repro_torch.forecast.rolling import (day_ahead_dirty_mask,
                                              rolling_dirty_mask)
    from repro_torch.kernels import LAUNCHES, reset_launches

    setup = bench.ForecastSetup(instances=INSTANCES)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = bench.run_forecast(setup, dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    rec = out["record"]

    n_scales, n_everys = len(bench.FC_SCALES), len(bench.FC_EVERYS)
    want_gate = 1 + n_scales * (1 + n_everys)
    check(launches.get("gate_quantile", 0) == want_gate,
          f"gate_quantile launched {launches.get('gate_quantile', 0)} times "
          f"on the forecast path, expected {want_gate} (the perfect gate, "
          "then per scale the day-ahead gate and one per replan interval)")
    off = max(setup.sa_iters, 60)
    sa_evals = 1 + setup.sa_iters + setup.sa_iters // 25
    want_eval = (1 + off + off // 25) + n_scales * sa_evals * sum(
        bench.mpc_config(setup, e).n_replans for e in bench.FC_EVERYS)
    check(launches.get("schedule_eval", 0) == want_eval,
          f"schedule_eval launched {launches.get('schedule_eval', 0)} times "
          f"on the forecast path, expected {want_eval} (the offline "
          "bound's phase 2, then every replan's SA)")
    check(not any(rec["violations"].values()),
          f"validator masses {rec['violations']}, expected all 0")

    batch, perfect = out["batch"], out["perfect_dirty"]
    for name, m in out["masks0"].items():
        check(torch.equal(m, perfect[:, None].expand(m.shape)),
              f"at scale 0 the {name} mask != dirty_mask on the truth")
    mask = batch.task_mask[:, None]
    n_plans = 0
    for (scale, every), r in out["mpc"].items():
        ps, pa = r.plans_start, r.plans_assign
        for k in range(ps.shape[-2] - 1):
            frozen = mask & (ps[..., k, :] < (k + 1) * every)
            for x in (ps, pa):
                check(torch.equal(torch.where(frozen, x[..., k + 1, :], 0),
                                  torch.where(frozen, x[..., k, :], 0)),
                      f"MPC (scale {scale}, every {every}): a frozen task "
                      f"moved at replan {k + 1}")
            n_plans += 1
        check(torch.equal(ps[..., -1, :], r.start)
              and torch.equal(pa[..., -1, :], r.assign),
              "MPC: the final plan is not the last replan's")
        check(bool((r.realized.makespan <= r.deadline).all()),
              f"MPC (scale {scale}, every {every}): makespan past deadline")
        if scale == 0.0:
            check(bool((r.realized.carbon
                        <= r.baseline.carbon * (1 + 1e-6)).all()),
                  f"MPC (every {every}) at scale 0 ends above its baseline")

    k = ORACLE_INSTANCES // 2
    truths, xi = out["truths"][:k, None].cpu(), out["xi"].cpu()
    cpu = {"day_ahead": day_ahead_dirty_mask(
        truths, bench.FC_THETA, bench.FC_WINDOW, xi, 0.0, bench.FC_WINDOW)}
    for every in bench.FC_EVERYS:
        cpu[every] = rolling_dirty_mask(truths, bench.FC_THETA,
                                        bench.FC_WINDOW, xi, 0.0, every,
                                        bench.FC_WINDOW)
    for name, m in cpu.items():
        check(torch.equal(out["masks0"][name][:k].cpu(), m),
              f"the card's scale-0 {name} mask != the CPU's on {k} "
              "instances")

    print(f"forecast path: run_forecast {INSTANCES} instances x "
          f"{rec['seeds']} seeds (MPC {rec['mpc_seeds']}), horizon "
          f"{rec['horizon']}, {rec['tasks_per_instance']} tasks, scales "
          f"{list(bench.FC_SCALES)} x every {list(bench.FC_EVERYS)}: "
          f"{rec['seconds']:.3f} s of stages (whole call {wall:.3f} s); "
          "stages " + json.dumps({s: round(v, 3) for s, v in
                                  rec["stage_seconds"].items()})
          + f"; launches {json.dumps(launches)}; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"forecast path: every schedule complete and validator-clean "
          f"({json.dumps(rec['violations'])}); at scale 0 the day-ahead and "
          "rolling masks equal dirty_mask on the truth for every `every`, "
          f"bitwise, and the card's equal the CPU's on {k} instances; the "
          f"MPC kept every frozen prefix over {n_plans} replan pairs x "
          f"{INSTANCES} x {rec['mpc_seeds']}, met every deadline, and at "
          "scale 0 never ended above its baseline", flush=True)
    print(f"forecast summary: greedy carbon {rec['greedy_carbon_mean']:.3f}"
          f" g; perfect gate {rec['perfect_day_ahead_gate']['savings_vs_greedy_pct']:.3f}"
          f"%, offline bound {rec['offline_bound']['savings_vs_greedy_pct']:.3f}"
          f"%; rolling_vs_day_ahead_ok {rec['rolling_vs_day_ahead_ok']}",
          flush=True)
    for c in rec["cells"]:
        print("forecast summary: " + json.dumps(
            {"scale": c["scale"], "every": c["every"],
             "day_ahead_pct": round(c["day_ahead"]["savings_vs_greedy_pct"], 4),
             "rolling_pct": round(c["rolling"]["savings_vs_greedy_pct"], 4),
             "mpc_pct": round(c["mpc"]["savings_vs_greedy_pct"], 4),
             "rolling_ge_day_ahead": c["rolling_ge_day_ahead"]}), flush=True)

    # Where the time goes, in windows short enough to trace: one scale's
    # gates and the first PROFILE_EPOCHS epochs of its dispatch, and one
    # MPC replan (boundary 48 of every = 48, at scale 1).
    truths, cums = out["truths"], out["cums"]
    budgets = torch.full(truths.shape[:1], 1 << 20, dtype=torch.int32,
                         device=dev)

    def gates_and_dispatch():
        t = truths[:, None]
        d = [day_ahead_dirty_mask(t, bench.FC_THETA, bench.FC_WINDOW,
                                  out["xi"], 1.0, bench.FC_WINDOW)]
        d += [rolling_dirty_mask(t, bench.FC_THETA, bench.FC_WINDOW,
                                 out["xi"], 1.0, e, bench.FC_WINDOW)
              for e in bench.FC_EVERYS]
        simulate_online(batch, torch.cat(d, 1), budgets, PROFILE_EPOCHS)
    profile_busy(f"one scale's gates and {PROFILE_EPOCHS} epochs of its "
                 "dispatch", gates_and_dispatch)
    every, S = 48, setup.mpc_seeds
    cfg = bench.mpc_config(setup, every)
    r = out["mpc"][(1.0, every)]
    fc = issue(truths[:, None], every, out["xi"][:S, 1], scale=1.0)
    cum_k = forecast_cum(fc.point)
    profile_busy(f"one MPC replan ({INSTANCES} x {S} seeds x pop "
                 f"{cfg.sa.pop}, {cfg.sa.iters} iterations)",
                 lambda: replan_step(
                     batch, r.plans_start[..., 0, :],
                     r.plans_assign[..., 0, :], every, cum_k,
                     SeedShared(TorchDraws(0, dev), batch.lead, (S,)),
                     r.deadline[:, 0], cfg=cfg))
    return {"launches": launches, "seconds": rec["seconds"]}


# tests/test_structure_golden.py's comparison of the TINY grid's rows.
GOLDEN_EXACT = ("family", "width", "depth", "n_jobs", "n_machines", "fleet",
                "tasks_per_job", "greedy_makespan")
GOLDEN_SKIP = ("online_best_policy",)
STRUCTURE_PER_CELL = 16         # 60 cells x 16 = 960 instances
PROFILE_EPOCHS = 128            # dispatch epochs traced for a busy share


def golden_mismatches(got: dict, want: dict) -> list:
    """Fields of a TINY-grid row that differ from the golden: exact ones
    unequal, other numbers outside rtol 1e-4 (atol 2e-3)."""
    import numpy as np
    if set(got) != set(want):
        return sorted(set(got) ^ set(want))
    bad = []
    for k, w in want.items():
        g = got[k]
        if k in GOLDEN_SKIP:
            continue
        if k not in GOLDEN_EXACT and isinstance(w, (list, int, float)):
            ok = np.allclose(np.asarray(g, float), np.asarray(w, float),
                             rtol=1e-4, atol=2e-3)
        else:
            ok = g == w
        if not ok:
            bad.append(k)
    return bad


def structure_path(dev) -> dict:
    """The structure sweep's FULL grid at 16 instances per cell (960);
    launch counts read around it; then the dispatch-only TINY grid on the
    card against tests/golden/structure_tiny.json."""
    import numpy as np
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers import online_torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.scenarios import build_batch, sweep_structure

    spec = bench.structure_spec(instances_per_cell=STRUCTURE_PER_CELL)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    r = bench.run_structure(spec, device=dev)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    meta, rows = r["meta"], r["rows"]
    n = len(spec.cells) * STRUCTURE_PER_CELL
    check(meta["instances"] == n and len(rows) == len(spec.cells) == 60,
          f"structure: {meta['instances']} instances in {len(rows)} cells, "
          f"expected {n} in 60")
    check(launches.get("gate_quantile", 0) == 1,
          f"gate_quantile launched {launches.get('gate_quantile', 0)} times "
          "in the structure sweep, expected once")
    want = 1 + spec.sa.iters + spec.sa.iters // spec.sa.migrate_every
    check(launches.get("schedule_eval", 0) == want,
          f"schedule_eval launched {launches.get('schedule_eval', 0)} times "
          f"in the structure sweep, expected {want} (the bound's phase 2)")
    off = np.array([row["offline_bound_savings_pct"] for row in rows])
    check(bool(np.all(np.isfinite(off)) and np.all(off >= 0)),
          "structure: offline-bound savings non-finite or negative")
    print(f"structure path: FULL grid, {len(rows)} cells x "
          f"{STRUCTURE_PER_CELL} = {meta['instances']} instances, pad "
          f"T={meta['pad_tasks']} M={meta['pad_machines']}, horizon "
          f"{meta['horizon']}, {meta['policies']} policies, SA {spec.sa}: "
          f"{r['seconds']:.3f} s wall; stages " + json.dumps(
              {s: round(v, 3) for s, v in meta["seconds"].items()})
          + f"; launches {json.dumps(launches)}; greedy and gated runs "
          f"complete and validator-clean; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    for key, series in r["trends"].items():
        print(f"structure summary: {key} {json.dumps(series)}", flush=True)

    with open(os.path.join(ROOT, "tests", "golden",
                           "structure_tiny.json")) as f:
        golden = json.load(f)["structure_tiny"]
    t0 = time.perf_counter()
    tiny, tmeta = sweep_structure(bench.structure_spec(tiny=True),
                                  offline=False, device=dev)
    check((tmeta["pad_tasks"], tmeta["pad_machines"])
          == (golden["pad_tasks"], golden["pad_machines"])
          and len(tiny) == len(golden["cells"]),
          "structure TINY: shape or cell count differs from the golden")
    for got, want_row in zip(tiny, golden["cells"]):
        bad = golden_mismatches(got, want_row)
        check(not bad, f"structure TINY cell {want_row['family']}-m"
              f"{want_row['n_machines']}-{want_row['fleet']}: {bad} differ "
              "from tests/golden/structure_tiny.json")
    tiny_s = time.perf_counter() - t0
    print(f"structure path: the dispatch-only TINY grid ({len(tiny)} cells) "
          "on the card matches tests/golden/structure_tiny.json (exact "
          f"fields equal, the rest within rtol 1e-4; {tiny_s:.1f} s)",
          flush=True)

    sb = build_batch(spec, dev)
    dirty = online_torch.dirty_mask(sb.intensity, spec.thetas[0],
                                    spec.windows[0], spec.windows[0])
    dirty = dirty[:, None].expand(-1, meta["policies"], -1)
    profile_busy(f"{PROFILE_EPOCHS} epochs of the structure dispatch "
                 f"({meta['instances']} x {meta['policies']} rows)",
                 lambda: online_torch.simulate_online(
                     sb.batch, dirty, 1 << 20, PROFILE_EPOCHS))
    return {"launches": launches, "seconds": r["seconds"], "rows": rows,
            "meta": meta, "spec": spec, "tiny_rows": tiny,
            "tiny_seconds": tiny_s}


# tests/test_stream_golden.py's TINY stream (both goldens' config).
STREAM_GOLDEN = dict(arrivals="bursty", rate=0.08, horizon=192, n_lanes=3,
                     family="layered", width=3, depth=2, n_machines=3,
                     fleet="tiered", mean_dur=5.0, theta=0.5, window=96,
                     stretch=1.5, seed=2024)
STREAM_EXACT = ("rid", "arrival", "admitted", "queue_delay", "finished",
                "budget", "greedy_makespan", "completed", "truncated")
STREAM_LOAD = 0.9
STREAM_EVERY = 24               # the banded gate's forecast interval
STREAM_CPU_TOL = 1e-6           # card vs CPU: each job's carbon, rtol
# The FULL-knob cells: (arrival family, shared fleet, banded-gate fields).
STREAM_CELLS = (("poisson", False, {}),
                ("bursty", True, {}),
                ("poisson", False, {"forecast_every": STREAM_EVERY,
                                    "forecast_scale": 1.0}))


# Fields of a stream row that must equal the reference harness's record.
STREAM_BENCH_EXACT = ("n_jobs", "n_admitted", "n_rejected", "n_finished",
                      "n_truncated", "n_unfinished", "final_lane_occupancy",
                      "rate_jobs_per_epoch", "queue_delay_epochs")


def stream_bench_cell(arrivals: str, shared: bool) -> dict:
    """The reference harness's FULL cell at STREAM_LOAD from the repo's
    ``BENCH_stream.json`` (``benchmarks/stream_serve.py``, seed 2024)."""
    from repro_torch import bench
    with open(os.path.join(ROOT, "BENCH_stream.json")) as f:
        rec = json.load(f)
    check(rec["mode"] == "full" and rec["seed"] == bench.STREAM_SEED,
          "BENCH_stream.json is not the FULL grid at the bench's seed")
    (cell,) = [c for c in rec["cells"] if c["arrivals"] == arrivals
               and c["load"] == STREAM_LOAD and c["shared_fleet"] == shared]
    return cell


def stream_full_setup(dev) -> tuple:
    """The FULL grid's knobs and the rate of load STREAM_LOAD, calibrated
    against the pool's greedy capacity on the card."""
    from repro_torch import bench
    knobs, _, _ = bench.stream_knobs()
    service = bench.probe_service_epochs(knobs, device=dev)
    return knobs, STREAM_LOAD * knobs["n_lanes"] / service, service


def stream_gate_phase(dev, knobs, rate) -> None:
    """gate_quantile at the stream engine's two shapes, bitwise against its
    plain version and timed: the day-ahead gate ``[1, E]`` and the banded
    gate ``[K, E]`` (every = 24) over the FULL poisson cell's AU-SA window
    (E = 1024 + 192 = 1216, window 96, theta 0.5); the banded rows come
    from the engine's own noise (drawn on the CPU, whatever the device)."""
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers.common import TorchDraws
    from repro_torch.forecast.rolling import n_replans, rolling_forecasts
    from repro_torch.kernels.gate_quantile import gate_quantile_stats
    from repro_torch.kernels.ref import gate_quantile_stats_ref
    from repro_torch.stream.engine import stream_setup

    cfg = bench.stream_config(knobs, "poisson", rate)
    _, _, _, trace = stream_setup(cfg)
    inten = torch.as_tensor(trace.intensity, device=dev)
    E = inten.shape[-1]
    K = n_replans(E, STREAM_EVERY)
    xi = TorchDraws(cfg.seed, "cpu").normal((K, E)).to(dev)
    points = rolling_forecasts(inten, xi, 1.0, STREAM_EVERY).point
    flush = l2_flush(dev)
    for name, rows in (("stream day-ahead", inten[None]),
                       ("stream banded", points)):
        rows = rows.contiguous()
        theta = torch.full_like(rows, cfg.theta)
        window = torch.full(rows.shape[:1], cfg.window, dtype=torch.int32,
                            device=dev)
        got = gate_quantile_stats(rows, theta, window, cfg.window)
        want = gate_quantile_stats_ref(rows, theta, window, cfg.window)
        torch.cuda.synchronize()
        check(all(same_bits(x, y) for x, y in zip(got, want)),
              f"gate_quantile != gate_quantile_stats_ref at the {name} "
              f"shape {tuple(rows.shape)}")
        gate_timing(name, rows, theta, window, cfg.window, flush,
                    KERNEL_REPS)


def stream_events_differ(got: list, want: list, tol=None) -> list:
    """rids whose event records differ: a field set, an exact field, or
    (``tol`` = (rtol, atol)) a float outside it; ``tol=None`` compares
    the exact fields only."""
    if len(got) != len(want):
        return ["length"]
    bad = []
    for g, w in zip(got, want):
        ok = set(g) == set(w)
        for k, v in w.items():
            if not ok:
                break
            if k in STREAM_EXACT:
                ok = g[k] == v
            elif tol is not None:
                ok = abs(g[k] - v) <= tol[1] + tol[0] * abs(v)
        if not ok:
            bad.append(w["rid"])
    return bad


def stream_card_vs_cpu(card, cpu) -> list:
    """rids whose records differ between a card's and the CPU's
    :class:`StreamResult` of one config: an exact event field, the
    schedule, or carbon, energy or a greedy baseline beyond rtol
    STREAM_CPU_TOL."""
    bad = stream_events_differ(card.events, cpu.events)
    for a, b in zip(card.jobs, cpu.jobs):
        same = ((a.start is None and b.start is None)
                or (a.start is not None and b.start is not None
                    and (a.start == b.start).all()
                    and (a.assign == b.assign).all()))
        for f in ("carbon", "energy", "greedy_carbon", "greedy_energy"):
            x, y = getattr(a, f), getattr(b, f)
            same &= abs(x - y) <= STREAM_CPU_TOL * abs(y)
        if not same:
            bad.append(b.rid)
    return sorted(set(bad))


def fleet_overlaps(jobs) -> int:
    """Pairs of finished tasks that share a machine at one epoch, over all
    jobs of a shared-fleet run (durations from each packed instance)."""
    busy: dict[int, list] = {}
    n = 0
    for sj in jobs:
        if not sj.finished:
            continue
        dur = sj.inst.dur.cpu().numpy()
        for ti in range(sj.job.n_tasks):
            m, s0 = int(sj.assign[ti]), int(sj.start[ti])
            e0 = s0 + int(dur[ti, m])
            n += sum(s0 < e and s < e0 for s, e in busy.get(m, ()))
            busy.setdefault(m, []).append((s0, e0))
    return n


def stream_row_line(r: dict) -> str:
    keys = ("n_jobs", "n_admitted", "n_finished", "n_rejected", "n_truncated",
            "n_unfinished", "ticks", "seconds", "jobs_per_sec",
            "admission_wall_s", "tick_wall_s", "queue_delay_epochs",
            "carbon_savings_pct")
    return json.dumps({k: r[k] for k in keys})


def stream_path(dev, knobs, rate, service) -> dict:
    """The streaming service: the TINY goldens on the card, the TINY grid's
    most backlogged cell card vs CPU, then three FULL-knob cells with the
    launch counts read around them, and one profiled tick and admission."""
    import dataclasses

    import torch
    from repro_torch import bench
    from repro_torch.core.instance import Instance, pack
    from repro_torch.core.validate import check_feasible_np
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.stream import StreamConfig, simulate_stream
    from repro_torch.stream import engine as stream_engine

    t0 = time.perf_counter()
    for shared, name in ((False, "stream_tiny.json"),
                         (True, "stream_contention_tiny.json")):
        with open(os.path.join(ROOT, "tests", "golden", name)) as f:
            golden = json.load(f)
        res = simulate_stream(StreamConfig(**STREAM_GOLDEN,
                                           shared_fleet=shared), device=dev)
        check({k: res.meta[k] for k in golden["meta"]} == golden["meta"],
              f"stream TINY ({name}): meta {res.meta} differs from the "
              "golden")
        bad = stream_events_differ(res.events, golden["events"],
                                   (1e-4, 2e-3))
        check(not bad, f"stream TINY on the card: events of rids {bad} "
              f"differ from tests/golden/{name}")
    print("stream path: both TINY goldens reproduced on the card (ints "
          "exact, floats within rtol 1e-4 / atol 2e-3; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    tk, tloads, _ = bench.stream_knobs(tiny=True)
    load = max(tloads)
    tservice = bench.probe_service_epochs(tk, device=dev)
    check(tservice == bench.probe_service_epochs(tk, device="cpu"),
          "stream TINY: the card's greedy service time differs from the CPU's")
    trate = load * tk["n_lanes"] / tservice
    for shared in (False, True):
        card = bench.run_stream_cell(tk, "bursty", load, trate, shared,
                                     device=dev)
        cpu = bench.run_stream_cell(tk, "bursty", load, trate, shared,
                                    device="cpu")
        bad = stream_card_vs_cpu(card["result"], cpu["result"])
        check(not bad, f"stream TINY bursty load {load} (shared {shared}): "
              f"card != CPU for rids {bad}")
        print(f"stream path: TINY bursty load {load}, shared fleet {shared}:"
              f" {len(card['result'].jobs)} jobs, the card's event log "
              "equals the CPU's (ints exact; schedules equal; carbon, "
              "energy and the "
              f"greedy baselines within rtol {STREAM_CPU_TOL}); card "
              f"{card['seconds']:.3f} s, CPU {cpu['seconds']:.3f} s",
              flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    seconds = 0.0
    for fam, shared, gate in STREAM_CELLS:
        before = dict(LAUNCHES)
        row = bench.run_stream_cell(knobs, fam, STREAM_LOAD, rate, shared,
                                    device=dev, **gate)
        seconds += row["seconds"]
        got = {k: LAUNCHES.get(k, 0) - before.get(k, 0)
               for k in set(LAUNCHES) | set(before)}
        label = (f"FULL {fam} load {STREAM_LOAD}"
                 + (" shared" if shared else "")
                 + (f" banded every {gate['forecast_every']}" if gate else ""))
        check({k: v for k, v in got.items() if v} == {"gate_quantile": 1},
              f"stream {label}: launches {got}, expected gate_quantile "
              "once (the engine's gate) and no other kernel")
        res = row["result"]
        finished = [sj for sj in res.jobs if sj.finished]
        check(row["n_finished"] == len(finished) > 0
              and row["n_admitted"] == (row["n_finished"]
                                        + row["final_lane_occupancy"]),
              f"stream {label}: counts {stream_row_line(row)}")
        for sj in finished:     # the engine validated each eviction; again
            probs = check_feasible_np(sj.inst, sj.start, sj.assign)
            check(not probs, f"stream {label}: rid {sj.rid} infeasible: "
                  f"{probs}")
        if shared:
            n = fleet_overlaps(res.jobs)
            check(n == 0, f"stream {label}: {n} cross-lane machine overlaps")
        if not gate:
            want = stream_bench_cell(fam, shared)
            bad = [k for k in STREAM_BENCH_EXACT if row[k] != want[k]] + [
                q for q, v in want["carbon_savings_pct"].items()
                if abs(row["carbon_savings_pct"][q] - v) > 2e-3]
            check(not bad, f"stream {label}: {bad} differ from the "
                  "reference's cell in BENCH_stream.json")
        else:   # the banded gate's rows and thresholds, held to the CPU's
            cpu = bench.run_stream_cell(knobs, fam, STREAM_LOAD, rate,
                                        shared, device="cpu", **gate)
            bad = stream_card_vs_cpu(res, cpu["result"])
            check(not bad, f"stream {label}: card != CPU for rids {bad}")
            cpu_s = cpu["seconds"]
        gate_name = json.dumps(gate) if gate else "day-ahead gate"
        print(f"stream path: {label} ({gate_name}; rate {rate:.5f} "
              f"jobs/epoch, service {service:.3f} epochs): "
              f"{stream_row_line(row)}; every finished schedule "
              "validator-clean (the engine and check_feasible_np)"
              + ("; no cross-lane machine overlap" if shared else "")
              + (f"; event log equal to the CPU's ({cpu_s:.3f} s there; "
                 "ints exact, schedules equal, carbon, energy and the "
                 f"greedy baselines within rtol {STREAM_CPU_TOL})" if gate
                 else "; counts, queue delays and savings equal to the "
                 "reference's cell in BENCH_stream.json"),
              flush=True)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"stream path: three FULL cells {seconds:.3f} s; launches "
          f"{json.dumps(launches)}; peak device memory {peak / 2**30:.3f} "
          "GiB", flush=True)

    # Where the time goes: one tick of a full pool, each fleet mode, and
    # one admission solve mid-stream.
    cfg = bench.stream_config(knobs, "poisson", rate)
    jobs, powers, speeds, trace = stream_engine.stream_setup(cfg)
    pad = max(j.n_tasks for j in jobs)
    L = knobs["n_lanes"]
    for shared in (False, True):
        eng = stream_engine.StreamEngine(trace, powers, speeds, L, pad,
                                         shared_fleet=shared, device=dev)
        for lane in range(L):
            sj = stream_engine.StreamJob(
                lane, dataclasses.replace(jobs[lane], arrival=0))
            eng.pool.insert(lane, sj)
            check(eng._admit_job(lane, sj, 0), "stream profile: admission")
        if shared:
            def tick():
                out = stream_engine._pool_tick_shared(
                    eng.pool_inst, eng.cp, eng.lstate, eng.mfree,
                    eng.dirty[0], eng.budget, 0, eng._lane_order(),
                    eng.machine_rule)
                stream_engine._to_host(*out[2:])
        else:
            def tick():
                out = stream_engine._pool_tick(
                    eng.pool_inst, eng.cp, eng.lstate, eng.mfree,
                    eng.dirty[0], eng.budget, 0, eng.machine_rule)
                stream_engine._to_host(*out[2:])
        tick()
        profile_busy(f"one {'shared' if shared else 'partitioned'} pool tick"
                     f" ({L} lanes x {pad} tasks)", tick)
    t_adm = knobs["horizon"] // 2
    inst = pack(Instance(jobs=(dataclasses.replace(jobs[L], arrival=t_adm),),
                         powers_kw=powers, speeds=speeds), pad_tasks=pad,
                device=dev)

    def admission():
        cp, budget, obj, complete = stream_engine._admission_eval(
            inst, eng.cum, eng._stretch, t_adm, eng._idle_mfree, eng.E,
            eng.machine_rule)
        stream_engine._to_host(complete, budget, obj.makespan, obj.carbon)
    admission()
    profile_busy(f"one admission solve ({jobs[L].n_tasks} tasks, admitted "
                 f"at epoch {t_adm})", admission)
    return {"launches": launches, "seconds": seconds}


LEARN_SMOKE_STEPS = 2          # training steps a stretch on the FULL grid
                               # (cut so that phase 21 fits the time limit)
LEARN_GOLDEN_TOL = {"loss_curve": (1e-3, 2e-4), "final_theta": (1e-3, 2e-3),
                    "learned_savings_pct": (1e-4, 2e-3)}   # (rtol, atol)
# The fixed-grid fields of BENCH_learn.json's rows, each held to its file
# value within its rounding (0.001); the greedy carbon, a float32 sum that
# XLA and torch associate differently (one ulp is 0.001-0.002 g at 8-33
# kg), also within rtol 1e-6.
LEARN_FIXED = ("greedy_carbon_g", "greedy_makespan", "greedy_utilization_pct",
               "online_savings_pct_by_policy")


def profile_kernels(label: str, fn) -> None:
    """:func:`profile_busy` from a trace of the card alone (no host ops:
    a learner step launches ~3e5 kernels, and host events would multiply
    the trace), with the time the trace took to read back.  The device
    events are read from the profiler's raw results: building its Python
    event list took ~50 s for a learner step's trace, this ~1 s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    kernels = [(e.name(), e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    report_kernels(label, kernels, (t1 - t0) * 1e3,
                   f" (trace read back in {time.perf_counter() - t1:.1f} s)")


def learn_gate_phase(dev) -> None:
    """The learner's gate at the FULL grid's shape ([240, 2048], window
    48, per-epoch theta from a seeded raw) on the grid's own AU-SA
    windows: ``ops.gate_threshold`` (one gate_quantile launch) against the
    plain sorted-window path on the same card tensors; the thresholds and
    the gradient of a seeded weighted sum in theta bitwise; the launch
    timed beside its bound."""
    import torch
    from repro_torch import bench
    from repro_torch.core.solvers import online_torch
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.scenarios import build_batch

    sb = build_batch(bench.structure_spec(
        instances_per_cell=bench.LEARN_PER_CELL), dev)
    inten = sb.intensity.contiguous()
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    raw = torch.randn(inten.shape, generator=g, device=dev)
    weight = torch.randn(inten.shape, generator=g, device=dev)
    out = []
    for kernel in (True, False):
        theta = torch.sigmoid(raw).requires_grad_(True)
        if kernel:
            reset_launches()
            thr = ops.gate_threshold(inten, theta, 48, 48)
            check(LAUNCHES.get("gate_quantile", 0) == 1,
                  "learn gate: gate_threshold did not launch gate_quantile "
                  "once")
        else:
            sv, n = online_torch.sorted_windows(inten, 48, 48)
            thr = online_torch.quantile_threshold(sv, n, theta)
        (thr * weight).sum().backward()
        out.append((thr.detach(), theta.grad))
    torch.cuda.synchronize()
    (t_k, g_k), (t_p, g_p) = out
    check(same_bits(t_k, t_p), "learn gate: the kernel's thresholds differ "
          "from the plain path's")
    check(same_bits(g_k, g_p), "learn gate: the gradient in theta through "
          "the kernel's selection differs from the plain path's")
    print(f"learn gate: ops.gate_threshold at {tuple(inten.shape)} (window "
          "48, per-epoch theta): thresholds and d(sum thr x w)/d theta "
          "bitwise equal to sorted_windows + quantile_threshold on the "
          f"card (|grad| max {float(g_k.abs().max()):.4f})", flush=True)
    window = torch.full(inten.shape[:1], 48, dtype=torch.int32, device=dev)
    gate_timing("learn", inten, torch.sigmoid(raw), window, 48,
                l2_flush(dev), KERNEL_REPS)


def learn_path(dev) -> dict:
    """The gate-policy learner: the tiny golden run on the card, then the
    learned_gate cell's FULL grid (240 instances, horizon 2048, both
    stretches) cut to LEARN_SMOKE_STEPS steps a stretch, launch counts
    read around it, and one profiled training step."""
    import numpy as np
    import torch
    from repro_torch import bench
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.learn import train_gate
    from repro_torch.learn.train import greedy_reference
    from repro_torch.scenarios import build_batch

    t0 = time.perf_counter()
    with open(os.path.join(ROOT, "tests", "golden", "learn_tiny.json")) as f:
        golden = json.load(f)["learn_tiny"]
    reset_launches()
    t_tiny = time.perf_counter()
    tiny = bench.run_learn_tiny(dev)
    tiny_s = time.perf_counter() - t_tiny
    steps = bench.LEARN_TINY["steps"]
    check(LAUNCHES.get("gate_quantile", 0) == steps + 1,
          f"learn TINY: gate_quantile launched "
          f"{LAUNCHES.get('gate_quantile', 0)} times, expected {steps + 1} "
          "(one a step, one for the hard evaluation)")
    check(tiny["families"] == golden["families"], "learn TINY: families")
    for key, (rtol, atol) in LEARN_GOLDEN_TOL.items():
        check(bool(np.allclose(tiny[key], golden[key], rtol=rtol,
                               atol=atol)),
              f"learn TINY on the card: {key} {tiny[key]} differs from "
              f"tests/golden/learn_tiny.json {golden[key]}")
    print(f"learn path: the tiny golden run on the card ({steps} steps, "
          f"{statistics.mean(tiny['step_seconds']):.4f} s a step) matches "
          "tests/golden/learn_tiny.json at its tolerances; final theta "
          f"{tiny['final_theta']}, learned savings "
          f"{tiny['learned_savings_pct']}", flush=True)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rec = bench.run_learned_gate(steps=LEARN_SMOKE_STEPS, device=dev)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    S = len(rec["grid"]["stretches"])
    want = 1 + S * (LEARN_SMOKE_STEPS + 1)
    check(launches.get("gate_quantile", 0) == want,
          f"gate_quantile launched {launches.get('gate_quantile', 0)} times "
          f"on the learn path, expected {want} (the fixed sweep, one a "
          "training step, one a hard evaluation)")
    check(rec["instances"] == 240 and len(rec["cells"]) == 60
          and rec["horizon"] == 2048,
          f"learn FULL: {rec['instances']} instances in "
          f"{len(rec['cells'])} cells, horizon {rec['horizon']}")
    with open(os.path.join(ROOT, "BENCH_learn.json")) as f:
        ref = json.load(f)
    for got, want_row in zip(rec["cells"], ref["cells"]):
        for k in LEARN_FIXED:
            g = np.asarray(got[k], float)
            w = np.asarray(want_row[k], float)
            tol = 1e-3 + 1e-9 + (1e-6 * np.abs(w)
                                 if k == "greedy_carbon_g" else 0.0)
            check(bool(np.all(np.abs(g - w) <= tol)),
                  f"learn FULL cell {want_row['family']}-m"
                  f"{want_row['n_machines']}-{want_row['fleet']}: {k} "
                  f"{got[k]} differs from BENCH_learn.json's {want_row[k]}")
    # The kept savings are max(trained, fixed) by construction, so the
    # acceptance flag cannot fail; the trained savings are what training
    # produced.
    trained = [c["learned"][sx]["trained_savings_pct"]
               for c in rec["cells"] for sx in c["learned"]]
    check(bool(np.isfinite(trained).all()),
          "learn FULL: a trained saving is not finite")
    n_ge = sum(c["learned"][sx]["trained_savings_pct"]
               >= c["learned"][sx]["fixed_best_savings_pct"]
               for c in rec["cells"] for sx in c["learned"])
    walls = rec["learn_step_seconds"]
    print(f"learn path: trained savings finite in all {len(trained)} "
          f"(cell, stretch) pairs; trained >= best fixed in {n_ge}",
          flush=True)
    print(f"learn path: the learned_gate FULL grid ({len(rec['cells'])} "
          f"cells x {rec['instances_per_cell']} = {rec['instances']} "
          f"instances, horizon {rec['horizon']}, pad T={rec['pad_tasks']} "
          f"M={rec['pad_machines']}) cut to {LEARN_SMOKE_STEPS} steps a "
          f"stretch: {rec['seconds']:.3f} s wall; stages " + json.dumps(
              {k: round(v, 3) for k, v in rec["seconds_by_stage"].items()})
          + "; seconds a step " + json.dumps(
              {sx: [round(t, 4) for t in ts] for sx, ts in walls.items()})
          + f"; launches {json.dumps(launches)}; every fixed and learned "
          "schedule complete and validator-clean; learned >= fixed "
          "everywhere; the fixed-grid fields equal BENCH_learn.json's "
          f"within its rounding; peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    for fam, by_sx in rec["summary_by_family"].items():
        for sx, d in by_sx.items():
            r = ref["summary_by_family"][fam][sx]
            print(f"learn summary ({LEARN_SMOKE_STEPS} steps): {fam} S={sx}"
                  f" learned {d['learned_savings_pct']}% vs fixed "
                  f"{d['fixed_best_savings_pct']}% ({d['improved_cells']}/"
                  f"{d['cells']} improved); BENCH_learn.json (150 steps): "
                  f"{r['learned_savings_pct']}% vs "
                  f"{r['fixed_best_savings_pct']}%", flush=True)

    # One training step of the same grid at S=1.5, profiled.
    spec = bench.structure_spec(instances_per_cell=bench.LEARN_PER_CELL)
    sb = build_batch(spec, dev)
    E = sb.intensity.shape[-1]
    baseline = greedy_reference(sb.batch, sb.cum, E)
    theta0 = np.full(len(spec.cells), 0.3, np.float32)
    window = np.full(sb.cell_of.shape, 48, np.int32)
    cfg = bench.FULL_LEARN._replace(steps=1)

    def step():      # warm: the cut grid above ran the same shapes
        tr = train_gate(sb.batch, sb.intensity, sb.cum, sb.cell_of, window,
                        1.5, theta0, cfg=cfg, baseline=baseline, device=dev)
        tr.theta.cpu()
    reset_launches()
    profile_kernels(f"one training step of the FULL grid ({rec['instances']}"
                    f" rows x {E} epochs, S=1.5)", step)
    check(LAUNCHES.get("gate_quantile", 0) == 1,
          "learn: a training step did not launch gate_quantile once")
    learn_step_card_vs_cpu(sb, baseline, dev)
    print(f"learn path: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return {"launches": launches, "seconds": rec["seconds"], "tiny": tiny,
            "tiny_seconds": tiny_s}


def learn_step_card_vs_cpu(sb, baseline, dev) -> None:
    """One training step's per-row gradients (``per_row_grads``, one
    backward through the soft gate, ``expected_wait`` over every epoch and
    the soft starts) and their ``seq_sum`` at the FULL grid's shape, card
    against CPU on the same inputs: at rtol 1e-4, atol 1e-6 x max |grad|
    (the CPU tests' gradient-parity tolerance), and each row's (carbon,
    penalty) at rtol 1e-6 (the penalty also at atol 1e-6)."""
    import numpy as np
    import torch
    from repro_torch import bench
    from repro_torch.core.instance import PackedInstance
    from repro_torch.core.solvers.online_torch import stretch_budget
    from repro_torch.learn import logit
    from repro_torch.learn import train as ttrain

    rng = np.random.default_rng(18)
    G = int(sb.cell_of.max()) + 1
    raw = torch.stack([logit(rng.uniform(0.2, 0.6, G).astype(np.float32)),
                       torch.as_tensor(rng.normal(0.0, 0.5, G)
                                       .astype(np.float32))], dim=1)
    feats = rng.normal(0.0, 1.0, tuple(sb.intensity.shape)).astype(np.float32)
    cfg = bench.FULL_LEARN
    out, secs = [], []
    for d in (dev, torch.device("cpu")):
        batch = PackedInstance(*(f.to(d) for f in sb.batch))
        inten, cum = sb.intensity.to(d), sb.cum.to(d)
        ms0, bc = (x.to(d) for x in baseline)
        B, E = inten.shape
        t0 = time.perf_counter()
        g, aux = ttrain.per_row_grads(
            raw.to(d), torch.as_tensor(sb.cell_of, device=d),
            lambda rows: ttrain.per_row_loss(
                rows, torch.tensor(cfg.temp0, device=d), batch, cum, inten,
                torch.full((B,), 48, dtype=torch.int32, device=d), 48,
                torch.as_tensor(feats, device=d), stretch_budget(1.5, ms0),
                torch.clamp_min(bc, 1e-6),
                torch.clamp_min(ms0.to(torch.float32), 1.0),
                torch.tensor(1.0, device=d) / torch.tensor(float(B),
                                                           device=d),
                cfg, E))
        total = ttrain.seq_sum(g)
        out.append([x.cpu().numpy() for x in (g, total, *aux)])
        secs.append(time.perf_counter() - t0)
    (g_k, t_k, c_k, p_k), (g_c, t_c, c_c, p_c) = out
    check(bool((g_c != 0).any()), "learn step: every CPU gradient is zero")
    for name, a, b in (("per-row gradients", g_k, g_c),
                       ("seq_sum of the gradients", t_k, t_c)):
        tol = 1e-4 * np.abs(b) + 1e-6 * np.abs(b).max()
        bad = int((np.abs(a - b) > tol).sum())
        check(bad == 0, f"learn step at {tuple(sb.intensity.shape)}: {bad} "
              f"{name} differ between card and CPU beyond rtol 1e-4")
    for name, a, b, atol in (("carbon", c_k, c_c, 0.0),
                             ("penalty", p_k, p_c, 1e-6)):
        check(bool(np.all(np.abs(a - b) <= 1e-6 * np.abs(b) + atol)),
              f"learn step: the rows' {name} differs between card and CPU "
              f"(max |diff| {float(np.abs(a - b).max())})")
    print(f"learn step card vs CPU at {tuple(sb.intensity.shape)} (S=1.5, "
          f"temp {cfg.temp0}, per-cell raw and per-epoch features from seed "
          "18): per-row gradients and their seq_sum within rtol 1e-4 / atol "
          "1e-6 x max, (carbon, penalty) within rtol 1e-6; |grad| max "
          f"{float(np.abs(g_c).max()):.3e}, max |diff| "
          f"{float(np.abs(g_k - g_c).max()):.3e}; card "
          f"{secs[0]:.3f} s, CPU {secs[1]:.3f} s", flush=True)


def serve_run(dev, cfg, lens, rng, per_prefill: dict, note: str) -> dict:
    """``cfg`` (random weights from seed 0) serves one request of each
    prompt length in ``lens`` (tokens drawn from ``rng``) through
    ServeEngine (SERVE_SLOTS lanes,
    greedy, SERVE_NEW new tokens), launch counts read around the run:
    every request done with 1 + SERVE_NEW tokens, every logit finite, each
    kernel of ``per_prefill`` launched that many times a prefill.  Prints
    tokens/s, the prefill and decode walls, peak memory, and the busy
    share of one prefill and one decode tick."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.api import build_model
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.serve.engine import frontend_tokens

    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(L))
                    .astype(np.int32), max_new=SERVE_NEW)
            for i, L in enumerate(lens)]
    P = frontend_tokens(cfg)
    eng = ServeEngine(model, ServeConfig(batch_slots=SERVE_SLOTS,
                                         max_len=P + int(max(lens)) + 40),
                      device=dev)
    # Every logit the engine samples from, checked on the device.
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    plain_prefill, plain_decode = model.prefill, model.decode

    def checked(fn):
        def call(batch):
            logits, caches = fn(batch)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, caches
        return call
    model.prefill, model.decode = checked(plain_prefill), \
        checked(plain_decode)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    del model.prefill, model.decode      # the class's methods again
    peak = torch.cuda.max_memory_allocated(dev)
    n_tok = sum(len(r.out_tokens) for r in done)
    check(len(done) == len(lens) and all(
        r.done and not r.truncated and len(r.out_tokens) == 1 + SERVE_NEW
        for r in done),
        f"serve {cfg.name}: not every request came back done with "
        f"{1 + SERVE_NEW} tokens: "
        f"{[(r.rid, r.done, r.truncated, len(r.out_tokens)) for r in done]}")
    check(int(bad) == 0, f"serve {cfg.name}: {int(bad)} non-finite logits")
    for k in ("flash_attention", "ssd_scan"):
        want = per_prefill.get(k, 0) * len(lens)
        check(launches.get(k, 0) == want,
              f"{k} launched {launches.get(k, 0)} times in the {cfg.name} "
              f"serve run, expected {want} ({per_prefill.get(k, 0)} a "
              f"prefill x {len(lens)} prefills)")
    s = eng.summary()
    pw = {k: v for k, v in s["wall"].items() if k.startswith("prefill")}
    dw = {k: v for k, v in s["wall"].items() if k.startswith("decode")}
    prefill_s = sum(v["mean"] * v["count"] for v in pw.values())
    decode_s = sum(v["mean"] * v["count"] for v in dw.values())
    print(f"serve: {cfg.name} {note} ({n_params / 1e9:.3f} B "
          f"parameters as stored; ArchConfig.param_count "
          f"{cfg.param_count() / 1e9:.3f} B; init {init_s:.1f} s), "
          f"{len(lens)} requests of {sorted(int(L) for L in lens)} "
          f"tokens{f' after {P} patch embeddings' if P else ''}, "
          f"{SERVE_SLOTS} lanes, greedy, max_new {SERVE_NEW}: "
          f"{wall:.3f} s wall, {n_tok} tokens out ({n_tok / wall:.2f} "
          f"tokens/s; {int(sum(lens)) / prefill_s:.1f} prompt tokens/s in "
          f"prefill); prefill {prefill_s:.3f} s over {len(lens)} "
          f"(first {pw.get('prefill_wall_s_first', {}).get('mean', 0):.3f} s,"
          f" warm mean {pw.get('prefill_wall_s_warm', {}).get('mean', 0):.3f}"
          f" s), decode {decode_s:.3f} s over {s['ticks']} ticks (first "
          f"{dw.get('decode_wall_s_first', {}).get('mean', 0) * 1e3:.2f} ms,"
          f" warm mean "
          f"{dw.get('decode_wall_s_warm', {}).get('mean', 0) * 1e3:.2f}"
          f" ms, p90 {dw.get('decode_wall_s_warm', {}).get('p90', 0) * 1e3:.2f}"
          f" ms; {s['decode_tokens']} decode tokens); flash_attention "
          f"launches {launches.get('flash_attention', 0)}, ssd_scan "
          f"launches {launches.get('ssd_scan', 0)}; peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    longest = reqs[int(np.argmax(lens))].prompt
    batch = eng.prefill_batch(longest)
    profile_busy(f"one {cfg.name} prefill of {len(longest)} tokens",
                 lambda: model.prefill(batch))
    profile_busy(f"one {cfg.name} decode tick of {SERVE_SLOTS} lanes",
                 lambda: model.decode({
                     "token": batch["tokens"][:, :1].expand(SERVE_SLOTS, 1),
                     "pos": torch.tensor([P + len(longest)] * SERVE_SLOTS,
                                         device=dev), **eng.caches}))
    del model, eng, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": wall}


def serve_phase(dev) -> dict:
    """hymba-1.5b at full width through ServeEngine, 8 requests of 2-4k
    tokens; each kernel launched once a layer a prefill."""
    import numpy as np
    from repro_torch import configs

    cfg = configs.get("hymba-1.5b")
    rng = np.random.default_rng(0)
    lens = rng.integers(2048, 4097, SERVE_REQUESTS)
    return serve_run(dev, cfg, lens, rng, {"flash_attention": cfg.n_layers,
                                      "ssd_scan": cfg.n_layers},
                     "at full width")


def serve_reference_phase(dev) -> None:
    """hymba at full width, 2 layers: the same weights on the card (the
    kernels) and on the CPU (their plain versions)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models.api import Model, build_model

    cfg = dataclasses.replace(configs.get("hymba-1.5b"), n_layers=2)
    card = build_model(cfg, dev, seed=0)

    def to_cpu(t):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in t.items()}
    cpu = Model(cfg, to_cpu(card.tree()))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 300)))
    errs = []
    t0 = time.perf_counter()
    lg, cg = card.prefill({"tokens": prompt.to(dev)})
    lc, cc = cpu.prefill({"tokens": prompt})
    for step in range(5):
        err, ratio = allclose_ratio(lg.cpu(), lc, SERVE_REF_TOL)
        check(bool(torch.isfinite(lg).all()) and ratio <= 1.0,
              f"serve reference: card != CPU logits at step {step} (max "
              f"|diff| {err}, {ratio:.3f} of the {SERVE_REF_TOL} bound)")
        errs.append((err, ratio))
        if step == 4:
            break
        tok = torch.argmax(lc[:, :cfg.vocab_size], -1)[:, None]
        pos = 300 + step
        lg, cg = card.decode({"token": tok.to(dev),
                              "pos": torch.tensor(pos, device=dev), **cg})
        lc, cc = cpu.decode({"token": tok, "pos": torch.tensor(pos), **cc})
    print(f"serve reference: hymba-1.5b at full width, 2 layers, a 300-token"
          f" prompt and 4 decode steps: card logits allclose to the CPU's at "
          f"atol=rtol={SERVE_REF_TOL} (max |diff| per step "
          f"{[round(e, 6) for e, _ in errs]}, largest share of the bound "
          f"{max(r for _, r in errs):.3f}; {time.perf_counter() - t0:.1f} s)",
          flush=True)


CLUSTER_DAYS = 2                # the cluster cell cut to two days (seeds 3-4)
CLUSTER_CPU_RTOL = 1e-6         # card vs CPU: the reports' floats


def cluster_kernel_phase(dev) -> None:
    """schedule_delta at the cluster's shapes, bitwise against its plain
    version, and timed: seed 3's day, one instance (B = 1) with its
    2001-entry ``cum``, the plan's population [64, T] and a re-solve's
    [32, T]; starts over the window and its overrun, durations of the
    instance's own machines."""
    import torch
    from repro_torch import bench
    from repro_torch.cluster.executor import PLAN_SA, RESOLVE_SA
    from repro_torch.kernels import schedule_eval
    from repro_torch.kernels.ref import schedule_delta_ref
    from repro_torch.kernels.schedule_eval import schedule_delta

    _, p, cum = bench.cluster_inputs(bench.CLUSTER_FIRST_SEED, dev)
    cum = torch.as_tensor(cum, dtype=torch.float32, device=dev)
    H = cum.numel() - 1
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    flush = l2_flush(dev)
    for label, pop in (("plan", PLAN_SA.pop), ("re-solve", RESOLVE_SA.pop)):
        shape = (1, pop, p.T)
        start = torch.randint(-3, H + 6, shape, generator=g, device=dev,
                              dtype=torch.int32)
        m = torch.randint(0, p.M, shape, generator=g, device=dev)
        dur = torch.gather(p.dur.expand(1, pop, p.T, p.M), -1,
                           m[..., None])[..., 0].contiguous()
        c = cum[None].contiguous()
        out = schedule_delta(start, dur, c)
        ref = schedule_delta_ref(start, dur, c)
        torch.cuda.synchronize()
        check(same_bits(out, ref), f"schedule_delta != schedule_delta_ref at "
              f"the cluster {label} shape {shape}, H={H}")
        ms = time_cuda(lambda: schedule_delta(start, dur, c), KERNEL_REPS,
                       flush)
        plain_ms = time_cuda(lambda: schedule_delta_ref(start, dur, c),
                             KERNEL_REPS, flush)
        bound_ms, _, moved = kernel_bound(schedule_eval, start, dur, c)
        print(f"kernel schedule_delta cluster {label} shape {shape} (H={H}): "
              f"bitwise equal to the plain version; {ms:.4f} ms (L2 "
              f"flushed), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({moved / 1e3:.1f} kB"
              " at 3.35 TB/s)", flush=True)
        print_device_ms(f"schedule_delta cluster {label} shape",
                        lambda: schedule_delta(start, dur, c),
                        "schedule_delta")


def cluster_days_differ(cpu: dict, card: dict, rtol: float) -> list:
    """Where two ``bench.cluster_day`` records part: the plan's starts,
    assignments and makespan and every report's ints exactly, their
    floats within ``rtol``."""
    import numpy as np
    out = []
    for f in ("start", "assign"):
        if not np.array_equal(cpu[f], card[f]):
            out.append(f"plan {f}: {cpu[f].tolist()} vs {card[f].tolist()}")
    if cpu["plan"]["makespan"] != card["plan"]["makespan"]:
        out.append(f"plan makespan {cpu['plan']['makespan']} vs "
                   f"{card['plan']['makespan']}")
    for run in ("clean", "failure", "straggler"):
        for k, a in cpu[run].items():
            b = card[run][k]
            if k.endswith("seconds"):
                continue
            if isinstance(a, int):
                ok = a == b
            else:
                ok = bool(np.isclose(b, a, rtol=rtol, atol=0.0))
            if not ok:
                out.append(f"{run} {k}: CPU {a} vs card {b}")
    return out


def cluster_path(dev) -> dict:
    """The cluster cell cut to two days (seeds 3-4) through
    ``bench.run_cluster``, launch counts read around it, held to the
    reference test's invariants; one plan under ``torch.profiler``; then
    seed 3's day on the CPU and on the card, both fed the CPU generator's
    draws: the same plan and the same three reports."""
    import torch
    from repro_torch import bench
    from repro_torch.cluster.executor import (PLAN_SA, RESOLVE_SA,
                                              ClusterExecutor)
    from repro_torch.core.solvers.common import HostDraws
    from repro_torch.kernels import LAUNCHES, reset_launches

    seed = bench.CLUSTER_FIRST_SEED
    reset_launches()
    rec = bench.run_cluster(CLUSTER_DAYS, dev)
    launches = dict(LAUNCHES)

    def sa_launches(cfg):       # phase 2: init + iterations + migrations
        return 1 + cfg.iters + cfg.iters // cfg.migrate_every

    n_resolves = sum(d["failure"]["n_resolves"] for d in rec["days"])
    want = (CLUSTER_DAYS * sa_launches(PLAN_SA)
            + n_resolves * sa_launches(RESOLVE_SA))
    check(launches.get("schedule_eval", 0) == want,
          f"schedule_eval launched {launches.get('schedule_eval', 0)} times "
          f"on the cluster path, expected {want} (phase 2 of each plan and "
          "each re-solve)")
    for line in bench.cluster_lines(rec["days"][0]):
        print(f"cluster path: {line}", flush=True)
    for d in rec["days"]:
        ex_s = sum(d[r]["seconds"] for r in ("clean", "failure",
                                             "straggler"))
        print(f"cluster path: seed {d['seed']} (T={d['T']}): plan "
              f"{d['plan']['seconds']:.3f} s, re-solve "
              f"{[round(x, 4) for x in d['failure']['resolve_seconds']]} s, "
              f"executions {ex_s:.4f} s (clean "
              f"{d['clean']['seconds']:.4f}, failure "
              f"{d['failure']['seconds']:.4f}, straggler "
              f"{d['straggler']['seconds']:.4f}); makespans plan "
              f"{d['plan']['makespan']}, failure "
              f"{d['failure']['achieved_makespan']} (restarts "
              f"{d['failure']['n_restarts']}), straggler "
              f"{d['straggler']['achieved_makespan']} (copies "
              f"{d['straggler']['n_speculative']}); plan start "
              f"{d['start'].tolist()}, assign {d['assign'].tolist()}",
              flush=True)
    for d in rec["days"]:
        plan, day = d["plan"], f"cluster seed {d['seed']}"
        clean, fail, slow = d["clean"], d["failure"], d["straggler"]
        check(clean["achieved_makespan"] == plan["makespan"]
              and abs(clean["achieved_carbon"] - plan["carbon"])
              <= 1e-3 * abs(plan["carbon"])
              and clean["n_resolves"] == clean["n_restarts"] == 0,
              f"{day}: the clean run {clean} does not reproduce the plan "
              f"{plan}")
        check(fail["n_resolves"] == 1 and fail["recovery_overhead"] < 1.0,
              f"{day}: the failure run {fail}")
        check(slow["n_resolves"] == 0
              and slow["achieved_makespan"] < 3 * plan["makespan"],
              f"{day}: the straggler run {slow}")
    # A copy needs an idle live machine when the straggler crosses its
    # threshold, so whether a day issues one depends on its plan (ROADMAP
    # Queue 3 item 9).
    check(any(d["straggler"]["n_speculative"] >= 1 for d in rec["days"]),
          "cluster: no straggler run issued a speculative copy")
    print(f"cluster path: {len(rec['days'])} days in {rec['seconds']:.3f} s; "
          "stages " + json.dumps(rec["seconds_by_stage"]) + "; launches "
          + json.dumps(launches), flush=True)

    _, p, cum = bench.cluster_inputs(seed, dev)
    ex = ClusterExecutor(p, cum, stretch=bench.CLUSTER["stretch"],
                         seed=seed, device=dev)
    ex.plan()
    profile_kernels("one cluster plan (seed 3, pop 64 x 60 a phase)",
                    ex.plan)

    def host_draws(device):
        """The plan from one CPU generator, the re-solves from another."""
        resolve = HostDraws(seed + 1, device)
        return lambda kind: HostDraws(seed, device) if kind == "plan" \
            else resolve

    t0 = time.perf_counter()
    cpu = bench.cluster_day(seed, "cpu", draws=host_draws("cpu"))
    card = bench.cluster_day(seed, dev, draws=host_draws(dev))
    check(cpu["failure"]["n_resolves"] == 1,
          "cluster card vs CPU: the failure run made no re-solve")
    diff = cluster_days_differ(cpu, card, CLUSTER_CPU_RTOL)
    check(not diff, "cluster card vs CPU on the same draws: "
          + "; ".join(diff))
    print(f"cluster card vs CPU: seed {seed}'s day on the CPU generator's "
          "draws (the plan and one re-solve): plan equal, all three"
          f" reports' ints equal, floats within rtol {CLUSTER_CPU_RTOL} "
          f"(CPU plan {cpu['plan']['seconds']:.3f} s, re-solve "
          f"{cpu['failure']['resolve_seconds'][0]:.3f} s; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return {"launches": launches, "seconds": rec["seconds"]}


# The shard layer (rows split into blocks, one per shard): row-keyed
# draws, then the sharded bound, sweep and learner on one card, then a
# two-process fleet on the one card.
SHARD_KINDS = ("bits", "uniform", "bernoulli", "randint", "normal", "gumbel")
SHARD_INT_KINDS = ("bits", "uniform", "bernoulli", "randint")
SHARD_BOUND_SHARDS = 2          # the FULL bound, 960 rows as 2 x 480
SHARD_TINY_SHARDS = 3           # the TINY grid's 40 rows, padded to 42
SHARD_LEARN_SHARDS = 2
FLEET_PROCESSES = 2
FLEET_TIMEOUT_S = 600


def _row_draw(draws, kind: str, shape: tuple, T: int):
    if kind == "bernoulli":
        return draws.bernoulli(2.0 / T, shape)
    if kind == "randint":
        return draws.randint(0, T, shape)
    return getattr(draws, kind)(shape)


def _leaves(tree, prefix: str = "") -> list:
    """``(name, tensor)`` of every tensor of nested NamedTuples."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    return [leaf for f in tree._fields
            for leaf in _leaves(getattr(tree, f), f"{prefix}.{f}".strip("."))]


def row_draws_phase(dev, B: int, pop: int, T: int, M: int, seed: int
                    ) -> None:
    """``RowDraws`` at the structure cell's SA shapes ``[B, pop, T]`` and
    ``[B, pop, T, M]``: every kind's first half of the rows, drawn alone,
    bitwise the same rows of the full draw; the integer path bitwise the
    same draw on the CPU; each draw timed beside ``TorchDraws``'s."""
    import torch
    from repro_torch.core.solvers.common import (RowDraws, TorchDraws,
                                                 row_seeds)

    t0 = time.perf_counter()
    seeds = row_seeds(seed, B)
    half = B // 2
    times = {}
    for shape in ((B, pop, T), (B, pop, T, M)):
        for kind in SHARD_KINDS:
            full = _row_draw(RowDraws(seeds, dev), kind, shape, T)
            part = _row_draw(RowDraws(seeds[:half], dev), kind,
                             (half,) + shape[1:], T)
            check(same_bits(full[:half], part),
                  f"RowDraws.{kind} at {list(shape)}: rows 0:{half} drawn "
                  "alone differ from the full draw's")
            if kind in SHARD_INT_KINDS:
                cpu = _row_draw(RowDraws(seeds, "cpu"), kind, shape, T)
                check(same_bits(full.cpu(), cpu),
                      f"RowDraws.{kind} at {list(shape)}: the card's draw "
                      "differs from the CPU's")
            if kind != "bits":
                times[f"{kind}{list(shape)}"] = [
                    round(time_cuda(lambda: _row_draw(
                        draws, kind, shape, T), 5), 4)
                    for draws in (RowDraws(seeds, dev), TorchDraws(0, dev))]
            del full, part
    torch.cuda.synchronize(dev)
    print(f"shard path: RowDraws at [{B}, {pop}, {T}] and [{B}, {pop}, {T}, "
          f"{M}]: rows 0:{half} alone bitwise the full draw's for "
          f"{', '.join(SHARD_KINDS)}; {', '.join(SHARD_INT_KINDS)} bitwise "
          f"the CPU's ({time.perf_counter() - t0:.1f} s)", flush=True)
    print("shard path: ms a draw by CUDA events, [RowDraws, TorchDraws]: "
          + json.dumps(times), flush=True)


def shard_bound_phase(dev, structure: dict) -> dict:
    """The FULL structure batch's offline bound (SA pop x iterations of
    the structure spec, both phases) unsharded and through
    ``bilevel_sharded`` at SHARD_BOUND_SHARDS shards on the one card:
    every field bitwise; the unsharded bound is the structure path's
    (its per-cell mean savings are the rows' ``offline_bound_savings_pct``);
    launch counts read around each."""
    import numpy as np
    import torch
    from repro_torch.core.solvers import solve_bilevel_batch
    from repro_torch.core.solvers.common import RowDraws, row_seeds
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.scenarios import build_batch
    from repro_torch.shard import bilevel_sharded

    spec = structure["spec"]
    sb = build_batch(spec, dev)
    B = int(sb.cell_of.shape[0])
    seeds = row_seeds(spec.seed, B)
    kw = dict(objective="carbon", stretch=spec.offline_stretch,
              cfg1=spec.sa, cfg2=spec.sa)
    walls, launches, out = {}, {}, {}
    for name, fn in (
            ("unsharded", lambda: solve_bilevel_batch(
                sb.batch, sb.cum, RowDraws(seeds, dev), **kw)),
            ("sharded", lambda: bilevel_sharded(
                sb.batch, sb.cum, seeds,
                devices=[dev] * SHARD_BOUND_SHARDS, **kw))):
        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - t0
        launches[name] = dict(LAUNCHES)
    want = 1 + spec.sa.iters + spec.sa.iters // spec.sa.migrate_every
    check(launches["unsharded"].get("schedule_eval", 0) == want
          and launches["sharded"].get("schedule_eval", 0)
          == SHARD_BOUND_SHARDS * want,
          f"schedule_eval launches: unsharded "
          f"{launches['unsharded'].get('schedule_eval', 0)} (expected "
          f"{want}), sharded {launches['sharded'].get('schedule_eval', 0)} "
          f"(expected {SHARD_BOUND_SHARDS * want})")
    bad = []
    for (name, a), (_, b) in zip(_leaves(out["unsharded"]),
                                 _leaves(out["sharded"])):
        if not same_bits(a, b):
            rows = (a != b).reshape(B, -1).any(-1).nonzero().flatten()
            bad.append(f"{name} ({rows.numel()} rows, first "
                       f"{rows[:8].tolist()})")
    check(not bad, f"bilevel_sharded at {SHARD_BOUND_SHARDS} shards differs "
          f"from the unsharded bound in: {'; '.join(bad)}")
    sav = out["unsharded"].carbon_savings.cpu().numpy()
    for ci, row in enumerate(structure["rows"]):
        got = round(100 * float(sav[sb.cell_of == ci].mean()), 3)
        check(got == row["offline_bound_savings_pct"],
              f"the unsharded bound's cell {ci} savings {got} differ from "
              f"the structure path's {row['offline_bound_savings_pct']}")
    print(f"shard path: the FULL structure bound ({B} rows, T={sb.batch.T}, "
          f"M={sb.batch.M}, H={sb.cum.shape[-1] - 1}, SA {spec.sa.pop} x "
          f"{spec.sa.iters}) through bilevel_sharded at "
          f"{SHARD_BOUND_SHARDS} shards on one card: every field bitwise "
          f"the unsharded bound's (the structure path's, cell means equal); "
          f"{walls['sharded']:.3f} s sharded vs {walls['unsharded']:.3f} s "
          f"unsharded; launches {json.dumps(launches['sharded'])} vs "
          f"{json.dumps(launches['unsharded'])}; mean savings "
          f"{100 * float(np.mean(sav)):.3f}%", flush=True)
    return launches["sharded"]


def shard_tiny_phase(dev, structure: dict, learn: dict) -> dict:
    """The dispatch-only TINY grid through ``sweep_structure(devices=...)``
    at SHARD_TINY_SHARDS shards (40 rows padded to 42) against the
    structure path's unsharded rows and the golden; the learn TINY golden
    run through ``train_sharded`` / ``eval_theta_sharded`` at
    SHARD_LEARN_SHARDS shards against the learn path's unsharded run and
    the golden; launch counts read around each."""
    import numpy as np
    import torch
    from repro_torch import bench
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.learn import LearnConfig
    from repro_torch.scenarios import sweep_structure
    from repro_torch.shard import eval_theta_sharded, train_sharded

    with open(os.path.join(ROOT, "tests", "golden",
                           "structure_tiny.json")) as f:
        golden = json.load(f)["structure_tiny"]
    reset_launches()
    t0 = time.perf_counter()
    tiny, meta = sweep_structure(bench.structure_spec(tiny=True),
                                 offline=False,
                                 devices=[dev] * SHARD_TINY_SHARDS)
    torch.cuda.synchronize(dev)
    tiny_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check(launches.get("gate_quantile", 0) == SHARD_TINY_SHARDS,
          f"the sharded TINY sweep launched gate_quantile "
          f"{launches.get('gate_quantile', 0)} times, expected one a shard "
          f"({SHARD_TINY_SHARDS})")
    check(tiny == structure["tiny_rows"],
          "the sharded TINY grid's rows differ from the unsharded ones")
    for got, want_row in zip(tiny, golden["cells"]):
        bad = golden_mismatches(got, want_row)
        check(not bad, f"sharded structure TINY cell {want_row['family']}-m"
              f"{want_row['n_machines']}-{want_row['fleet']}: {bad} differ "
              "from tests/golden/structure_tiny.json")
    print(f"shard path: the dispatch-only TINY grid at {SHARD_TINY_SHARDS} "
          f"shards on one card ({meta['instances']} rows padded to "
          f"{-(-meta['instances'] // SHARD_TINY_SHARDS) * SHARD_TINY_SHARDS})"
          f" equals the unsharded rows and tests/golden/structure_tiny.json;"
          f" {tiny_s:.3f} s vs {structure['tiny_seconds']:.3f} s unsharded; "
          f"launches {json.dumps(launches)}", flush=True)

    k = bench.LEARN_TINY
    batch, intens, cums, group, window = bench.learn_tiny_inputs(dev)
    on = dict(devices=[dev] * SHARD_LEARN_SHARDS)
    reset_launches()
    t0 = time.perf_counter()
    res = train_sharded(batch, intens, cums, group, window, k["stretch"],
                        np.full(len(k["families"]), k["theta0"], np.float32),
                        LearnConfig(steps=k["steps"]), **on)
    sav = eval_theta_sharded(batch, intens, cums,
                             res.theta[torch.as_tensor(group, device=dev)],
                             window, k["stretch"], **on)[0].cpu().numpy()
    learn_s = time.perf_counter() - t0
    learn_launches = dict(LAUNCHES)
    want = SHARD_LEARN_SHARDS * (k["steps"] + 1)
    check(learn_launches.get("gate_quantile", 0) == want,
          f"the sharded tiny training launched gate_quantile "
          f"{learn_launches.get('gate_quantile', 0)} times, expected {want} "
          "(one a shard a step, one a shard for the evaluation)")
    got = {"loss_curve": [round(float(v), 6) for v in res.loss_curve.cpu()],
           "final_theta": [round(float(v), 6) for v in res.theta.cpu()],
           "learned_savings_pct": [
               round(100 * float(sav[group == gi].mean()), 3)
               for gi in range(len(k["families"]))]}
    with open(os.path.join(ROOT, "tests", "golden", "learn_tiny.json")) as f:
        lgold = json.load(f)["learn_tiny"]
    for key, (rtol, atol) in LEARN_GOLDEN_TOL.items():
        check(got[key] == learn["tiny"][key],
              f"learn TINY at {SHARD_LEARN_SHARDS} shards: {key} "
              f"{got[key]} differs from the unsharded {learn['tiny'][key]}")
        check(bool(np.allclose(got[key], lgold[key], rtol=rtol, atol=atol)),
              f"learn TINY at {SHARD_LEARN_SHARDS} shards: {key} differs "
              "from tests/golden/learn_tiny.json")
    print(f"shard path: the learn TINY golden run at {SHARD_LEARN_SHARDS} "
          "shards on one card (train_sharded, eval_theta_sharded) equals "
          "the unsharded run and tests/golden/learn_tiny.json; "
          f"{learn_s:.3f} s vs {learn['tiny_seconds']:.3f} s unsharded; "
          f"launches {json.dumps(learn_launches)}", flush=True)
    return {k: launches.get(k, 0) + learn_launches.get(k, 0)
            for k in set(launches) | set(learn_launches)}


def fleet_worker() -> int:
    """One rank of the fleet phase (spawned by :func:`fleet_phase` with
    the ``REPRO_*`` env): the TINY grid with the offline bound, sharded
    over the fleet on this rank's card; its rows as the last line."""
    sys.path.insert(0, SRC)
    import torch
    from repro_torch import bench, shard
    from repro_torch.scenarios import sweep_structure
    shard.initialize_from_env(initialization_timeout=FLEET_TIMEOUT_S)
    t0 = time.perf_counter()
    rows, meta = sweep_structure(bench.structure_spec(tiny=True),
                                 offline=True,
                                 processes=shard.process_count())
    torch.cuda.synchronize()
    print(json.dumps({"rows": rows, "seconds": time.perf_counter() - t0,
                      "device": meta["device"]}), flush=True)
    return 0


def spawn_ranks(n: int, args: list, timeout: float, label: str,
                order=None) -> dict:
    """``n`` ranks of a gloo fleet on this machine: this script run with
    ``args`` and the ``REPRO_*`` env, spawned in ``order`` (rank order by
    default).  Each writes to files of its own, never to a pipe that could
    fill while another rank is being waited on.  Fails unless every rank
    ends within ``timeout`` with code 0; returns each rank's last stdout
    line, parsed as JSON."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = {}, {}
    try:
        for rank in (range(n) if order is None else order):
            env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{port}",
                       REPRO_NUM_PROCESSES=str(n), REPRO_PROCESS_ID=str(rank))
            logs[rank] = (tempfile.TemporaryFile("w+"),
                          tempfile.TemporaryFile("w+"))
            procs[rank] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *args],
                env=env, stdout=logs[rank][0], stderr=logs[rank][1],
                text=True)
        deadline = time.monotonic() + timeout
        for rank, p in procs.items():
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"{label} rank {rank} still running "
                                   f"after {timeout} s") from None
        outs = {}
        for rank, files in logs.items():
            for f in files:
                f.seek(0)
            outs[rank] = tuple(f.read() for f in files)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for files in logs.values():
            for f in files:
                f.close()
    results = {}
    for rank, p in sorted(procs.items()):
        out, err = outs[rank]
        check(p.returncode == 0, f"{label} rank {rank} failed (rc="
              f"{p.returncode}):\n{err[-3000:]}")
        results[rank] = json.loads(out.strip().splitlines()[-1])
    return results


def fleet_phase(dev) -> None:
    """FLEET_PROCESSES ranks on the one card over gloo (this script in
    ``--fleet-worker`` mode, spawned in reversed rank order with the
    ``REPRO_*`` env) sweep the TINY grid with the offline bound; each
    rank's rows must equal this process's unsharded sweep's."""
    import torch
    from repro_torch import bench
    from repro_torch.scenarios import sweep_structure

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    single, _ = sweep_structure(bench.structure_spec(tiny=True),
                                offline=True, device=dev)
    torch.cuda.synchronize(dev)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn_ranks(FLEET_PROCESSES, ["--fleet-worker"], FLEET_TIMEOUT_S,
                        "fleet", order=reversed(range(FLEET_PROCESSES)))
    wall = time.perf_counter() - t0
    for rank in ranks:
        check(ranks[rank]["rows"] == json.loads(json.dumps(single)),
              f"fleet rank {rank}'s TINY rows with the offline bound "
              "differ from the single-process sweep's")
    print(f"shard path: a {FLEET_PROCESSES}-process fleet on one card "
          "(gloo, spawned in reversed rank order) swept the TINY grid with "
          "the offline bound equal to the single-process sweep on every "
          f"rank; sweep {[round(r['seconds'], 3) for r in ranks.values()]} "
          f"s a rank ({wall:.1f} s with the processes' start) vs "
          f"{single_s:.3f} s in one process", flush=True)


def shard_path(dev, structure: dict, learn: dict) -> dict:
    """The shard layer's phases: row-keyed draws, the sharded FULL bound,
    the sharded TINY sweep and learner, the two-process fleet."""
    t0 = time.perf_counter()
    spec, meta = structure["spec"], structure["meta"]
    row_draws_phase(dev, meta["instances"], spec.sa.pop, meta["pad_tasks"],
                    meta["pad_machines"], spec.seed)
    bound = shard_bound_phase(dev, structure)
    tiny = shard_tiny_phase(dev, structure, learn)
    fleet_phase(dev)
    print(f"shard path: {time.perf_counter() - t0:.1f} s in all", flush=True)
    return {"launches": {k: bound.get(k, 0) + tiny.get(k, 0)
                         for k in set(bound) | set(tiny)}}


# The moe, encdec and vlm families at inference: the attention kernel at
# their shapes, then each served, then the card against the CPU.
FAMILY_LAYERS = 8               # qwen3-moe (48) and llava (60) cut to 8
WHISPER_CONTEXT = 448           # whisper's decoder positions
WHISPER_PROMPT = WHISPER_CONTEXT - SERVE_NEW   # decoding stays inside it
FAMILY_PROMPTS = (1024, 2049)   # qwen3-moe and llava prompt lengths
FLIP_TOL = 1e-6                 # a routing flip only at a near tie


def family_plan(rng) -> list:
    """Phase 17's served runs, ``(cfg, prompt lengths, flash_attention
    launches a prefill, note)``: whisper-base at full width and depth
    (prompts of WHISPER_PROMPT tokens, so that decoding stays inside the
    decoder's 448 positions; the reference's engine feeds the encoder one
    zero frame a prompt token, so all take one pool length), then
    qwen3-moe-30b-a3b and llava-next-34b at full width cut to
    FAMILY_LAYERS layers (prompts of 1024-2048 tokens drawn from ``rng``;
    llava's after 8 zero patches).  flash_attention: 18 launches a
    whisper prefill (6 encoder, 6 decoder, 6 cross), one a layer for the
    other two."""
    import dataclasses

    from repro_torch import configs

    whisper = configs.get("whisper-base")
    plan = [(whisper, [WHISPER_PROMPT] * SERVE_REQUESTS,
             2 * whisper.n_layers + whisper.n_encoder_layers,
             "at full width and depth")]
    for arch in ("qwen3-moe-30b-a3b", "llava-next-34b"):
        full = configs.get(arch)
        cfg = dataclasses.replace(full, n_layers=FAMILY_LAYERS)
        plan.append((cfg, rng.integers(*FAMILY_PROMPTS, SERVE_REQUESTS),
                     FAMILY_LAYERS, f"at full width, {FAMILY_LAYERS} of "
                     f"{full.n_layers} layers"))
    return plan


def family_flash_cases(dev, plan) -> tuple[dict, dict]:
    """flash_attention inputs ``(q, k, v, causal)``, bf16, at the new
    families' shapes.  First the shapes the served runs of ``plan`` give
    it, at each model's longest prompt: whisper's encoder over its frames
    (non-causal), its decoder's cross attention to them (non-causal) and
    its causal self-attention; qwen3-moe's and llava's causal prefill
    (llava's after its patches).  Then timing shapes the served path does
    not reach: whisper's encoder over its 30 s window of 1500 frames, its
    decoder's 448 queries against them, qwen3-moe's prefill of 4096
    tokens (32 heads on 4, dh 128) and llava's of 2880 patches and 1024
    text tokens (56 heads on 8, dh 128)."""
    import torch
    from repro_torch.serve.engine import frontend_tokens
    g = torch.Generator(device=dev)
    g.manual_seed(17)

    def qkv(H, KVH, Sq, Skv, dh):
        return [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                for s in ((1, H, Sq, dh), (1, KVH, Skv, dh),
                          (1, KVH, Skv, dh))]
    served = {}
    for cfg, lens, _, _ in plan:
        H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        n = int(max(lens))
        S = frontend_tokens(cfg) + n
        if cfg.n_encoder_layers:        # one encoder frame a prompt token
            served[f"{cfg.name} served encoder"] = (*qkv(H, KVH, n, n, dh),
                                                    False)
            served[f"{cfg.name} served cross"] = (*qkv(H, KVH, S, n, dh),
                                                  False)
        served[f"{cfg.name} served prefill"] = (*qkv(H, KVH, S, S, dh), True)
    timing = {"whisper encoder": (*qkv(8, 8, 1500, 1500, 64), False),
              "whisper cross": (*qkv(8, 8, 448, 1500, 64), False),
              "qwen3-moe prefill": (*qkv(32, 4, 4096, 4096, 128), True),
              "llava prefill": (*qkv(56, 8, 3904, 3904, 128), True)}
    return served, timing


def family_kernel_phase(dev, plan) -> dict:
    """(a) flash_attention at the families' shapes against its plain
    version, timed beside its bound and SDPA (``is_causal``); the timing
    shapes also by their device time."""
    from repro_torch.kernels.flash_attention import flash_attention

    flush = l2_flush(dev)
    served, timing = family_flash_cases(dev, plan)
    out = {}
    for name, (q, k, v, causal) in {**served, **timing}.items():
        out[name] = flash_measure(name, q, k, v, causal, 0, KERNEL_REPS,
                                  flush, sdpa_mask=False)
        if name in timing:
            print_device_ms(f"flash_attention {name}",
                            lambda: flash_attention(q, k, v, causal),
                            "flash_")
    return out


def family_serve_phase(dev, plan, rng) -> dict:
    """(b) Each model of ``plan`` served through ServeEngine, its prompt
    tokens drawn from ``rng``."""
    runs, launches, seconds = {}, {}, 0.0
    for cfg, lens, per_prefill, note in plan:
        r = serve_run(dev, cfg, lens, rng, {"flash_attention": per_prefill},
                      note)
        runs[cfg.name] = r
        seconds += r["seconds"]
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"launches": launches, "seconds": seconds, "runs": runs}


def route_flips(ids_a, probs_a, ids_b, names=("the card", "the CPU")
                ) -> int:
    """Rows whose chosen experts differ between two routings of the same
    tokens (``names`` say whose); fails unless the experts at the
    differing slots tie within FLIP_TOL in ``probs_a``."""
    rows = (ids_a != ids_b).any(-1).nonzero()[:, 0].tolist()
    for r in rows:
        slots = (ids_a[r] != ids_b[r]).nonzero()[:, 0]
        experts = sorted(set(ids_a[r, slots].tolist())
                         | set(ids_b[r, slots].tolist()))
        p = probs_a[r, experts]
        check(float(p.max() - p.min()) <= FLIP_TOL,
              f"routing: row {r} chose experts {ids_a[r].tolist()} on "
              f"{names[0]} and {ids_b[r].tolist()} on {names[1]}, "
              f"probabilities "
              f"{p.tolist()} (not a tie within {FLIP_TOL})")
    return len(rows)


def family_reference_phase(dev) -> None:
    """(c) The same weights on the card and on the CPU: whisper-base whole,
    qwen3-moe at full width and 2 layers, llava at full width, 1 layer and
    8 patches, kimi-k2 reduced.  A short prompt, prefill and 4 decode
    steps, logits allclose at SERVE_REF_TOL; the MoE routes compared layer
    by layer."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.api import Model, build_model
    from repro_torch.serve.engine import frontend_inputs, frontend_tokens

    def to_cpu(t):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in t.items()}

    def pad(c):          # room for the decode steps in the KV caches
        return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
                if k in ("k_cache", "v_cache") else v for k, v in c.items()}

    real_route = moe_mod._route
    cases = [(configs.get("whisper-base"), 96),
             (dataclasses.replace(configs.get("qwen3-moe-30b-a3b"),
                                  n_layers=2), 128),
             (dataclasses.replace(configs.get("llava-next-34b"), n_layers=1),
              64),
             (configs.get("kimi-k2-1t-a32b").reduced(), 100)]
    for cfg, n in cases:
        t0 = time.perf_counter()
        card = build_model(cfg, dev, seed=0)
        cpu = Model(cfg, to_cpu(card.tree()))
        prompt = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, n)))
        batch = {"tokens": prompt, **frontend_inputs(cfg, n, "cpu")}
        P = frontend_tokens(cfg)
        routes = {"card": [], "cpu": []}
        side = ["card"]

        def recording(x2d, router, k):
            out = real_route(x2d, router, k)
            routes[side[0]].append((x2d.cpu(), router.cpu(), k,
                                    out[0].cpu(), out[2].cpu()))
            return out
        moe_mod._route = recording
        try:
            errs = []
            lg, cg = card.prefill({k: v.to(dev) for k, v in batch.items()})
            side[0] = "cpu"
            lc, cc = cpu.prefill(batch)
            cg, cc = pad(cg), pad(cc)
            for step in range(5):
                err, ratio = allclose_ratio(lg.cpu(), lc, SERVE_REF_TOL)
                check(bool(torch.isfinite(lg).all()) and ratio <= 1.0,
                      f"families reference: {cfg.name} card != CPU logits "
                      f"at step {step} (max |diff| {err}, {ratio:.3f} of "
                      f"the {SERVE_REF_TOL} bound)")
                errs.append((err, ratio))
                if step == 4:
                    break
                tok = torch.argmax(lc[:, :cfg.vocab_size], -1)[:, None]
                pos = P + n + step
                side[0] = "card"
                lg, cg = card.decode({"token": tok.to(dev), "pos":
                                      torch.tensor(pos, device=dev), **cg})
                side[0] = "cpu"
                lc, cc = cpu.decode({"token": tok, "pos": torch.tensor(pos),
                                     **cc})
        finally:
            moe_mod._route = real_route
        # Layer by layer, the card's router against the CPU's on the
        # card's own router inputs: the same tokens, so any flip is the
        # two devices' float32 sums at a near tie.  End to end the CPU's
        # router reads its own hidden states, which differ from the
        # card's by bf16 noise: those differences are counted (slots
        # reordered, experts changed), and the logits check above holds
        # their effect.
        flips = rows = moved = changed = 0
        check(len(routes["card"]) == len(routes["cpu"]),
              f"families reference: {cfg.name} routed {len(routes['card'])}"
              f" times on the card, {len(routes['cpu'])} on the CPU")
        for (x2d, router, k, ia, pa), (_, _, _, ib, _) in zip(
                routes["card"], routes["cpu"]):
            flips += route_flips(ia, pa, real_route(x2d, router, k)[0])
            rows += ia.shape[0]
            moved += int((ia != ib).any(-1).sum())
            changed += int((ia.sort(-1).values != ib.sort(-1).values)
                           .any(-1).sum())
        routed = (f"; routes compared layer by layer on the card's router "
                  f"inputs: {rows} token rows in {len(routes['card'])} calls,"
                  f" {flips} flips at near ties; end to end (each device's "
                  f"own hidden states) {moved} rows routed otherwise, "
                  f"{changed} of them to another expert set"
                  if routes["card"] else "")
        print(f"families reference: {cfg.name} ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}), a {n}-token prompt"
              f"{f' after {P} patches' if P else ''} and 4 decode steps: "
              f"card logits allclose to the CPU's at atol=rtol="
              f"{SERVE_REF_TOL} (max |diff| per step "
              f"{[round(e, 6) for e, _ in errs]}, largest share of the bound "
              f"{max(r for _, r in errs):.3f}){routed}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del card, cpu
        torch.cuda.empty_cache()


def family_path(dev) -> dict:
    """Phase 17: the moe, encdec and vlm families (a), (b), (c)."""
    import numpy as np

    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    plan = family_plan(rng)
    kernels = family_kernel_phase(dev, plan)
    served = family_serve_phase(dev, plan, rng)
    family_reference_phase(dev)
    print(f"families: phase 17 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {**served, "kernels": kernels}


# Phase 18: training.  hymba-1.5b at its published width and depth
# through launch.train and the Trainer (a preemption and its resume),
# whisper-base's encoder and cross attention, the card against the CPU,
# then the two kernels timed at the train shapes.
TRAIN_SEQ = 4096                # the reference's train_4k sequence
TRAIN_BATCH = 2                 # train_4k's 256, cut so one card holds it
TRAIN_STEPS = 6                 # these two cut so that phase 21 fits
TRAIN_CKPT_EVERY = 3            # the time limit: two saves
TRAIN_FAULT = 4                 # the preemption: raised as step 4 starts
TRAIN_RESUME_RTOL = 1e-3        # resumed vs uninterrupted final loss
TRAIN_RESUME_LAYERS = 8         # the preemption's hymba: 8 of 32 layers
TRAIN_REF_TOL = 3e-2            # card vs CPU: loss, params after a step
TRAIN_GRAD_TOL = 5e-2           # card vs CPU: each gradient leaf, rel. norm
WHISPER_TRAIN = (448, 4, 2)     # whisper-base: seq, batch, steps


class TrainCounts:
    """Per-step kernel launches of every Trainer built while it is
    installed (``train.loop.make_train_step`` wrapped), and the calls of
    the two plain versions, split by whether autograd's backward made
    them (``torch._C._current_graph_task_id() != -1``)."""

    def __init__(self):
        self.steps: list[dict] = []
        self.plain = {"flash_attention": [0, 0], "ssd_scan": [0, 0]}

    def __enter__(self):
        import torch
        from repro_torch.kernels import LAUNCHES, ref
        from repro_torch.models import ssm
        from repro_torch.train import loop

        self._real = (loop.make_train_step, ref.flash_attention_plain,
                      ssm.ssd_chunked)
        real_step = loop.make_train_step

        def make(model, tc):
            step = real_step(model, tc)

            def counted(*args):
                before = dict(LAUNCHES)
                out = step(*args)
                self.steps.append({k: LAUNCHES.get(k, 0) - before.get(k, 0)
                                   for k in ("flash_attention", "ssd_scan")})
                return out
            return counted

        def plain(name, fn):
            def call(*args, **kwargs):
                self.plain[name][int(torch._C._current_graph_task_id()
                                     != -1)] += 1
                return fn(*args, **kwargs)
            return call
        loop.make_train_step = make
        ref.flash_attention_plain = plain("flash_attention",
                                          ref.flash_attention_plain)
        ssm.ssd_chunked = plain("ssd_scan", ssm.ssd_chunked)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        from repro_torch.models import ssm
        from repro_torch.train import loop
        (loop.make_train_step, ref.flash_attention_plain,
         ssm.ssd_chunked) = self._real

    def check(self, label: str, per_step: dict) -> None:
        """Every step launched each kernel ``per_step[k]`` times; the plain
        versions ran only in the backward, once per kernel launch pair."""
        for i, n in enumerate(self.steps):
            check(n == per_step, f"train {label}: step {i + 1} launched "
                  f"{n}, expected {per_step} a step")
        for k, (outside, inside) in self.plain.items():
            want = len(self.steps) * per_step[k] // 2
            check(outside == 0 and inside == want,
                  f"train {label}: the plain {k} ran {outside} times outside "
                  f"the backward and {inside} inside, expected 0 and {want}")


def train_config(steps: int):
    """launch.train's optimizer and schedule for ``steps`` steps: lr 3e-4,
    one warmup step, logged every step."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    return TrainConfig(steps=steps, ckpt_every=TRAIN_CKPT_EVERY, log_every=1,
                       opt=AdamWConfig(lr=3e-4, warmup_steps=max(
                           steps // 10, 1), total_steps=steps))


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_split(tr) -> dict:
    """One more step of ``tr`` by its parts, each between two
    synchronisations of the card: the forward (``loss_fn``), the backward
    (``torch.autograd.grad``: the remat recompute, the plain recompute of
    attention and the scan, the rest), the plain recompute's share of it
    (``ops._plain_grads`` timed alike), and the optimizer (AdamW and the
    write-back).  The synchronisations cost a little: the parts add up to
    slightly more than a step."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.api import loss_fn
    from repro_torch.optim import adamw_update

    model = tr.model
    dev = model.device
    batch = tr.pipeline.next_batch()
    params = dict(model.named_parameters())
    plain = {"flash": 0.0, "ssd": 0.0}
    real = ops._plain_grads

    def timed(fn, inputs, grad_out):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real(fn, inputs, grad_out)
        torch.cuda.synchronize(dev)
        plain["flash" if len(inputs) == 3 else "ssd"] += \
            time.perf_counter() - t0
        return out
    ops._plain_grads = timed
    try:
        for p in params.values():
            p.requires_grad_(True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss = loss_fn(model.tree(), batch, model.cfg, model.par)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
    finally:
        ops._plain_grads = real
        for p in params.values():
            p.requires_grad_(False)
    new, tr.state["opt"], _ = adamw_update(params, grads, tr.state["opt"],
                                           tr.tc.opt)
    del grads
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(new[k])
    del new
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    return {"forward": t1 - t0, "backward": t2 - t1,
            "plain attention": plain["flash"], "plain scan": plain["ssd"],
            "optimizer": t3 - t2, "loss": float(loss.detach())}


def train_hymba(dev) -> dict:
    """(a) hymba-1.5b at full width and depth: 6 uninterrupted steps
    through ``launch.train.main`` (seq 4096, batch 2, remat full), a
    split step and a profiled step; then, at full width and
    TRAIN_RESUME_LAYERS layers (for the time of its 5.4 GB checkpoints,
    not 19.7 GB), 6 uninterrupted steps through ``Trainer`` and the same
    6 steps with a checkpoint every 3 and a preemption as step 4 starts,
    resumed by a fresh Trainer from the latest complete checkpoint."""
    import dataclasses
    import statistics as st

    import torch
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.models.api import build_model
    from repro_torch.models.common import ShapeCfg
    from repro_torch.models.parallel import ParallelCfg
    from repro_torch.train import Trainer

    cfg = configs.get("hymba-1.5b")
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "ssd_scan": 2 * cfg.n_layers}
    counts = TrainCounts()
    torch.cuda.synchronize(dev)          # the card's context, if no phase
    torch.cuda.reset_peak_memory_stats(dev)      # before made it
    t0 = time.perf_counter()
    with counts:
        tr = launch_train.main(["--arch", "hymba-1.5b", "--steps",
                                str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ),
                                "--batch", str(TRAIN_BATCH), "--device",
                                str(dev)])
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    counts.check("hymba-1.5b", per_step)
    hist = tr.history
    losses = [m["loss"] for m in hist]
    check(len(hist) == TRAIN_STEPS and all(
        math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
        for m in hist), f"train hymba-1.5b: a loss or grad norm is not "
        f"finite: {hist}")
    check(losses[-1] < losses[0], f"train hymba-1.5b: the loss did not fall "
          f"({losses})")
    warm = st.median(m["sec"] for m in hist[1:])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    n_params = sum(p.numel() for p in tr.model.parameters())
    print(f"train: hymba-1.5b at full width and depth ({n_params / 1e9:.3f}"
          f" B parameters, f32 with f32 AdamW moments), seq {TRAIN_SEQ} x "
          f"batch {TRAIN_BATCH}, remat full, {TRAIN_STEPS} steps through "
          f"launch.train in {run_s:.1f} s: losses "
          f"{[round(l, 4) for l in losses]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in hist]}; s a step "
          f"{[round(m['sec'], 3) for m in hist]} (first {hist[0]['sec']:.3f}"
          f" s, warm median {warm:.3f} s: {tokens / warm:.1f} tokens/s); "
          f"peak device memory {peak / 2**30:.3f} GiB; each kernel "
          f"{per_step['flash_attention']} launches a step ({len(counts.steps)}"
          f" steps), the plain versions {counts.plain['flash_attention'][1]}"
          f" / {counts.plain['ssd_scan'][1]} calls, all in the backward",
          flush=True)
    split = train_split(tr)
    total = sum(v for k, v in split.items()
                if k in ("forward", "backward", "optimizer"))
    print("train: one hymba-1.5b step by its parts (each between two "
          f"synchronisations; {total:.3f} s in all, loss "
          f"{split['loss']:.4f}): " + ", ".join(
              f"{k} {split[k]:.3f} s ({100 * split[k] / total:.1f}%)"
              for k in ("forward", "backward", "plain attention",
                        "plain scan", "optimizer"))
          + " (the plain recompute is part of the backward)", flush=True)
    batch = tr.pipeline.next_batch()
    profile_kernels("one hymba-1.5b train step (seq 4096 x 2, remat full)",
                    lambda: tr.step_fn(tr.state["opt"], tr.state["cstate"],
                                       batch))
    del tr, batch
    free_card()

    class Preempted(Exception):
        pass

    def bomb(step):
        if step == TRAIN_FAULT:
            raise Preempted()

    shape = ShapeCfg("cli", "train", TRAIN_SEQ, TRAIN_BATCH)
    par = ParallelCfg(remat="full")
    cut = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    resumed = TrainCounts()
    with tempfile.TemporaryDirectory() as ckpt, resumed:
        whole = Trainer(build_model(cut, dev, seed=0, par=par),
                        train_config(TRAIN_STEPS), shape=shape)
        cut_losses = [m["loss"] for m in whole.run()]
        del whole
        free_card()
        t0 = time.perf_counter()
        first = Trainer(build_model(cut, dev, seed=0, par=par),
                        train_config(TRAIN_STEPS), shape=shape,
                        ckpt_dir=ckpt, fault_hook=bomb, keep=1)
        check(first.resume() == 0, "train: a fresh checkpoint directory "
              "resumed at a step")
        try:
            first.run()
            check(False, "train: the fault hook did not raise")
        except Preempted:
            pass
        first.ckpt.wait()          # the async step-4 save, as a crash
        saved = first.ckpt.all_steps()     # would leave it on disk
        del first
        free_card()
        pre_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = Trainer(build_model(cut, dev, seed=1, par=par),
                         train_config(TRAIN_STEPS), shape=shape,
                         ckpt_dir=ckpt, keep=1)
        start = second.resume()
        restore_s = time.perf_counter() - t0
        check(start == TRAIN_FAULT - 1 and second.pipeline.step == start,
              f"train: resumed at step {start}, data cursor "
              f"{second.pipeline.step}, expected {TRAIN_FAULT - 1} (saved: "
              f"{saved})")
        t0 = time.perf_counter()
        after = second.run()
        rest_s = time.perf_counter() - t0
        final = after[-1]["loss"]
        del second
        free_card()
    resumed.check(f"hymba-1.5b ({TRAIN_RESUME_LAYERS} layers) preempted and "
                  "resumed", {k: 2 * TRAIN_RESUME_LAYERS for k in per_step})
    err = abs(final - cut_losses[-1]) / abs(cut_losses[-1])
    check(err <= TRAIN_RESUME_RTOL, f"train: the resumed run ended at loss "
          f"{final}, the uninterrupted one at {cut_losses[-1]} (rel "
          f"{err:.3g} > {TRAIN_RESUME_RTOL})")
    print(f"train: hymba-1.5b at full width, {TRAIN_RESUME_LAYERS} layers: "
          f"preemption as step {TRAIN_FAULT} started ({TRAIN_FAULT} "
          f"steps and saves at {TRAIN_CKPT_EVERY}-step intervals, "
          f"{pre_s:.1f} s; on disk after the crash: steps {saved}); a fresh "
          f"Trainer with other weights resumed at step {start} in "
          f"{restore_s:.1f} s and ran to step {TRAIN_STEPS} in {rest_s:.1f} "
          f"s: final loss {final:.6f} vs the uninterrupted "
          f"{cut_losses[-1]:.6f} (rel {err:.3g} <= {TRAIN_RESUME_RTOL})",
          flush=True)
    launches = {k: sum(n[k] for n in counts.steps + resumed.steps)
                for k in per_step}
    return {"launches": launches, "seconds": run_s, "step_s": warm,
            "peak": peak, "split": split}


def train_whisper(dev) -> dict:
    """(b) whisper-base at full width and depth (6 encoder and 6 decoder
    layers), two steps at seq 448, batch 4: the encoder's non-causal and
    the decoder's cross attention through the trainable entry; 36
    flash_attention launches a step under full remat."""
    import torch
    from repro_torch import configs
    from repro_torch.models.api import build_model
    from repro_torch.models.common import ShapeCfg
    from repro_torch.models.parallel import ParallelCfg
    from repro_torch.train import Trainer

    cfg = configs.get("whisper-base")
    seq, batch, steps = WHISPER_TRAIN
    per_step = {"flash_attention": 2 * (2 * cfg.n_layers
                                        + cfg.n_encoder_layers),
                "ssd_scan": 0}
    counts = TrainCounts()
    t0 = time.perf_counter()
    with counts:
        tr = Trainer(build_model(cfg, dev, seed=0,
                                 par=ParallelCfg(remat="full")),
                     train_config(steps),
                     shape=ShapeCfg("cli", "train", seq, batch))
        hist = tr.run()
    wall = time.perf_counter() - t0
    counts.check("whisper-base", per_step)
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in hist), f"train whisper-base: not finite: {hist}")
    print(f"train: whisper-base at full width and depth ({cfg.n_encoder_layers}"
          f" + {cfg.n_layers} layers), seq {seq} x batch {batch}, {steps} "
          f"steps in {wall:.1f} s (s a step {[round(m['sec'], 3) for m in hist]}"
          f"), losses {[round(m['loss'], 4) for m in hist]}; flash_attention "
          f"{per_step['flash_attention']} launches a step (encoder, decoder "
          f"and cross attention, each twice under full remat), the plain "
          f"version {counts.plain['flash_attention'][1]} calls, all in the "
          f"backward", flush=True)
    launches = {k: sum(n[k] for n in counts.steps) for k in per_step}
    del tr
    free_card()
    return {"launches": launches, "seconds": wall}


def train_reference(dev) -> None:
    """(c) The same weights and batch on the card (the kernels forward,
    full remat) and on the CPU (the plain versions): hymba-1.5b at full
    width cut to 2 layers (seq 512, batch 2), and reduced qwen1.5-0.5b,
    mamba2-370m, qwen3-moe-30b-a3b, whisper-base and llava-next-34b (seq
    128, batch 2).  The loss within TRAIN_REF_TOL, each gradient leaf
    within relative Frobenius TRAIN_GRAD_TOL (the worst printed), and the
    parameters after one AdamW step allclose at TRAIN_REF_TOL."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models.api import Model, build_model
    from repro_torch.models.common import ShapeCfg
    from repro_torch.models.parallel import ParallelCfg
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    def to_cpu(t):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in t.items()}

    par = ParallelCfg(remat="full")
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=8)
    cases = [(dataclasses.replace(configs.get("hymba-1.5b"), n_layers=2),
              512)]
    cases += [(configs.get(a).reduced(), 128) for a in (
        "qwen1.5-0.5b", "mamba2-370m", "qwen3-moe-30b-a3b", "whisper-base",
        "llava-next-34b")]
    for cfg, seq in cases:
        t0 = time.perf_counter()
        card = build_model(cfg, dev, seed=0, par=par)
        cpu = Model(cfg, to_cpu(card.tree()), par)
        batch = SyntheticPipeline(cfg, ShapeCfg("t", "train", seq, 2),
                                  device="cpu").next_batch()
        lg, gg = card.loss({k: v.to(dev) for k, v in batch.items()})
        lc, gc_ = cpu.loss(batch)
        lerr = abs(float(lg) - float(lc))
        check(math.isfinite(float(lg)) and lerr <= TRAIN_REF_TOL,
              f"train reference: {cfg.name} loss {float(lg)} on the card, "
              f"{float(lc)} on the CPU")
        errs = {k: float((g.cpu() - gc_[k]).norm()
                         / gc_[k].norm().clamp_min(1e-30))
                for k, g in gg.items()}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= TRAIN_GRAD_TOL, f"train reference: {cfg.name} "
              f"gradient {worst} off the CPU's by {errs[worst]:.4g} "
              f"(relative Frobenius > {TRAIN_GRAD_TOL})")
        pg = dict(card.named_parameters())
        pc = dict(cpu.named_parameters())
        newg, _, _ = adamw_update(pg, gg, adamw_init(pg, opt), opt)
        newc, _, _ = adamw_update(pc, gc_, adamw_init(pc, opt), opt)
        perr, pratio = max((allclose_ratio(newg[k].cpu(), newc[k],
                                           TRAIN_REF_TOL) for k in newc),
                           key=lambda r: r[1])
        check(pratio <= 1.0, f"train reference: {cfg.name} parameters after "
              f"one AdamW step differ by {perr}")
        print(f"train reference: {cfg.name} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}), seq {seq} x 2: loss card {float(lg):.6f} vs "
              f"CPU {float(lc):.6f} (|diff| {lerr:.3g} <= {TRAIN_REF_TOL}); "
              f"worst gradient leaf {worst} at {errs[worst]:.4g} (relative "
              f"Frobenius <= {TRAIN_GRAD_TOL}; {len(errs)} leaves); "
              f"parameters after one AdamW step max |diff| {perr:.3g} "
              f"({pratio:.3f} of the {TRAIN_REF_TOL} bound); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del card, cpu, gg, newg
        free_card()


def train_kernel_phase(dev) -> None:
    """(d) Both kernels at the train shapes (hymba, seq 4096 x batch 2),
    L2 flushed, CUDA events, median of KERNEL_REPS, beside their bounds,
    their plain versions and, for attention, SDPA with the window mask;
    and the trainable entries' backward (autograd through the plain
    version), which a backward kernel would replace, timed alike (median
    of 5)."""
    import torch
    from repro_torch.kernels import ops

    flush = l2_flush(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((B, 25, S, 64), (B, 5, S, 64), (B, 5, S, 64)))
    flash_measure("train (hymba, batch 2)", q, k, v, True, 2048,
                  KERNEL_REPS, flush)
    x = (0.5 * torch.randn((B, S, 32, 100), generator=g, device=dev)
         ).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((B, S, 32), generator=g,
                                                  device=dev))
    A = -torch.exp(0.3 * torch.randn((32,), generator=g, device=dev))
    Bm, Cm = ((0.5 * torch.randn((B, S, 1, 16), generator=g, device=dev)
               ).to(torch.bfloat16) for _ in range(2))
    ssd_measure("train (hymba, batch 2)", x, dt, A, Bm, Cm, 256,
                KERNEL_REPS, flush)

    def backward(fn, inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        ct = torch.ones_like(out)
        return lambda: torch.autograd.grad(out, leaves, ct,
                                           retain_graph=True)
    flash_bwd = time_cuda(backward(
        lambda *a: ops.flash_attention_trainable(*a, causal=True,
                                                 window=2048), (q, k, v)),
        5, flush)
    ssd_bwd = time_cuda(backward(
        lambda *a: ops.ssd_scan_trainable(*a, chunk=256)[0],
        (x, dt, A, Bm, Cm)), 5, flush)
    print(f"kernel train backward (hymba's shapes, batch 2): "
          f"flash_attention_trainable {flash_bwd:.3f} ms, "
          f"ssd_scan_trainable {ssd_bwd:.3f} ms a backward (the plain "
          f"version recomputed and differentiated; L2 flushed, median of 5)",
          flush=True)
    del q, k, v, x, dt, A, Bm, Cm
    free_card()


def train_path(dev) -> dict:
    """Phase 18: training (a), (b), (c), (d)."""
    t0 = time.perf_counter()
    hymba = train_hymba(dev)
    whisper = train_whisper(dev)
    train_reference(dev)
    train_kernel_phase(dev)
    print(f"train: phase 18 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"launches": {k: hymba["launches"][k] + whisper["launches"][k]
                         for k in ("flash_attention", "ssd_scan")},
            "seconds": hymba["seconds"] + whisper["seconds"]}


DRYRUN_ARCH = "hymba-1.5b"      # phase 18's cell: seq 4096 x batch 2, remat
DRYRUN_PEAK_BAND = 0.10         # meta peak vs max_memory_allocated, relative
DRYRUN_MOE = ("qwen3-moe-30b-a3b", "decode_32k")   # a cell only meta holds


def op_table_diff(a: dict, b: dict, limit: int = 20) -> list:
    """The ops whose ``[calls, flops, bytes]`` differ between two
    ``CostMode.ops`` tables."""
    keys = sorted(set(a) | set(b))
    return [(k, a.get(k), b.get(k)) for k in keys
            if a.get(k) != b.get(k)][:limit]


def hook_cost(dev, calls: int = 20000) -> None:
    """The host cost of the kernel entries' cost hook with nothing
    counting: a ``schedule_delta`` call's host time on the card (launches
    queued, not waited for) beside the hook's test alone."""
    import timeit

    import torch
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels.schedule_eval import schedule_delta

    check(not kcost.ACTIVE, f"a count is still active: {kcost.ACTIVE}")
    start = torch.zeros((1, 4, 8), dtype=torch.int32, device=dev)
    dur = torch.ones_like(start)
    cum = torch.zeros((1, 65), device=dev)
    schedule_delta(start, dur, cum)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        schedule_delta(start, dur, cum)
    entry_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize(dev)
    hook_us = timeit.timeit("if kcost.ACTIVE: pass", number=calls,
                            globals={"kcost": kcost}) / calls * 1e6
    print(f"dryrun: the kernel entries' cost hook, nothing counting: a "
          f"schedule_delta call {entry_us:.3f} us on the host ({calls} "
          f"calls, launches queued), the hook's test {hook_us:.4f} us of it",
          flush=True)


def dryrun_path(dev) -> dict:
    """Phase 19: the meta-device dry run against the card.

    (a) hymba-1.5b at full width and depth, one ``make_train_step`` step
    at seq 4096 x batch 2, remat full (phase 18's cell), counted by
    ``launch.op_analysis`` on ``meta`` and then on the card: FLOPs and
    bytes equal, parameter and moment bytes equal to the dry run's
    analytic ones, the meta peak within 10% of the card's
    ``max_memory_allocated`` for the step; a warm step's achieved vs
    roofline at the card's constants.  (b) qwen3-moe-30b-a3b decode_32k
    on ``meta`` for the one-card mesh: status ok (the MoE dispatch runs
    on ``meta``), and the record says it does not fit the card."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.roofline import achieved_vs_roofline
    from repro_torch.models.common import ShapeCfg

    t0 = time.perf_counter()
    cfg = configs.get(DRYRUN_ARCH)
    sc = ShapeCfg("train_4k", "train", TRAIN_SEQ, TRAIN_BATCH)
    mesh = MeshShape.card()
    overrides = {"remat": "full"}
    rec = dryrun.run_cell(DRYRUN_ARCH, sc, mesh, overrides=overrides)
    check(rec["status"] == "ok", f"dry run of {DRYRUN_ARCH} at {sc}: "
          f"{rec.get('error')}")
    policy = dryrun.cell_policy(cfg, sc, mesh, overrides)
    check(policy["microbatches"] == 1, f"policy {policy} splits the step")
    meta_cost, meta_mem, meta_s = rec["cost_total"], rec["memory"], \
        rec["total_s"]

    free_card()
    cell = dryrun.build_cell(cfg, sc, policy, device=dev, seed=0)
    p_bytes = sum(p.untyped_storage().nbytes()
                  for p in cell.model.parameters())
    m_bytes = sum(x.untyped_storage().nbytes()
                  for x in (*cell.opt_state.m.values(),
                            *cell.opt_state.v.values()))
    check(p_bytes == rec["param_bytes_per_device"]
          and m_bytes == rec["moment_bytes_per_device"],
          f"dry run: parameter / moment bytes {rec['param_bytes_per_device']}"
          f" / {rec['moment_bytes_per_device']}, the card's tensors "
          f"{p_bytes} / {m_bytes}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launches()
    t1 = time.perf_counter()
    card_cost, card_mem, card_mode = dryrun.count_cell(cell)
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t1
    counted = dict(LAUNCHES)
    card_peak = (torch.cuda.max_memory_allocated(dev) - base
                 + card_mem["argument_bytes"])
    if (meta_cost["flops"], meta_cost["bytes"]) != \
            (card_cost["flops"], card_cost["bytes"]):
        _, _, meta_mode = dryrun.count_cell(dryrun.build_cell(cfg, sc,
                                                              policy))
        check(False, f"dry run: meta counts {meta_cost['flops']:.0f} FLOPs "
              f"/ {meta_cost['bytes']:.0f} bytes, the card's "
              f"{card_cost['flops']:.0f} / {card_cost['bytes']:.0f}; ops "
              "that differ (op, meta, card): "
              f"{op_table_diff(meta_mode.ops, card_mode.ops)}")
    want = {"flash_attention": 2 * cfg.n_layers,
            "ssd_scan": 2 * cfg.n_layers}
    check({k: counted.get(k, 0) for k in want} == want,
          f"dry run: the counted card step launched {counted}, expected "
          f"{want}")
    meta_peak = meta_mem["argument_bytes"] + meta_mem["temp_bytes"]
    ratio = meta_peak / card_peak
    print(f"dryrun: {DRYRUN_ARCH} {sc}, one step: meta "
          f"{meta_cost['flops']:.6e} FLOPs, {meta_cost['bytes']:.6e} bytes "
          f"(the dry run's cell in {meta_s:.1f} s); the card's equal "
          f"({card_s:.1f} s counted, {counted}); "
          f"parameters {p_bytes} B and moments {m_bytes} B equal to the "
          f"dry run's; peak: meta {meta_peak / 2**30:.3f} GiB (arguments "
          f"{meta_mem['argument_bytes'] / 2**30:.3f}), the card's "
          f"{card_peak / 2**30:.3f} GiB (max_memory_allocated above "
          f"{(base - card_mem['argument_bytes']) / 2**30:.3f} GiB held "
          f"before), ratio {ratio:.4f}; the tracker on the card "
          f"{(card_mem['argument_bytes'] + card_mem['temp_bytes']) / 2**30:.3f}"
          " GiB", flush=True)
    check(abs(ratio - 1.0) <= DRYRUN_PEAK_BAND,
          f"dry run: meta peak {meta_peak} B is {ratio:.4f} x the card's "
          f"{card_peak} B, outside 1 +- {DRYRUN_PEAK_BAND}")
    warms = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        cell.fn(*cell.args)
        torch.cuda.synchronize(dev)
        warms.append(time.perf_counter() - t1)
    roof = achieved_vs_roofline(meta_cost, min(warms))
    print(f"dryrun roofline: {DRYRUN_ARCH} {sc}, a warm step "
          f"{min(warms):.4f} s (of {[round(w, 4) for w in warms]}): "
          f"{roof['achieved_flops_per_s'] / 1e12:.2f} TFLOP/s, "
          f"{roof['achieved_bytes_per_s'] / 1e12:.3f} TB/s of op bytes; "
          f"bound {roof['roofline_bound_s']:.4f} s ({roof['dominant']}: "
          f"{roof['roofline_compute_s']:.4f} s compute, "
          f"{roof['roofline_memory_s']:.4f} s unfused bytes), "
          f"{roof['roofline_frac']:.4f} of it; card {nvidia_smi()}",
          flush=True)
    launches = dict(LAUNCHES)
    del cell
    free_card()

    arch, shape = DRYRUN_MOE
    moe = dryrun.run_cell(arch, shape, mesh)
    check(moe["status"] == "ok", f"dry run of {arch} x {shape}: "
          f"{moe.get('error')}")
    peak = moe["memory"]["argument_bytes"] + moe["memory"]["temp_bytes"]
    check(moe["fits"] is False and peak > moe["hbm_bytes"],
          f"dry run: {arch} x {shape} peak {peak} B said to fit "
          f"{moe['hbm_bytes']} B")
    print(f"dryrun: {arch} x {shape} on meta in {moe['total_s']} s: "
          f"{moe['flops']:.4e} FLOPs; bf16 weights "
          f"{moe['param_bytes_per_device'] / 1e9:.2f} GB, arguments "
          f"{moe['memory']['argument_bytes'] / 1e9:.1f} GB, peak "
          f"{peak / 1e9:.1f} GB against the card's "
          f"{moe['hbm_bytes'] / 1e9:.0f} GB: does not fit", flush=True)
    hook_cost(dev)
    seconds = time.perf_counter() - t0
    print(f"dryrun: phase 19 in {seconds:.1f} s", flush=True)
    return {"launches": launches, "seconds": seconds}


def probe_path(dev) -> dict:
    """Phase 20: the perf probe on the card: the four pinned cells timed
    (``perf.perf_probe``), each roofline column finite, and a record
    written with ``perf.write_json`` that passes
    ``perf_gate.check_provenance``.  The timing verdict against the
    committed baseline is printed, not acted on: wall clocks across
    machines are the gate's business, run by hand."""
    from repro_torch import perf, perf_gate
    from repro_torch.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    reset_launches()
    probe = perf.perf_probe(fresh=True, device=dev)
    launches = dict(LAUNCHES)
    check(set(probe["cells"]) == set(perf.PROBE_CELLS),
          f"probe cells {sorted(probe['cells'])}")
    for name, c in probe["cells"].items():
        roof = c["roofline"]
        check(all(math.isfinite(v) for v in roof.values()
                  if isinstance(v, float)) and c["warm_s_min"] > 0,
              f"probe {name}: {c}")
        print(f"probe {name} ({c['entry']}): cold {c['compile_s']:.6f} s, "
              f"warm min {c['warm_s_min']:.6f} s, median "
              f"{c['warm_s_median']:.6f} s; {roof['hlo_flops']:.4e} FLOPs, "
              f"{roof['hlo_bytes']:.4e} op bytes, "
              f"{roof['roofline_frac']:.6f} of the roofline "
              f"({roof['dominant']})", flush=True)
    for k in ("schedule_eval", "gate_quantile"):
        check(launches.get(k, 0) > 0, f"probe: {k} never launched")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe.json")
        perf.write_json(path, {"bench": "chip_smoke", "timing": {
            "wall_s": round(time.perf_counter() - t0, 3), "probe": probe}},
            dev)
        problems = perf_gate.check_provenance([path])
        with open(path) as f:
            prov = json.load(f)["provenance"]
    check(not problems, f"probe record provenance: {problems}")
    print(f"probe: provenance {json.dumps(prov)}", flush=True)
    verdict = perf_gate.gate_verdict(
        probe, perf_gate.load_baselines([perf_gate.BASELINE_JSON]))
    print("probe gate (printed, not acted on): " + json.dumps(
        {k: verdict[k] for k in ("ok", "compared", "skipped")}), flush=True)
    seconds = time.perf_counter() - t0
    print(f"probe: phase 20 in {seconds:.1f} s, launches {launches}",
          flush=True)
    return {"launches": launches, "seconds": seconds}


# Phase 21: the model over a placed mesh.  Gloo ranks that share the one
# card (this script spawned as --mesh-worker), each holding its shard of
# the model, talking only through models.parallel's all-reduces.
MESH_TIMEOUT_S = 600
MESH_STEP_MESH = "data=2,model=2"   # (a) reduced qwen3-moe, 4 ranks
MESH_STEP_TOL = 5e-3            # (a) card fleet vs CPU fleet: loss, abs
MESH_STEP_GRAD_TOL = 3e-2       # (a) ... each gradient leaf, rel. norm
MESH_SERVE_MESH = "data=1,model=4"  # (b) qwen3-moe-30b-a3b, 8 layers
MESH_SERVE_LANES = 2
MESH_SERVE_PROMPT = 1024
MESH_SERVE_DECODE = 16
MESH_SERVE_TOL = 3e-2           # (b) logits vs one card, atol = rtol
MESH_TRAIN_MESH = "data=1,model=2"  # (c) hymba-1.5b, full width and depth
MESH_TRAIN_SEQ = 1024           # (c) phase 18's 4096 cut: see mesh_train
MESH_TRAIN_BATCH = 2
MESH_TRAIN_TOL = 3e-2           # (c) loss vs one card, relative
MESH_TRAIN_GRAD_TOL = 5e-2      # (c) each gradient leaf, rel. norm
MESH_TRAIN_F32_TOL = 5e-3       # (c) float32 witness: mesh vs one card
MESH_TRAIN_WITNESS = 2.0        # (c) mesh's bf16 distance to it / one card's


def mesh_tokens(cfg, seed: int, shape: tuple):
    import numpy as np
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def serial_build(mesh, build):
    """``build()`` on each rank in turn (a barrier between ranks): a rank
    draws each whole leaf on the card before it keeps its block, and the
    ranks' whole leaves would not fit the card at once."""
    import torch
    import torch.distributed as dist
    out = None
    for r in range(mesh.size):
        if r == mesh.rank:
            out = build()
            torch.cuda.synchronize(mesh.device)
        dist.barrier()
    return out


def mesh_worker(mode: str, work: str, device: str) -> int:
    """One rank of phase 21 (spawned by :func:`mesh_path` with the
    ``REPRO_*`` env): ``step`` (a), ``serve`` (b) or ``train`` (c); its
    results as the last line, rank 0's arrays under ``work``."""
    sys.path.insert(0, SRC)
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs, shard
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import MeshShape, ProcessMesh
    from repro_torch.launch.sharding import (batch_shard, gather_params,
                                             make_parallel)
    from repro_torch.models import parallel
    from repro_torch.models.api import build_model, model_defs
    from repro_torch.models.common import materialize
    from repro_torch.models.params import local_slices
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig
    from repro_torch.train.loop import make_train_step

    shard.initialize_from_env(initialization_timeout=MESH_TIMEOUT_S)
    if device == "cpu":
        torch.set_num_threads(2)
    spec = {"step": MESH_STEP_MESH, "serve": MESH_SERVE_MESH,
            "train": MESH_TRAIN_MESH}[mode]
    mesh = ProcessMesh.build(MeshShape.parse(spec), device)
    dev = mesh.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = {"rank": mesh.rank, "device": str(dev)}
    parallel.TIME_COLLECTIVES = True
    if mode == "step":
        cfg = configs.get("qwen3-moe-30b-a3b").reduced()
        par = make_parallel(cfg, mesh, remat="none")
        model = build_model(cfg, "cpu", seed=0, par=par).to(dev)
        tokens = torch.from_numpy(mesh_tokens(cfg, 0, (8, 64)))
        labels = torch.cat([tokens[:, 1:], torch.full((8, 1), -1,
                                                      dtype=torch.int32)], 1)
        batch = batch_shard({"tokens": tokens.to(dev),
                             "labels": labels.to(dev)}, cfg, par)
        reset_launches()
        loss, grads = model.loss(batch)
        out["loss"] = float(parallel.sum_no_grad(loss, par, par.batch_axes))
        out["launches"] = dict(LAUNCHES)
        grads = gather_params(parallel.sum_over_data(grads, par),
                              model_defs(cfg), par)
        if mesh.rank == 0:
            np.savez(os.path.join(work, f"step_{device}.npz"),
                     **{k: g.float().cpu().numpy() for k, g in grads.items()})
    elif mode == "serve":
        cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b"),
                                  n_layers=FAMILY_LAYERS)
        par = make_parallel(cfg, mesh)
        model = serial_build(mesh, lambda: build_model(cfg, dev, seed=0,
                                                       par=par))
        toks = torch.from_numpy(mesh_tokens(
            cfg, 24, (MESH_SERVE_LANES, MESH_SERVE_PROMPT + MESH_SERVE_DECODE)
        )).to(dev)
        logits, routes, walls = mesh_serve(model, toks, sync)
        out.update(walls)
        if mesh.rank == 0:      # the router's inputs are the same on each
            np.save(os.path.join(work, "serve_mesh.npy"), logits)
            torch.save(routes, os.path.join(work, "serve_routes.pt"))
    else:
        cfg = configs.get("hymba-1.5b")
        par = make_parallel(cfg, mesh, remat="full")
        model = serial_build(mesh, lambda: build_model(cfg, dev, seed=0,
                                                       par=par))
        batch = materialize(cfg, "train_4k", seq=MESH_TRAIN_SEQ,
                            batch=MESH_TRAIN_BATCH, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        parallel.reset_traffic()
        rules = par.effective_rules()

        def grad_sq(grads, folders):
            """This rank's block of each leaf against each of ``folders``'
            whole leaves: ``{folder: {leaf: [|diff|^2, |want|^2]}}``,
            on the card (float32 norms)."""
            sq = {f: {} for f in folders}
            for d, name in mesh_leaves(model_defs(cfg)):
                for f in folders:
                    want = torch.from_numpy(np.ascontiguousarray(np.load(
                        os.path.join(work, f, name + ".npy"), mmap_mode="r")[
                            local_slices(d, rules, mesh)])).to(dev)
                    sq[f][name] = [
                        float(torch.linalg.vector_norm(grads[name] - want))
                        ** 2, float(torch.linalg.vector_norm(want)) ** 2]
                    del want
            return sq
        sync()
        t0 = time.perf_counter()
        loss, grads = model.loss(batch)
        sync()
        out["loss_s"] = time.perf_counter() - t0
        out["loss"] = float(loss)
        out["launches"] = dict(LAUNCHES)
        out["traffic"] = {a: list(v) for a, v in parallel.TRAFFIC.items()}
        out["grad_sq"] = grad_sq(grads, ("grads", "grads32"))
        del grads
        loss, grads = f32_loss(model, batch)      # the float32 witness
        out["loss32"] = float(loss)
        out["grad_sq"]["f32"] = grad_sq(grads, ("grads32",))["grads32"]
        del grads
        out["sharded"] = sorted(model.sharded)
        tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=1,
                                         total_steps=8))
        opt = adamw_init(dict(model.named_parameters()), tc.opt)
        sync()
        t0 = time.perf_counter()
        _, _, m = make_train_step(model, tc)(opt, None, batch)
        sync()
        out["step_s"] = time.perf_counter() - t0
        out["step_loss"] = float(m["loss"])
        out["grad_norm"] = float(m["grad_norm"])
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        out["launches_run"] = dict(LAUNCHES)
    # Every rank leaves the groups together: a rank that exits with gloo's
    # threads still up can abort at interpreter shutdown.
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def f32_loss(model, batch):
    """``model.loss(batch)`` with the compute dtype float32 (hymba's
    weights are float32 already): the kernels' float32 paths and no bf16
    rounding anywhere, a witness for the bf16 runs' gradients."""
    import torch
    from repro_torch.models import layers
    layers.COMPUTE_DTYPE = torch.float32
    try:
        return model.loss(batch)
    finally:
        layers.COMPUTE_DTYPE = torch.bfloat16


def mesh_leaves(defs, prefix: str = ""):
    """(ParamDef, ``named_parameters`` name) of every leaf."""
    from repro_torch.models.params import ParamDef
    for k in sorted(defs):
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(defs[k], ParamDef):
            yield defs[k], name
        else:
            yield from mesh_leaves(defs[k], name)


def mesh_serve(model, toks, sync):
    """A prefill of ``toks``' prompts and MESH_SERVE_DECODE decode steps
    fed its next tokens (the same on one card and on the mesh): the logits
    of every step, every router call's ``(inputs, ids)`` in call order
    (the prefill's layers, then each decode step's), and the walls, peak
    memory, kernel launches and collective traffic of the run."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.build import LAUNCHES, reset_launches
    from repro_torch.models import moe, parallel

    dev = model.device
    P = MESH_SERVE_PROMPT
    real, routes = moe._route, []

    def route(x2d, router, k):          # kept on the card until the end
        out = real(x2d, router, k)
        routes.append((x2d.detach(), out[0]))
        return out
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    parallel.reset_traffic()
    moe._route = route
    try:
        sync()
        t0 = time.perf_counter()
        logits, caches = model.prefill({"tokens": toks[:, :P]})
        sync()
        prefill_s = time.perf_counter() - t0
        for k in ("k_cache", "v_cache"):             # room for the decode
            caches[k] = F.pad(caches[k], (0, 0, 0, 0, 0, MESH_SERVE_DECODE))
        steps = [logits]
        t0 = time.perf_counter()
        for t in range(MESH_SERVE_DECODE):
            logits, caches = model.decode(
                {"token": toks[:, P + t:P + t + 1],
                 "pos": torch.tensor(P + t), **caches})
            steps.append(logits)
        sync()
        decode_s = time.perf_counter() - t0
    finally:
        moe._route = real
    walls = {"prefill_s": prefill_s, "decode_s": decode_s,
             "peak": torch.cuda.max_memory_allocated(dev),
             "launches": dict(LAUNCHES),
             "traffic": {a: list(v) for a, v in parallel.TRAFFIC.items()}}
    routes = [(x.cpu(), ids.cpu()) for x, ids in routes]
    return torch.stack(steps).cpu().numpy(), routes, walls


def mesh_step(work: str) -> dict:
    """(a) the reduced qwen3-moe 2 x 2 loss and gradients on the card and
    on the CPU, each a 4-rank fleet (the CPU fleet is the one
    ``tests/test_torch_mesh_fleet.py`` holds to the reference)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # the two fleets side by side
        card, cpu = pool.map(
            lambda d: spawn_ranks(4, ["--mesh-worker", "step", work, d],
                                  MESH_TIMEOUT_S, f"mesh step ({d})"),
            ("cuda", "cpu"))
    wall = time.perf_counter() - t0
    losses = {r["loss"] for r in card.values()}
    check(len(losses) == 1 and len({r["loss"] for r in cpu.values()}) == 1,
          f"mesh step: the ranks' losses differ: {card} / {cpu}")
    err = abs(card[0]["loss"] - cpu[0]["loss"])
    check(err <= MESH_STEP_TOL, f"mesh step: the card fleet's loss "
          f"{card[0]['loss']} is {err:.3g} from the CPU fleet's "
          f"{cpu[0]['loss']} (> {MESH_STEP_TOL})")
    with np.load(os.path.join(work, "step_cuda.npz")) as a, \
            np.load(os.path.join(work, "step_cpu.npz")) as b:
        rel = {k: float(np.linalg.norm(a[k] - b[k])
                        / max(np.linalg.norm(b[k]), 1e-30)) for k in b.files}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= MESH_STEP_GRAD_TOL, f"mesh step: gradient {worst} "
          f"of the card fleet is {rel[worst]:.3g} from the CPU fleet's")
    print(f"mesh (a): reduced qwen3-moe, one loss and backward over "
          f"{MESH_STEP_MESH} (4 gloo ranks on the card, 4 on the CPU; "
          f"{wall:.1f} s with the processes' start): loss {card[0]['loss']:.6f}"
          f" on every card rank vs {cpu[0]['loss']:.6f} on the CPU ranks "
          f"(|diff| {err:.3g} <= {MESH_STEP_TOL}); gradients put back "
          f"together, worst {worst} at {rel[worst]:.3g} (<= "
          f"{MESH_STEP_GRAD_TOL}); launches a card rank "
          f"{card[0]['launches']}", flush=True)
    return {r: card[r]["launches"] for r in card}


def mesh_serve_phase(dev, work: str) -> dict:
    """(b) qwen3-moe-30b-a3b at full width cut to FAMILY_LAYERS layers
    (PR 21's cut) over ``model=4``: a prefill of 2 prompts of 1024 tokens
    and 16 decode steps on one card, then on 4 ranks holding a quarter of
    its experts, heads and vocabulary each; logits within MESH_SERVE_TOL.
    The router is replicated: as in phase 17, rank 0's router inputs of
    every call go through one card's router, and the ids must be rank
    0's but at ties within FLIP_TOL.  End to end (each run's own hidden
    states, which differ by the f32 reduce's rounding) the routings that
    differ are counted, and the logits check holds their effect."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(configs.get("qwen3-moe-30b-a3b"),
                              n_layers=FAMILY_LAYERS)
    model = build_model(cfg, dev, seed=0)
    toks = torch.from_numpy(mesh_tokens(
        cfg, 24, (MESH_SERVE_LANES, MESH_SERVE_PROMPT + MESH_SERVE_DECODE)
    )).to(dev)
    want, want_routes, single = mesh_serve(
        model, toks, lambda: torch.cuda.synchronize(dev))
    routers = model.tree()["blocks"]["moe"]["router"].detach().clone()
    del model
    free_card()
    t0 = time.perf_counter()
    ranks = spawn_ranks(4, ["--mesh-worker", "serve", work, "cuda"],
                        MESH_TIMEOUT_S, "mesh serve")
    wall = time.perf_counter() - t0
    got = np.load(os.path.join(work, "serve_mesh.npy"))
    routes = torch.load(os.path.join(work, "serve_routes.pt"))
    check(bool(np.isfinite(got).all()), "mesh serve: logits not finite")
    bad = np.abs(got - want) > MESH_SERVE_TOL * (1 + np.abs(want))
    check(not bad.any(), f"mesh serve: {int(bad.sum())} logits off the one "
          f"card's by more than {MESH_SERVE_TOL} (max |diff| "
          f"{float(np.abs(got - want).max()):.3g})")
    check(len(routes) == len(want_routes) == cfg.n_layers * (
        1 + MESH_SERVE_DECODE), f"mesh serve: {len(routes)} router calls "
        f"on the mesh, {len(want_routes)} on one card")
    flips = rows = moved = 0
    for i, ((x2d, ids), (_, ids_1)) in enumerate(zip(routes, want_routes)):
        ia, _, pa = moe._route(x2d.to(dev), routers[i % cfg.n_layers],
                               cfg.experts_per_token)
        flips += route_flips(ia.cpu(), pa.cpu(), ids,
                             ("one card", "the mesh's rank 0"))
        rows += ids.shape[0]
        moved += int((ids != ids_1).any(-1).sum())
    ms = {r: {k: ranks[r][k] for k in ("prefill_s", "decode_s")}
          for r in ranks}
    print(f"mesh (b): qwen3-moe-30b-a3b at full width, {cfg.n_layers} "
          f"layers, over {MESH_SERVE_MESH} (4 gloo ranks on one card): "
          f"prefill {MESH_SERVE_LANES} x {MESH_SERVE_PROMPT} and "
          f"{MESH_SERVE_DECODE} decode steps; logits within "
          f"{MESH_SERVE_TOL} of one card (max |diff| "
          f"{float(np.abs(got - want).max()):.3g}); routes compared call by "
          f"call on rank 0's router inputs: {rows} token rows in "
          f"{len(routes)} calls, {flips} flips at ties within {FLIP_TOL}; "
          f"end to end (each run's own hidden states) {moved} rows routed "
          f"otherwise; one card prefill {single['prefill_s']:.3f} s decode "
          f"{single['decode_s']:.3f} s peak {single['peak'] / 2**30:.2f} GiB;"
          f" per rank {json.dumps(ms)}, peak GiB "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks.values()]}, "
          f"flash_attention launches "
          f"{[r['launches'].get('flash_attention', 0) for r in ranks.values()]}"
          f", all-reduce calls/bytes/s per rank "
          f"{json.dumps(ranks[0]['traffic'])}; {wall:.1f} s with the "
          "processes' start", flush=True)
    return {r: ranks[r]["launches"] for r in ranks}


def mesh_train_phase(dev, work: str) -> dict:
    """(c) hymba-1.5b at full width and depth over ``model=2`` (its 25
    attention heads replicated, the SSM, MLP and vocabulary split): one
    loss and gradient, then one train step, through
    ``flash_attention_trainable`` and ``ssd_scan_trainable`` on each
    rank's heads, against one card's on the same weights and batch.

    A float32 witness: the same loss and gradient with the compute dtype
    float32, on one card and on the ranks.  The two float32 gradients
    must agree to MESH_TRAIN_F32_TOL, which a sharding fault would break;
    and each bf16 run is held to the witness, the mesh's within
    MESH_TRAIN_WITNESS times one card's distance (plus
    MESH_TRAIN_F32_TOL), so that the bf16 gap between the two runs is
    shown to be each side's own bf16 rounding.

    The sequence is cut from phase 18's 4096 x 2 to MESH_TRAIN_SEQ x 2
    for time, not memory: one card's step holds 6.6 GB of parameters,
    as much of gradients and 13 GB of moments, each rank half of it, and
    phase 18 fits the whole step at 4096 in 80 GB; but every layer
    all-reduces its [2, S, 1600] float32 activations about six times a
    step (forward, remat recompute, backward), through gloo's host
    staging at well under 1 GB/s, which at 4096 costs tens of seconds a
    step."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models.api import build_model
    from repro_torch.models.common import materialize
    from repro_torch.models.parallel import ParallelCfg
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainConfig
    from repro_torch.train.loop import make_train_step

    def save(grads, folder):
        os.makedirs(os.path.join(work, folder))
        for k, g in grads.items():
            np.save(os.path.join(work, folder, k + ".npy"), g.cpu().numpy())

    cfg = configs.get("hymba-1.5b")
    model = build_model(cfg, dev, seed=0, par=ParallelCfg(remat="full"))
    batch = materialize(cfg, "train_4k", seq=MESH_TRAIN_SEQ,
                        batch=MESH_TRAIN_BATCH, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    loss, grads = model.loss(batch)
    torch.cuda.synchronize(dev)
    loss_s = time.perf_counter() - t0
    loss32, grads32 = f32_loss(model, batch)
    # One card's bf16 gradient against the witness, leaf by leaf (as
    # rel() below: relative, or absolute where the witness is zero).
    witness = {}
    for k in grads:
        d, n = (float(torch.linalg.vector_norm(t))
                for t in (grads[k] - grads32[k], grads32[k]))
        witness[k] = d / n if n else d
    save(grads, "grads")
    save(grads32, "grads32")
    del grads, grads32
    tc = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=8))
    opt = adamw_init(dict(model.named_parameters()), tc.opt)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, _, m = make_train_step(model, tc)(opt, None, batch)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    single = {"loss": float(loss), "loss32": float(loss32),
              "step_loss": float(m["loss"]),
              "grad_norm": float(m["grad_norm"])}
    del model, opt, m, batch
    free_card()
    t0 = time.perf_counter()
    ranks = spawn_ranks(2, ["--mesh-worker", "train", work, "cuda"],
                        MESH_TIMEOUT_S, "mesh train")
    wall = time.perf_counter() - t0
    # Each leaf's relative error over the whole leaf: a sharded leaf's
    # blocks summed over the ranks, a replicated leaf on each rank.
    sharded = set(ranks[0]["sharded"])

    def rel(key):
        out = {}
        for name in ranks[0]["grad_sq"][key]:
            parts = [r["grad_sq"][key][name] for r in ranks.values()]
            if name in sharded:
                parts = [[sum(p[0] for p in parts),
                          sum(p[1] for p in parts)]]
            out[name] = max(math.sqrt(d / n) if n else math.sqrt(d)
                            for d, n in parts)
        return out
    bf16, f32, mesh_w = rel("grads"), rel("f32"), rel("grads32")
    top = sorted(bf16, key=bf16.get, reverse=True)[:3]
    worst32 = max(f32, key=f32.get)
    print(f"mesh (c): hymba-1.5b at full width and depth over "
          f"{MESH_TRAIN_MESH} (2 gloo ranks on one card), seq "
          f"{MESH_TRAIN_SEQ} x {MESH_TRAIN_BATCH}, remat full: loss "
          f"{[round(r['loss'], 6) for r in ranks.values()]} vs one card "
          f"{single['loss']:.6f}; step loss / grad norm "
          f"{[(round(r['step_loss'], 6), round(r['grad_norm'], 4)) for r in ranks.values()]}"
          f" vs {single['step_loss']:.6f} / {single['grad_norm']:.4f}; the "
          f"worst bf16 gradient leaves against one card's (relative "
          f"Frobenius, <= {MESH_TRAIN_GRAD_TOL}), each run's own distance "
          f"to the float32 witness beside them (mesh, one card): "
          f"{json.dumps({k: [round(v[k], 5) for v in (bf16, mesh_w, witness)] for k in top})}; "
          f"float32 witness: loss "
          f"{[round(r['loss32'], 6) for r in ranks.values()]}"
          f" vs one card {single['loss32']:.6f}, the worst leaf {worst32} "
          f"at {f32[worst32]:.3g} (<= {MESH_TRAIN_F32_TOL}); loss+backward"
          f" s per rank {[round(r['loss_s'], 3) for r in ranks.values()]} "
          f"vs one card {loss_s:.3f}; step s "
          f"{[round(r['step_s'], 3) for r in ranks.values()]} vs "
          f"{step_s:.3f}; peak GiB "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks.values()]} vs "
          f"{peak / 2**30:.2f}; launches per rank (bf16 loss and backward) "
          f"{[r['launches'] for r in ranks.values()]}, in all "
          f"{[r['launches_run'] for r in ranks.values()]}; all-reduce "
          f"calls/bytes/s of rank 0's loss and backward "
          f"{json.dumps(ranks[0]['traffic'])}; {wall:.1f} s with the "
          "processes' start", flush=True)
    for r in ranks.values():
        for k in ("loss", "step_loss", "grad_norm"):
            err = abs(r[k] - single[k]) / abs(single[k])
            check(err <= MESH_TRAIN_TOL, f"mesh train: rank {r['rank']}'s "
                  f"{k} {r[k]} is {err:.3g} from one card's {single[k]}")
        err = abs(r["loss32"] - single["loss32"]) / abs(single["loss32"])
        check(err <= MESH_TRAIN_F32_TOL, f"mesh train: rank {r['rank']}'s "
              f"float32 loss {r['loss32']} is {err:.3g} from one card's "
              f"{single['loss32']}")
        n = 2 * cfg.n_layers
        check(r["launches"].get("flash_attention", 0) == n
              and r["launches"].get("ssd_scan", 0) == n,
              f"mesh train: rank {r['rank']} launched {r['launches']}, "
              f"expected {n} of each (forward and remat recompute)")
    check(bf16[top[0]] <= MESH_TRAIN_GRAD_TOL, f"mesh train: gradient "
          f"{top[0]} is {bf16[top[0]]:.3g} from one card's")
    check(f32[worst32] <= MESH_TRAIN_F32_TOL, f"mesh train: float32 "
          f"gradient {worst32} is {f32[worst32]:.3g} from one card's")
    for k in bf16:
        check(mesh_w[k] <= MESH_TRAIN_WITNESS * witness[k]
              + MESH_TRAIN_F32_TOL, f"mesh train: the mesh's bf16 gradient "
              f"{k} is {mesh_w[k]:.3g} from the float32 witness, one "
              f"card's {witness[k]:.3g}")
    return {r: ranks[r]["launches_run"] for r in ranks}


def mesh_path(dev) -> dict:
    """Phase 21: (a) the reduced qwen3-moe 2 x 2 step, card fleet vs CPU
    fleet; (b) qwen3-moe-30b-a3b served over ``model=4``; (c) hymba-1.5b
    trained over ``model=2``.  Launches are the mesh ranks' own (the
    one-card comparisons are not counted)."""
    free_card()               # the ranks share the card with this process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        per_rank = [mesh_step(work), mesh_serve_phase(dev, work),
                    mesh_train_phase(dev, work)]
    launches = {}
    for part in per_rank:
        for counts in part.values():
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
    seconds = time.perf_counter() - t0
    print(f"mesh: phase 21 in {seconds:.1f} s, launches on the ranks "
          f"{launches}", flush=True)
    return {"launches": launches, "seconds": seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure(f"no src/repro_torch beside {__file__}: run it "
                           "from a checkout of the repository")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    for name, lib in libs.items():
        print(f"build: {name}.cu -> {os.path.relpath(lib, ROOT)}", flush=True)
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # The model kernels run on the tensor cores: wgmma (HGMMA) fed by TMA
    # (UTMALDG) for attention, mma.sync (HMMA) for the SSD.
    flash = sass_ops(str(libs["flash_attention"]), build.nvcc(),
                     ("HGMMA", "UTMALDG"))
    ssd = sass_ops(str(libs["ssd_scan"]), build.nvcc(), ("HMMA",))
    print(f"sass: flash_attention {flash}, ssd_scan {ssd}", flush=True)
    check(min(flash.values()) > 0 and ssd["HMMA"] > 0,
          f"the model kernels' SASS lacks tensor-core instructions: "
          f"flash_attention {flash}, ssd_scan {ssd}")

    laps, last = {"build": round(time.perf_counter() - t0, 1)}, [
        time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        laps[name] = round(now - last[0], 1)
        last[0] = now

    kernels = [kernel_phase(dev), gate_kernel_phase(dev)]
    lap("kernels")
    main = main_path(dev)
    kernels[0]["launches"] = main["launches"].get("schedule_eval", 0)
    lap("main")
    online = online_path(dev)
    kernels[1]["launches"] = online["launches"].get("gate_quantile", 0)
    lap("online")
    layer_phase(dev, main["seconds"])
    reference_phase(dev)
    lap("layers, reference")
    kernels += [flash_kernel_phase(dev), ssd_kernel_phase(dev)]
    lap("model kernels")
    serve = serve_phase(dev)
    kernels[2]["launches"] = serve["launches"].get("flash_attention", 0)
    kernels[3]["launches"] = serve["launches"].get("ssd_scan", 0)
    serve_reference_phase(dev)
    lap("serve")
    forecast_kernel_phase(dev)
    forecast = forecast_path(dev)
    lap("forecast")
    structure = structure_path(dev)
    lap("structure")
    knobs, rate, service = stream_full_setup(dev)
    stream_gate_phase(dev, knobs, rate)
    stream = stream_path(dev, knobs, rate, service)
    lap("stream")
    learn_gate_phase(dev)
    learn = learn_path(dev)
    lap("learn")
    cluster_kernel_phase(dev)
    cluster = cluster_path(dev)
    lap("cluster")
    sharded = shard_path(dev, structure, learn)
    lap("shard")
    family = family_path(dev)
    kernels[2]["launches"] += family["launches"].get("flash_attention", 0)
    lap("families")
    train = train_path(dev)
    kernels[2]["launches"] += train["launches"]["flash_attention"]
    kernels[3]["launches"] += train["launches"]["ssd_scan"]
    lap("train")
    dry = dryrun_path(dev)
    lap("dryrun")
    probe = probe_path(dev)
    lap("probe")
    mesh = mesh_path(dev)
    lap("mesh")
    for kern, name in zip(kernels, ("schedule_eval", "gate_quantile",
                                    "flash_attention", "ssd_scan")):
        kern["launches"] += (dry["launches"].get(name, 0)
                             + probe["launches"].get(name, 0)
                             + mesh["launches"].get(name, 0))
    print(f"phase seconds ({sum(laps.values()):.1f} in all): "
          + json.dumps(laps), flush=True)

    paths = {"main": main, "online": online, "serve": serve,
             "forecast": forecast, "structure": structure, "stream": stream,
             "learn": learn, "cluster": cluster, "shard": sharded,
             "families": family, "train": train, "dryrun": dry,
             "probe": probe, "mesh": mesh}
    print("launches by path: " + json.dumps(
        {name: {k: r["launches"].get(k, 0)
                for k in ("schedule_eval", "gate_quantile",
                          "flash_attention", "ssd_scan")}
         for name, r in paths.items()}), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:] == ["--fleet-worker"]:
            sys.exit(fleet_worker())
        if sys.argv[1:2] == ["--mesh-worker"]:
            sys.exit(mesh_worker(*sys.argv[2:5]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
