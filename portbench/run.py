"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (imports, the card, the kernels'
load or first build, the inputs from ``--seed``, the warm-up at the
cell's shapes) is ``setup_s``; then jobs run back to back until
``--seconds`` have passed since the window opened, the last one to its
end.  With ``--trace 1`` the mix's sample job runs under the profiler, another
job's spans are recorded without it, and the cell's per-layer metrics are
read from them.  Once the window has
closed the plain reference judges every job, and the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number compared beside its limit.

It needs a CUDA card (exit 2 without one) and the program under ``src/``
(exit 3 without it), and exits 4 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own CUDA builds already land in
    ``src/repro_torch/kernels/build/``)."""
    cache = os.path.join(root, "portbench", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def forbidden_modules(modules=None) -> list[str]:
    """The modules loaded (``sys.modules`` unless given) whose top-level
    name is JAX's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip()


def _stamp(what: str, t_start: float) -> None:
    print(f"portbench: {what} at {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _profile(torch, device):
    """The device's activity only (the host's runtime calls with it); on
    the CPU, its ops."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[act.CUDA if device.type == "cuda" else act.CPU])


def main(argv=None, root: str = ROOT, device=None,
         t_start: float | None = None) -> int:
    """One run.  ``device`` given (a test's CPU) skips the look for a card;
    ``t_start`` is when set-up began (the process's start)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = _args(argv)
    _cache_dirs(root)
    for p in (os.path.join(root, "src"), root):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness.spec import Bench
    bench = Bench(root)
    cell = bench.workload(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])

    import torch
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
                  f"card(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count() "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    cuda = device.type == "cuda"
    torch.set_num_threads(1)
    try:
        drv = bench.driver(mix["driver"])
    except ImportError as e:
        print(f"portbench: the program is not importable: {e}",
              file=sys.stderr)
        return 3
    if cuda:
        torch.cuda.init()
    _stamp("imports and card ready", t_start)

    # ---- set-up ------------------------------------------------------------
    driver = getattr(drv, mix["driver"].capitalize())(cfg, mix, args.seed,
                                                      device)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    _stamp(f"set-up done ({driver.setup_parts} s)", t_start)

    # ---- the window --------------------------------------------------------
    from portbench.harness.trace import (JOB_SPAN, Span, SpanRecorder,
                                         reduce_events)
    sample = mix["trace_job"] if args.trace else -1
    span_job = mix["span_job"] if args.trace else -1
    if sample >= 0 and sample == span_job:
        raise ValueError(f"mix {cell['traffic']}: trace_job and span_job "
                         f"must differ")
    records, job_s, host_spans = [], [], []
    t_w = time.perf_counter()
    k = 0
    while (time.perf_counter() - t_w < args.seconds
           or k <= max(sample, span_job)):
        t_job = time.perf_counter()
        if k == span_job:
            with SpanRecorder(drv.SPANS) as host:
                records.append(driver.run_job(k))
            host_spans = host.spans
        elif k == sample:
            spans = SpanRecorder(drv.SPANS)
            with _profile(torch, device) as prof, spans:
                mark_ns = time.time_ns()
                if cuda:
                    torch.cuda.synchronize(device)
                t0 = time.time_ns()
                records.append(driver.run_job(k))
                spans.spans.append(Span(JOB_SPAN, t0, time.time_ns()))
            _stamp(f"sampled job {k} done", t_start)
        else:
            records.append(driver.run_job(k))
        job_s.append(time.perf_counter() - t_job)
        k += 1
    window_s = time.perf_counter() - t_w
    _stamp("window closed", t_start)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = driver.context()
    driver.release()
    if cuda:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 4

    # ---- the reading of the trace --------------------------------------------
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": _power_limit() if cuda else "n/a"}
    metrics, extra = {}, {}
    if args.trace:
        events = prof.profiler.kineto_results.events()
        _stamp(f"{len(events)} profiler events read", t_start)
        trace = reduce_events(events, torch.autograd.DeviceType.CPU,
                              spans.spans, mark_ns, host_spans)
        del prof, events
        _stamp("trace reduced", t_start)
        device_info["busy_s"] = trace.busy_ns / 1e9
        device_info["window_s"] = trace.window_ns / 1e9
        ctx["power_limit"] = device_info["power_limit"]
        for m in bench.per_layer(args.workload):
            got = bench.reader(m["name"]).read(trace, ctx)
            if got is not None:
                value, note = got if isinstance(got, tuple) else (got, None)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                if note:
                    extra[m["name"]] = note
        breakdown = trace.breakdown()
    else:
        e2e = {"setup_s": setup_s, **driver.end_to_end(records, window_s)}
        for m in bench.end_to_end(args.workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # ---- the comparison with the reference -------------------------------
    limits = cfg["limits"]
    per_job = [driver.judge(r) for r in records]
    _stamp("reference done", t_start)
    numbers = driver.aggregate(per_job)

    def ok(nums):
        return all(n in nums and not math.isnan(nums[n])
                   and nums[n] <= lim for n, lim in limits.items())

    failed = sum(r["units"] for r, nums in zip(records, per_job)
                 if not ok(nums))
    result = {"correct": ok(numbers) and failed == 0,
              "attempted": sum(r["units"] for r in records),
              "failed": failed, "metrics": metrics, "device": device_info,
              "job_s": job_s}
    if args.trace:
        result["breakdown"] = breakdown
        result["roofline_bounds"] = extra
    result["checks"] = {n: {"value": numbers.get(n), "limit": lim}
                        for n, lim in limits.items()}
    for n, lim in limits.items():
        print(f"check {n}: {numbers.get(n)!r} limit {lim!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(t_start=T_PROCESS))
