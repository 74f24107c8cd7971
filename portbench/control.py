"""The readings that set the limits of ``correct``, and the faults and the
control that a limit has to catch.

    python3 portbench/control.py --workload <cell> --seeds 12 \
        --fault-seeds 3 [--out readings.json]

In one process, at the cell's own sizes: for each of ``--seeds`` seeds,
one job of the cell's mix (seed ``i`` takes job ``i`` of the mix's cycle
of stretches and objectives, so the seeds cover it), judged by the
plain reference; the same job's outputs judged again with the control in
their place (:func:`control`: the reference's carbon, energy and savings
of the program's schedules, and the fitness of the tapped call's
candidates, in bfloat16, the precision below the configuration's
float32); then each fault of :data:`FAULTS`, planted in
the program or in what it hands back, on ``--fault-seeds`` seeds.  It
prints every reading and, for each number, the lower reading (the
largest a sound run gave) and the upper ones (the least the control and
each fault gave).  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tile(x, n: int):
    """``x``'s leading axis filled to ``n`` with its own first rows."""
    import torch
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[:n - x.shape[0]]])
    return type(x)(*(_tile(f, n) for f in x))


@contextlib.contextmanager
def _patched(obj, name: str, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def sweep_unchanged():
    """The timing sweep returns the starts it was given."""
    from repro_torch.core.solvers import common
    return _patched(common, "timing_sweep",
                    lambda old: lambda inst, start, *a, **k: start)


def sa_unchanged():
    """Every SA iteration leaves the chains as they were (no iteration
    runs): each phase returns the best of its initial population."""
    from repro_torch.core.solvers import bilevel

    def make(old):
        def solve_sa(*a, cfg, **k):
            return old(*a, cfg=cfg._replace(iters=0), **k)
        return solve_sa
    return _patched(bilevel, "solve_sa", make)


def half_batch():
    """Half of a job's instances are solved, and their results stand for
    the other half too."""
    from portbench.drivers import bound

    def make(old):
        def solve(insts, cums, draws, **k):
            n = insts.lead[0]
            h = n // 2
            res = old(type(insts)(*(f[:h] for f in insts)), cums[:h],
                      draws, **k)
            return _tile(res, n)
        return solve
    return _patched(bound, "solve_bilevel_batch", make)


def start_altered():
    """Where phase 2's schedule is produced, one start of each instance
    is one epoch late, and nothing reported follows it."""
    from portbench.drivers import bound

    def make(old):
        def solve(*a, **k):
            res = old(*a, **k)
            res.optimized.start[..., 0] += 1
            return res
        return solve
    return _patched(bound, "solve_bilevel_batch", make)


def carbon_epoch_off():
    """The population's carbon integral (``ops.population_carbon``, the
    ``schedule_eval`` kernel's entry) reads ``cum`` one epoch late: each
    task's emissions from ``start + 1``."""
    from repro_torch.kernels import ops
    return _patched(ops, "population_carbon",
                    lambda old: lambda inst, start, assign, cum:
                    old(inst, start + 1, assign, cum))


def carbon_scaled():
    """The population's carbon integral comes out scaled by ``1 +
    2**-10``: the ranking of candidates is kept."""
    from repro_torch.kernels import ops
    return _patched(ops, "population_carbon",
                    lambda old: lambda *a: old(*a) * (1 + 2 ** -10))


FAULTS = {"sweep_unchanged": sweep_unchanged, "sa_unchanged": sa_unchanged,
          "half_batch": half_batch, "start_altered": start_altered,
          "carbon_epoch_off": carbon_epoch_off,
          "carbon_scaled": carbon_scaled}


def control():
    """The control in the program's place: each job's outputs with what
    the program computed from the trace and the powers (carbon, energy,
    savings) taken from the reference in bfloat16 instead."""
    from portbench.drivers import bound
    from portbench.reference import bilevel as ref

    def make(old):
        def run_job(self, k):
            rec = old(self, k)
            rec["out"] = ref.control_out(rec["job"], rec["out"],
                                         self.solver.sweeps)
            return rec
        return run_job
    return _patched(bound.Bound, "run_job", make)


def _cycle(mix: dict) -> int:
    return math.lcm(len(mix["stretch_cycle"]), len(mix["objective_cycle"]))


def one_job(bench, cell: dict, seed: int, i: int, device,
            judge_control: bool = False) -> dict:
    """Job ``i`` of the mix's cycle on ``seed``: set-up over one job's
    pool, the job, and its numbers (and the control's)."""
    from portbench.reference import bilevel as ref
    cfg = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    mix = {**mix, "pool_instances": cfg["batch_instances"]}
    drv = bench.driver(mix["driver"])
    driver = getattr(drv, mix["driver"].capitalize())(cfg, mix, seed, device)
    k = i % _cycle(mix)
    t0 = time.perf_counter()
    rec = driver.run_job(k)
    out = {"seed": seed, "job": k, "plan": driver.job_plan(k),
           "job_s": time.perf_counter() - t0,
           "numbers": driver.judge(rec)}
    if judge_control:
        ctl = {**rec, "out": ref.control_out(rec["job"], rec["out"],
                                             driver.solver.sweeps)}
        out["control"] = driver.judge(ctl)
    driver.release()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_100_000_007)
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--out")
    args = p.parse_args(argv)
    for path in (os.path.join(ROOT, "src"), ROOT):
        sys.path.insert(0, path)
    import torch
    from portbench.harness.spec import Bench
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Bench(ROOT)
    cell = bench.workload(args.workload)
    limits = bench.config(cell["config"])["limits"]
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    sound = [one_job(bench, cell, s, i, device, judge_control=True)
             for i, s in enumerate(seeds)]
    for r in sound:
        print("sound", json.dumps(r), flush=True)
    faults = {}
    for name in [f for f in args.faults.split(",") if f]:
        runs = []
        for i, s in enumerate(seeds[:args.fault_seeds]):
            with FAULTS[name]():
                runs.append(one_job(bench, cell, s + 1, i, device))
            print(name, json.dumps(runs[-1]), flush=True)
        faults[name] = runs
    summary = {}
    for n in limits:
        row = {"lower": max(r["numbers"][n] for r in sound),
               "control": min(r["control"][n] for r in sound),
               "limit": limits[n]}
        for name, runs in faults.items():
            row[name] = min(r["numbers"][n] for r in runs)
        summary[n] = row
        print("reading", n, json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "device": torch.cuda.get_device_name(device),
                       "sound": sound, "faults": faults,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
