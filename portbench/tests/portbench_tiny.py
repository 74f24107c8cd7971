"""A benchmark root at a size the CPU tests can hold.

:func:`make_root` copies ``BENCHMARK.json`` and the benchmark's data
(configurations, mixes, metric readers) under a temporary directory and
cuts the configurations and mixes to a few instances, a short horizon
and a small SA budget.  The cells, names and files are the real ones; the
harness's code runs from the repository.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("homog-bound-fig5", "hetero-bound-fig7")

# The cut: 4 instances a job out of a pool of 8, 200-epoch windows, SA at
# population 16 for 20 iterations, every job at S = 2 (the most slack,
# where the search gains most over its start).
TINY_SOLVER = {"pop": 16, "iters": 20}
TINY_BATCH = 4
TINY_MIX = {"pool_instances": 8, "stretch_cycle": [2.0]}
TINY_HORIZON = 200
# What a tiny search gains is far from what the full budget's does
# (tiny carbon readings on the seeds the tests use: sound 0.85-0.93
# homogeneous, 0.81-0.88 heterogeneous; the search frozen 0.977 and
# 0.947-0.987), so the carbon search's limit is cut; the other limits
# are the cells' own (tiny energy readings: sound 0.968-0.972, frozen 1).
TINY_LIMITS = {"paper-homog": {"carbon_search_ratio": 0.94},
               "paper-hetero": {"carbon_search_ratio": 0.93}}


def make_root(tmp_path) -> str:
    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "portbench", sub),
                        os.path.join(root, "portbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name in os.listdir(os.path.join(root, "portbench", "configs")):
        path = os.path.join(root, "portbench", "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["trace"]["horizon"] = TINY_HORIZON
        cfg["solver"].update(TINY_SOLVER)
        cfg["batch_instances"] = TINY_BATCH
        cfg["limits"].update(TINY_LIMITS[cfg["name"]])
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(root, "portbench", "traffic")):
        path = os.path.join(root, "portbench", "traffic", name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(TINY_MIX)
        with open(path, "w") as f:
            json.dump(mix, f)
    return root


def run_many(root: str, specs: list[dict]) -> list[dict]:
    """Runs on the CPU, in one fresh interpreter (so that what the test
    process imported does not meet the harness's check for JAX): each
    spec gives ``cell``, ``seed``, and optionally ``trace``,
    ``seconds``, ``fault`` (a name of ``portbench.control.FAULTS``) or
    ``control``.  Returns each run's ``{"rc", "result"}``."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "src"), REPO])}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.tests.portbench_tiny", root,
         json.dumps(specs)], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])
    return [json.loads(line[len(_TAG):]) for line in
            proc.stdout.splitlines() if line.startswith(_TAG)]


_TAG = "portbench-tiny "


def _run_one(root: str, spec: dict) -> dict:
    from portbench import control
    from portbench.run import main
    if spec.get("fault"):
        ctx = control.FAULTS[spec["fault"]]()
    elif spec.get("control"):
        ctx = control.control()
    else:
        ctx = contextlib.nullcontext()
    out = io.StringIO()
    with ctx, contextlib.redirect_stdout(out):
        rc = main(["--workload", spec["cell"], "--seed", str(spec["seed"]),
                   "--seconds", str(spec.get("seconds", 0.01)),
                   "--trace", str(spec.get("trace", 0))], root=root,
                  device=torch.device("cpu"))
    lines = out.getvalue().strip().splitlines()
    return {"rc": rc, "result": json.loads(lines[-1]) if lines else None,
            "last_line": lines[-1] if lines else ""}


if __name__ == "__main__":
    torch.set_num_threads(1)
    for spec in json.loads(sys.argv[2]):
        print(_TAG + json.dumps(_run_one(sys.argv[1], spec)), flush=True)
