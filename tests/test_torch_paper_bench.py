"""``BENCH_torch_paper.json``: the paper cell's savings, reference vs port.

The paper cell (``BenchSetup()`` defaults: n=10 jobs x k=4 tasks, M=5
homogeneous servers, AU-SA, S=1, carbon objective, 1500-epoch windows,
SA pop 96 x 150 iterations per phase) solved three ways:

* the reference (JAX) on the CPU at the reference harness's 16 instances
  (``benchmarks/run.py``'s default);
* the port on the CPU on the very same 16 instances and windows;
* the port on the card at the paper's 1000 instances, read from a
  ``chip_smoke.py`` log (its ``main path distribution:`` line).

The two packages draw their SA noise from different streams (jax's
threefry, torch's Philox), so the file holds distributions (mean, spread,
quantiles of the per-instance savings), never single instances.
Regenerate with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_paper_bench.py \\
        --write --card-log <a chip_smoke.py log>

The tests check the file's contract, that the port's paper instances
and windows are the reference harness's, and that the three mean
savings agree within two standard errors of their difference (from
the stored spreads: ~3.5 points between the two 16-instance runs).
That bound is loose by design: 16 instances cannot tell a gap of a
few tenths of a point from noise, so the check catches a port that
has gone wrong, not a small bias.
"""
import argparse
import json
import os
import platform
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BENCH_PATH = os.path.join(ROOT, "BENCH_torch_paper.json")
CPU_INSTANCES = 16
CARD_INSTANCES = 1000
CARD_LINE = "main path distribution: "


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load():
    with open(BENCH_PATH) as f:
        return json.load(f)


def _check_distribution(d: dict, n: int):
    assert d["instances"] == n
    q = [d["quantiles_pct"][f"p{p}"] for p in (10, 25, 50, 75, 90)]
    assert d["min_pct"] <= q[0] and q[-1] <= d["max_pct"]
    assert all(a <= b for a, b in zip(q, q[1:]))
    assert d["min_pct"] <= d["mean_pct"] <= d["max_pct"]
    assert d["std_pct"] >= 0.0


def test_bench_file_contract():
    rec = _load()
    from repro_torch import bench
    assert rec["setup"] == {k: v for k, v in vars(
        bench.BenchSetup()).items() if k != "instances"}
    assert tuple(rec["sa"]) == tuple(bench.SA_FAST)
    for side in ("reference_cpu", "port_cpu"):
        _check_distribution(rec[side]["carbon_savings"], CPU_INSTANCES)
        assert rec[side]["seconds"] > 0
    _check_distribution(rec["port_card"]["carbon_savings"], CARD_INSTANCES)
    stamp = rec["port_card"]["stamp"]
    assert {"device", "power_limit", "torch", "cuda", "triton"} <= set(stamp)
    assert "H100" in stamp["device"] and stamp["cuda"] != "none"
    for side in ("reference_cpu", "port_cpu"):
        assert rec[side]["stamp"]["device"] == "cpu"
    # Distributions only: no per-instance arrays.
    assert not any(isinstance(v, list) for side in rec.values()
                   if isinstance(side, dict) for v in side.values())


@pytest.mark.parametrize("a,b", [("reference_cpu", "port_cpu"),
                                 ("reference_cpu", "port_card"),
                                 ("port_cpu", "port_card")])
def test_mean_savings_agree(a, b):
    """|mean_a - mean_b| < 2 standard errors of the difference of two
    independent means, each std / sqrt(instances) from the file."""
    rec = _load()
    da, db = rec[a]["carbon_savings"], rec[b]["carbon_savings"]
    se = np.hypot(da["std_pct"] / np.sqrt(da["instances"]),
                  db["std_pct"] / np.sqrt(db["instances"]))
    assert abs(da["mean_pct"] - db["mean_pct"]) < 2.0 * se


def test_paper_instances_are_the_reference_harness():
    """The port's paper_batch draws the reference harness's instances and
    windows (benchmarks/common.py run_batch), field for field."""
    import jax.numpy as jnp
    from benchmarks import common as jcommon
    from repro.core import generate_instance, pack, stack_packed, synthesize
    from repro_torch import bench

    setup = bench.BenchSetup(instances=4)
    rng = np.random.default_rng(setup.seed)
    year = synthesize(setup.region, days=366, seed=2024)
    packs, cums = [], []
    for _ in range(setup.instances):
        inst = generate_instance(rng, n_jobs=setup.n_jobs,
                                 k_tasks=setup.k_tasks,
                                 n_machines=setup.n_machines,
                                 heterogeneous=setup.heterogeneous)
        packs.append(pack(inst, pad_tasks=setup.n_jobs * setup.k_tasks))
        start = int(rng.integers(0, year.n_epochs - jcommon.DEF_HORIZON))
        cums.append(jnp.asarray(year.window(start, jcommon.DEF_HORIZON)
                                .cumulative()))
    want = stack_packed(packs)
    batch, cum = bench.paper_batch(setup, "cpu")
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(batch, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.stack([np.asarray(c) for c in cums]),
                                  cum.numpy())
    assert bench.DEF_HORIZON == jcommon.DEF_HORIZON
    assert tuple(bench.SA_FAST) == tuple(jcommon.SA_FAST)


def test_savings_distribution():
    from repro_torch import bench
    d = bench.savings_distribution(np.array([0.1, 0.2, 0.3, 0.4]))
    _check_distribution(d, 4)
    assert d["mean_pct"] == pytest.approx(25.0)
    assert d["quantiles_pct"]["p50"] == pytest.approx(25.0)


# ---------------------------------------------------------------------------
# Regeneration (not a test)
# ---------------------------------------------------------------------------

def _card_run(log_path: str) -> dict:
    """The card's paper-cell distribution and stamp from a chip_smoke log."""
    with open(log_path) as f:
        lines = [ln for ln in f if ln.startswith(CARD_LINE)]
    if not lines:
        raise SystemExit(f"{log_path}: no '{CARD_LINE.strip()}' line")
    return json.loads(lines[-1][len(CARD_LINE):])


def _cpu_runs() -> dict:
    import jax
    from benchmarks import common as jcommon
    from repro_torch import bench

    torch.set_num_threads(os.cpu_count() or 1)
    out = {}
    t0 = time.perf_counter()
    r = jcommon.run_batch(jcommon.BenchSetup(instances=CPU_INSTANCES))
    out["reference_cpu"] = {
        "carbon_savings": bench.savings_distribution(r["carbon_savings"]),
        "seconds": r["seconds"], "wall_seconds": time.perf_counter() - t0,
        "stamp": {"device": "cpu", "jax": jax.__version__,
                  "cpu_count": os.cpu_count()}}
    t0 = time.perf_counter()
    r = bench.run_batch(bench.BenchSetup(instances=CPU_INSTANCES), "cpu")
    out["port_cpu"] = {
        "carbon_savings": bench.savings_distribution(r["carbon_savings"]),
        "seconds": r["seconds"], "wall_seconds": time.perf_counter() - t0,
        "stamp": {**bench.device_stamp("cpu"),
                  "threads": torch.get_num_threads(),
                  "cpu_count": os.cpu_count()}}
    return out


def write(card_log: str) -> dict:
    import dataclasses
    from repro_torch import bench

    card = _card_run(card_log)
    setup = dataclasses.asdict(bench.BenchSetup())
    del setup["instances"]
    rec = {
        "bench": "paper_cell_reference_vs_port",
        "regenerate": "PYTHONPATH=src JAX_PLATFORMS=cpu python "
                      "tests/test_torch_paper_bench.py --write --card-log "
                      "<chip_smoke log>",
        "setup": setup,
        "sa": list(bench.SA_FAST),
        **_cpu_runs(),
        "port_card": {"carbon_savings": card["carbon_savings"],
                      "seconds": card["seconds"], "stamp": card["stamp"],
                      "source": "chip_smoke.py main path"},
        "python": platform.python_version(),
    }
    with open(BENCH_PATH, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
        f.write("\n")
    return rec


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--card-log", required=True)
    args = ap.parse_args()
    if args.write:
        rec = write(args.card_log)
        print(json.dumps({k: rec[k]["carbon_savings"]["mean_pct"]
                          for k in ("reference_cpu", "port_cpu",
                                    "port_card")}))
