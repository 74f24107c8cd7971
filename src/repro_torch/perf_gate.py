"""Perf-regression gate over the port's pinned probe cells.

The counterpart of ``benchmarks/perf_gate.py``.  It re-times the probe
cells (``repro_torch.perf.perf_probe``: the dispatch sweep, the gate
learner, population fitness and the gate, warm times over synced reps on
the card) and compares each cell's best warm time against the
``timing.probe`` blocks of stored baselines.  A warm time more than
``--tolerance`` (default 30%) above a comparable baseline fails the gate
(exit 1).

Wall clocks compare only on like hardware, so every probe carries a
machine fingerprint (backend, device name and count, power limit, CPU
count); a baseline with another fingerprint is skipped with a message,
never compared (``--cross-machine`` overrides).  No comparable baseline
at all is the skip path: exit 0 with an explanation.

The port's baseline is ``torch_perf_baseline.json`` at the repository
root, a name the reference gate's ``BENCH_*.json`` glob does not match:

    python -m repro_torch.perf_gate                     # gate vs the baseline
    python -m repro_torch.perf_gate --write-baseline    # refresh it: the
                                                        # median of 5 fresh
                                                        # processes' probes
    python -m repro_torch.perf_gate --check-provenance 'out/*.json'
"""
from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.perf import (REPO_ROOT, bench_timing, machine_fingerprint,
                              perf_probe, write_json)

BASELINE_JSON = os.path.join(REPO_ROOT, "torch_perf_baseline.json")
DEFAULT_TOLERANCE = 0.30
BASELINE_RUNS = 5               # fresh processes a baseline is the median of

# Provenance fields every record must carry; timing.probe is required only
# of records that ran the probe (a "timing" block implies it).
REQUIRED_PROVENANCE = ("git_sha", "torch", "cuda", "device_kind",
                       "device_count", "power_limit")


def extract_probe(record: dict) -> dict | None:
    """The ``timing.probe`` block of a record (None if absent)."""
    probe = record.get("timing", {}).get("probe")
    if probe and "cells" in probe:
        return probe
    return None


def load_baselines(patterns: list[str]) -> list[tuple[str, dict]]:
    """(path, probe) for every matched JSON that carries probe timing."""
    out = []
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            try:
                with open(path) as f:
                    record = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            probe = extract_probe(record)
            if probe is not None:
                out.append((path, probe))
    return out


def _warm(cell: dict) -> float:
    """The gate quantity: the best warm rep (the median for records
    without ``warm_s_min``)."""
    return cell.get("warm_s_min", cell.get("warm_s_median"))


def gate_verdict(current: dict, baselines: list[tuple[str, dict]],
                 tolerance: float = DEFAULT_TOLERANCE,
                 cross_machine: bool = False) -> dict:
    """Pure comparison.  Each cell's baseline is the best warm time across
    comparable stored baselines; the verdict is ``ok`` unless a cell
    regressed past ``tolerance``, and ``skipped`` carries each file left
    out and why."""
    fp = current["fingerprint"]
    comparable, skipped = [], []
    for path, base in baselines:
        if not cross_machine and base.get("fingerprint") != fp:
            skipped.append((path, "machine fingerprint differs"))
            continue
        comparable.append((path, base))
    rows = []
    for cell, cur in sorted(current["cells"].items()):
        best, src = None, None
        for path, base in comparable:
            b = base["cells"].get(cell)
            if b is None:
                continue
            w = _warm(b)
            if best is None or w < best:
                best, src = w, path
        if best is None:
            continue
        ratio = _warm(cur) / max(best, 1e-12)
        rows.append({"cell": cell, "warm_s": _warm(cur),
                     "baseline_warm_s": best, "baseline_from": src,
                     "ratio": round(ratio, 3),
                     "ok": ratio <= 1.0 + tolerance})
    return {
        "ok": all(r["ok"] for r in rows),
        "compared": rows,
        "skipped": [{"path": p, "reason": r} for p, r in skipped],
        "tolerance": tolerance,
        "fingerprint": fp,
    }


def _resolve_entry(entry: str) -> str | None:
    """None when the dotted path names a live object, else why not: a
    probe naming an entry point that no longer exists times dead code."""
    parts = entry.split(".")
    for split in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError as e:
            return f"resolved module but {e}"
        return None
    return "no importable module prefix"


def _check_processes(path: str, record: dict, prov: dict) -> list[str]:
    """The ``processes`` column, when present: a positive int, equal to
    the record's own ``processes``, and dividing ``device_count`` on a
    fleet."""
    procs = prov.get("processes")
    if procs is None:
        return []
    if not isinstance(procs, int) or procs < 1:
        return [f"{path}: provenance 'processes' {procs!r} is not a "
                "positive int"]
    problems = []
    meta_procs = record.get("processes")
    if meta_procs is not None and meta_procs != procs:
        problems.append(
            f"{path}: processes column mismatch — provenance stamped "
            f"{procs} but the record says {meta_procs}")
    dc = prov.get("device_count")
    if procs > 1 and isinstance(dc, int) and dc % procs:
        problems.append(
            f"{path}: device_count {dc} does not divide across {procs} "
            "processes")
    return problems


def check_provenance(patterns: list[str]) -> list[str]:
    """Problems of the matched records (empty == pass): missing
    provenance fields, a timing block without probe cells, a probe entry
    that no longer resolves, an inconsistent ``processes`` column."""
    problems = []
    paths = [p for pattern in patterns for p in sorted(glob.glob(pattern))]
    if not paths:
        return [f"no files matched {patterns}"]
    for path in paths:
        try:
            with open(path) as f:
                record = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"{path}: unreadable ({e})")
            continue
        prov = record.get("provenance")
        if not isinstance(prov, dict):
            problems.append(f"{path}: missing provenance block")
            continue
        for field in REQUIRED_PROVENANCE:
            if field not in prov:
                problems.append(f"{path}: provenance missing {field!r}")
        problems.extend(_check_processes(path, record, prov))
        probe = extract_probe(record)
        if record.get("timing") is not None and probe is None:
            problems.append(f"{path}: timing block without probe cells")
        for cell, data in (probe or {}).get("cells", {}).items():
            entry = data.get("entry")
            if entry is None:
                continue
            reason = _resolve_entry(entry)
            if reason is not None:
                problems.append(f"{path}: probe cell {cell!r} entry "
                                f"{entry!r} does not resolve ({reason})")
    return problems


def _fresh_probe(device: str) -> dict:
    """The probe measured in a new python process: each run starts as cold
    as the gate's own."""
    code = ("import json, sys; from repro_torch.perf import perf_probe; "
            "json.dump(perf_probe(device=sys.argv[1]), "
            "open(sys.argv[2], 'w'))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.join(REPO_ROOT, "src"),
                    os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe.json")
        subprocess.run([sys.executable, "-c", code, str(device), path],
                       env=env, check=True)
        with open(path) as f:
            return json.load(f)


def median_run(probes: list[dict]) -> dict:
    """One baseline probe from several runs' probes: each cell's record is
    that of the run whose best warm time is the median of the runs' (the
    lower middle one for an even count), with every run's best warm time
    beside it (``warm_s_min_runs``, in run order)."""
    out = json.loads(json.dumps(probes[0]))
    for cell in out["cells"]:
        ranked = sorted(probes, key=lambda p: _warm(p["cells"][cell]))
        out["cells"][cell] = {
            **ranked[(len(ranked) - 1) // 2]["cells"][cell],
            "warm_s_min_runs": [_warm(p["cells"][cell]) for p in probes]}
    out["runs"] = len(probes)
    return out


def write_baseline(out: str = BASELINE_JSON,
                   device: str = DEFAULT_DEVICE) -> str:
    """Measure the probe cells in ``BASELINE_RUNS`` fresh processes, one
    after the other, and write their :func:`median_run` as a baseline
    record.  A fresh process's best warm time spreads by tens of percent
    from one process to the next; one run's would set the gate by
    chance."""
    device = str(resolve_device(device))      # raises here without a card
    t0 = time.time()
    probe = median_run([_fresh_probe(device)
                        for _ in range(BASELINE_RUNS)])
    record = {"bench": "perf_gate",
              "timing": {**bench_timing(time.time() - t0, probe=False),
                         "probe": probe}}
    return write_json(out, record, device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", action="append", default=None,
                    help="glob(s) of baseline records (default: "
                         f"{os.path.basename(BASELINE_JSON)})")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="allowed warm-time regression fraction "
                         f"(default {DEFAULT_TOLERANCE})")
    ap.add_argument("--cross-machine", action="store_true",
                    help="compare even when machine fingerprints differ")
    ap.add_argument("--write-baseline", action="store_true",
                    help="re-measure and write --out, skipping the gate")
    ap.add_argument("--out", default=BASELINE_JSON,
                    help="baseline output path for --write-baseline")
    ap.add_argument("--check-provenance", action="append", default=None,
                    metavar="GLOB",
                    help="check the provenance of matched records instead "
                         "of running the gate")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    if args.check_provenance:
        problems = check_provenance(args.check_provenance)
        for p in problems:
            print(f"# perf_gate provenance FAIL: {p}", flush=True)
        if problems:
            return 1
        print("# perf_gate: provenance fields present on all matched "
              "records", flush=True)
        return 0

    if args.write_baseline:
        path = write_baseline(args.out, args.device)
        print(f"# perf_gate: wrote baseline {path}", flush=True)
        return 0

    patterns = args.baseline or [BASELINE_JSON]
    verdict = gate_verdict(perf_probe(device=args.device),
                           load_baselines(patterns),
                           tolerance=args.tolerance,
                           cross_machine=args.cross_machine)
    for s in verdict["skipped"]:
        print(f"# perf_gate skip: {s['path']} ({s['reason']})", flush=True)
    if not verdict["compared"]:
        print("# perf_gate: SKIP — no comparable stored baselines "
              f"(patterns {patterns}, fingerprint "
              f"{machine_fingerprint(args.device)}); run --write-baseline "
              "on this machine to arm the gate", flush=True)
        return 0
    for r in verdict["compared"]:
        state = "ok" if r["ok"] else "REGRESSION"
        print(f"# perf_gate {state}: {r['cell']} warm {r['warm_s']:.6f}s vs "
              f"baseline {r['baseline_warm_s']:.6f}s "
              f"(x{r['ratio']}, from {os.path.basename(r['baseline_from'])})",
              flush=True)
    if not verdict["ok"]:
        print(f"# perf_gate: FAIL — warm time regressed more than "
              f"{100 * args.tolerance:.0f}% on a pinned cell", flush=True)
        return 1
    print("# perf_gate: PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
