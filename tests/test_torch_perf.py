"""Port vs reference: the bench's provenance, timing, probes and perf gate.

* ``perf_gate.gate_verdict`` and ``extract_probe`` give the reference
  gate's verdicts on its own cases (``tests/test_obs.py``), and
  ``check_provenance`` its case translated to the port's required
  fields (``torch``, ``cuda``, ``power_limit`` where the reference asks
  for ``jax``, ``jaxlib``, ``backend``);
* ``BenchTimer`` on a fake clock, ``write_json``'s stamp, the probe
  cells' entries and two probe cells run on the CPU (their roofline
  columns finite), and the gate's command line on its skip, pass and
  fail paths with the probe faked.
"""
import fnmatch
import json
import math
import os

import pytest
import torch

from benchmarks import perf_gate as j_gate
from repro_torch import perf, perf_gate


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probe(fp, dispatch=0.010, learn=0.020):
    return {"fingerprint": fp,
            "cells": {"dispatch_sweep": {"warm_s_median": dispatch},
                      "learn_step": {"warm_s_median": learn}}}


FP = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
      "device_count": 1, "power_limit": "700.00 W"}
FP_OTHER = {**FP, "power_limit": "500.00 W"}

GATE_CASES = {
    "within_tolerance": (_probe(FP, 0.012, 0.021),
                         [("BENCH_a.json", _probe(FP))], {"tolerance": 0.3}),
    "regression": (_probe(FP, dispatch=0.014),
                   [("BENCH_a.json", _probe(FP, dispatch=0.010))],
                   {"tolerance": 0.3}),
    "best_baseline": (_probe(FP, dispatch=0.012),
                      [("BENCH_slow.json", _probe(FP, dispatch=0.020)),
                       ("BENCH_fast.json", _probe(FP, dispatch=0.010))], {}),
    "foreign": (_probe(FP), [("BENCH_tpu.json", _probe(FP_OTHER))], {}),
    "cross_machine": (_probe(FP), [("BENCH_tpu.json", _probe(FP_OTHER))],
                      {"cross_machine": True}),
    "no_baselines": (_probe(FP), [], {}),
    "min_over_median": (
        {"fingerprint": FP, "cells": {"gate": {"warm_s_min": 0.010,
                                               "warm_s_median": 0.5}}},
        [("b.json", {"fingerprint": FP,
                     "cells": {"gate": {"warm_s_median": 0.009}}})], {}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_verdict_matches_reference(case):
    current, baselines, kw = GATE_CASES[case]
    assert perf_gate.gate_verdict(current, baselines, **kw) == \
        j_gate.gate_verdict(current, baselines, **kw)


def test_gate_verdicts():
    """The reference gate's own assertions, on the port."""
    v = perf_gate.gate_verdict(*GATE_CASES["within_tolerance"][:2],
                               tolerance=0.30)
    assert v["ok"] and len(v["compared"]) == 2
    v = perf_gate.gate_verdict(*GATE_CASES["regression"][:2], tolerance=0.3)
    row = next(r for r in v["compared"] if r["cell"] == "dispatch_sweep")
    assert not row["ok"] and not v["ok"]
    assert row["ratio"] == pytest.approx(1.4)
    v = perf_gate.gate_verdict(*GATE_CASES["best_baseline"][:2])
    row = next(r for r in v["compared"] if r["cell"] == "dispatch_sweep")
    assert row["baseline_warm_s"] == 0.010
    assert row["baseline_from"] == "BENCH_fast.json"
    v = perf_gate.gate_verdict(*GATE_CASES["foreign"][:2])
    assert v["ok"] and v["compared"] == []
    assert v["skipped"][0]["path"] == "BENCH_tpu.json"
    v2 = perf_gate.gate_verdict(*GATE_CASES["cross_machine"][:2],
                                cross_machine=True)
    assert len(v2["compared"]) == 2 and v2["skipped"] == []
    v = perf_gate.gate_verdict(_probe(FP), [])
    assert v["ok"] and v["compared"] == [] and v["skipped"] == []


def test_extract_probe_matches_reference():
    p = _probe(FP)
    for rec in ({}, {"timing": {"wall_s": 1.0}}, {"timing": {"probe": p}},
                {"timing": {"probe": {"fingerprint": FP}}}):
        assert perf_gate.extract_probe(rec) == j_gate.extract_probe(rec)
    assert perf_gate.extract_probe({"timing": {"probe": p}}) == p


def test_check_provenance(tmp_path):
    """``tests/test_obs.py``'s case, with the port's required fields."""
    good = {"bench": "x", "provenance": {
        "git_sha": "abc", "torch": "2.11", "cuda": "12.8",
        "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1,
        "power_limit": "700.00 W"}}
    bad = {"bench": "y", "provenance": {"git_sha": "abc"}}
    none = {"bench": "z"}
    stale = {**good, "timing": {"probe": {"cells": {
        "c": {"entry": "repro_torch.kernels.ops.no_such_entry"}}}}}
    fleet = {**good, "processes": 2, "provenance": {
        **good["provenance"], "processes": 3, "device_count": 4}}
    for name, rec in [("good.json", good), ("bad.json", bad),
                      ("none.json", none), ("stale.json", stale),
                      ("fleet.json", fleet)]:
        (tmp_path / name).write_text(json.dumps(rec))
    assert perf_gate.check_provenance([str(tmp_path / "good.json")]) == []
    missing = perf_gate.check_provenance([str(tmp_path / "bad.json")])
    assert any("power_limit" in m for m in missing)
    assert any("cuda" in m for m in missing)
    assert any("missing provenance block" in m for m in
               perf_gate.check_provenance([str(tmp_path / "none.json")]))
    assert perf_gate.check_provenance([str(tmp_path / "nope-*.json")])
    assert any("does not resolve" in m for m in
               perf_gate.check_provenance([str(tmp_path / "stale.json")]))
    fleet_problems = perf_gate.check_provenance([str(tmp_path /
                                                     "fleet.json")])
    assert any("mismatch" in m for m in fleet_problems)
    assert any("does not divide" in m for m in fleet_problems)


def test_probe_entries_resolve():
    for name, (entry, _) in perf.PROBE_CELLS.items():
        assert perf_gate._resolve_entry(entry) is None, name
    assert perf_gate._resolve_entry("repro_torch.kernels.ops.nothing")
    assert set(perf.PROBE_CELLS) == {"dispatch_sweep", "learn_step",
                                     "fitness", "gate"}


def test_bench_timer_with_fake_clock():
    ticks = iter([0.0, 5.0, 10.0, 11.0, 20.0, 22.0, 30.0, 33.0])
    timer = perf.BenchTimer("cpu", clock=lambda: next(ticks))
    out, t = timer.cold_warm(lambda x: x + 1, 1, warm_reps=3)
    assert out == 2
    assert t == {"compile_s": 5.0, "warm_s_median": 2.0,
                 "warm_s_all": [1.0, 2.0, 3.0]}


def test_write_json_stamps_provenance(tmp_path):
    path = perf.write_json(str(tmp_path / "sub" / "rec.json"), {"bench": "t"},
                           "cpu")
    rec = json.loads(open(path).read())
    prov = rec["provenance"]
    for k in perf_gate.REQUIRED_PROVENANCE + ("git_dirty", "python",
                                              "processes", "timestamp_utc"):
        assert k in prov
    assert prov["backend"] == "cpu" and prov["processes"] == 1
    assert perf_gate.check_provenance([path]) == []
    kept = perf.write_json(str(tmp_path / "b.json"),
                           {"bench": "t", "provenance": {"git_sha": "x"}},
                           "cpu")
    assert json.loads(open(kept).read())["provenance"] == {"git_sha": "x"}


@pytest.mark.parametrize("cell", ["fitness", "gate"])
def test_probe_cell_on_cpu(cell):
    """A probe cell runs on the CPU: its times positive, its roofline
    columns finite, its counts those of ``op_analysis``."""
    _, build = perf.PROBE_CELLS[cell]
    rec = perf._probe_cell(build, perf.BenchTimer("cpu"))
    assert len(rec["warm_s_all"]) == perf.PROBE_WARM_REPS
    assert rec["warm_s_min"] > 0 and rec["compile_s"] > 0
    roof = rec["roofline"]
    assert all(math.isfinite(v) for v in roof.values()
               if isinstance(v, float))
    assert roof["hlo_bytes"] > 0 and rec["memory"]["argument_bytes"] > 0


def test_gate_main_paths(tmp_path, monkeypatch, capsys):
    fp = perf.machine_fingerprint("cpu")
    current = {"fingerprint": fp, "warm_reps": 7, "cells": {
        "gate": {"warm_s_min": 0.010, "warm_s_median": 0.011}}}
    monkeypatch.setattr(perf_gate, "perf_probe", lambda **kw: current)
    base = tmp_path / "torch_perf_baseline.json"
    # no baseline: the skip path
    assert perf_gate.main(["--device", "cpu", "--baseline",
                           str(base)]) == 0
    assert "SKIP" in capsys.readouterr().out
    monkeypatch.setattr(perf_gate, "perf_probe",
                        lambda **kw: json.loads(json.dumps(current)))
    monkeypatch.setattr(perf_gate, "_fresh_probe",
                        lambda device: json.loads(json.dumps(current)))
    perf_gate.write_baseline(str(base), "cpu")
    assert perf_gate.main(["--check-provenance", str(base)]) == 0
    assert perf_gate.main(["--device", "cpu", "--baseline",
                           str(base)]) == 0
    assert "PASS" in capsys.readouterr().out
    slow = json.loads(json.dumps(current))
    slow["cells"]["gate"]["warm_s_min"] = 0.020
    monkeypatch.setattr(perf_gate, "perf_probe", lambda **kw: slow)
    assert perf_gate.main(["--device", "cpu", "--baseline",
                           str(base)]) == 1
    assert "REGRESSION" in capsys.readouterr().out


def test_baseline_is_the_median_fresh_run(tmp_path, monkeypatch):
    """``write_baseline`` measures in fresh processes and keeps, for each
    cell, the run whose best warm time is the median, beside every
    run's."""
    fp = {"backend": "cpu"}
    runs = [{"fingerprint": fp, "cells": {
        "gate": {"warm_s_min": g, "roofline": {"run": i}},
        "fitness": {"warm_s_min": f}}}
        for i, (g, f) in enumerate([(0.5, 3.0), (0.2, 1.0), (0.4, 2.0),
                                     (0.1, 5.0)])]
    got = perf_gate.median_run(runs)
    assert got["runs"] == 4 and got["fingerprint"] == fp
    assert got["cells"]["gate"] == {"warm_s_min": 0.2, "roofline": {"run": 1},
                                    "warm_s_min_runs": [0.5, 0.2, 0.4, 0.1]}
    assert got["cells"]["fitness"]["warm_s_min"] == 2.0
    assert perf_gate.median_run(runs[:3])["cells"]["gate"]["warm_s_min"] \
        == 0.4
    assert perf_gate.BASELINE_RUNS == 5
    fresh = iter(runs + runs[2:3])
    monkeypatch.setattr(perf_gate, "_fresh_probe", lambda device: next(fresh))
    path = perf_gate.write_baseline(str(tmp_path / "b.json"), "cpu")
    with open(path) as f:
        probe = json.load(f)["timing"]["probe"]
    assert probe["runs"] == 5 and probe["cells"]["gate"]["warm_s_min"] == 0.4


def test_baseline_is_outside_the_reference_gate_glob():
    """The reference gate reads every root ``BENCH_*.json``; the port's
    baseline is not one of them, and it was written on the card."""
    name = os.path.basename(perf_gate.BASELINE_JSON)
    assert not fnmatch.fnmatch(name, "BENCH_*.json")
    assert perf_gate.check_provenance([perf_gate.BASELINE_JSON]) == []
    with open(perf_gate.BASELINE_JSON) as f:
        prov = json.load(f)["provenance"]
    assert prov["backend"] == "cuda" and prov["device_count"] >= 1
    assert set(perf_gate.load_baselines([perf_gate.BASELINE_JSON])[0][1]
               ["cells"]) == set(perf.PROBE_CELLS)
