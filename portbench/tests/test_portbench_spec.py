"""BENCHMARK.json against the benchmark's contract; configurations, mixes,
cells and metrics found by name; the shape of a run's last line."""
from __future__ import annotations

import json
import os
import re
import sys

import pytest

from portbench.harness.spec import Bench
from portbench.reference.bilevel import NUMBERS
from portbench.tests.portbench_tiny import CELLS, REPO, make_root, run_many

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _spec() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    spec = _spec()
    assert set(spec) == TOP
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits the driver's time.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    configs = {c["name"]: c for c in spec["configs"]}
    assert 1 <= len(configs) == len(spec["configs"]) <= 24
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in spec["configs"]}) == len(configs)
    assert len({c["source"] for c in spec["configs"]}) == len(configs)

    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert {w["config"] for w in cells} == set(configs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    bench = Bench(REPO)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert bench.mix(w["traffic"])["driver"]

    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = spec["per_layer"]
    assert 1 <= len(layers) <= 128
    names = [m["name"] for m in spec["end_to_end"] + layers]
    assert len(set(names)) == len(names)
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(REPO, "portbench", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        assert bench.per_layer(w["name"]), w["name"]
        assert {m["name"] for m in bench.end_to_end(w["name"])} >= {
            "setup_s", "bound_instances_per_s"}


def test_configurations_hold_their_limits_and_guarantees():
    bench = Bench(REPO)
    for c in _spec()["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert {"violations", "opt_mismatch", "carbon_rel_gap",
                "energy_rel_gap", "savings_gap", "sweep_gap",
                "carbon_search_ratio", "fitness_rel_gap"} \
            <= set(cfg["limits"]) <= set(NUMBERS)
        # Each cut of scale names its key, its source's value and why.
        assert set(cfg["reduced"]) == set(cfg["reduced_from"])
        for k in cfg["reduced"]:
            assert cfg[k] < cfg["reduced_from"][k] and cfg["reduced_why"]
        objectives = {o for w in _spec()["workloads"]
                      if w["config"] == c["name"]
                      for o in bench.mix(w["traffic"])["objective_cycle"]}
        assert {f"{o}_search_ratio" for o in objectives} \
            <= set(cfg["limits"])
        assert cfg["limits"]["violations"] == 0
        assert cfg["limits"]["opt_mismatch"] == 0
        assert cfg["guarantees"] and cfg["assumed"]


def test_a_new_configuration_mix_cell_and_metric_need_only_new_files(
        tmp_path):
    root = make_root(tmp_path)
    before = {p: os.path.getmtime(os.path.join(REPO, p)) for p in
              ("BENCHMARK.json", "portbench/configs/paper-homog.json")}
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "configs", "paper-homog.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "throwaway-m3"
    cfg["instance"].update(n_machines=3, powers_kw=[1.0] * 3,
                           speeds=[1.0] * 3)
    with open(os.path.join(bench_dir, "configs", "throwaway-m3.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "bound-fig5.json")) as f:
        mix = json.load(f)
    with open(os.path.join(bench_dir, "traffic", "throwaway-mix.json"),
              "w") as f:
        json.dump({**mix, "objective_cycle": ["carbon", "energy"]}, f)
    with open(os.path.join(bench_dir, "metrics", "throwaway_ms.py"),
              "w") as f:
        f.write("def read(trace, ctx):\n"
                "    return len(trace.named('repro_torch.sgs'))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "throwaway-m3", "source": "a test",
                            "file": "portbench/configs/throwaway-m3.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "throwaway-cell",
                              "config": "throwaway-m3",
                              "traffic": "throwaway-mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "throwaway_ms", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "decoder",
                              "moves": "bound_instances_per_s",
                              "workloads": ["throwaway-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)

    bench = Bench(root)
    assert bench.config("throwaway-m3")["instance"]["n_machines"] == 3
    assert bench.mix("throwaway-mix")["objective_cycle"][1] == "energy"
    assert [m["name"] for m in bench.per_layer("throwaway-cell")] \
        == ["throwaway_ms"]
    (res,) = run_many(root, [{"cell": "throwaway-cell", "seed": 3,
                              "trace": 1}])
    assert res["rc"] == 0 and res["result"]["correct"]
    assert res["result"]["metrics"]["throwaway_ms"]["value"] > 0
    assert {p: os.path.getmtime(os.path.join(REPO, p)) for p in before} \
        == before


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("tiny"))
    specs = [{"cell": c, "seed": 2**31 + 11, "trace": t}
             for c in CELLS for t in (0, 1)]
    return dict(zip([(s["cell"], s["trace"]) for s in specs],
                    run_many(root, specs)))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_last_line_has_the_shape_the_driver_reads(runs, cell, trace):
    res = runs[(cell, trace)]
    assert res["rc"] == 0
    line = res["result"]
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 4
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = Bench(REPO)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in bench.per_layer(cell)}
        # On the CPU only the host's spans are read; the device's
        # metrics find nothing and are left out.
        assert {"sa_self_ms.bound", "sgs_ms.bound"} <= set(line["metrics"])
        assert set(line["metrics"]) <= allowed
    else:
        assert set(line["metrics"]) == {m["name"] for m in
                                         bench.end_to_end(cell)}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_card_no_result(capsys):
    from portbench.run import main
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without")
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0"], root=REPO)
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    from portbench.run import forbidden_modules
    mods = {"repro_torch": 1, "repro_torch.core": 1, "reprox": 1,
            "jaxtyping": 1, "numpy": 1}
    assert forbidden_modules(mods) == []
    assert forbidden_modules({**mods, "repro.core": 1, "jax.numpy": 1,
                              "flax": 1}) == ["flax", "jax", "repro"]
    assert "portbench" not in forbidden_modules(sys.modules)
