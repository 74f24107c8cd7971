"""``BENCHMARK.json`` and the files it names, found by name.

* a cell: an entry of ``workloads``;
* a configuration: the ``file`` of its ``configs`` entry (JSON);
* a traffic mix: ``<bench>/traffic/<mix>.json``, which names its driver,
  ``portbench.drivers.<driver>``;
* a per-layer metric: ``<bench>/metrics/<metric>.py``, a module with
  ``read(trace, ctx)``.

``<bench>`` is the first of ``paths``.  Adding any of these is adding a
file and an entry; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os


class Bench:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.dir = os.path.join(root, self.spec["paths"][0])

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        with open(os.path.join(self.dir, "traffic", f"{name}.json")) as f:
            return json.load(f)

    @staticmethod
    def driver(name: str):
        return importlib.import_module(f"portbench.drivers.{name}")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]

    def reader(self, metric: str):
        path = os.path.join(self.dir, "metrics", f"{metric}.py")
        mod_name = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
