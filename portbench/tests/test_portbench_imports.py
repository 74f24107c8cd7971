"""Nothing under portbench/ imports JAX or the JAX package ``repro`` (by
whole top-level name: ``repro_torch`` is not ``repro``), and the plain
references import nothing of the program."""
from __future__ import annotations

import ast
import os

from portbench.tests.portbench_tiny import REPO

BENCH = os.path.join(REPO, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules() -> list[str]:
    out = []
    for d, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if not x.startswith((".", "__"))]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_walk_finds_every_part():
    rel = {os.path.relpath(p, BENCH) for p in _modules()}
    assert {"run.py", "control.py", "drivers/bound.py",
            "reference/bilevel.py", "harness/trace.py"} <= rel
    assert any(r.startswith("metrics/") for r in rel)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {os.path.relpath(p, REPO): sorted(top_level_imports(p) & FORBIDDEN)
           for p in _modules()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_references_import_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for p in _modules():
        if p.startswith(ref + os.sep):
            assert not top_level_imports(p) & {"repro_torch", "torch",
                                               "portbench"}, p


def test_the_check_compares_whole_names():
    assert "repro" not in {"repro_torch.core".split(".")[0]}
    assert top_level_imports(os.path.join(BENCH, "drivers", "bound.py")) \
        >= {"repro_torch", "portbench"}
