"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch`` only begins with
that name, so names are compared whole, up to the first dot), and the
reference and the architecture and graph plug-ins import nothing of the
program (``repro_torch``), of JAX or of the JAX package's scripts."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "gnnbench"

# a tiny run of a cell on the CPU, through run.py's own start (its path
# and environment set-up), then every module loaded
PROBE = r"""
import copy, json, runpy, sys, time
run = runpy.run_path(sys.argv[1], run_name="gnnbench_run")
from gnnbench import harness
cell = copy.deepcopy(harness.load_cell(sys.argv[2]))
cell.config["data"]["num_nodes"] = 256
cell.traffic = {"seeds_per_trainer": 4}
out = harness.run(cell, 3, 0.1, False, time.perf_counter(), "cpu",
                  log=lambda *a: None)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("cell", ["sage-products-b1000",
                                  "gat-products-b1000"])
def test_a_run_loads_no_jax_and_no_jax_package(cell):
    # no PYTHONPATH: run.py's own start has to find the program
    env = {k: v for k, v in os.environ.items()
           if k in ("HOME", "TMPDIR", "PATH")}
    out = subprocess.run([sys.executable, "-c", PROBE,
                          str(BENCH / "run.py"), cell], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "gnnbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    """Top-level names a module imports (relative imports as '.')."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".", 1)[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py")
                 if not p.name.startswith("test_"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_source_of_the_benchmark_imports_jax_or_its_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro",
                                 "benchmarks"}


def test_the_reference_imports_nothing_of_the_program():
    """The reference and the plug-ins (architectures and graphs)."""
    paths = sorted(p for d in ("reference", "archs", "graphs")
                   for p in (BENCH / d).glob("*.py"))
    assert {p.parent.name for p in paths} == {"reference", "archs", "graphs"}
    for path in paths:
        assert _imports(path) <= {"__future__", "dataclasses", "math",
                                  "statistics", "typing", "numpy", "torch",
                                  "."}, path
