"""The port stands alone: no module of ``src/repro_torch``, no
``examples/*_torch.py`` and not ``chip_smoke.py`` imports JAX or anything
of the JAX package ``repro``, the port imports with JAX made unimportable
and exports the reference's public names, and ``chip_smoke.py`` fails
(and prints no result) where there is no card or no repo around it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "from repro_torch import InferenceServer\n"
        "from repro_torch.launch import gnn_serve, serve, train\n"
        "import repro_torch.models.lm\n"
        "from repro_torch import DistGNNTrainer, NodeDataLoader\n"
        "import repro_torch.configs, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.optim, repro_torch.training\n"
        "import repro_torch.checkpoint\n"
        "import repro_torch.sharding\n"
        "from repro_torch.launch import (dryrun, gnn_dryrun, input_specs,\n"
        "                                mesh, roofline)\n"
        "from repro_torch import DistEmbedding, SparseAdamConfig\n"
        "assert InferenceServer.__module__ == 'repro_torch.api.inference'\n"
        "assert DistGNNTrainer.__module__ == 'repro_torch.training.trainer'\n"
        "gnn_serve.build_parser().parse_args(['--device', 'cpu'])\n"
        "train.build_parser().parse_args(['--arch', 'gat'])\n"
        "serve.build_parser().parse_args(['--arch', 'llama3-8b'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _reference_all(path: Path) -> list:
    """The names of a reference module's ``__all__`` literal, read
    without importing it."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("module", ["", "kernels", "core.sampler"])
def test_port_exports_the_reference_public_names(module):
    """Every name of the reference's ``__all__`` but the ``*_pallas`` entry
    points (the port's kernels are ``*_cuda``)."""
    import importlib

    rel = Path(*module.split(".")) if module else Path()
    names = _reference_all(ROOT / "src" / "repro" / rel / "__init__.py")
    port = importlib.import_module(
        "repro_torch" + (f".{module}" if module else ""))
    want = [n for n in names if not n.endswith("_pallas")]
    missing = [n for n in want if not hasattr(port, n)]
    assert not missing, f"repro_torch.{module} lacks {missing}"
    assert set(want) <= set(port.__all__)


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        r = _run_smoke(cwd)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
