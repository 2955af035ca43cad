"""The port stands alone: no module of ``src/repro_torch``, no
``examples/*_torch.py`` and not ``chip_smoke.py`` imports JAX or anything
of the JAX package ``repro``, the port imports with JAX made unimportable
and exports the reference's public names, every module of the reference
has its public functions and classes at the same path in the port (each
function taking the reference's parameter names), and ``chip_smoke.py``
fails (and prints no result) where there is no card or no repo around
it."""
import ast
import importlib
import inspect
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


REF = ROOT / "src" / "repro"
REF_MODULES = sorted(REF.rglob("*.py"))

# The reference's public names that the port has no counterpart for, by
# module (the path under ``repro``), each with its reason. Nothing else may
# be missing.
NOT_PORTED = {
    # the Pallas entry points: each kernel's port is the ``*_cuda`` wrapper
    # of a CUDA source beside its plain version
    "kernels.edge_softmax.kernel": {"edge_softmax_pallas"},
    "kernels.fused_edge_softmax_aggregate.kernel": {
        "fused_edge_softmax_aggregate_pallas"},
    "kernels.fused_gather_aggregate.kernel": {
        "fused_gather_aggregate_pallas"},
    "kernels.gather.kernel": {"gather_rows_pallas"},
    "kernels.segment_sum.kernel": {"segment_sum_pallas"},
    "kernels.sparse_adam.kernel": {"sparse_adam_pallas"},
    # parses XLA's HLO text; the port's dry-run reads its collectives from
    # the traced step (``StepTrace``)
    "launch.dryrun": {"collective_bytes_from_hlo"},
    # builds a ``jax.ShapeDtypeStruct``; the port's specs are fake tensors
    "launch.input_specs": {"sds"},
    # renamed ``NodeMinibatchPipeline`` and ``LinkMinibatchPipeline``:
    # ``tools/check_docs.py`` refuses a ``MinibatchPipeline(`` outside the
    # reference's ``api/`` (ROADMAP.md, "The API boundary")
    "core.pipeline.minibatch": {"MinibatchPipeline", "EdgeMinibatchPipeline"},
}
# Parameters of the reference's functions that the port's take under
# another name or not at all, each with its reason.
PARAMS_NOT_PORTED = {
    # the HLO dump (the port saves its trace with ``save_trace``)
    ("launch.dryrun", "run_one"): {"save_hlo"},
    # named for JAX abstract values; the port passes the tensors
    # (``repro_torch.sharding.rules.cache_pspecs`` / ``batch_pspecs``)
    ("launch.dryrun", "cache_pspecs"): {"cache_abs"},
    ("launch.dryrun", "batch_pspecs"): {"batch_abs"},
    # JAX PRNG keys; a ``torch.Generator`` takes their place
    ("models.gnn.models", "init_gnn"): {"rng"},
    ("models.lm.model", "init_params"): {"key"},
}


def _ref_module_name(path: Path) -> str:
    parts = path.relative_to(REF).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _ref_public_defs(path: Path) -> list:
    """The module's public top-level functions and classes, read by AST
    (the reference is not imported)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")]


def _param_names(node: ast.FunctionDef) -> list:
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


@pytest.mark.parametrize("path", REF_MODULES,
                         ids=lambda p: _ref_module_name(p) or "repro")
def test_port_has_the_reference_public_surface(path):
    """``repro_torch.<path>`` has each public function and class of
    ``repro.<path>``, and each function accepts every parameter name of
    the reference's, but for the commented allow-lists above."""
    name = _ref_module_name(path)
    port = importlib.import_module("repro_torch" + (f".{name}" if name
                                                    else ""))
    defs = {d.name: d for d in _ref_public_defs(path)}
    skip = NOT_PORTED.get(name, set())
    assert skip <= set(defs), f"stale allow-list entry {name}: {skip}"
    missing = [n for n in defs if n not in skip and not hasattr(port, n)]
    assert not missing, f"repro_torch.{name} lacks {missing}"
    assert not [n for n in skip if hasattr(port, n)], \
        f"repro_torch.{name} has {skip}: drop them from NOT_PORTED"
    for n, d in defs.items():
        if n in skip or isinstance(d, ast.ClassDef):
            continue
        params = inspect.signature(getattr(port, n)).parameters
        gone = PARAMS_NOT_PORTED.get((name, n), set())
        assert gone <= set(_param_names(d)), f"stale entry {name}.{n}"
        lacks = [a for a in _param_names(d) if a not in gone and (
            a not in params or params[a].kind is params[a].VAR_POSITIONAL)]
        assert not lacks, f"repro_torch.{name}.{n} takes no {lacks}"
        assert not [a for a in gone if a in params], \
            f"repro_torch.{name}.{n}: drop {gone} from PARAMS_NOT_PORTED"


def test_surface_allow_lists_name_reference_modules():
    names = {_ref_module_name(p) for p in REF_MODULES}
    assert set(NOT_PORTED) <= names
    assert {m for m, _ in PARAMS_NOT_PORTED} <= names


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
