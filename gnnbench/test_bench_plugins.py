"""The architecture and graph plug-ins (``gnnbench/archs/``,
``gnnbench/graphs/``): what a cell reads from them, pinned to the values
the benchmark read before they were plug-ins (FLOPs a step, each kernel's
least seconds, the generated arrays and the initial weights, bit for
bit); that nothing else of the benchmark names an architecture or a
generator; that a plug-in pair is found by name and its ``forward`` is
the one the check follows; and that a typed batch's edge types reach the
check."""
import ast
import hashlib
import json
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from gnnbench import counts, harness, inputs
from gnnbench.reference import check, model

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "gnnbench"
CONFIGS = {n: json.loads((BENCH / "configs" / f"{n}.json").read_text())
           for n in ("graphsage-products", "gat-products")}
H100 = counts.peaks("NVIDIA H100 80GB HBM3")

FLOPS = {("graphsage-products", 1000): 74511360000,
         ("graphsage-products", 128): 9537454080,
         ("gat-products", 1000): 547378912000,
         ("gat-products", 128): 70064500736}


@pytest.mark.parametrize("config,batch", sorted(FLOPS))
def test_flops_per_step_are_pinned(config, batch):
    m = CONFIGS[config]["model"]
    got = harness.plugin("archs", m["arch"]).flops_per_step(m, batch, 4)
    assert type(got) is int and got == FLOPS[config, batch]


# (live edges, distinct live sources, distinct live destinations) a layer
LIVE = {1000: [(2_300_000, 120_000, 60_000), (610_000, 60_000, 40_000),
               (19_000, 17_000, 4_000)],
        128: [(330_000, 90_000, 9_000), (80_000, 9_000, 5_000),
              (2_500, 2_400, 512)]}
LEAST = {("graphsage-products", 1000):
         {"fused_gather_aggregate": 8.620059701492537e-05},
         ("graphsage-products", 128):
         {"fused_gather_aggregate": 2.0507634626865675e-05},
         ("gat-products", 1000):
         {"fused_edge_softmax_aggregate": 0.0001608513432835821},
         ("gat-products", 128):
         {"fused_edge_softmax_aggregate": 4.399961791044777e-05}}


@pytest.mark.parametrize("config,batch", sorted(LEAST))
def test_kernel_least_seconds_are_pinned(config, batch):
    m = CONFIGS[config]["model"]
    got = harness.plugin("archs", m["arch"]).kernel_least_per_step(
        m, batch, 4, LIVE[batch], H100)
    assert got == LEAST[config, batch]


# SHA-256 of each generated array at num_nodes 4096
DATA = {
    1: {
        "indptr":
            "6f59b2cd290daa963cb8cebbe8cedc3b"
            "4cda714629d0e927402a7d6bcb92130a",
        "indices":
            "efeced168789c0841a91484856c84086"
            "cb18a24d234392ab4de3f1d7463703c3",
        "feats":
            "8cb7cdf02593dd53baf6fb5bbafc13e6"
            "2cd4395d162b5cd5a49bda78859d17a6",
        "labels":
            "80044cc3e7d526f4b8d8d56ef6d700e2"
            "73868ad1fb7b7c36ac45a1701576341d",
        "split_mask":
            "5fd2274627cedd4a2a5ed44a7a150a2b"
            "6703e0c8fe622c5816342064100c6c54",
    },
    2: {
        "indptr":
            "1754b65f8c099881d331ff236b3db09f"
            "0acde0b2f59da3f9543ff7819e4e20ab",
        "indices":
            "0c2b75e48f393c43d9ae38112a234258"
            "141a72393e2b878efcb4422531ff0805",
        "feats":
            "06e3ca1bd06a2af723cf3297d69c393f"
            "c8f65b394d3e424add22db09983d6210",
        "labels":
            "ea9808117acdb3767e48571545ebd7e4"
            "8580573e0178614720a5529bcfcb7432",
        "split_mask":
            "8ecbcf8c21c09a3264c589e786102efa"
            "921c72afc84ef26b0e3b176c0a08eee9",
    },
}


@pytest.mark.parametrize("seed", sorted(DATA))
def test_generated_arrays_are_pinned(seed):
    data_cfg = dict(CONFIGS["graphsage-products"]["data"], num_nodes=4096)
    graph = harness.plugin("graphs", data_cfg["generator"])
    data = graph.make(data_cfg, seed)
    got = {k: hashlib.sha256(np.ascontiguousarray(getattr(data, k))
                             .tobytes()).hexdigest() for k in DATA[seed]}
    assert got == DATA[seed]


WEIGHTS = {"graphsage-products":
           "996b5ab6466f24a78b4ae226092f8002463fe6e6200d1bbf7426b9e713d7d344",
           "gat-products":
           "26cd4a7edad79a918a654d6809b4483d1dc90530e86007cf5d0c4244d3e42fb3"}


def _in_order(tree):
    """Leaves in the tree's own order (the order they were drawn in)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _in_order(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _in_order(v)
    else:
        yield tree


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_initial_weights_are_pinned(config):
    m = CONFIGS[config]["model"]
    w = inputs.make_weights(harness.plugin("archs", m["arch"]), m, 1, "cpu")
    h = hashlib.sha256()
    for t in _in_order(w):
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == WEIGHTS[config]


NAMED = {"graphsage", "gat", "rmat"}
PLUGIN_DIRS = {"archs", "graphs"}


def test_only_the_plug_ins_name_an_architecture_or_a_generator():
    sources = [p for p in BENCH.rglob("*.py")
               if not p.name.startswith("test_")
               and "__pycache__" not in p.parts
               and not PLUGIN_DIRS & set(p.relative_to(BENCH).parts)]
    assert BENCH / "harness.py" in sources
    for path in sources:
        strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert not strings & NAMED, (path, strings & NAMED)


# a plug-in pair of the test's own: a linear model of each seed's own
# features, and a graph of nothing but features and labels
TOY_ARCH = '''
from ..reference import model as ref

CALLS = []


def weight_shapes(model):
    return {"w": (model["in_dim"], model["num_classes"])}


def staged_shapes(model, batch_size, trainers):
    return {"input_feats": (trainers, batch_size, model["in_dim"]),
            "edges": []}


def forward(params, sample, precision="float32"):
    CALLS.append(precision)
    n = sample["labels"].shape[0]
    return ref.matmul(sample["feats"][:n], params["w"], precision)
'''
TOY_GRAPH = '''
import types

import numpy as np

from ..reference.check import Decoded


def make(data_cfg, seed):
    rng = np.random.default_rng(seed)
    n = data_cfg["num_nodes"]
    return types.SimpleNamespace(
        feats=rng.standard_normal((n, data_cfg["feat_dim"]),
                                  dtype=np.float32),
        labels=rng.integers(0, data_cfg["num_classes"], n))


def decode(data, steps, model, batch_size):
    samples = [[{"feats": data.feats[ids], "layers": [],
                 "labels": data.labels[ids]} for ids in st["seeds"]]
               for st in steps]
    return Decoded(samples, {"sample": 0, "row": 0, "seed": 0},
                   [[] for _ in steps])
'''
LIMITS = {"loss1_gap": 1e-6, "grad_gap": 1e-5, "change_med_gap": 1e-5,
          "sample_faults": 0, "row_faults": 0, "seed_faults": 0,
          "shape_faults": 0}


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    for rel, text in (("archs/toy_arch.py", TOY_ARCH),
                      ("graphs/toy_graph.py", TOY_GRAPH),
                      ("traffic/toy.json", '{"seeds_per_trainer": 4}'),
                      ("limits/toy-cell.json",
                       json.dumps({"limits": LIMITS}))):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(textwrap.dedent(text))
    config = {"name": "toy", "model": {"arch": "toy_arch", "in_dim": 5,
                                       "num_classes": 3},
              "data": {"generator": "toy_graph", "num_nodes": 64,
                       "feat_dim": 5, "num_classes": 3},
              "optimizer": {"lr": 0.003, "betas": [0.9, 0.999],
                            "eps": 1e-8, "weight_decay": 0.0},
              "job": {"num_machines": 1, "trainers_per_machine": 2}}
    (tmp_path / "toy.json").write_text(json.dumps(config))
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    yield tmp_path
    for key in ("gnnbench.archs.toy_arch", "gnnbench.graphs.toy_graph"):
        sys.modules.pop(key, None)


def test_a_plug_in_pair_is_found_by_name_and_followed(toy_root):
    manifest = {"workloads": [{"name": "toy-cell", "config": "toy",
                               "traffic": "toy", "chips": 1}],
                "configs": [{"name": "toy",
                             "file": str(toy_root / "toy.json")}],
                "end_to_end": [], "per_layer": []}
    cell = harness.load_cell("toy-cell", manifest)
    assert Path(cell.arch.__file__) == toy_root / "archs" / "toy_arch.py"
    assert Path(cell.graph.__file__) == toy_root / "graphs" / "toy_graph.py"
    data = cell.graph.make(cell.config["data"], 7)
    params0 = inputs.make_weights(cell.arch, cell.model, 7, "cpu")
    # the program's side: the plain model itself through three steps
    opt = cell.config["optimizer"]
    adam = model.AdamW(params0, opt["lr"], tuple(opt["betas"]), opt["eps"],
                       opt["weight_decay"])
    rng = np.random.default_rng(0)
    shapes = cell.arch.staged_shapes(cell.model, cell.batch_size,
                                     cell.trainers)
    steps, losses, params, moment1 = [], [], params0, None
    for _ in range(harness.CHECKED_STEPS):
        st = {"seeds": [rng.choice(64, 4, replace=False) for _ in range(2)],
              "shapes": shapes}
        steps.append(st)
        decoded = cell.graph.decode(data, [st], cell.model, cell.batch_size)
        loss, grads = model.loss_and_grads(
            cell.arch.forward, params,
            check.to_device(decoded.samples[0], "cpu"))
        losses.append(float(loss))
        params = adam.step(params, grads)
        if moment1 is None:
            moment1 = model.tree_map(torch.clone, adam.m)
    st = types.SimpleNamespace(
        data=data, params0=params0, losses=losses,
        first=types.SimpleNamespace(steps=steps, moment1=moment1,
                                    params_end=params))
    calls = cell.arch.CALLS
    calls.clear()
    values, decoded = harness.check_first_steps(cell, st, "cpu",
                                                log=lambda *a: None)
    assert calls and set(calls) == {"float32"}
    assert check.judge(values, cell.limits), values
    r = harness.control_readings(cell, st, decoded, "cpu")
    assert "tf32" in calls
    assert not check.judge(r["half_batch"], {
        k: v for k, v in cell.limits.items() if k in r["half_batch"]})


def test_edge_types_reach_the_capture_and_the_reference():
    first = harness.FirstSteps(types.SimpleNamespace(), 3)
    gen = torch.Generator().manual_seed(0)
    block = {"edge_src": torch.randint(2, 6, (2, 8), generator=gen),
             "edge_dst": torch.randint(0, 2, (2, 8), generator=gen),
             "edge_mask": torch.ones(2, 8, dtype=torch.uint8),
             "edge_types": torch.randint(0, 4, (2, 8), generator=gen,
                                         dtype=torch.int32)}
    stacked = {"blocks": [block], "seed_mask": torch.ones(2, 2),
               "labels": torch.zeros(2, 2, dtype=torch.int64),
               "input_feats": torch.randn(2, 10, 3, generator=gen)}
    got = first._capture(stacked)
    first.close()
    for k, v in block.items():
        assert np.array_equal(got["blocks"][0][k], v.numpy())
    assert got["feats"][0].shape == (6, 3)
    layer = {"src": got["blocks"][0]["edge_src"][0],
             "dst": got["blocks"][0]["edge_dst"][0], "n_dst": 2,
             "etype": got["blocks"][0]["edge_types"][0]}
    sample = {"feats": got["feats"][0], "layers": [layer],
              "labels": np.zeros(2, dtype=np.int64)}
    on = check.to_device([sample], "cpu")[0]["layers"][0]
    assert set(on) == set(layer) and on["n_dst"] == 2
    for k in ("src", "dst", "etype"):
        assert torch.equal(on[k], torch.as_tensor(layer[k]))
