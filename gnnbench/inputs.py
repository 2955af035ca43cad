"""The benchmark's own inputs, made from ``--seed``: the graph, its node
features, labels and training split, and the model's initial weights.

``rmat_edges`` is a frozen copy of the port's R-MAT generator
(``repro_torch/graph/generate.py::rmat_graph`` with ``from_edges`` and
``to_undirected`` of ``repro_torch/graph/csr.py``), so that a change to
the port's generator cannot move the yardstick. A test holds the copy to
the port's generator at a small scale.

Nothing here imports the port: the harness wraps these arrays in the
port's ``GraphDataset`` itself.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .counts import layer_widths

# sub-streams of one run's seed
GRAPH, FEATS, LABELS, SPLIT, JOB, WEIGHTS = range(6)


def substream(seed: int, which: int) -> np.random.SeedSequence:
    """The independent key of one consumer of a run's seed (any whole
    number, negative or past 64 bits included)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(seed < 0)]
    return np.random.SeedSequence(words).spawn(6)[which]


def seed31(seed: int, which: int) -> int:
    """A non-negative seed under 2**31 for a consumer that takes an int."""
    return int(substream(seed, which).generate_state(1)[0] >> 1)


def rmat_edges(scale: int, edge_factor: int, *, a: float, b: float,
               c: float, seed: int) -> tuple:
    """R-MAT power-law graph, symmetrised, self loops and duplicates
    dropped -> (indptr, indices) of its CSR (out-neighbours; the graph is
    undirected, so they are also its in-neighbours). Draws exactly what
    the port's ``rmat_graph(scale, edge_factor, a=, b=, c=, seed=)`` draws
    and returns the same arrays."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        go_right = r >= a + b
        go_down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    _, uniq = np.unique(src * n + dst, return_index=True)
    src, dst = src[uniq], dst[uniq]        # sorted by (src, dst)
    # symmetrise: both directions, each pair once, sorted by (src, dst)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    _, first = np.unique(s2 * n + d2, return_index=True)
    s2, d2 = s2[first], d2[first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, s2 + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, d2.astype(np.int64)


@dataclasses.dataclass
class GraphData:
    """A configuration's data, as plain arrays."""
    indptr: np.ndarray        # (n+1,) int64
    indices: np.ndarray       # (nnz,) int64
    feats: np.ndarray         # (n, d) float32
    labels: np.ndarray        # (n,) int64
    split_mask: np.ndarray    # (n,) int8: 1 for a training node, else 0
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def train_nids(self) -> np.ndarray:
        return np.nonzero(self.split_mask == 1)[0].astype(np.int64)


def make_graph_data(data_cfg: dict, seed: int) -> GraphData:
    """The configuration's ``data`` section drawn from ``seed``."""
    n = int(data_cfg["num_nodes"])
    scale = int(round(math.log2(n)))
    if 1 << scale != n:
        raise ValueError(f"num_nodes {n} is not a power of two (R-MAT)")
    r = data_cfg["rmat"]
    indptr, indices = rmat_edges(
        scale, int(r["edge_factor"]), a=float(r["a"]), b=float(r["b"]),
        c=float(r["c"]), seed=seed31(seed, GRAPH))
    feats = np.random.default_rng(substream(seed, FEATS)).standard_normal(
        (n, int(data_cfg["feat_dim"])), dtype=np.float32)
    num_classes = int(data_cfg["num_classes"])
    labels = np.random.default_rng(substream(seed, LABELS)).integers(
        0, num_classes, size=n, dtype=np.int64)
    n_train = int(round(n * float(data_cfg["train_frac"])))
    train = np.random.default_rng(substream(seed, SPLIT)).choice(
        n, n_train, replace=False)
    split_mask = np.zeros(n, dtype=np.int8)
    split_mask[train] = 1
    return GraphData(indptr, indices, feats, labels, split_mask, num_classes)


def weight_shapes(model_cfg: dict) -> dict:
    """The parameter tree the port's models take, as shapes:
    GraphSAGE ``{"layers": [{"w_self", "w_neigh", "b"}]}``, GAT
    ``{"layers": [{"w" (d_in, H, d_h), "a_l", "a_r", "b"}], "head"?}``
    (the head where the last layer's H x d_h is not the class count)."""
    arch = model_cfg["arch"]
    layers = []
    for d_in, d_out in layer_widths(model_cfg):
        if arch == "graphsage":
            layers.append({"w_self": (d_in, d_out), "w_neigh": (d_in, d_out),
                           "b": (d_out,)})
        elif arch == "gat":
            heads = int(model_cfg["num_heads"])
            d_h = d_out // heads
            layers.append({"w": (d_in, heads, d_h), "a_l": (heads, d_h),
                           "a_r": (heads, d_h), "b": (d_out,)})
        else:
            raise ValueError(f"no weights for arch {arch!r}")
    tree = {"layers": layers}
    d_last = layer_widths(model_cfg)[-1][1]
    if arch == "gat" and d_last != int(model_cfg["num_classes"]):
        tree["head"] = (d_last, int(model_cfg["num_classes"]))
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_weights(model_cfg: dict, seed: int, device) -> dict:
    """Glorot-uniform weights (limits sqrt(6 / (fan_in + fan_out)) from
    the first and last axes) and zero biases, drawn on ``device`` from the
    seed in one call, in float32."""
    import torch

    shapes = weight_shapes(model_cfg)
    leaves = [(p, s) for p, s in _leaves(shapes) if len(s) > 1]
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed31(seed, WEIGHTS))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32)
    tree = _structure(shapes)
    at = 0
    for path, shape in leaves:
        k = math.prod(shape)
        lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
        _set(tree, path, (flat[at:at + k].view(shape) * 2 - 1) * lim)
        at += k
    for path, shape in _leaves(shapes):
        if len(shape) == 1:
            _set(tree, path, torch.zeros(shape, device=device))
    return tree


def _structure(shapes):
    if isinstance(shapes, dict):
        return {k: _structure(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_structure(v) for v in shapes]
    return None
