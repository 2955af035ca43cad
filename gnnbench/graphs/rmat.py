"""The R-MAT graph (``data.generator: "rmat"``): a homogeneous power-law
graph with standard normal features, uniform labels and a random training
split, all drawn from the run's seed; the port's dataset over it; and the
check's decode of a run's staged batches against it.

``rmat_edges`` is a frozen copy of the port's R-MAT generator
(``repro_torch/graph/generate.py::rmat_graph`` with ``from_edges`` and
``to_undirected`` of ``repro_torch/graph/csr.py``), so that a change to
the port's generator cannot move the yardstick. A test holds the copy to
the port's generator at a small scale.

Imports nothing of the program: ``dataset`` is handed the port's
``repro_torch.graph`` module.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..inputs import FEATS, GRAPH, LABELS, SPLIT, seed31, substream
from ..reference.check import Decoded


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


def make(data_cfg: dict, seed: int) -> GraphData:
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


def dataset(data: GraphData, name: str, port_graph):
    """The port's ``GraphDataset`` over ``data`` (``port_graph``: the
    module ``repro_torch.graph``)."""
    graph = port_graph.CSRGraph(
        indptr=data.indptr, indices=data.indices,
        edge_ids=np.arange(len(data.indices), dtype=np.int64))
    return port_graph.GraphDataset(
        name=name, graph=graph, feats=data.feats, labels=data.labels,
        split_mask=data.split_mask, num_classes=data.num_classes)


def _row_keys(rows: np.ndarray) -> np.ndarray:
    """A 64-bit key of each float32 row: its first two words."""
    w = np.ascontiguousarray(rows[:, :2]).view(np.uint32).astype(np.uint64)
    return (w[:, 0] << np.uint64(32)) | w[:, 1]


class GraphIndex:
    """Lookups into the benchmark's graph data for the check."""

    def __init__(self, data):
        self.data = data
        n = data.num_nodes
        keys = _row_keys(data.feats)
        self.key_order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[self.key_order]
        if np.any(self.sorted_keys[1:] == self.sorted_keys[:-1]):
            raise ValueError("two feature rows share a key: draw again")
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
        self.edge_keys = src * n + data.indices       # sorted ascending
        self.degree = np.diff(data.indptr)

    def identify(self, rows: np.ndarray) -> tuple:
        """(node id of each row or -1, number of rows that are not a
        generated row byte for byte)."""
        keys = _row_keys(rows)
        at = np.searchsorted(self.sorted_keys, keys)
        at = np.minimum(at, len(self.sorted_keys) - 1)
        found = self.sorted_keys[at] == keys
        ids = np.where(found, self.key_order[at], -1)
        same = found & np.all(
            rows == self.data.feats[np.maximum(ids, 0)], axis=1)
        return np.where(same, ids, -1), int((~same).sum())

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        keys = u * self.data.num_nodes + v
        at = np.minimum(np.searchsorted(self.edge_keys, keys),
                        len(self.edge_keys) - 1)
        return self.edge_keys[at] == keys


def decode(data: GraphData, steps: list, model: dict,
           batch_size: int) -> Decoded:
    """Judge the captured steps. ``steps[k]`` = {"epoch", "seed_mask" (S,
    B), "labels" (S, B), "blocks": [{"edge_src", "edge_dst",
    "edge_mask", ...} (S, E_l)], "feats": [(rows, F) per slot]}: each
    slot's batch worked out again from ``data``. Every feature row is
    identified by its bytes among the generated features; each live edge
    of layer l has to be an edge of the graph, each destination has to
    have min(degree, fanout_l) distinct sampled sources, the seeds have to
    be training nodes with their own labels, never repeated within an
    epoch across trainers and steps, and every row has to be the generated
    row. Faults are counted."""
    index = GraphIndex(data)
    fanouts = [int(f) for f in model["fanouts"]]
    faults = {"sample": 0, "row": 0, "seed": 0}
    out, live = [], []
    seen = {}                    # epoch -> seed ids taken in that epoch
    for st in steps:
        slots = []
        num_layers = len(st["blocks"])
        step_live = [[0, 0, 0] for _ in range(num_layers)]
        for s in range(st["seed_mask"].shape[0]):
            mask = st["seed_mask"][s]
            n_seeds = int(mask.sum())
            if n_seeds != batch_size or not mask[:n_seeds].all():
                faults["seed"] += 1
            # live counts, from the top layer down
            layers = [None] * num_layers
            n_dst = n_seeds
            for l in range(num_layers - 1, -1, -1):
                b = st["blocks"][l]
                m = b["edge_mask"][s].astype(bool)
                es = b["edge_src"][s][m].astype(np.int64)
                ed = b["edge_dst"][s][m].astype(np.int64)
                if len(ed) and (ed.min() < 0 or ed.max() >= n_dst
                                or es.min() < 0):
                    faults["sample"] += 1
                    es, ed = es[:0], ed[:0]
                n_src = max(n_dst, int(es.max()) + 1 if len(es) else 0)
                layers[l] = {"src": es, "dst": ed, "n_dst": n_dst,
                             "n_src": n_src}
                n_dst = n_src
            rows = st["feats"][s]
            if rows.shape[0] < n_dst:
                faults["row"] += n_dst - rows.shape[0]
            ids, bad = index.identify(rows[:n_dst])
            faults["row"] += bad
            ids = np.concatenate([ids, np.full(n_dst - len(ids), -1)])
            if len(np.unique(ids[ids >= 0])) != int((ids >= 0).sum()):
                faults["sample"] += 1     # a node twice among the sources
            for l, blk in enumerate(layers):
                es, ed = blk["src"], blk["dst"]
                u, v = ids[es], ids[ed]
                ok = (u >= 0) & (v >= 0)
                ok[ok] = index.has_edges(v[ok], u[ok])
                faults["sample"] += int((~ok).sum())
                pair = ed * blk["n_src"] + es
                faults["sample"] += len(pair) - len(np.unique(pair))
                want = np.minimum(
                    index.degree[np.maximum(ids[:blk["n_dst"]], 0)],
                    int(fanouts[l]))
                got = np.bincount(ed, minlength=blk["n_dst"])
                faults["sample"] += int((got != want).sum())
                step_live[l][0] += len(es)
                step_live[l][1] += len(np.unique(es))
                step_live[l][2] += len(np.unique(ed))
            seeds = ids[:n_seeds]
            labels = st["labels"][s][:n_seeds].astype(np.int64)
            good = seeds >= 0
            faults["seed"] += int((~good).sum())
            faults["seed"] += int((data.split_mask[seeds[good]] != 1).sum())
            faults["seed"] += int((data.labels[seeds[good]]
                                    != labels[good]).sum())
            seen.setdefault(st["epoch"], []).append(seeds[good])
            slots.append({"feats": data.feats[np.maximum(ids, 0)],
                          "layers": [{"src": b["src"], "dst": b["dst"],
                                      "n_dst": b["n_dst"]} for b in layers],
                          "labels": data.labels[np.maximum(seeds, 0)]})
        out.append(slots)
        live.append(step_live)
    for taken in seen.values():
        allseeds = np.concatenate(taken)
        faults["seed"] += len(allseeds) - len(np.unique(allseeds))
    return Decoded(out, faults, live)
