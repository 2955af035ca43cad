"""Named synthetic datasets, scaled to this machine.

Mirrors the paper's Table 1 roles:
  * ``product-sim``  — medium power-law graph (ogbn-products stand-in)
  * ``amazon-sim``   — denser medium graph (Amazon stand-in)
  * ``papers-sim``   — the "large" graph for scalability runs (scaled down
                       to host memory; structure/degree-skew preserved)
  * ``mag-sim``      — heterogeneous (typed edges) graph for RGCN
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .csr import CSRGraph
from .hetero import HeteroSchema
from .generate import (community_labels_and_features, mag_graph,
                       planted_partition_graph, random_features, rmat_graph,
                       train_val_test_split)


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CSRGraph
    feats: np.ndarray              # (n, d) node features
    labels: np.ndarray             # (n,) int64
    split_mask: np.ndarray         # (n,) int8: 1 train / 2 val / 3 test
    num_classes: int
    schema: Optional[HeteroSchema] = None   # set => first-class heterograph

    @property
    def train_nids(self) -> np.ndarray:
        return np.nonzero(self.split_mask == 1)[0].astype(np.int64)

    @property
    def val_nids(self) -> np.ndarray:
        return np.nonzero(self.split_mask == 2)[0].astype(np.int64)

    @property
    def test_nids(self) -> np.ndarray:
        return np.nonzero(self.split_mask == 3)[0].astype(np.int64)


_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_dataset(name: str, **kw) -> GraphDataset:
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)


def list_datasets():
    return sorted(_REGISTRY)


def _make(name, g, num_classes, feat_dim, seed, train_frac=0.1):
    labels, feats = community_labels_and_features(g, num_classes, feat_dim, seed=seed)
    mask = train_val_test_split(g.num_nodes, train_frac=train_frac, seed=seed)
    return GraphDataset(name=name, graph=g, feats=feats, labels=labels,
                        split_mask=mask, num_classes=num_classes)


@register("product-sim")
def product_sim(scale: int = 14, seed: int = 0) -> GraphDataset:
    g = rmat_graph(scale, edge_factor=12, seed=seed)
    return _make("product-sim", g, num_classes=16, feat_dim=100, seed=seed)


@register("amazon-sim")
def amazon_sim(scale: int = 13, seed: int = 1) -> GraphDataset:
    g = rmat_graph(scale, edge_factor=32, seed=seed)
    return _make("amazon-sim", g, num_classes=16, feat_dim=200, seed=seed,
                 train_frac=0.5)


@register("papers-sim")
def papers_sim(scale: int = 16, seed: int = 2) -> GraphDataset:
    g = rmat_graph(scale, edge_factor=10, seed=seed)
    return _make("papers-sim", g, num_classes=32, feat_dim=128, seed=seed,
                 train_frac=0.01)


@register("mag-sim")
def mag_sim(scale: int = 14, seed: int = 3, num_etypes: int = 4) -> GraphDataset:
    g = rmat_graph(scale, edge_factor=12, seed=seed, num_etypes=num_etypes,
                   num_ntypes=3)
    return _make("mag-sim", g, num_classes=16, feat_dim=128, seed=seed,
                 train_frac=0.01)


@register("mag-hetero")
def mag_hetero(scale: int = 12, seed: int = 5) -> GraphDataset:
    """First-class heterograph (schema attached): 3 ntypes / 4 etypes,
    labels + train/val/test split on papers only (the MAG-LSC task)."""
    g, schema = mag_graph(scale, seed=seed)
    labels, feats = community_labels_and_features(g, 16, 64, seed=seed)
    mask = train_val_test_split(g.num_nodes, train_frac=0.1, seed=seed)
    papers = g.ntypes == schema.ntype_id("paper")
    mask[~papers] = 0              # only papers carry the prediction task
    return GraphDataset(name="mag-hetero", graph=g, feats=feats,
                        labels=labels, split_mask=mask, num_classes=16,
                        schema=schema)


@register("cluster-sim")
def cluster_sim(num_nodes: int = 20000, num_blocks: int = 64, seed: int = 4) -> GraphDataset:
    g = planted_partition_graph(num_nodes, num_blocks, seed=seed)
    return _make("cluster-sim", g, num_classes=16, feat_dim=64, seed=seed)
