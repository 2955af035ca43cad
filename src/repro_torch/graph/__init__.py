from .csr import CSRGraph, from_edges, to_coo, to_undirected
from .hetero import HeteroCSRGraph, HeteroSchema, fused_from_typed
from .generate import (mag_graph, planted_partition_graph, random_features,
                       rmat_graph, train_val_test_split)
from .datasets import GraphDataset, get_dataset, list_datasets

__all__ = [
    "CSRGraph", "from_edges", "to_coo", "to_undirected",
    "HeteroCSRGraph", "HeteroSchema", "fused_from_typed", "mag_graph",
    "planted_partition_graph", "random_features", "rmat_graph",
    "train_val_test_split", "GraphDataset", "get_dataset", "list_datasets",
]
