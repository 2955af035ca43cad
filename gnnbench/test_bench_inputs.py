"""The benchmark's inputs: the R-MAT plug-in's frozen generator against
the port's, and every draw repeatable from the seed, for any seed."""
import numpy as np
import pytest
import torch

from gnnbench import harness, inputs

RMAT = harness.plugin("graphs", "rmat")

DATA = {"num_nodes": 1024, "rmat": {"edge_factor": 30, "a": 0.57,
                                    "b": 0.19, "c": 0.19},
        "feat_dim": 100, "num_classes": 47, "train_frac": 0.080283}


@pytest.mark.parametrize("scale,seed", [(5, 0), (8, 3), (10, 12345)])
def test_frozen_rmat_is_the_ports_generator(scale, seed):
    from repro_torch.graph.generate import rmat_graph

    g = rmat_graph(scale, edge_factor=30, seed=seed)
    indptr, indices = RMAT.rmat_edges(scale, 30, a=0.57, b=0.19, c=0.19,
                                      seed=seed)
    assert np.array_equal(g.indptr, indptr)
    assert np.array_equal(g.indices, indices)
    assert np.array_equal(g.edge_ids, np.arange(len(indices)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 1, -3])
def test_graph_data_repeats_from_its_seed(seed):
    a = RMAT.make(DATA, seed)
    b = RMAT.make(DATA, seed)
    for k in ("indptr", "indices", "feats", "labels", "split_mask"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert a.feats.dtype == np.float32 and a.feats.shape == (1024, 100)
    assert a.labels.min() >= 0 and a.labels.max() < 47
    assert len(a.train_nids) == round(1024 * 0.080283)
    # symmetric, no self loops, no duplicates
    src = np.repeat(np.arange(1024), np.diff(a.indptr))
    keys = src * 1024 + a.indices
    assert np.array_equal(np.sort(keys),
                          np.sort(a.indices * 1024 + src))
    assert not np.any(src == a.indices)
    assert len(np.unique(keys)) == len(keys)


def test_seeds_differ():
    a = RMAT.make(DATA, 1)
    b = RMAT.make(DATA, 2)
    assert not np.array_equal(a.feats, b.feats)
    assert not np.array_equal(a.indices[:100], b.indices[:100])


@pytest.mark.parametrize("arch,heads", [("graphsage", None), ("gat", 2)])
def test_weights_take_the_ports_layout(arch, heads):
    from repro_torch.models.gnn import GNNConfig, init_gnn

    model = dict(arch=arch, num_layers=3, in_dim=100, hidden_dim=256,
                 num_classes=47, fanouts=[15, 10, 5], num_heads=heads)
    plug = harness.plugin("archs", arch)
    w = inputs.make_weights(plug, model, 2**31 + 9, "cpu")
    ref = init_gnn(GNNConfig(**plug.port_config(model, 8)),
                   torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(w) == shapes(ref)
    again = inputs.make_weights(plug, model, 2**31 + 9, "cpu")
    assert torch.equal(w["layers"][0]["b"], again["layers"][0]["b"])
    for a, b in zip(w["layers"], again["layers"]):
        for k in a:
            assert torch.equal(a[k], b[k])
    lim = (6.0 / (100 + 256)) ** 0.5 if arch == "graphsage" else \
        (6.0 / (100 + 128)) ** 0.5
    first = w["layers"][0]["w_self" if arch == "graphsage" else "w"]
    assert float(first.abs().max()) <= lim
    assert float(first.abs().max()) > 0.9 * lim
