"""The port's host plane is a byte-for-byte copy of the reference's: the
same dataset, partition, KVStore pulls, sampled blocks and ego networks
for the same seeds, and a pack arena byte-equal to ``repro``'s
``pack()`` for the same host tree. Ints, floats and bytes must match
exactly; nothing here has a tolerance."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import DistGraph as RefDistGraph
from repro.core.sampler import DistributedSampler as RefSampler
from repro.core.sampler import sample_ego_networks as ref_ego
from repro.graph import get_dataset as ref_get_dataset
from repro.kernels.pack import pack as ref_pack
from repro_torch.api import DistGraph
from repro_torch.core.sampler import DistributedSampler, sample_ego_networks
from repro_torch.graph import get_dataset
from repro_torch.kernels.pack import device_stage, pack

SCALE = 9


@pytest.fixture(scope="module")
def worlds():
    kw = dict(num_machines=2, trainers_per_machine=2, seed=3)
    ref = RefDistGraph(ref_get_dataset("product-sim", scale=SCALE), **kw)
    port = DistGraph(get_dataset("product-sim", scale=SCALE), **kw)
    return ref, port


def _assert_same(a, b, what):
    """Recursive exact equality of dataclasses / dicts / lists / arrays."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if f.compare:
                _assert_same(getattr(a, f.name), getattr(b, f.name),
                             f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


@pytest.mark.parametrize("name,kw", [("product-sim", {"scale": SCALE}),
                                     ("amazon-sim", {"scale": SCALE}),
                                     ("mag-hetero", {"scale": SCALE})])
def test_datasets_byte_identical(name, kw):
    _assert_same(ref_get_dataset(name, **kw), get_dataset(name, **kw), name)


def test_dist_graph_partition_and_store_identical(worlds):
    ref, port = worlds
    _assert_same(ref.book, port.book, "book")
    for i, (a, b) in enumerate(zip(ref.partitions, port.partitions)):
        _assert_same(a, b, f"partition {i}")
    _assert_same(ref.labels, port.labels, "labels")
    for rank in range(ref.num_trainers):
        _assert_same(ref.trainer_view(rank).node_split(),
                     port.trainer_view(rank).node_split(), f"split {rank}")
    _assert_same(list(ref.edge_endpoints()), list(port.edge_endpoints()),
                 "edge_endpoints")
    ids = np.random.default_rng(0).integers(0, ref.num_nodes(), 300)
    _assert_same(ref.ndata["feat"][ids], port.ndata["feat"][ids], "pull")
    r_feats, r_fresh = ref.new_client().pull_degraded("feat", ids)
    p_feats, p_fresh = port.new_client().pull_degraded("feat", ids)
    _assert_same([r_feats, r_fresh], [p_feats, p_fresh], "pull_degraded")


@pytest.mark.parametrize("fanouts,batch,index", [([4, 3], 16, 0),
                                                  ([5, 3, 2], 8, 7)])
def test_sampler_blocks_identical(worlds, fanouts, batch, index):
    ref, port = worlds
    kw = dict(machine=1, transport=None, seed=11)
    rs = RefSampler(ref.book, ref.partitions, fanouts, batch, **kw)
    ps = DistributedSampler(port.book, port.partitions, fanouts, batch, **kw)
    seeds = port.trainer_view(2).node_split()[:batch - 3]
    _assert_same(rs.sample(seeds, batch_index=index, epoch=2),
                 ps.sample(seeds, batch_index=index, epoch=2), "minibatch")


def test_ego_networks_and_feature_pulls_identical(worlds):
    ref, port = worlds
    kw = dict(machine=0, transport=None, seed=0)
    rs = RefSampler(ref.book, ref.partitions, [4, 2], 6, **kw)
    ps = DistributedSampler(port.book, port.partitions, [4, 2], 6, **kw)
    nids = np.arange(0, 500, 37)            # 14 nodes: a ragged last chunk
    got = list(sample_ego_networks(ps, port.new_client(), "feat", nids,
                                   drop_last=False))
    want = list(ref_ego(rs, ref.new_client(), "feat", nids, drop_last=False))
    assert len(got) == len(want) == 3
    for i, (a, b) in enumerate(zip(want, got)):
        _assert_same(a, b, f"chunk {i}")
        assert b.input_feats is not None


def _model_tree(mb):
    return {"input_feats": mb.input_feats,
            "blocks": [dict(edge_src=b.edge_src, edge_dst=b.edge_dst,
                            edge_mask=b.edge_mask, edge_types=b.edge_types)
                       for b in mb.blocks]}


def test_pack_arena_byte_equal_to_reference(worlds):
    _, port = worlds
    ps = DistributedSampler(port.book, port.partitions, [4, 2], 6,
                            machine=0, transport=None, seed=0)
    mb = next(sample_ego_networks(ps, port.new_client(), "feat",
                                  np.arange(6)))
    rng = np.random.default_rng(0)
    trees = [
        _model_tree(mb),
        # int64 / float64 leaves take the reference's staging casts, None
        # leaves are recorded, scalars and stacked leaves keep their shape
        {"seeds": mb.seeds, "labels": None, "w": rng.random((3, 5)),
         "step": np.int64(7), "mask": mb.seed_mask,
         "stack": np.stack([mb.blocks[0].edge_src] * 3)},
    ]
    for tree in trees:
        r_spec, r_arena = ref_pack(tree)
        p_spec, p_arena = pack(tree)
        assert r_spec.fields == p_spec.fields
        assert r_spec.none_paths == p_spec.none_paths
        assert r_spec.arena_layout == p_spec.arena_layout
        assert r_arena.tobytes() == p_arena.tobytes()


def test_device_stage_unpacks_views_with_canonical_dtypes():
    tree = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "b": [np.array([True, False, True]), None],
            "c": np.linspace(0, 1, 4), "s": np.float32(2.5)}
    staged = device_stage(tree, "cpu")
    out = staged.unpack()
    assert out["a"].dtype == torch.int32 and out["a"].shape == (2, 3)
    assert out["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["b"][0].dtype == torch.bool
    assert out["b"][0].tolist() == [True, False, True]
    assert out["b"][1] is None
    assert out["c"].dtype == torch.float32
    assert out["c"].numpy().tobytes() == tree["c"].astype(
        np.float32).tobytes()
    assert out["s"].shape == () and float(out["s"]) == 2.5
    # every leaf is a view into the one arena
    base = staged.arena.untyped_storage().data_ptr()
    for leaf in (out["a"], out["b"][0], out["c"], out["s"]):
        assert leaf.untyped_storage().data_ptr() == base
