"""The port's checkpoints against the JAX package's: the strict tree
restores of ``tests/test_checkpoint.py`` (now for trees of tensors too),
KVStore checkpoints that are the reference's files byte for byte and load
across the two packages, and the cache and replica contracts of a restore.
Every comparison is bitwise."""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import load_kvstore as ref_load_kvstore
from repro.checkpoint import load_pytree as ref_load_pytree
from repro.checkpoint import save_kvstore as ref_save_kvstore
from repro.checkpoint import save_pytree as ref_save_pytree
from repro.core.kvstore import DistEmbedding as RefEmbedding
from repro.core.kvstore import DistKVStore as RefStore
from repro.core.kvstore import PartitionPolicy as RefPolicy
from repro_torch.checkpoint import (load_cache, load_kvstore, load_pytree,
                                    save_cache, save_kvstore, save_pytree)
from repro_torch.core.kvstore import (CacheConfig, DistEmbedding,
                                      DistKVStore, FeatureCache,
                                      PartitionPolicy)
from repro_torch.optim import adamw_init
from repro_torch.optim.optimizers import tree_leaves

OFFSETS = np.array([0, 10, 25, 40])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- tree round-trips ----------------------------------------------------

def _tree(rng):
    """One tree spanning the leaf types a train state holds: tensors of
    several types, NumPy arrays and scalars, nested lists."""
    return {
        "w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)),
        "step": np.int64(7),
        "mask": rng.random(5) > 0.5,
        "acc": rng.standard_normal(6).astype(np.float64),
        "nested": [torch.from_numpy(rng.standard_normal(2).astype(
                       np.float32)),
                   torch.arange(3, dtype=torch.int32)],
    }


def _bytes(x):
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            ).tobytes()


def test_pytree_roundtrip_bitwise(tmp_path):
    tree = _tree(np.random.default_rng(0))
    save_pytree(tree, str(tmp_path))
    out = load_pytree(_tree(np.random.default_rng(1)), str(tmp_path))
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert type(a) is type(b) or not isinstance(a, torch.Tensor)
        assert _bytes(a) == _bytes(b)
    assert isinstance(out["nested"][1], torch.Tensor)
    assert out["nested"][1].dtype == torch.int32


def test_optimizer_state_roundtrip_keeps_its_type(tmp_path):
    params = {"layers": [{"w": torch.randn(3, 2), "b": torch.zeros(2)}]}
    opt = adamw_init(params)._replace(
        step=torch.tensor(5, dtype=torch.int32))
    save_pytree(opt, str(tmp_path))
    out = load_pytree(adamw_init(params), str(tmp_path))
    assert type(out) is type(opt) and out.step.dtype == torch.int32
    assert int(out.step) == 5
    paths = {m["path"] for m in json.load(open(tmp_path / "manifest.json"))}
    assert ".step" in paths and ".mu/['layers']/[0]/['w']" in paths


def test_pytree_paths_interchange_with_the_reference(tmp_path):
    """The manifest's paths are the reference's, so a NumPy tree saved by
    either package loads in the other."""
    tree = {"a": np.arange(4, dtype=np.float32),
            "b": [np.ones(2, np.int32), np.zeros((2, 2), np.float64)]}
    ref_save_pytree(tree, str(tmp_path / "ref"))
    save_pytree(tree, str(tmp_path / "port"))
    assert (json.load(open(tmp_path / "ref" / "manifest.json"))
            == json.load(open(tmp_path / "port" / "manifest.json")))
    for src, load in (("ref", load_pytree), ("port", ref_load_pytree)):
        out = load(tree, str(tmp_path / src))
        for a, b in zip(tree_leaves(tree), tree_leaves(out)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pytree_dtype_mismatch_raises(tmp_path, as_tensor):
    leaf = np.ones(3, np.float32)
    save_pytree({"w": np.ones(3, np.float64)}, str(tmp_path))
    with pytest.raises(ValueError, match="dtype"):
        load_pytree({"w": torch.from_numpy(leaf) if as_tensor else leaf},
                    str(tmp_path))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pytree_explicit_cast_coerces(tmp_path, as_tensor):
    save_pytree({"w": np.arange(3, dtype=np.float64) + 0.5}, str(tmp_path))
    leaf = np.zeros(3, np.float32)
    out = load_pytree({"w": torch.from_numpy(leaf) if as_tensor else leaf},
                      str(tmp_path), cast=True)
    got = out["w"].numpy() if as_tensor else out["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, [0.5, 1.5, 2.5])


def test_pytree_shape_mismatch_raises_even_with_cast(tmp_path):
    save_pytree({"w": torch.ones((2, 3))}, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        load_pytree({"w": torch.ones((3, 2))}, str(tmp_path), cast=True)


def test_pytree_missing_leaf_raises(tmp_path):
    save_pytree({"a": torch.ones(2)}, str(tmp_path))
    with pytest.raises(KeyError, match="missing"):
        load_pytree({"a": torch.ones(2), "b": torch.ones(2)}, str(tmp_path))


def test_pytree_extra_leaf_raises(tmp_path):
    save_pytree({"a": torch.ones(2), "b": torch.ones(2)}, str(tmp_path))
    with pytest.raises(KeyError, match="leaves the template"):
        load_pytree({"a": torch.ones(2)}, str(tmp_path))


def test_pytree_corrupt_manifest_raises(tmp_path):
    save_pytree({"a": torch.ones(2)}, str(tmp_path))
    with open(os.path.join(str(tmp_path), "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(ValueError):   # json.JSONDecodeError is a ValueError
        load_pytree({"a": torch.ones(2)}, str(tmp_path))


# ---- KVStore shards + row versions, against the reference ---------------

def _ref_world(replication=1):
    s = RefStore({"node": RefPolicy("node", OFFSETS)},
                 replication=replication)
    full = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    s.init_data("feat", (3,), np.float32, "node", full_array=full)
    return s, RefEmbedding(s, "emb", 40, 4, "node", seed=3)


def _world(replication=1):
    s = DistKVStore({"node": PartitionPolicy("node", OFFSETS)},
                    replication=replication)
    full = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    s.init_data("feat", (3,), np.float32, "node", full_array=full)
    return s, DistEmbedding(s, "emb", 40, 4, "node", seed=3, device="cpu")


PUSHES = [(np.array([1, 17, 30]), np.ones((3, 4), np.float32)),
          (np.array([2, 2, 39]), np.full((3, 4), -0.5, np.float32))]


def _assert_stores_equal(a, b):
    for name in ("feat", "emb", "emb__m", "emb__v", "emb__t"):
        assert a.gather_all(name).tobytes() == b.gather_all(name).tobytes()
    assert np.array_equal(a.version_table("emb"), b.version_table("emb"))


def test_kvstore_files_byte_identical_to_reference(tmp_path):
    ref_s, ref_e = _ref_world()
    s, e = _world()
    for ids, grad in PUSHES:
        ref_e.push_grad(ref_s.client(0), ids, grad)
        e.push_grad(s.client(0), ids, grad)
    ref_save_kvstore(ref_s, str(tmp_path / "ref"))
    save_kvstore(s, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ref", tmp_path / "port", names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def test_kvstore_checkpoints_load_across_packages(tmp_path):
    ref_s, ref_e = _ref_world()
    s, e = _world()
    for ids, grad in PUSHES[:1]:
        ref_e.push_grad(ref_s.client(0), ids, grad)
        e.push_grad(s.client(0), ids, grad)
    ref_save_kvstore(ref_s, str(tmp_path / "ref"))
    save_kvstore(s, str(tmp_path / "port"))
    fresh_port, _ = _world()
    fresh_ref, _ = _ref_world()
    load_kvstore(fresh_port, str(tmp_path / "ref"))
    ref_load_kvstore(fresh_ref, str(tmp_path / "port"))
    _assert_stores_equal(fresh_port, ref_s)
    _assert_stores_equal(fresh_ref, s)


def test_kvstore_roundtrip_with_versions(tmp_path):
    s, emb = _world()
    c = s.client(0)
    emb.push_grad(c, *PUSHES[0])
    w_ref = s.gather_all("emb").copy()
    f_ref = s.gather_all("feat").copy()
    v_ref = s.version_table("emb").copy()
    assert v_ref.max() > 0
    save_kvstore(s, str(tmp_path))
    emb.push_grad(c, *PUSHES[1])
    c.push("feat", np.array([0]), np.full((1, 3), -9, np.float32),
           reduce="assign")
    assert not np.array_equal(s.version_table("emb"), v_ref)
    load_kvstore(s, str(tmp_path))
    assert s.gather_all("emb").tobytes() == w_ref.tobytes()
    assert s.gather_all("feat").tobytes() == f_ref.tobytes()
    assert np.array_equal(s.version_table("emb"), v_ref)
    assert int(s.servers[0].local_view("emb__t")[1]) == 1


# ---- caches and replicas across a restore -------------------------------

def test_cache_snapshot_refused_when_versions_moved(tmp_path):
    s, emb = _world()
    c = s.client(0)
    cache = FeatureCache(CacheConfig.from_mb(1.0), store=s)
    cache.register(s, "emb")
    ids = np.array([4, 21])
    cache.insert("emb", ids, c.pull("emb", ids), force=True)
    save_cache(cache, str(tmp_path))
    emb.push_grad(c, np.array([4]), np.ones((1, 4), np.float32))
    cache2 = FeatureCache(CacheConfig.from_mb(1.0), store=s)
    cache2.register(s, "emb")
    assert load_cache(cache2, str(tmp_path)) == 1   # row 4 refused
    hit, _ = cache2.lookup("emb", ids)
    assert hit.tolist() == [False, True]


def test_cache_state_roundtrip(tmp_path):
    s, emb = _world()
    c = s.client(0)
    emb.push_grad(c, np.array([2, 12]), np.ones((2, 4), np.float32))
    cache = FeatureCache(CacheConfig.from_mb(1.0), store=s)
    cache.register(s, "feat")
    cache.register(s, "emb")
    f_ids, e_ids = np.array([11, 26, 35]), np.array([2, 12, 33])
    cache.insert("feat", f_ids, c.pull("feat", f_ids), force=True)
    cache.insert("emb", e_ids, c.pull("emb", e_ids), force=True)
    save_kvstore(s, str(tmp_path / "kv"))
    save_cache(cache, str(tmp_path / "cache"))
    # the restore below flushes every live cache, this one included
    saved = {name: cache.lookup(name, ids)[1].copy()
             for name, ids in (("feat", f_ids), ("emb", e_ids))}
    cache2 = FeatureCache(CacheConfig.from_mb(1.0), store=s)
    cache2.register(s, "feat")
    cache2.register(s, "emb")
    load_kvstore(s, str(tmp_path / "kv"))
    assert load_cache(cache2, str(tmp_path / "cache")) == 6
    for name, ids in (("feat", f_ids), ("emb", e_ids)):
        hit, rows = cache2.lookup(name, ids)
        assert hit.all()
        assert rows.tobytes() == saved[name].tobytes()


def test_restore_invalidates_cached_mutable_rows(tmp_path):
    s, emb = _world()
    cache = FeatureCache(CacheConfig(budget_bytes=1 << 20), s)
    cache.register(s, "emb")
    client = s.client(1).attach_cache(cache)
    ids = np.array([0])                  # remote to machine 1
    save_kvstore(s, str(tmp_path))
    emb.push_grad(s.client(0), ids, np.ones((1, 4), np.float32))
    cached = client.pull("emb", ids)
    load_kvstore(s, str(tmp_path))
    assert cache.stats()["rows"]["emb"] == 0
    restored = client.pull("emb", ids)
    assert np.array_equal(restored[0], s.gather_all("emb")[0])
    assert not np.array_equal(restored, cached)


def test_restore_resyncs_replicas(tmp_path):
    s, emb = _world(replication=2)
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(0, 40, size=6)
        emb.push_grad(s.client(0), ids,
                      rng.standard_normal((6, 4)).astype(np.float32))
    save_kvstore(s, str(tmp_path))
    s2, _ = _world(replication=2)
    load_kvstore(s2, str(tmp_path))
    for name in ("feat", "emb", "emb__m", "emb__v", "emb__t"):
        assert s2.gather_all(name).tobytes() == s.gather_all(name).tobytes()
        for p in range(3):
            primary = s2.servers[p].local_view(name)
            for h in s2.replicas_of(p)[1:]:
                assert (s2.servers[h].replica_view(name, p).tobytes()
                        == primary.tobytes()), (name, p, h)
