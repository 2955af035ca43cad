"""The port's sparse embeddings against the JAX package's: K5's plain
version (``repro_torch.kernels.sparse_adam_apply``) against
``repro.kernels.sparse_adam_apply`` with ``impl="ref"`` and with the
Pallas kernel in interpret mode, and ``repro_torch.core.kvstore.
DistEmbedding`` against ``repro.core.kvstore.DistEmbedding`` after the
same pushes, unreplicated and with replicas, through a ``FeatureCache``
and through ``DistGraph.ndata``.

Every comparison is bitwise (no tolerance): the contract of the JAX
package is byte-identity with the NumPy update
(``tests/test_embedding_oracle.py``), and the port keeps it. The card's
route (staged rows, K5) runs here through the CPU stand-in of the kernel
in ``_torch_emulated_cuda``; the ``cuda``-marked test holds the kernel
itself against the plain version on the card.
"""
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.api import DistGraph as RefDistGraph
from repro.core.kvstore import DistEmbedding as RefEmbedding
from repro.core.kvstore import DistKVStore as RefStore
from repro.core.kvstore import PartitionPolicy as RefPolicy
from repro.graph import get_dataset as ref_get_dataset
from repro.kernels.sparse_adam import sparse_adam_apply as ref_apply
from repro_torch.api import DistGraph
from repro_torch.core.kvstore import (CacheConfig, DistEmbedding,
                                      DistKVStore, FeatureCache,
                                      PartitionPolicy, SparseAdamConfig)
from repro_torch.graph import get_dataset
from repro_torch.kernels import (sparse_adam_apply, sparse_adam_cuda,
                                 sparse_adam_ref)

NUM, DIM = 40, 4
OFFSETS = np.array([0, 10, 25, 40])
HYPER = dict(beta1=0.9, beta2=0.999, lr=1e-2, eps=1e-8)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(rng, n, d, dtype=np.float32):
    w = rng.standard_normal((n, d)).astype(dtype)
    m = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    v = rng.random((n, d)).astype(np.float32) * 0.01
    t = rng.integers(0, 5, n).astype(np.int64)
    return w, m, v, t


def _copies(tabs):
    return [a.copy() for a in tabs]


@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
@pytest.mark.parametrize("n,d,r,steps", [(40, 4, 7, 5), (64, 128, 16, 3),
                                         (33, 100, 9, 4)])
def test_sparse_adam_apply_bitwise_vs_reference(ref_impl, n, d, r, steps):
    rng = np.random.default_rng(n + d + r)
    ref_tabs = _tables(rng, n, d)
    port_tabs = _copies(ref_tabs)
    w, m, v, t = port_tabs
    views = [torch.from_numpy(a) for a in (w, m, v)]
    for _ in range(steps):
        rows = np.sort(rng.choice(n, r, replace=False))
        grad = rng.standard_normal((r, d)).astype(np.float32)
        ref_apply(*ref_tabs[:3], rows, grad, ref_tabs[3], impl=ref_impl,
                  **HYPER)
        sparse_adam_apply(*views, rows, grad, t, **HYPER)
    for a, b, name in zip(ref_tabs, port_tabs, "wmvt"):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_sparse_adam_plain_version_takes_any_float_type_on_the_cpu():
    rng = np.random.default_rng(5)
    ref_tabs = _tables(rng, 20, 6, dtype=np.float64)
    port_tabs = _copies(ref_tabs)
    rows = np.array([1, 4, 19])
    grad = rng.standard_normal((3, 6)).astype(np.float32)
    ref_apply(*ref_tabs[:3], rows, grad, ref_tabs[3], impl="ref", **HYPER)
    sparse_adam_apply(*(torch.from_numpy(a) for a in port_tabs[:3]), rows,
                      grad, port_tabs[3], **HYPER)
    for a, b in zip(ref_tabs, port_tabs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_kernel_stand_in_matches_plain_version():
    """The stand-in repeats the kernel's operation order; on the same
    staged inputs it gives the plain version's bytes."""
    rng = np.random.default_rng(2)
    w, m, v, _ = (torch.from_numpy(a) for a in _tables(rng, 30, 8))
    w2, m2, v2 = w.clone(), m.clone(), v.clone()
    rows = torch.tensor([3, 7, 29, 0], dtype=torch.int32)
    g = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    bc1 = torch.from_numpy(1 - 0.9 ** np.array([1, 2, 3, 9], np.float32))
    bc2 = torch.from_numpy(1 - 0.999 ** np.array([1, 2, 3, 9], np.float32))
    sparse_adam_ref(w, m, v, rows, g, bc1[:, None], bc2[:, None], **HYPER)
    emu.sparse_adam.launches = 0
    emu.sparse_adam(w2, m2, v2, rows, (1 - 0.9) * g, (1 - 0.999) * g * g,
                    bc1, bc2, **HYPER)
    for a, b in ((w, w2), (m, m2), (v, v2)):
        assert torch.equal(a, b)


def _push_seq(seed, steps, num=NUM, dim=DIM):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        n = int(rng.integers(1, 12))
        ids = rng.integers(0, num, size=n)
        out.append((ids, rng.standard_normal((n, dim)).astype(np.float32)))
    return out


def _worlds(replication=1, seed=3, **port_kw):
    ref_s = RefStore({"node": RefPolicy("node", OFFSETS)},
                     replication=replication)
    ref_e = RefEmbedding(ref_s, "emb", NUM, DIM, "node", seed=seed)
    s = DistKVStore({"node": PartitionPolicy("node", OFFSETS)},
                    replication=replication)
    e = DistEmbedding(s, "emb", NUM, DIM, "node", seed=seed,
                      **{"device": "cpu", **port_kw})
    return (ref_s, ref_e), (s, e)


def _assert_family_equal(ref_s, s, name="emb"):
    for suffix in ("", "__m", "__v", "__t"):
        a, b = ref_s.gather_all(name + suffix), s.gather_all(name + suffix)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), suffix


def _assert_replicas_equal(s, name="emb"):
    for suffix in ("", "__m", "__v", "__t"):
        for p in range(s.num_parts):
            primary = s.servers[p].local_view(name + suffix)
            for h in s.replicas_of(p)[1:]:
                rep = s.servers[h].replica_view(name + suffix, p)
                assert rep.tobytes() == primary.tobytes(), (suffix, p, h)


@pytest.mark.parametrize("replication", [1, 2])
def test_dist_embedding_bitwise_vs_reference(replication):
    (ref_s, ref_e), (s, e) = _worlds(replication)
    assert s.gather_all("emb").tobytes() == ref_s.gather_all("emb").tobytes()
    for i, (ids, grad) in enumerate(_push_seq(7, 20)):
        ref_e.push_grad(ref_s.client(i % 3), ids, grad)
        e.push_grad(s.client(i % 3), ids, grad)
    _assert_family_equal(ref_s, s)
    _assert_replicas_equal(s)
    assert s.transport.stats() == ref_s.transport.stats()
    assert e.spans["apply"] > 0 and e.spans["stage"] == 0


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("replication", [1, 2])
def test_card_route_bitwise_vs_reference(monkeypatch, replication, impl):
    """The card's route (touched rows staged, K5 on them, copied back and
    scattered) with the kernel's CPU stand-in: the reference's bytes, and
    one launch for each owner a push touches; with ``impl="ref"`` the
    plain version updates the staged rows and K5 never launches."""
    kernels = emu.emulate_cuda(monkeypatch)
    (ref_s, ref_e), (s, e) = _worlds(replication, impl=impl)
    owners = 0
    for ids, grad in _push_seq(11, 15):
        ref_e.push_grad(ref_s.client(0), ids, grad)
        e.push_grad(s.client(0), ids, grad)
        owners += len(np.unique(s.policy_for("emb").part_of(ids)))
    _assert_family_equal(ref_s, s)
    _assert_replicas_equal(s)
    assert kernels["sparse_adam"].launches == (owners if impl == "auto"
                                               else 0)
    assert e.spans["stage"] > 0 and e.spans["unstage"] > 0


def test_card_route_refuses_other_table_types(monkeypatch):
    emu.emulate_cuda(monkeypatch)
    s = DistKVStore({"node": PartitionPolicy("node", OFFSETS)})
    with pytest.raises(TypeError, match="float32"):
        DistEmbedding(s, "emb", NUM, DIM, "node", dtype=np.float16,
                      device="cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    s = DistKVStore({"node": PartitionPolicy("node", OFFSETS)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistEmbedding(s, "emb", NUM, DIM, "node")


def test_kernel_wrapper_refuses_cpu_tensors():
    w = torch.zeros(4, 2)
    rows = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sparse_adam_cuda(w, w, w, rows, w[:1], w[:1], w[0, :1], w[0, :1],
                         **HYPER)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        sparse_adam_apply(w, w.clone(), w.clone(), np.array([0]),
                          np.ones((1, 2), np.float32), np.zeros(4, np.int64),
                          impl="cuda", **HYPER)


@pytest.mark.parametrize("pusher_machine", [0, 1])
def test_cached_pull_after_push_sees_updated_rows(pusher_machine):
    """A pull through a trainer's cache after a push returns the
    post-update row (eager invalidation when the pusher shares the cache,
    version refusal when not), and it is the reference's row."""
    (ref_s, ref_e), (s, e) = _worlds()
    cache = FeatureCache(CacheConfig(budget_bytes=1 << 20), s)
    cache.register(s, "emb")
    reader = s.client(1).attach_cache(cache)
    pusher = s.client(pusher_machine)
    if pusher_machine == 1:
        pusher.attach_cache(cache)
    ids = np.array([0, 5, 30])          # all remote to machine 1
    before = reader.pull("emb", ids)
    assert np.array_equal(reader.pull("emb", ids), before)
    grad = np.full((3, DIM), 2.0, np.float32)
    e.push_grad(pusher, ids, grad)
    ref_e.push_grad(ref_s.client(pusher_machine), ids, grad)
    after = reader.pull("emb", ids)
    assert after.tobytes() == ref_s.gather_all("emb")[ids].tobytes()
    assert not np.array_equal(after, before)
    remote = s.transport.stats()["remote_bytes"]
    assert np.array_equal(reader.pull("emb", ids), after)
    assert s.transport.stats()["remote_bytes"] == remote


def test_writable_through_dist_graph_ndata():
    kw = dict(num_machines=2, trainers_per_machine=1, seed=0)
    ref_g = RefDistGraph(ref_get_dataset("product-sim", scale=9), **kw)
    g = DistGraph(get_dataset("product-sim", scale=9), **kw)
    ref_e = RefEmbedding(ref_g.store, "api_emb", ref_g.num_nodes(), 8,
                         "node", seed=3)
    emb = DistEmbedding(g.store, "api_emb", g.num_nodes(), 8, "node",
                        seed=3, device="cpu",
                        optim=SparseAdamConfig(lr=0.05))
    t = g.ndata["api_emb"]
    assert t.writable, "version-tracked embedding tables accept writes"
    ids = np.array([1, 5, 9], dtype=np.int64)
    before = t[ids]
    assert before.tobytes() == ref_g.ndata["api_emb"][ids].tobytes()
    t[ids] = before + 1.0
    assert np.array_equal(t[ids], before + 1.0)
    assert np.array_equal(emb.pull(g.client, ids), before + 1.0)
    # a push after the write updates the written rows, and bumps their
    # versions past the write's
    v0 = g.store.version_table("api_emb")[ids].copy()
    emb.push_grad(g.client, ids, np.ones((3, 8), np.float32))
    assert (g.store.version_table("api_emb")[ids] > v0).all()
    assert not np.array_equal(t[ids], before + 1.0)
    del ref_e


@pytest.mark.cuda
def test_sparse_adam_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card)")
    rng = np.random.default_rng(0)
    w, m, v, t = _tables(rng, 5000, 128)
    dev = [torch.from_numpy(a).cuda() for a in (w, m, v)]
    plain = [x.clone() for x in dev]
    t2 = t.copy()
    for _ in range(3):
        rows = np.sort(rng.choice(5000, 700, replace=False))
        grad = rng.standard_normal((700, 128)).astype(np.float32)
        sparse_adam_apply(*dev, rows, grad, t, impl="cuda", **HYPER)
        sparse_adam_apply(*plain, rows, grad, t2, impl="ref", **HYPER)
        torch.cuda.synchronize()
        for a, b in zip(dev, plain):
            assert torch.equal(a, b)
