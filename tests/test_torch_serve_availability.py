"""The port's serving and availability cases that the other port tests do
not mirror: ``tests/test_inference.py``'s single-node requests, shared
cache, micro-batch window, stale rows under concurrent writes, RPC fault
mid-request and lifecycle cases, and ``tests/test_owner_loss.py``'s
``nc-homo`` owner outage and degraded-serving cases (degraded answers, a
warm cache masking an outage, ``pull_degraded``, retry exhaustion failing
only its handle, ``close()`` with pending handles or a surviving scheduler
thread, shedding on overload and at the deadline).

Each case runs the port on the CPU as the reference's test runs the JAX
package, and holds the port to the JAX package's results on the same
inputs: served logits rtol = 1e-4, atol = 1e-5 (XLA's and PyTorch's CPU
GEMMs accumulate in different orders); fault, retry, failover, cache and
degraded-pull counters, salvaged rows and freshness masks exactly (the
host plane is the reference's, copied).
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import DistGNNTrainer as RefTrainer
from repro.api import DistGraph as RefDistGraph
from repro.api import InferenceServer as RefServer
from repro.api import TrainJobConfig as RefJob
from repro.core.kvstore import CacheConfig as RefCacheConfig
from repro.core.kvstore import DistKVStore as RefKVStore
from repro.core.kvstore import FaultInjector as RefFaultInjector
from repro.core.kvstore import FeatureCache as RefFeatureCache
from repro.core.kvstore import PartitionPolicy as RefPolicy
from repro.core.kvstore.faults import OwnerDownWindow as RefDownWindow
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import init_gnn as ref_init_gnn
from repro_torch.api import (DeadlineExceeded, DistGNNTrainer, DistGraph,
                             FaultInjector, InferenceServer, OwnerDownWindow,
                             RPCRetriesExhausted, ServerOverloaded,
                             TrainJobConfig, offline_embeddings)
from repro_torch.core.kvstore import (CacheConfig, DistKVStore, FeatureCache,
                                      PartitionPolicy)
from repro_torch.core.sampler import DistributedSampler, sample_ego_networks
from repro_torch.core.pipeline.minibatch import host_blocks
from repro_torch.graph import get_dataset
from repro_torch.models.gnn import GNNConfig, apply_gnn, params_from_numpy
from repro_torch.optim.optimizers import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-5)
FOREVER = 10 ** 9
EPOCHS = 2
# tests/test_inference.py's and tests/test_owner_loss.py's serving model
MODEL = dict(arch="graphsage", hidden_dim=8, fanouts=[3, 2], batch_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worlds(replication=1):
    """Fresh port and reference worlds (product-sim scale 10, 2 machines)
    with one GraphSAGE model, the reference's parameters carried across.
    Fresh per test: the cases leave fault injectors on the transports."""
    world = dict(num_machines=2, trainers_per_machine=1, seed=0,
                 replication=replication)
    ds = get_dataset("product-sim", scale=10)
    kw = dict(MODEL, in_dim=int(ds.feats.shape[1]),
              num_classes=int(ds.num_classes))
    ref_params = ref_init_gnn(RefConfig(**kw), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params))
    port = (DistGraph(ds, **world), GNNConfig(**kw), params)
    ref = (RefDistGraph(ref_get_dataset("product-sim", scale=10), **world),
           RefConfig(**kw, impl="ref"), ref_params)
    return port, ref


def _part1_nids(g, n):
    lo, hi = int(g.book.node_offsets[1]), int(g.book.node_offsets[2])
    return np.arange(lo, lo + min(n, hi - lo), dtype=np.int64)


def _down(injector_cls, window_cls, owner, start=0, end=FOREVER):
    return injector_cls(owner_down=[window_cls(owner=owner, start=start,
                                               end=end, unit="calls")])


# ---------------------------------------------------------------------------
# tests/test_inference.py
# ---------------------------------------------------------------------------

def test_single_node_requests_match_adhoc_protocol():
    """Each 1-node request is chunk 0 of its own trace: byte-identical to
    the ad-hoc protocol (``sample_ego_networks``) on just that node with
    the model applied directly, and within tolerance of the reference
    server's answer."""
    (g, cfg, params), (rg, rcfg, rparams) = _worlds()
    sampler = DistributedSampler(g.book, g.partitions, cfg.fanouts,
                                 cfg.batch_size, machine=g.machine,
                                 transport=None, seed=3)
    client = g.new_client()
    nids = g.node_split()[:5]
    with RefServer(rg, rcfg, rparams, sampler_seed=3) as srv:
        want = [srv.predict([nid]) for nid in nids]
    with InferenceServer(g, cfg, params, sampler_seed=3,
                         device="cpu") as srv:
        for nid, ref in zip(nids, want):
            mb = next(sample_ego_networks(sampler, client, g.feat_name,
                                          np.array([nid]), drop_last=False))
            oracle = apply_gnn(cfg, params, {
                "input_feats": torch.from_numpy(mb.input_feats),
                "blocks": [{k: torch.from_numpy(v) for k, v in b.items()}
                           for b in host_blocks(mb)]}).numpy()
            got = srv.predict([nid])
            assert got.tobytes() == oracle[:1].tobytes()
            np.testing.assert_allclose(got, ref, **TOL)


def test_shared_cache_instance_and_stats():
    """A pre-built FeatureCache shared with a server: stats expose the
    tick and cache counters, ``reset_stats()`` zeroes the counters and
    keeps the rows; the counters and rows are the reference's."""
    (g, cfg, params), (rg, rcfg, rparams) = _worlds()
    nids = g.node_split()[: 2 * cfg.batch_size]
    assert np.array_equal(nids, rg.node_split()[: 2 * cfg.batch_size])
    runs = {}
    for side, (graph, c, p, server, cache_cls, cache_cfg, kw) in {
            "port": (g, cfg, params, InferenceServer, FeatureCache,
                     CacheConfig, {"device": "cpu"}),
            "ref": (rg, rcfg, rparams, RefServer, RefFeatureCache,
                    RefCacheConfig, {})}.items():
        cache = cache_cls(cache_cfg(budget_bytes=1 << 20), graph.store)
        with server(graph, c, p, cache=cache, **kw) as srv:
            assert srv.cache is cache
            first = srv.predict(nids)
            st0 = srv.stats()
            assert st0["requests"] == 1 and st0["ticks"] >= 1
            assert st0["cache"]["hits"] + st0["cache"]["misses"] > 0
            cache.reset_stats()
            st1 = cache.stats()
            assert st1["hits"] == st1["misses"] == 0
            assert st1["rows"] == st0["cache"]["rows"]
            again = srv.predict(nids)
        assert first.tobytes() == again.tobytes()
        runs[side] = (first, st0["cache"], st1)
    np.testing.assert_allclose(runs["port"][0], runs["ref"][0], **TOL)
    assert runs["port"][1] == runs["ref"][1]
    assert runs["port"][2] == runs["ref"][2]


def test_micro_batch_window_coalesces():
    """With pre-staged concurrent submits and a generous window, the
    scheduler packs several chunks into a tick (wall-clock sensitive:
    best of 2), and the co-batched answers are the reference's."""
    (g, cfg, params), (rg, rcfg, rparams) = _worlds()
    requests = [np.array([i]) for i in range(8)]

    def run():
        with InferenceServer(g, cfg, params, micro_batch_capacity=8,
                             micro_batch_window_ms=200.0,
                             device="cpu") as srv:
            srv.predict([0])                      # warm up first
            handles = [srv.submit(r) for r in requests]
            rows = [h.result(timeout=60) for h in handles]
            return srv.ticks - 1, rows            # minus the warmup tick

    (t1, rows), (t2, _) = run(), run()
    assert min(t1, t2) < len(requests)
    with RefServer(rg, rcfg, rparams) as srv:
        want = [srv.predict(r) for r in requests]
    for a, b in zip(rows, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_concurrent_serving_never_observes_stale_rows():
    """Reader threads predict through a TINY shared cache (constant
    eviction churn) while a writer bumps a mutable embedding tensor
    registered in the same cache: served bytes equal the quiescent
    oracle's (which is within tolerance of the reference's), embedding
    reads are never torn and never go backwards."""
    (g, cfg, params), (rg, rcfg, rparams) = _worlds()
    emb_dim, n_versions = 4, 30
    store = g.store
    store.init_data("serve_emb", (emb_dim,), np.float32, "node",
                    mutable=True)
    writer_client = g.new_client()
    ids = np.arange(0, g.num_nodes(), 7, dtype=np.int64)
    cache = FeatureCache(CacheConfig(budget_bytes=8192, admit_after=1),
                         store)
    cache.register(store, g.feat_name)
    cache.register(store, "serve_emb")

    rng = np.random.default_rng(11)
    requests = [rng.integers(0, g.num_nodes(), size=4) for _ in range(12)]
    with InferenceServer(g, cfg, params, sampler_seed=1,
                         device="cpu") as quiet:
        oracle = [quiet.predict(r) for r in requests]
    with RefServer(rg, rcfg, rparams, sampler_seed=1) as srv:
        for r, want in zip(requests, oracle):
            np.testing.assert_allclose(want, srv.predict(r), **TOL)

    errors = []

    def writer():
        v = np.zeros((len(ids), emb_dim), np.float32)
        for version in range(1, n_versions + 1):
            v[:] = version
            writer_client.push("serve_emb", ids, v, reduce="assign")

    def reader(srv):
        try:
            client = g.new_client().attach_cache(cache)
            last = 0.0
            for _rep in range(3):
                for i, req in enumerate(requests):
                    assert srv.predict(req).tobytes() == oracle[i].tobytes()
                rows = client.pull("serve_emb", ids[:8])
                assert (rows == rows[:, :1]).all()        # never torn
                assert rows.max() >= last                 # never stale
                last = rows.max()
        except BaseException as e:                        # after join
            errors.append(e)

    servers = [InferenceServer(g, cfg, params, cache=cache, sampler_seed=1,
                               device="cpu") for _ in range(3)]
    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in servers] + [threading.Thread(target=writer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        for srv in servers:
            srv.close()
    assert not errors, errors[0]
    final = g.new_client().attach_cache(cache).pull("serve_emb", ids[:4])
    assert (final == n_versions).all()


def test_rpc_fault_mid_request_retries_transparently():
    """A transient pull fault mid-request is retried inside the KVStore
    client: the same bytes as a clean request, and the same failures and
    retries as the reference's seeded schedule gives its server."""
    counts = {}
    for side, ((g, cfg, params), server, injector, kw) in {
            "port": (_worlds()[0], InferenceServer, FaultInjector,
                     {"device": "cpu"}),
            "ref": (_worlds()[1], RefServer, RefFaultInjector, {})}.items():
        nids = g.node_split()[: 2 * cfg.batch_size]
        with server(g, cfg, params, sampler_seed=2, **kw) as srv:
            clean = srv.predict(nids)
        before = g.transport.stats()
        g.transport.fault_injector = injector(
            seed=13, rpc_failure_rate=0.4, ops=("pull",),
            max_rpc_failures=6)
        try:
            with server(g, cfg, params, sampler_seed=2, **kw) as srv:
                faulted = srv.predict(nids)
        finally:
            g.transport.fault_injector = None
        after = g.transport.stats()
        failures = after["rpc_failures"] - before["rpc_failures"]
        retries = after["rpc_retries"] - before["rpc_retries"]
        assert failures > 0                       # faults really fired
        assert retries >= failures
        assert faulted.tobytes() == clean.tobytes()
        counts[side] = (failures, retries, clean)
    assert counts["port"][:2] == counts["ref"][:2]
    np.testing.assert_allclose(counts["port"][2], counts["ref"][2], **TOL)


def test_server_lifecycle_and_errors():
    (g, cfg, params), _ = _worlds()
    srv = InferenceServer(g, cfg, params, device="cpu")
    with pytest.raises(ValueError):
        srv.submit([])
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit([0])
    for bad in (dict(micro_batch_capacity=0), dict(deadline_ms=0.0),
                dict(max_pending_chunks=0)):
        with pytest.raises(ValueError):
            InferenceServer(g, cfg, params, device="cpu", **bad)
    with pytest.raises(ValueError):
        offline_embeddings(g, cfg, params, chunk_size=1, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_owner_loss.py: the nc-homo outage under replication 2
# ---------------------------------------------------------------------------

def _outage_counts(trainer, inj) -> dict:
    st = trainer.transport.stats()
    return {"owner_down_hits": inj.stats()["owner_down_hits"],
            **{k: st[k] for k in ("owner_down_failures", "failovers",
                                  "deferred_replica_writes")}}


def test_owner_outage_trains_through_byte_identical_nc_homo():
    """Replication 2 with owner 2 of 3 down from (epoch 1, batch 2): the
    GraphSAGE run trains through with no restart and ends with the clean
    unreplicated run's bytes; the outage's counters are the reference's
    in the same run.

    Both outage runs take the synchronous pipeline (``sync=True``): with
    the async one, each loader's CPU-prefetch thread pulls a batch's
    features while the injector's batch clock may or may not have entered
    the window yet, and a prefetch of the batch past the last can still be
    retrying against owner 2 when the counters are read. The reads served
    by owner 2's copy (``failovers``) then vary from run to run: in 18
    async runs per side, 12 at a time, the reference counted 1, 2 or 3
    (2, 12 and 4 runs) and the port 0, 1, 2 or 3 (1, 1, 15 and 1 runs),
    with 4 owner-down hits and failures in all 36. The pipeline, KVStore,
    cache, transport and injector are the reference's code, so both sides
    share the race. Inline, every pull runs after its batch's
    ``check_death``: 12 sync runs per side, 12 at a time, all counted
    failovers at batches (1, 2) and (1, 3), 2 in all. The clean run stays
    async, and the bytes are the same either way."""
    ds = get_dataset("product-sim", scale=10)
    cfg = GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                    hidden_dim=16, num_classes=ds.num_classes,
                    fanouts=[3, 2], batch_size=8)

    def job(cls, cache_cls, **kw):
        return cls(num_machines=3, trainers_per_machine=1, seed=5,
                   cache=cache_cls(budget_bytes=4096), **kw)

    base = DistGNNTrainer(ds, cfg, job(TrainJobConfig, CacheConfig),
                          device="cpu")
    assert base.batches_per_epoch >= 4, "world too small for a mid-window"
    for e in range(EPOCHS):
        base.train_epoch(e)
    base_params = [p.numpy().tobytes() for p in tree_leaves(base.params)]
    base.stop()

    def window(cls):
        return [cls(owner=2, start=(EPOCHS - 1, 2), end=(EPOCHS, 0),
                    unit="batch")]

    inj = FaultInjector(seed=11, owner_down=window(OwnerDownWindow))
    tr = DistGNNTrainer(ds, cfg, job(TrainJobConfig, CacheConfig,
                                     replication=2, fault_injector=inj,
                                     sync=True),
                        device="cpu")
    for e in range(EPOCHS):
        tr.train_epoch(e)
    assert [p.numpy().tobytes() for p in tree_leaves(tr.params)] == \
        base_params, "owner outage under r=2 must not change one byte"
    got = _outage_counts(tr, inj)
    tr.stop()
    assert got["owner_down_hits"] > 0 and got["owner_down_failures"] > 0
    assert got["failovers"] > 0 or got["deferred_replica_writes"] > 0

    rds = ref_get_dataset("product-sim", scale=10)
    rcfg = RefConfig(arch="graphsage", in_dim=rds.feats.shape[1],
                     hidden_dim=16, num_classes=rds.num_classes,
                     fanouts=[3, 2], batch_size=8)
    rinj = RefFaultInjector(seed=11, owner_down=window(RefDownWindow))
    ref = RefTrainer(rds, rcfg, job(RefJob, RefCacheConfig, replication=2,
                                    fault_injector=rinj, sync=True))
    for e in range(EPOCHS):
        ref.train_epoch(e)
    assert got == _outage_counts(ref, rinj)
    ref.stop()


# ---------------------------------------------------------------------------
# tests/test_owner_loss.py: degraded-mode serving
# ---------------------------------------------------------------------------

def test_degraded_serving_when_all_copies_down():
    """Owner 1 down with no replica: the part-1 request is answered from
    zero-filled rows and flagged, the part-0 request still served, no
    request fails; the flags, counters and answers are the reference's."""
    runs = {}
    for side, ((g, cfg, params), server, cache_cfg, injector, window,
               kw) in {
            "port": (_worlds()[0], InferenceServer, CacheConfig,
                     FaultInjector, OwnerDownWindow, {"device": "cpu"}),
            "ref": (_worlds()[1], RefServer, RefCacheConfig,
                    RefFaultInjector, RefDownWindow, {})}.items():
        with server(g, cfg, params, cache=cache_cfg(budget_bytes=1 << 20,
                                                    prewarm=False),
                    **kw) as srv:
            g.transport.fault_injector = _down(injector, window, 1)
            down = srv.submit(_part1_nids(g, cfg.batch_size))
            up = srv.submit(np.arange(cfg.batch_size, dtype=np.int64))
            rows = down.result(timeout=60)
            assert rows.shape == (cfg.batch_size, cfg.num_classes)
            assert np.isfinite(rows).all()
            assert down.degraded, "salvaged answer must be flagged"
            out = up.result(timeout=60)
            assert np.isfinite(out).all()
            st = srv.stats()
            assert st["degraded_requests"] >= 1
            assert st["failed_requests"] == 0
        pulls = g.transport.stats()["degraded_pulls"]
        assert pulls > 0
        runs[side] = (rows, out, down.degraded, up.degraded,
                      st["degraded_requests"], pulls)
    port, ref = runs["port"], runs["ref"]
    np.testing.assert_allclose(port[0], ref[0], **TOL)
    np.testing.assert_allclose(port[1], ref[1], **TOL)
    assert port[2:] == ref[2:]


def test_warm_cache_masks_full_outage_byte_identically():
    """Every remote row of the request was cached by a healthy serve and
    feature tensors are immutable, so the outage is invisible: same
    bytes, not flagged; the answer is the reference's."""
    (g, cfg, params), (rg, rcfg, rparams) = _worlds()
    nids = _part1_nids(g, cfg.batch_size)
    with InferenceServer(g, cfg, params,
                         cache=CacheConfig(budget_bytes=1 << 20,
                                           prewarm=False),
                         device="cpu") as srv:
        healthy = srv.predict(nids, timeout=60)
        g.transport.fault_injector = _down(FaultInjector, OwnerDownWindow,
                                           1)
        h = srv.submit(nids)
        assert h.result(timeout=60).tobytes() == healthy.tobytes()
        assert not h.degraded
        assert srv.stats()["failed_requests"] == 0
    with RefServer(rg, rcfg, rparams) as srv:
        np.testing.assert_allclose(healthy, srv.predict(nids), **TOL)


def _kv(store_cls, policy_cls, k=3, per=4, dim=3, **kw):
    s = store_cls({"node": policy_cls("node", np.arange(k + 1) * per)},
                  **kw)
    full = np.arange(k * per * dim, dtype=np.float32).reshape(k * per, dim)
    s.init_data("feat", (dim,), np.float32, "node", full_array=full)
    return s, full


def test_pull_degraded_salvages_stale_cache_rows():
    """Two cached part-1 rows come back stale, an uncached one
    zero-filled, the healthy owner's fresh; rows, mask and counters are
    the reference's, byte for byte."""
    runs = {}
    for side, (store_cls, policy_cls, cache_cls, cache_cfg, injector,
               window) in {
            "port": (DistKVStore, PartitionPolicy, FeatureCache,
                     CacheConfig, FaultInjector, OwnerDownWindow),
            "ref": (RefKVStore, RefPolicy, RefFeatureCache, RefCacheConfig,
                    RefFaultInjector, RefDownWindow)}.items():
        s, full = _kv(store_cls, policy_cls, replication=1)
        c = s.client(0)
        cache = cache_cls(cache_cfg(budget_bytes=1 << 20, prewarm=False))
        cache.register(s, "feat")
        c.attach_cache(cache)
        c.pull("feat", np.array([4, 5]))           # warm two part-1 rows
        s.transport.fault_injector = _down(injector, window, 1)
        rows, fresh = c.pull_degraded("feat", np.array([4, 5, 6, 0]))
        assert fresh.tolist() == [False, False, False, True]
        assert np.array_equal(rows[:2], full[4:6]), "stale-cache salvage"
        assert np.allclose(rows[2], 0), "uncached row zero-fills"
        assert np.array_equal(rows[3], full[0]), "healthy owner fresh"
        assert cache.stats()["degraded_hits"] == 2
        assert s.transport.stats()["degraded_pulls"] == 3
        runs[side] = (rows.tobytes(), fresh.tobytes(), cache.stats(),
                      s.transport.stats())
    assert runs["port"] == runs["ref"]


def test_exhaustion_fails_only_its_handle():
    """A storm of transient faults exhausts the retries of one submit's
    pulls: only its handle fails, with the reference's error type, and
    the scheduler and later requests are unharmed."""
    (g, cfg, params), (rg, rcfg, rparams) = _worlds()
    with InferenceServer(g, cfg, params, device="cpu") as srv:
        healthy_before = srv.predict(np.arange(cfg.batch_size), timeout=60)
        g.transport.fault_injector = FaultInjector(seed=0,
                                                   rpc_failure_rate=1.0)
        doomed = srv.submit(_part1_nids(g, cfg.batch_size))
        with pytest.raises(RPCRetriesExhausted):
            doomed.result(timeout=60)
        g.transport.fault_injector = None
        again = srv.predict(np.arange(cfg.batch_size), timeout=60)
        assert again.tobytes() == healthy_before.tobytes()
        st = srv.stats()
        assert st["failed_requests"] == 1
        assert srv._thread.is_alive()
    with RefServer(rg, rcfg, rparams) as srv:
        rg.transport.fault_injector = RefFaultInjector(seed=0,
                                                       rpc_failure_rate=1.0)
        ref_doomed = srv.submit(_part1_nids(rg, cfg.batch_size))
        with pytest.raises(Exception) as ref_err:
            ref_doomed.result(timeout=60)
        rg.transport.fault_injector = None
        np.testing.assert_allclose(
            healthy_before, srv.predict(np.arange(cfg.batch_size)), **TOL)
    assert type(ref_err.value).__name__ == "RPCRetriesExhausted"


def test_close_fails_pending_handles():
    """A huge coalescing window parks submitted chunks in the queue;
    ``close()`` fails them instead of leaving ``result()`` hanging."""
    (g, cfg, params), _ = _worlds()
    srv = InferenceServer(g, cfg, params, micro_batch_window_ms=60_000,
                          micro_batch_capacity=64, device="cpu")
    warm = srv.submit(np.arange(cfg.batch_size))
    h = srv.submit(np.arange(cfg.batch_size))
    srv.close()
    for parked in (warm, h):
        with pytest.raises(RuntimeError, match="closed before"):
            parked.result(timeout=10)
    assert not srv._thread.is_alive()


def test_close_raises_if_scheduler_thread_survives():
    (g, cfg, params), _ = _worlds()
    srv = InferenceServer(g, cfg, params, device="cpu")
    real = srv._thread

    class _Stuck:
        def join(self, timeout=None):
            real.join(timeout)

        def is_alive(self):
            return True

    srv._thread = _Stuck()
    with pytest.raises(RuntimeError, match="did not stop"):
        srv.close()
    real.join(timeout=10)
    assert not real.is_alive()


def test_admission_control_sheds_overload():
    (g, cfg, params), _ = _worlds()
    srv = InferenceServer(g, cfg, params, micro_batch_window_ms=60_000,
                          micro_batch_capacity=64, max_pending_chunks=2,
                          device="cpu")
    try:
        a = srv.submit(np.arange(cfg.batch_size))    # 1 chunk queued
        b = srv.submit(np.arange(cfg.batch_size))    # 2 chunks queued
        with pytest.raises(ServerOverloaded):
            srv.submit(np.arange(cfg.batch_size))
        assert srv.stats()["rejected_requests"] == 1
    finally:
        srv.close()
    for parked in (a, b):
        with pytest.raises(RuntimeError, match="closed before"):
            parked.result(timeout=10)


def test_deadline_expired_chunks_are_shed():
    """The 1 ms budget expires while the scheduler holds its 100 ms
    window open, so the chunk is shed at tick assembly, never served
    late, and the loop survives."""
    (g, cfg, params), _ = _worlds()
    with InferenceServer(g, cfg, params, deadline_ms=1.0,
                         micro_batch_window_ms=100.0, device="cpu") as srv:
        h = srv.submit(np.arange(cfg.batch_size))
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=60)
        assert srv.stats()["shed_chunks"] == 1
        assert srv._thread.is_alive(), "shedding must not kill the loop"
