"""The port's typed path (RGCN on a heterograph) against the JAX
package's, on mag-hetero scale 10 on the CPU: typed loaders byte-identical
to ``repro.api.NodeDataLoader``'s, the synchronous trainer's first step,
losses and ``edges_per_etype`` against ``repro.training.DistGNNTrainer``
at ``tests/test_hetero.py::test_hetero_trainer_end_to_end``'s config
(hidden 16, batch 8, 2 machines x 1 trainer), typed serving against
``repro.api.InferenceServer`` (``tests/test_inference.py``'s hetero
cases), and the ``nc-typed`` cases of ``tests/test_chaos.py`` and
``tests/test_owner_loss.py``: kill-and-revive and an owner outage under
replication 2, each ending byte-identical to the uninterrupted run, with
typed checkpoints that round-trip every feature tensor, cache and version
table.

Tolerances: first-step loss rtol 1e-4, atol 1e-5 and gradients rtol 1e-4,
atol 1e-5, per-step losses the same, served logits rtol 1e-4, atol 1e-5
(XLA's and PyTorch's CPU GEMMs and scatters add in different orders).
Batches, replays and co-batched serving compare bitwise.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import DistGNNTrainer as RefTrainer
from repro.api import DistGraph as RefDistGraph
from repro.api import InferenceServer as RefServer
from repro.api import NodeDataLoader as RefLoader
from repro.api import TrainJobConfig as RefJob
from repro.core.kvstore import CacheConfig as RefCacheConfig
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import apply_gnn as ref_apply_gnn
from repro.models.gnn import init_gnn as ref_init_gnn
from repro.models.gnn import nc_loss as ref_nc_loss
from repro_torch.api import (DistGNNTrainer, DistGraph, FaultInjector,
                             InferenceServer, NodeDataLoader, OwnerDownWindow,
                             TrainJobConfig, TrainerDeath)
from repro_torch.core.kvstore import CacheConfig
from repro_torch.graph import get_dataset
from repro_torch.launch import gnn_serve, train
from repro_torch.models.gnn import GNNConfig, apply_gnn, params_from_numpy
from repro_torch.optim.optimizers import tree_leaves

SCALE = 10
FANOUTS = {"cites": 5, "writes": 3, "rev_writes": 2, "employs": 2}
FANOUTS_CHAOS = {"cites": 4, "writes": 3, "rev_writes": 2, "employs": 2}
TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds():
    return get_dataset("mag-hetero", scale=SCALE)


@pytest.fixture(scope="module")
def ref_ds():
    return ref_get_dataset("mag-hetero", scale=SCALE)


def _model(ds, fanouts=FANOUTS, hidden=16, batch_size=8, cls=GNNConfig,
           **kw):
    return cls(arch="rgcn", in_dim=ds.feats.shape[1], hidden_dim=hidden,
               num_classes=ds.num_classes, fanouts=[dict(fanouts)] * 2,
               batch_size=batch_size, num_rels=ds.schema.num_etypes, **kw)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    """The port's tree in the reference's leaf order (jax sorts dict
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _port_leaves(v)]
    return [tree.detach().cpu().numpy()]


def _host_leaves(batch: dict):
    out = {k: np.asarray(batch[k])
           for k in ("input_feats", "labels", "seed_mask")}
    for i, b in enumerate(batch["blocks"]):
        for k, v in b.items():
            out[f"blocks/{i}/{k}"] = np.asarray(v)
    return out


def _pbytes(params) -> list:
    return [p.detach().numpy().tobytes() for p in tree_leaves(params)]


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,sync", [("train", False), ("train", True),
                                       ("eval", False)])
def test_typed_loader_batches_byte_identical(ds, ref_ds, mode, sync):
    world = dict(num_machines=2, trainers_per_machine=1, seed=0,
                 hetero=True)
    kw = dict(batch_size=8, mode=mode, seed=5, sampler_seed=7)
    if mode == "train":
        kw["sync"] = sync
    got = {}
    for name, graph, cls in (("ref", RefDistGraph(ref_ds, **world), RefLoader),
                             ("port", DistGraph(ds, **world),
                              NodeDataLoader)):
        view = graph.trainer_view(1)
        seeds = view.train_nids
        with cls(view, seeds, [dict(FANOUTS)] * 2, labels=view.labels[seeds],
                 **kw) as ld:
            got[name] = [_host_leaves(b.model_input()) for b in ld.epoch(0)]
    assert len(got["ref"]) == len(got["port"]) >= 2
    for a, b in zip(got["ref"], got["port"]):
        assert a.keys() == b.keys()
        assert "blocks/0/edge_types" in a
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the trainer against the reference trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(ds, ref_ds):
    """Reference and port trainers from the same initial params at
    ``test_hetero_trainer_end_to_end``'s config (unpipelined, so both
    sample the same batches): the first stacked batch's loss and
    gradients, then two epochs."""
    job = dict(num_machines=2, trainers_per_machine=1, sync=True)
    ref = RefTrainer(ref_ds, _model(ref_ds, cls=RefConfig, impl="ref"),
                     RefJob(**job))
    params0 = jax.tree.map(np.asarray, ref.params)
    port = DistGNNTrainer(ds, _model(ds), TrainJobConfig(**job),
                          device="cpu", params=params_from_numpy(params0))
    try:
        assert ref.hetero and port.hetero and port.cfg.typed
        assert port.batches_per_epoch == ref.batches_per_epoch >= 2
        ref_first = [next(ld.epoch(0)).model_input() for ld in ref.loaders]
        port_first = [next(ld.epoch(0)).model_input() for ld in port.loaders]
        for a, b in zip(ref_first, port_first):
            a, b = _host_leaves(a), _host_leaves(b)
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
        etype_id = ref.schema.etype_id

        def ref_loss(p):
            def one(b):
                return ref_nc_loss(ref_apply_gnn(ref.cfg, p, b,
                                                 etype_id=etype_id),
                                   b["labels"], b["seed_mask"])
            return jax.vmap(one)(ref._stack(ref_first)).mean()

        want_loss, want_grads = jax.value_and_grad(ref_loss)(ref.params)
        loss, _acc, grads = port.loss_and_grads(port._stack(port_first))
        ref_epochs = [ref.train_epoch(e) for e in range(EPOCHS)]
        port_epochs = [port.train_epoch(e) for e in range(EPOCHS)]
    finally:
        ref.stop()
        port.stop()
    return dict(ref_loss=float(want_loss), loss=float(loss),
                ref_grads=_np_leaves(want_grads), grads=_port_leaves(grads),
                ref_epochs=ref_epochs, port_epochs=port_epochs,
                ref_params=_np_leaves(ref.params),
                params=_port_leaves(port.params),
                params0=_np_leaves(params0),
                ref_stats=ref.sampling_stats(),
                stats=port.sampling_stats())


def test_first_step_loss_and_gradients_match_reference(trained):
    np.testing.assert_allclose(trained["loss"], trained["ref_loss"], **TOL)
    assert len(trained["grads"]) == len(trained["ref_grads"]) == 6
    for got, want in zip(trained["grads"], trained["ref_grads"]):
        assert got.shape == want.shape
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, **TOL)


def test_per_step_losses_and_final_params_match_reference(trained):
    ref = [m["loss"] for m in trained["ref_epochs"]]
    got = [m["loss"] for m in trained["port_epochs"]]
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(trained["port_epochs"][0]["losses"][0],
                               trained["ref_loss"], **TOL)
    for got, want, start in zip(trained["params"], trained["ref_params"],
                                trained["params0"]):
        np.testing.assert_allclose(got, want, **PARAM_TOL)
        assert not np.array_equal(got, start)        # every leaf moved


def test_edges_per_etype_equal_to_reference(trained):
    got = trained["stats"]["edges_per_etype"]
    assert got == trained["ref_stats"]["edges_per_etype"]
    assert list(got) == ["cites", "writes", "rev_writes", "employs"]
    assert all(v > 0 for v in got.values())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving(ds, ref_ds):
    world = dict(num_machines=2, trainers_per_machine=1, hetero=True, seed=0)
    halved = {r: max(1, f // 2) for r, f in FANOUTS.items()}
    kw = dict(arch="rgcn", in_dim=ds.feats.shape[1], hidden_dim=8,
              num_classes=int(ds.num_classes), fanouts=[FANOUTS, halved],
              batch_size=4, num_rels=ds.graph.num_etypes)
    ref_params = ref_init_gnn(RefConfig(**kw), jax.random.PRNGKey(0))
    return (RefDistGraph(ref_ds, **world), DistGraph(ds, **world), kw,
            ref_params, params_from_numpy(jax.tree.map(np.asarray,
                                                       ref_params)))


@pytest.mark.parametrize("cached", [False, True], ids=["nocache", "cache"])
def test_typed_server_matches_reference_server(serving, cached):
    ref_g, g, kw, ref_params, params = serving
    nids = g.node_split()[: 3 * kw["batch_size"] + 1]     # ragged last chunk
    with RefServer(ref_g, RefConfig(**kw, impl="ref"), ref_params,
                   sampler_seed=7, micro_batch_capacity=2,
                   cache=RefCacheConfig(budget_bytes=1 << 20) if cached
                   else None) as srv:
        want = srv.predict(nids)
    with InferenceServer(g, GNNConfig(**kw), params, sampler_seed=7,
                         micro_batch_capacity=2,
                         cache=CacheConfig(budget_bytes=1 << 20) if cached
                         else None, device="cpu") as srv:
        got = srv.predict(nids)
        assert srv.stats()["ticks"] >= 2
        if cached:
            assert set(srv.stats()["cache"]["rows"]) == {
                "feat:paper", "feat:author", "feat:institution"}
    assert got.shape == (len(nids), kw["num_classes"])
    np.testing.assert_allclose(got, want, **TOL)


def test_typed_server_matches_eval_loader_and_co_batches_bitwise(serving):
    """Served bytes are the typed eval loader's forward bytes, and a
    request co-batched with others returns the bytes it returns alone."""
    _, g, kw, _, params = serving
    cfg = GNNConfig(**kw)
    nids = g.node_split()[: 3 * cfg.batch_size]
    loader = NodeDataLoader(g, nids, cfg.fanouts, batch_size=cfg.batch_size,
                            mode="eval", sampler_seed=7)
    oracle = np.concatenate([
        apply_gnn(cfg, params, jax.tree.map(torch.from_numpy,
                                            nb.model_input()),
                  etype_id=g.schema.etype_id).numpy()
        for nb in loader])
    reqs = [[int(n)] for n in nids[:5]] + [nids[5:11]]
    with InferenceServer(g, cfg, params, sampler_seed=7,
                         micro_batch_capacity=4, micro_batch_window_ms=50.0,
                         device="cpu") as srv:
        assert srv.predict(nids).tobytes() == oracle.tobytes()
        alone = [srv.predict(r) for r in reqs]
        together = [h.result(timeout=60) for h in
                    [srv.submit(r) for r in reqs]]
        assert max(srv.tick_chunks) > 1                  # really co-batched
    for a, b in zip(alone, together):
        assert a.tobytes() == b.tobytes()


def test_gnn_serve_hetero_on_cpu(capsys):
    out = gnn_serve.main(["--arch", "rgcn", "--dataset", "mag-hetero",
                          "--hetero", "--scale", "9", "--smoke",
                          "--device", "cpu"])
    assert out["served"] == out["requests"] == 8
    assert set(out["cache"]["rows"]) == {"feat:paper", "feat:author",
                                         "feat:institution"}
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"
    with pytest.raises(SystemExit, match="needs a schema'd dataset"):
        gnn_serve.main(["--arch", "rgcn", "--hetero", "--device", "cpu",
                        "--scale", "9", "--smoke"])


# ---------------------------------------------------------------------------
# fault tolerance: the nc-typed cases of test_chaos.py and test_owner_loss.py
# ---------------------------------------------------------------------------

def _chaos_trainer(ds, **kw) -> DistGNNTrainer:
    return DistGNNTrainer(ds, _model(ds, FANOUTS_CHAOS), TrainJobConfig(
        num_machines=2, trainers_per_machine=1, seed=5,
        cache=CacheConfig.from_mb(8), **kw), device="cpu")


def test_typed_kill_revive_byte_identical(ds, tmp_path):
    base = _chaos_trainer(ds)
    bpe = base.batches_per_epoch
    assert bpe >= 2, "world too small to die mid-epoch"
    for e in range(EPOCHS):
        base.train_epoch(e)
    base_params = _pbytes(base.params)
    base_eval = base.evaluate(ds.val_nids)
    base.stop()

    ck = str(tmp_path / "ck")
    kill = (EPOCHS - 1, max(bpe // 2, 1))
    victim = _chaos_trainer(ds, checkpoint_dir=ck, checkpoint_interval=2,
                            fault_injector=FaultInjector(seed=11,
                                                         kill_at=kill))
    with pytest.raises(TrainerDeath) as death:
        for e in range(EPOCHS):
            victim.train_epoch(e)
    assert (death.value.epoch, death.value.batch_index) == kill
    victim.stop()

    revived = _chaos_trainer(ds)
    meta = revived.recover(ck)
    assert (meta["epoch"], meta["batch_index"]) <= kill
    assert revived.global_step == meta["global_step"] > 0
    for e in range(meta["epoch"], EPOCHS):
        revived.train_epoch(e)
    assert _pbytes(revived.params) == base_params, \
        "recovered run's parameters diverged from the uninterrupted run"
    assert revived.evaluate(ds.val_nids) == base_eval
    revived.stop()


def test_typed_checkpoint_round_trips_features_caches_and_versions(
        ds, tmp_path):
    """Every per-node-type feature tensor (``feat:<ntype>``, saved as
    ``feat__<ntype>``) of every shard, every trainer's typed cache
    snapshot and the version tables come back byte for byte into a fresh
    trainer. Both run ``sync=True``: with the async pipeline the loaders'
    threads go on prefetching (and filling the caches) after the
    checkpoint, so the snapshot taken below would race them."""
    ck = str(tmp_path / "ck")
    tr = _chaos_trainer(ds, sync=True)
    tr.train_epoch(0)
    tr.save_checkpoint(ck, epoch=1, batch_index=0)
    names = sorted(tr.store._meta)
    assert {f"feat:{nt}" for nt in ds.schema.ntypes} <= set(names)
    with open(os.path.join(ck, "kvstore", "kv_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["names"] == names
    for p in range(tr.store.num_parts):
        for nt in ds.schema.ntypes:
            assert os.path.exists(os.path.join(
                ck, "kvstore", f"part{p}_feat__{nt}.npy"))
    for name in manifest["versions"]:
        assert os.path.exists(os.path.join(
            ck, "kvstore", f"versions_{name.replace(':', '__')}.npy"))
    caches = [c.state_dict() for c in tr.caches]
    assert all(set(c) >= {f"feat:{nt}" for nt in ds.schema.ntypes}
               for c in caches)
    assert any(len(s["gids"]) for c in caches for s in c.values())
    shards = {n: tr.store.gather_all(n).tobytes() for n in names}
    versions = {n: tr.store.version_table(n).tobytes()
                for n in manifest["versions"]}
    params = _pbytes(tr.params)
    tr.stop()

    fresh = _chaos_trainer(ds, sync=True)
    fresh.recover(ck)
    assert _pbytes(fresh.params) == params
    assert {n: fresh.store.gather_all(n).tobytes() for n in names} == shards
    assert {n: fresh.store.version_table(n).tobytes()
            for n in manifest["versions"]} == versions
    for want, cache in zip(caches, fresh.caches):
        got = cache.state_dict()
        assert got.keys() == want.keys()
        for name in want:
            for k in ("gids", "rows"):
                assert got[name][k].tobytes() == want[name][k].tobytes()
    fresh.stop()


def test_typed_owner_outage_trains_through_byte_identical(ds):
    """Replication 2, owner 2 of 3 down from (epoch 1, batch 2): the
    typed run trains through with no restart and ends with the bytes of
    the clean unreplicated run."""
    def job(**kw):
        return TrainJobConfig(num_machines=3, trainers_per_machine=1, seed=5,
                              cache=CacheConfig(budget_bytes=4096), **kw)

    cfg = _model(ds, FANOUTS_CHAOS)
    base = DistGNNTrainer(ds, cfg, job(), device="cpu")
    assert base.batches_per_epoch >= 4, "world too small for a mid-window"
    for e in range(EPOCHS):
        base.train_epoch(e)
    base_params = _pbytes(base.params)
    base.stop()

    inj = FaultInjector(seed=11, owner_down=[OwnerDownWindow(
        owner=2, start=(EPOCHS - 1, 2), end=(EPOCHS, 0), unit="batch")])
    tr = DistGNNTrainer(ds, cfg, job(replication=2, fault_injector=inj),
                        device="cpu")
    for e in range(EPOCHS):
        tr.train_epoch(e)
    assert _pbytes(tr.params) == base_params, \
        "owner outage under r=2 must not change one byte of training"
    assert inj.stats()["owner_down_hits"] > 0, "the outage never fired"
    st = tr.transport.stats()
    assert st["owner_down_failures"] > 0
    assert st["failovers"] > 0 or st["deferred_replica_writes"] > 0
    tr.stop()


def test_launch_train_hetero_revives_in_process(tmp_path):
    """``launch.train --arch rgcn --hetero`` with ``--inject-fault``
    revives from its last checkpoint and ends with the uninterrupted
    run's bytes."""
    argv = ["--arch", "rgcn", "--dataset", "mag-hetero", "--hetero",
            "--rel-fanout", "writes=3", "--scale", str(SCALE), "--epochs",
            "2", "--batch-size", "8", "--trainers-per-machine", "1",
            "--cache-budget-mb", "8", "--device", "cpu"]
    plain = train.run_gnn(train.build_parser().parse_args(argv))
    tr = plain["trainer"]
    assert tr.hetero and tr.cfg.fanouts[0]["writes"] == 3
    assert tr.batches_per_epoch >= 3
    chaos = train.run_gnn(train.build_parser().parse_args(
        argv + ["--checkpoint-dir", str(tmp_path / "ck"),
                "--checkpoint-interval", "2", "--inject-fault", "1:2"]))
    assert len(chaos["revived"]) == 1
    assert _pbytes(chaos["trainer"].params) == _pbytes(tr.params)
    assert chaos["val_acc"] == plain["val_acc"]
    assert sum(plain["stats"]["edges_per_etype"].values()) > 0
