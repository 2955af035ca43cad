"""The port's elastic fault tolerance (DESIGN.md §10), as
``tests/test_chaos.py`` pins it for the JAX package: kill a trainer
mid-epoch, revive a replacement from the last consistent checkpoint,
fast-forward the deterministic schedule, and the finished run's parameters
are byte-identical to an uninterrupted run's, through
``DistGNNTrainer`` and through ``repro_torch.launch.train``. Transient RPC
faults are retried and change no byte; a retried gradient push applies
its Adam step once.

Node classification on product-sim scale 10 (GraphSAGE, hidden 16,
fanouts [3, 2], batch 8, 2 machines x 1 trainer, seed 5, an 8 MB feature
cache so that recovery also restores cache snapshots), on the CPU. Every
comparison is bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (DistGNNTrainer, FaultInjector, TrainJobConfig,
                             TrainerDeath)
from repro_torch.core.kvstore import (CacheConfig, DistEmbedding,
                                      DistKVStore, PartitionPolicy)
from repro_torch.graph import get_dataset
from repro_torch.launch import train
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim.optimizers import tree_leaves

EPOCHS = 2
HYPER_LAUNCH = ["--arch", "graphsage", "--scale", "10", "--epochs", "2",
                "--batch-size", "8", "--trainers-per-machine", "1",
                "--cache-budget-mb", "8", "--device", "cpu"]


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
def homo_ds():
    return get_dataset("product-sim", scale=10)


def _cfg(ds) -> GNNConfig:
    return GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                     hidden_dim=16, num_classes=ds.num_classes,
                     fanouts=[3, 2], batch_size=8)


def _job(**kw) -> TrainJobConfig:
    return TrainJobConfig(num_machines=2, trainers_per_machine=1, seed=5,
                          cache=CacheConfig.from_mb(8), **kw)


def _trainer(ds, **kw) -> DistGNNTrainer:
    return DistGNNTrainer(ds, _cfg(ds), _job(**kw), device="cpu")


def _pbytes(params) -> list:
    return [p.detach().numpy().tobytes() for p in tree_leaves(params)]


def test_kill_revive_byte_identical(homo_ds, tmp_path):
    ds = homo_ds
    base = _trainer(ds)
    bpe = base.batches_per_epoch
    assert bpe >= 2, "world too small to die mid-epoch"
    for e in range(EPOCHS):
        base.train_epoch(e)
    base_params = _pbytes(base.params)
    base_eval = base.evaluate(ds.val_nids)
    base.stop()

    ck = str(tmp_path / "ck")
    kill = (EPOCHS - 1, max(bpe // 2, 1))
    victim = _trainer(ds, checkpoint_dir=ck, checkpoint_interval=2,
                      fault_injector=FaultInjector(seed=11, kill_at=kill))
    with pytest.raises(TrainerDeath) as death:
        for e in range(EPOCHS):
            victim.train_epoch(e)
    assert (death.value.epoch, death.value.batch_index) == kill
    victim.stop()

    revived = _trainer(ds)
    meta = revived.recover(ck)
    assert (meta["epoch"], meta["batch_index"]) <= kill
    assert revived.global_step == meta["global_step"] > 0
    for e in range(meta["epoch"], EPOCHS):
        revived.train_epoch(e)
    assert _pbytes(revived.params) == base_params, \
        "recovered run's parameters diverged from the uninterrupted run"
    assert revived.evaluate(ds.val_nids) == base_eval
    assert revived.opt.step.dtype == torch.int32
    assert int(revived.opt.step) == EPOCHS * bpe
    revived.stop()


def test_launch_train_revives_in_process(tmp_path):
    """``--inject-fault`` kills the trainer; the launcher revives it from
    the last checkpoint and ends with the uninterrupted run's bytes."""
    plain = train.run_gnn(train.build_parser().parse_args(HYPER_LAUNCH))
    bpe = plain["trainer"].batches_per_epoch
    assert bpe >= 3
    fault = HYPER_LAUNCH + ["--checkpoint-dir", str(tmp_path / "ck"),
                            "--checkpoint-interval", "2", "--inject-fault",
                            "1:2"]
    chaos = train.run_gnn(train.build_parser().parse_args(fault))
    # a checkpoint lands before every even global step, ahead of the
    # death check at the same boundary: the last one at or before the
    # death at (1, 2), global step bpe + 2, is the even step at or below it
    step = 2 * ((bpe + 2) // 2)
    assert chaos["revived"] == [divmod(step, bpe)]
    assert (_pbytes(chaos["trainer"].params)
            == _pbytes(plain["trainer"].params))
    assert chaos["val_acc"] == plain["val_acc"]

    summary = train.main(fault[:-2] + ["--recover"])   # resume, no fault
    assert summary["revived"] == [] and "trainer" not in summary
    assert summary["val_acc"] == plain["val_acc"]


def test_launch_train_checks_its_fault_flags():
    with pytest.raises(SystemExit, match="need --checkpoint-dir"):
        train.build_trainer(train.build_parser().parse_args(
            HYPER_LAUNCH + ["--inject-fault", "1:2"]))
    with pytest.raises(SystemExit, match="EPOCH:BATCH"):
        train.build_trainer(train.build_parser().parse_args(
            HYPER_LAUNCH + ["--checkpoint-dir", "x", "--inject-fault", "1"]))


def test_recover_rejects_mismatched_world(homo_ds, tmp_path):
    ds = homo_ds
    ck = str(tmp_path / "ck")
    tr = _trainer(ds)
    tr.save_checkpoint(ck, epoch=0, batch_index=1)
    tr.stop()

    other = DistGNNTrainer(ds, _cfg(ds), TrainJobConfig(
        num_machines=2, trainers_per_machine=1, seed=6), device="cpu")
    with pytest.raises(ValueError, match="seed"):
        other.recover(ck)
    other.stop()

    same = _trainer(ds)
    same.recover(ck)
    with pytest.raises(ValueError, match="epoch"):
        same.train_epoch(1)          # must resume at the saved epoch 0
    same.stop()


def test_transient_rpc_faults_leave_bytes_unchanged(homo_ds):
    ds = homo_ds
    runs = {}
    for tag, inj in (("clean", None),
                     ("faulty", FaultInjector(seed=3,
                                              rpc_failure_rate=0.15))):
        tr = _trainer(ds, fault_injector=inj)
        tr.train_epoch(0)
        runs[tag] = _pbytes(tr.params)
        stats = tr.transport.stats()
        if tag == "faulty":
            assert stats["rpc_failures"] > 0
            assert stats["rpc_retries"] == stats["rpc_failures"]
        else:
            assert stats["rpc_failures"] == 0 == stats["rpc_retries"]
        tr.stop()
    assert runs["clean"] == runs["faulty"]


def test_checkpoint_interval_needs_a_directory():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TrainJobConfig(checkpoint_interval=2)


@pytest.mark.parametrize("replication", [1, 2])
def test_push_retry_never_double_applies_adam(replication):
    """A gradient push whose transport charge fails transiently 5 times
    is retried, and the owners apply its Adam step exactly once: the
    bytes of a push that never failed."""
    def world(injector):
        s = DistKVStore({"node": PartitionPolicy("node",
                                                 np.array([0, 10, 20]))},
                        replication=replication)
        s.transport.fault_injector = injector
        return s, DistEmbedding(s, "emb", 20, 4, "node", seed=1,
                                device="cpu")

    ids = np.array([3, 3, 12])
    grad = np.ones((3, 4), np.float32)
    clean, e1 = world(None)
    e1.push_grad(clean.client(1), ids, grad)
    faulty, e2 = world(FaultInjector(seed=0, rpc_failure_rate=1.0,
                                     ops=("push",), max_rpc_failures=5))
    e2.push_grad(faulty.client(1), ids, grad)
    for suffix in ("", "__m", "__v", "__t"):
        assert (faulty.gather_all("emb" + suffix).tobytes()
                == clean.gather_all("emb" + suffix).tobytes())
    assert faulty.gather_all("emb__t")[3] == 1
    stats = faulty.transport.stats()
    assert stats["rpc_failures"] == 5 and stats["rpc_retries"] == 5
