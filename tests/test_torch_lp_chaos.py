"""The port's link-prediction fault tolerance and launcher on the CPU: the
``lp-homo`` and ``lp-typed`` cases of ``tests/test_chaos.py`` (a trainer
killed mid-epoch and revived from its last checkpoint ends with the
uninterrupted run's bytes, the ``lp`` subtree included, an empty one for
``dot``) and of ``tests/test_owner_loss.py`` (owner 2 of 3 down under
replication 2: the run trains through with no restart and ends with the
clean unreplicated run's bytes), at the reference's model sizes (hidden
16, batch 8, 4 negatives) on product-sim scale 6 / mag-hetero scale 5;
and ``repro_torch.launch.train --task link_prediction``: a run that ends
with ``[final] val_mrr=``, the same run killed and revived in process
bitwise, and the four link-prediction flags (the reference's choices and
defaults) reaching the job. Everything compares bitwise."""
import numpy as np
import pytest
import torch

from repro_torch.api import (DistGNNTrainer, FaultInjector, OwnerDownWindow,
                             TrainerDeath, TrainJobConfig)
from repro_torch.core.kvstore import CacheConfig
from repro_torch.graph import get_dataset
from repro_torch.launch import train as train_cli
from repro_torch.models.gnn import GNNConfig
from repro_torch.optim.optimizers import tree_leaves

FANOUTS = {"cites": 4, "writes": 3, "rev_writes": 2, "employs": 2}
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


def _pbytes(params) -> list:
    return [p.detach().numpy().tobytes() for p in tree_leaves(params)]


# ---------------------------------------------------------------------------
# fault tolerance: the lp cases of test_chaos.py and test_owner_loss.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos_ds():
    return {False: get_dataset("product-sim", scale=6),
            True: get_dataset("mag-hetero", scale=5)}


def _chaos_cfg(ds, typed):
    if typed:
        return GNNConfig(arch="rgcn", in_dim=ds.feats.shape[1],
                         hidden_dim=16, num_classes=16,
                         fanouts=[dict(FANOUTS)] * 2, batch_size=8,
                         num_rels=ds.schema.num_etypes)
    return GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                     hidden_dim=16, num_classes=16, fanouts=[3, 2],
                     batch_size=8)


def _chaos_trainer(ds, typed, machines=2, **kw):
    job = TrainJobConfig(num_machines=machines, trainers_per_machine=1,
                         task="link_prediction", num_negs=4, seed=5,
                         score_fn="distmult" if typed else "dot", **kw)
    return DistGNNTrainer(ds, _chaos_cfg(ds, typed), job, device="cpu")


@pytest.mark.parametrize("typed", [False, True], ids=["lp-homo", "lp-typed"])
def test_lp_kill_revive_byte_identical(chaos_ds, typed, tmp_path):
    ds = chaos_ds[typed]
    cache = dict(cache=CacheConfig.from_mb(8))
    base = _chaos_trainer(ds, typed, **cache)
    bpe = base.batches_per_epoch
    assert bpe >= 2, "world too small to die mid-epoch"
    for e in range(EPOCHS):
        base.train_epoch(e)
    base_params = _pbytes(base.params)
    base_eval = base.evaluate_lp(num_batches=2)
    base.stop()

    ck = str(tmp_path / "ck")
    kill = (EPOCHS - 1, max(bpe // 2, 1))
    victim = _chaos_trainer(ds, typed, checkpoint_dir=ck,
                            checkpoint_interval=2,
                            fault_injector=FaultInjector(seed=11,
                                                         kill_at=kill),
                            **cache)
    with pytest.raises(TrainerDeath) as death:
        for e in range(EPOCHS):
            victim.train_epoch(e)
    assert (death.value.epoch, death.value.batch_index) == kill
    victim.stop()

    revived = _chaos_trainer(ds, typed, **cache)
    meta = revived.recover(ck)
    assert (meta["epoch"], meta["batch_index"]) <= kill
    assert revived.global_step == meta["global_step"] > 0
    for e in range(meta["epoch"], EPOCHS):
        revived.train_epoch(e)
    assert _pbytes(revived.params) == base_params, \
        "recovered run's parameters diverged from the uninterrupted run"
    if typed:
        assert revived.params["lp"]["rel_emb"].shape == (4, 16)
    else:
        assert revived.params["lp"] == {}
    assert revived.evaluate_lp(num_batches=2) == base_eval
    revived.stop()


@pytest.mark.parametrize("typed", [False, True], ids=["lp-homo", "lp-typed"])
def test_lp_owner_outage_trains_through_byte_identical(chaos_ds, typed):
    """Replication 2, owner 2 of 3 down from (epoch 1, batch 2) with a
    small cache: the run trains through with no restart and ends with the
    bytes of the clean unreplicated run."""
    ds = chaos_ds[typed]
    cache = dict(cache=CacheConfig(budget_bytes=4096))
    base = _chaos_trainer(ds, typed, machines=3, **cache)
    assert base.batches_per_epoch >= 4, "world too small for a mid-window"
    for e in range(EPOCHS):
        base.train_epoch(e)
    base_params = _pbytes(base.params)
    base.stop()

    inj = FaultInjector(seed=11, owner_down=[OwnerDownWindow(
        owner=2, start=(EPOCHS - 1, 2), end=(EPOCHS, 0), unit="batch")])
    tr = _chaos_trainer(ds, typed, machines=3, replication=2,
                        fault_injector=inj, **cache)
    for e in range(EPOCHS):
        tr.train_epoch(e)
    assert _pbytes(tr.params) == base_params, \
        "owner outage under r=2 must not change one byte of training"
    assert inj.stats()["owner_down_hits"] > 0, "the outage never fired"
    st = tr.transport.stats()
    assert st["owner_down_failures"] > 0
    assert st["failovers"] > 0 or st["deferred_replica_writes"] > 0
    tr.stop()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_link_prediction_on_cpu(capsys, tmp_path):
    """``--task link_prediction`` trains, revives a killed trainer with the
    uninterrupted run's bytes, and ends with the ``[final] val_mrr=``
    line."""
    argv = ["--arch", "graphsage", "--task", "link_prediction", "--device",
            "cpu", "--scale", "5", "--epochs", "2", "--batch-size", "4",
            "--num-negs", "2", "--trainers-per-machine", "1"]
    plain = train_cli.run_gnn(train_cli.build_parser().parse_args(argv))
    assert plain["epochs"][0]["batches"] >= 3
    assert np.isfinite(plain["epochs"][0]["loss"])
    val = plain["val_lp"]
    # the reference's evaluation: 20 batches of min(4, 16) edges
    assert 0.0 < val["mrr"] <= 1.0 and val["num_edges"] == 20 * 4
    out = capsys.readouterr().out
    assert "[final] val_mrr=" in out and "hits@10=" in out
    assert " mrr=" in out.split("[epoch 0]")[1].splitlines()[0]
    chaos = train_cli.run_gnn(train_cli.build_parser().parse_args(
        argv + ["--checkpoint-dir", str(tmp_path / "ck"),
                "--checkpoint-interval", "2", "--inject-fault", "1:2"]))
    assert len(chaos["revived"]) == 1
    assert _pbytes(chaos["trainer"].params) == _pbytes(
        plain["trainer"].params)
    assert chaos["val_lp"] == val


@pytest.mark.parametrize("argv,want", [
    ([], dict(num_negs=16, score_fn="dot", neg_mode="uniform",
              neg_exclude=False)),
    (["--num-negs", "3", "--neg-mode", "in-batch", "--neg-exclude"],
     dict(num_negs=3, score_fn="dot", neg_mode="in-batch",
          neg_exclude=True)),
    (["--arch", "rgcn", "--dataset", "mag-hetero", "--hetero",
      "--score-fn", "distmult", "--num-negs", "2"],
     dict(num_negs=2, score_fn="distmult", neg_mode="uniform",
          neg_exclude=False)),
])
def test_lp_flags_reach_the_job(argv, want):
    """The four link-prediction flags (the reference's choices and
    defaults) land in the trainer's job; the model's output width is the
    hidden width, and the node batch is the edge batch's endpoints."""
    args = train_cli.build_parser().parse_args(
        ["--arch", "graphsage", "--task", "link_prediction", "--device",
         "cpu", "--scale", "6", "--batch-size", "4", *argv])
    _ds, tr = train_cli.build_trainer(args)
    tr.stop()
    assert tr.task == "link_prediction"
    assert {k: getattr(tr.job, k) for k in want} == want
    assert tr.cfg.num_classes == tr.cfg.hidden_dim
    assert tr.cfg.batch_size == 4
    per_edge = 2 + (0 if want["neg_mode"] == "in-batch" else want["num_negs"])
    assert tr.node_cfg.batch_size == 4 * per_edge
    assert (tr.params["lp"]["rel_emb"].shape == (4, tr.cfg.hidden_dim)
            if want["score_fn"] == "distmult" else tr.params["lp"] == {})
    assert tr.hetero == ("--hetero" in argv)


def test_lp_refuses_bad_choices():
    for argv in (["--score-fn", "cosine"], ["--neg-mode", "hard"]):
        with pytest.raises(SystemExit):
            train_cli.build_parser().parse_args(
                ["--arch", "graphsage", "--task", "link_prediction", *argv])
