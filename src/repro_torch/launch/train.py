"""Training launcher (the port of ``repro/launch/train.py``'s GNN branch).

Synchronous mini-batch node classification over a partitioned graph, on
the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gat \
        --dataset product-sim --machines 2 --trainers-per-machine 2 \
        --epochs 3

Link prediction (``--task link_prediction``), checkpoints and recovery
(``--checkpoint-dir``, ``--recover``, ``--inject-fault``,
``--rpc-fault-rate``), typed graphs (``--hetero``, ``--rel-fanout``) and
the LM stack are not ported yet: each raises ``NotImplementedError``
naming its ROADMAP item.
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def _refuse_unported(args) -> None:
    if args.arch not in ("graphsage", "gat", "rgcn"):
        raise NotImplementedError(f"arch {args.arch!r}: the LM stack is not "
                                  f"ported to repro_torch yet: ROADMAP "
                                  f"queue A item 10")
    if args.task != "node_classification":
        raise NotImplementedError("--task link_prediction is not ported to "
                                  "repro_torch yet: ROADMAP queue A item 5")
    if args.hetero or args.rel_fanout:
        raise NotImplementedError("--hetero / --rel-fanout are not ported "
                                  "to repro_torch yet: ROADMAP queue A "
                                  "item 4 (RGCN and the typed path)")
    if (args.checkpoint_dir or args.checkpoint_interval or args.recover
            or args.inject_fault or args.rpc_fault_rate):
        raise NotImplementedError(
            "--checkpoint-dir / --checkpoint-interval / --recover / "
            "--inject-fault / --rpc-fault-rate are not ported to "
            "repro_torch yet: ROADMAP queue A item 7 (checkpoints and "
            "recovery)")


def build_trainer(args):
    """(dataset, :class:`~repro_torch.api.DistGNNTrainer`) for ``args``."""
    from ..api import DistGNNTrainer, TrainJobConfig
    from ..configs import get_config
    from ..core.kvstore import CacheConfig, NetworkModel
    from ..graph import get_dataset

    _refuse_unported(args)
    cfg = get_config(args.arch)
    ds = get_dataset(args.dataset, scale=args.scale)
    cfg = dataclasses.replace(cfg, in_dim=ds.feats.shape[1],
                              num_classes=ds.num_classes,
                              batch_size=min(cfg.batch_size,
                                             args.batch_size))
    cache = (CacheConfig.from_mb(args.cache_budget_mb,
                                 policy=args.cache_policy)
             if args.cache_budget_mb > 0 else None)
    job = TrainJobConfig(
        num_machines=args.machines,
        trainers_per_machine=args.trainers_per_machine,
        partition_method=args.partition, sync=args.sync,
        non_stop=not args.no_nonstop, cache=cache,
        sample_workers=args.sample_workers, impl=args.impl,
        replication=args.replication, max_rpc_retries=args.max_rpc_retries,
        hedge_ms=args.hedge_ms,
        network=NetworkModel(sleep=args.simulate_network))
    return ds, DistGNNTrainer(ds, cfg, job, device=args.device)


def run_gnn(args, trainer=None) -> dict:
    """Train ``args.epochs`` epochs (with a trainer built from ``args``
    unless one is given), evaluate on the validation nodes, print the
    summary JSON and return it with the trainer (``"trainer"``, stopped)."""
    if trainer is None:
        ds, tr = build_trainer(args)
    else:
        tr = trainer
        ds = tr.ds
    print(f"[train] {args.arch} on {args.dataset} ({tr.device}): "
          f"{tr.num_trainers} trainers, {tr.batches_per_epoch} "
          f"batches/epoch, seed locality "
          f"{tr.locality['mean_local_frac']:.2f}", flush=True)
    epochs = []
    try:
        for e in range(args.epochs):
            m = tr.train_epoch(e)
            epochs.append(m)
            print(f"[epoch {e}] loss={m['loss']:.4f} acc={m['acc']:.3f} "
                  f"time={m['time_s']:.2f}s", flush=True)
        val = tr.evaluate(ds.val_nids)
    finally:
        tr.stop()
    stats = tr.sampling_stats()
    print(f"[final] val_acc={val:.3f} stats={json.dumps(stats)}",
          flush=True)
    return {"epochs": epochs, "val_acc": val, "stats": stats,
            "spans_ms": tr.spans_ms(), "trainer": tr}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    help="model: graphsage|gat (rgcn and the LM archs are "
                         "not ported yet)")
    ap.add_argument("--dataset", default="product-sim",
                    help="named synthetic dataset "
                         "(repro_torch.graph.datasets)")
    ap.add_argument("--scale", type=int, default=12,
                    help="dataset scale exponent (graph has ~2^scale nodes)")
    ap.add_argument("--machines", type=int, default=2,
                    help="simulated machines (level-1 partitions)")
    ap.add_argument("--trainers-per-machine", type=int, default=2,
                    help="trainers per machine (level-2 split)")
    ap.add_argument("--partition", default="metis",
                    choices=["metis", "random"],
                    help="graph partitioner (random = Euler baseline)")
    ap.add_argument("--epochs", type=int, default=3,
                    help="training epochs")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="seeds per batch per trainer (capped at the "
                         "config's batch)")
    ap.add_argument("--task", default="node_classification",
                    choices=["node_classification", "link_prediction"],
                    help="GNN workload (link prediction is not ported yet)")
    ap.add_argument("--hetero", action="store_true",
                    help="typed relations end-to-end (not ported yet)")
    ap.add_argument("--rel-fanout", action="append", metavar="REL=K",
                    help="per-relation fanout (not ported yet)")
    ap.add_argument("--cache-budget-mb", type=float, default=0.0,
                    help="per-trainer hot-vertex feature cache budget in "
                         "MB (0 disables the cache)")
    ap.add_argument("--cache-policy", default="clock",
                    choices=["clock", "lru"],
                    help="feature-cache eviction policy")
    ap.add_argument("--impl", default=None, choices=["auto", "ref", "cuda"],
                    help="kernels for the GNN aggregations (auto = the CUDA "
                         "kernels on the card, the plain versions on the "
                         "CPU; default keeps the model config's choice)")
    ap.add_argument("--sample-workers", type=int, default=1,
                    help="sampling-stage worker threads per trainer "
                         "(batches are byte-identical for any value)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoints (not ported yet)")
    ap.add_argument("--checkpoint-interval", type=int, default=0,
                    help="global steps between checkpoints (not ported "
                         "yet)")
    ap.add_argument("--recover", action="store_true",
                    help="restore a checkpoint (not ported yet)")
    ap.add_argument("--inject-fault", metavar="EPOCH:BATCH", default=None,
                    help="chaos testing (not ported yet)")
    ap.add_argument("--rpc-fault-rate", type=float, default=0.0,
                    help="chaos testing (not ported yet)")
    ap.add_argument("--replication", type=int, default=1,
                    help="KVStore feature-plane replica count")
    ap.add_argument("--max-rpc-retries", type=int, default=8,
                    help="per-destination transient-RPC retry budget "
                         "before a peer is treated as dead")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedged reads: race a replica after this many ms "
                         "without a primary response (needs "
                         "--replication >= 2; default off)")
    ap.add_argument("--sync", action="store_true",
                    help="disable the async pipeline (unpipelined baseline)")
    ap.add_argument("--no-nonstop", action="store_true",
                    help="drain the pipeline between epochs (ablation)")
    ap.add_argument("--simulate-network", action="store_true",
                    help="enable the network cost model's real sleeps")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises when no card "
                         "is present")
    return ap


def main(argv=None):
    summary = run_gnn(build_parser().parse_args(argv))
    summary.pop("trainer")
    return summary


if __name__ == "__main__":
    main()
