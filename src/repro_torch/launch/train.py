"""Training launcher (the port of ``repro/launch/train.py``), on the card
unless ``--device cpu`` is given.

GNN archs (graphsage, gat, rgcn): synchronous mini-batch node
classification or link prediction over a partitioned graph:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gat \
        --dataset product-sim --machines 2 --trainers-per-machine 2 \
        --epochs 3

Elastic fault tolerance (DESIGN.md §10): ``--checkpoint-dir`` with
``--checkpoint-interval N`` saves a consistent checkpoint every N steps,
``--recover`` resumes from it, and ``--inject-fault EPOCH:BATCH`` kills the
trainer at that coordinate; the launcher then revives a replacement in
process from the last checkpoint, and the run ends with the bytes of the
uninterrupted one. ``--rpc-fault-rate`` injects transient RPC faults
(retried; the bytes do not change), both seeded by ``--fault-seed``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage \
        --epochs 2 --checkpoint-dir /tmp/ck --checkpoint-interval 2 \
        --inject-fault 1:2

Heterogeneous graphs: ``--hetero`` trains RGCN over typed relations
end to end on a schema'd dataset, every relation at the layer's fanout
unless ``--rel-fanout REL=K`` overrides it (0 stops sampling it)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch rgcn \
        --dataset mag-hetero --hetero --rel-fanout cites=10 --epochs 3

Link prediction (``--task link_prediction``) trains on edge mini-batches:
``--batch-size`` counts positive edges, each with ``--num-negs`` negatives
(``--neg-mode uniform|in-batch``, ``--neg-exclude`` re-draws those that
collide with a positive of the batch), scored by ``--score-fn
dot|distmult`` on output embeddings of the hidden width; the run ends with
MRR and Hits@10 over held-out candidates::

    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage \
        --task link_prediction --num-negs 16 --epochs 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch rgcn \
        --dataset mag-hetero --hetero --task link_prediction \
        --score-fn distmult --neg-exclude --epochs 1

An LM arch id trains ``--steps`` steps of ``make_train_step`` on the
synthetic token stream (``--batch-size`` sequences of ``--seq-len``
tokens, AdamW at ``--lr``); ``--smoke`` takes the reduced same-family
config::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def _kill_at(args):
    """``--inject-fault EPOCH:BATCH`` as a coordinate, or None."""
    if not args.inject_fault:
        return None
    try:
        e, _, b = args.inject_fault.partition(":")
        return int(e), int(b)
    except ValueError:
        raise SystemExit(f"--inject-fault expects EPOCH:BATCH, "
                         f"got {args.inject_fault!r}")


def typed_fanouts(ds, fanouts, rel_fanout=None) -> list:
    """``--hetero``'s per-relation fanouts: every relation of ``ds``'s
    schema at the layer's fanout unless a ``<relation>=<k>`` spec of
    ``rel_fanout`` overrides it (0 stops sampling that relation)."""
    if ds.schema is None:
        raise SystemExit(f"--hetero needs a schema'd dataset "
                         f"(e.g. mag-hetero), got {ds.name}")
    overrides = {}
    for spec in rel_fanout or []:
        rel, sep, k = spec.partition("=")
        if not sep or not k.isdigit():
            raise SystemExit(f"--rel-fanout expects <relation>=<int>, "
                             f"got {spec!r}")
        if rel not in ds.schema.etypes:
            raise SystemExit(f"unknown relation {rel!r}; dataset "
                             f"relations: {list(ds.schema.etypes)}")
        overrides[rel] = int(k)
    return [{rel: overrides.get(rel, f) for rel in ds.schema.etypes}
            for f in fanouts]


def build_trainer(args):
    """(dataset, :class:`~repro_torch.api.DistGNNTrainer`) for ``args``."""
    from ..api import DistGNNTrainer, FaultInjector, TrainJobConfig
    from ..configs import get_config
    from ..core.kvstore import CacheConfig, NetworkModel
    from ..graph import get_dataset

    kill_at = _kill_at(args)
    if (kill_at or args.recover or args.checkpoint_interval) \
            and not args.checkpoint_dir:
        raise SystemExit("--inject-fault / --recover / "
                         "--checkpoint-interval need --checkpoint-dir")
    cfg = get_config(args.arch)
    ds = get_dataset(args.dataset, scale=args.scale)
    # link prediction: the model's output is an embedding of the hidden
    # width, not class logits, and batch_size counts POSITIVE EDGES
    out_dim = (cfg.hidden_dim if args.task == "link_prediction"
               else ds.num_classes)
    cfg = dataclasses.replace(cfg, in_dim=ds.feats.shape[1],
                              num_classes=out_dim,
                              batch_size=min(cfg.batch_size,
                                             args.batch_size),
                              num_rels=ds.graph.num_etypes)
    if args.hetero:
        from ..graph import HeteroCSRGraph

        cfg = dataclasses.replace(cfg, fanouts=typed_fanouts(
            ds, cfg.fanouts, args.rel_fanout))
        counts = HeteroCSRGraph(ds.graph, ds.schema).type_counts()
        print(f"[hetero] schema: {list(ds.schema.ntypes)} / "
              f"{list(ds.schema.canonical_etypes)}")
        print(f"[hetero] counts: {counts}")
        print(f"[hetero] per-relation fanouts: {cfg.fanouts}")
    cache = (CacheConfig.from_mb(args.cache_budget_mb,
                                 policy=args.cache_policy)
             if args.cache_budget_mb > 0 else None)
    injector = None
    if kill_at or args.rpc_fault_rate:
        injector = FaultInjector(seed=args.fault_seed, kill_at=kill_at,
                                 rpc_failure_rate=args.rpc_fault_rate)
    job = TrainJobConfig(
        num_machines=args.machines,
        trainers_per_machine=args.trainers_per_machine,
        partition_method=args.partition, sync=args.sync,
        non_stop=not args.no_nonstop, cache=cache,
        task=args.task, num_negs=args.num_negs, score_fn=args.score_fn,
        neg_mode=args.neg_mode, neg_exclude=args.neg_exclude,
        sample_workers=args.sample_workers, impl=args.impl,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_interval=args.checkpoint_interval,
        fault_injector=injector,
        replication=args.replication, max_rpc_retries=args.max_rpc_retries,
        hedge_ms=args.hedge_ms,
        network=NetworkModel(sleep=args.simulate_network))
    return ds, DistGNNTrainer(ds, cfg, job, device=args.device)


def _revive(tr, args):
    """A replacement for the killed trainer ``tr``: the same job spec
    without the injector (its schedule already fired), restored from the
    last consistent checkpoint and fast-forwarded to its coordinate, or
    from scratch when no checkpoint was written yet -> (trainer, epoch to
    resume, the checkpoint's metadata or None)."""
    from ..api import DistGNNTrainer

    tr.stop()
    job = dataclasses.replace(tr.job, fault_injector=None)
    new = DistGNNTrainer(tr.ds, tr.cfg, job, device=tr.device)
    if not os.path.exists(os.path.join(args.checkpoint_dir, "state.json")):
        print("[recover] no checkpoint written yet — restarting from "
              "epoch 0", flush=True)
        return new, 0, None
    meta = new.recover(args.checkpoint_dir)
    return new, meta["epoch"], meta


def run_gnn(args, trainer=None) -> dict:
    """Train ``args.epochs`` epochs (with a trainer built from ``args``
    unless one is given), reviving a killed trainer from its last
    checkpoint, evaluate (validation accuracy, or for link prediction MRR
    and Hits@k from :meth:`~repro_torch.api.DistGNNTrainer.evaluate_lp`),
    print the summary JSON and return it with the final trainer
    (``"trainer"``, stopped) and the coordinates it revived from
    (``"revived"``)."""
    from ..api import TrainerDeath

    if trainer is None:
        ds, tr = build_trainer(args)
    else:
        tr = trainer
        ds = tr.ds
    lp = tr.task == "link_prediction"
    metric = "mrr" if lp else "acc"
    print(f"[train] {args.arch}/{tr.task} on {args.dataset} ({tr.device}): "
          f"{tr.num_trainers} trainers, {tr.batches_per_epoch} "
          f"batches/epoch, seed locality "
          f"{tr.locality['mean_local_frac']:.2f}", flush=True)
    epochs, revived = [], []
    e = 0
    try:
        if args.recover:
            meta = tr.recover(args.checkpoint_dir)
            e = meta["epoch"]
            print(f"[recover] resuming at epoch {e}, batch "
                  f"{meta['batch_index']} (global step "
                  f"{meta['global_step']}) from {args.checkpoint_dir}",
                  flush=True)
        while e < args.epochs:
            try:
                m = tr.train_epoch(e)
            except TrainerDeath as death:
                # elastic recovery (DESIGN.md §10): tear the dead
                # trainer's world down, build a replacement from the same
                # job spec, restore the last checkpoint, and resume
                print(f"[fault] trainer killed at epoch {death.epoch}, "
                      f"batch {death.batch_index} — reviving from "
                      f"checkpoint", flush=True)
                t0 = time.perf_counter()
                tr, e, meta = _revive(tr, args)
                if meta is not None:
                    revived.append((meta["epoch"], meta["batch_index"]))
                    print(f"[recover] {time.perf_counter() - t0:.2f}s — "
                          f"resuming at epoch {e}, batch "
                          f"{meta['batch_index']}", flush=True)
                continue
            epochs.append(m)
            print(f"[epoch {e}] loss={m['loss']:.4f} {metric}={m['acc']:.3f} "
                  f"time={m['time_s']:.2f}s", flush=True)
            e += 1
        val = tr.evaluate_lp() if lp else tr.evaluate(ds.val_nids)
    finally:
        tr.stop()
    stats = tr.sampling_stats()
    out = {"epochs": epochs, "stats": stats, "spans_ms": tr.spans_ms(),
           "trainer": tr, "revived": revived}
    if lp:
        print(f"[final] val_mrr={val['mrr']:.3f} "
              f"hits@10={val['hits@10']:.3f} stats={json.dumps(stats)}",
              flush=True)
        out["val_lp"] = val
    else:
        print(f"[final] val_acc={val:.3f} stats={json.dumps(stats)}",
              flush=True)
        out["val_acc"] = val
    return out


def run_lm(args, cfg=None) -> dict:
    """Train an LM arch id (on ``cfg`` when given, else the id's config or
    with ``--smoke`` its reduced variant) for ``args.steps`` steps,
    printing the reference's ``[step i]`` lines every ``steps // 10``
    steps and its ``[done]`` line -> {"loss", "ce", "grad_norm": one float
    a step, "tok_s", "ms_per_step", "peak_gib" (the card's peak allocated
    memory, None on the CPU), "params": the trained parameters}."""
    import torch

    from ..configs import get_config, smoke_variant
    from ..data import TokenStream
    from ..models.lm import init_train_state, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card is available "
                           "(--device cpu runs on the CPU)")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(cfg, lr=args.lr)
    params, opt = init_train_state(cfg, seed=0, device=device)
    stream = TokenStream(vocab=cfg.vocab_size, batch=args.batch_size,
                         seq=args.seq_len, seed=0, cfg=cfg, device=device)
    metrics = []
    t0 = time.time()
    try:
        for i, batch in enumerate(stream):
            if i >= args.steps:
                break
            params, opt, m = step(params, opt, batch)
            metrics.append(m)
            if (i + 1) % max(args.steps // 10, 1) == 0:
                print(f"[step {i+1}] loss={float(m['loss']):.4f} "
                      f"ce={float(m['ce']):.4f} "
                      f"gnorm={float(m['grad_norm']):.2f}", flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
    finally:
        stream.stop()
    toks = args.steps * args.batch_size * args.seq_len
    print(f"[done] {args.steps} steps, {toks/dt:.0f} tok/s", flush=True)
    out = {k: [float(m[k]) for m in metrics]
           for k in ("loss", "ce", "grad_norm")}
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    return dict(out, tok_s=toks / dt, ms_per_step=dt * 1e3 / args.steps,
                peak_gib=peak, params=params)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    help="model: graphsage|gat|rgcn or an LM arch id")
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
                    help="GNN training epochs")
    ap.add_argument("--steps", type=int, default=20,
                    help="LM training steps")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="GNN: seeds (link prediction: positive edges) per "
                         "batch per trainer (capped at the config's batch); "
                         "LM: sequences per step")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="LM sequence length")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="LM learning rate")
    ap.add_argument("--task", default="node_classification",
                    choices=["node_classification", "link_prediction"],
                    help="GNN workload: node classification or edge "
                         "mini-batch link prediction (§6)")
    ap.add_argument("--num-negs", type=int, default=16,
                    help="link prediction: uniform negatives per positive "
                         "edge (static (B, K) shape; too few can collapse "
                         "the BCE score head)")
    ap.add_argument("--score-fn", default="dot", choices=["dot", "distmult"],
                    help="link-prediction scoring head (distmult learns "
                         "one diagonal relation embedding per etype)")
    ap.add_argument("--neg-mode", default="uniform",
                    choices=["uniform", "in-batch"],
                    help="negative sampling: fresh uniform nodes (own "
                         "ego-networks) or in-batch corrupted dsts")
    ap.add_argument("--neg-exclude", action="store_true",
                    help="re-draw negatives that collide with a positive "
                         "pair of the same batch (false-negative filter)")
    ap.add_argument("--hetero", action="store_true",
                    help="typed relations end-to-end (RGCN on a schema'd "
                         "dataset, e.g. mag-hetero)")
    ap.add_argument("--rel-fanout", action="append", metavar="REL=K",
                    help="per-relation fanout override for --hetero "
                         "(repeatable; 0 disables sampling the relation)")
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
                    help="directory for consistent checkpoints (params, "
                         "optimizer, KVStore shards with row versions, "
                         "cache snapshots)")
    ap.add_argument("--checkpoint-interval", type=int, default=0,
                    help="global steps between checkpoints (0 = off)")
    ap.add_argument("--recover", action="store_true",
                    help="restore --checkpoint-dir before training and "
                         "fast-forward to its coordinate")
    ap.add_argument("--inject-fault", metavar="EPOCH:BATCH", default=None,
                    help="kill the trainer at this coordinate; it is "
                         "revived in process from the last checkpoint")
    ap.add_argument("--rpc-fault-rate", type=float, default=0.0,
                    help="probability that a feature pull or gradient "
                         "push RPC fails transiently (retried)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault schedule")
    ap.add_argument("--replication", type=int, default=1,
                    help="KVStore feature-plane replica count")
    ap.add_argument("--max-rpc-retries", type=int, default=8,
                    help="per-destination transient-RPC retry budget "
                         "before a peer is treated as dead")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedged reads: race a replica after this many ms "
                         "without a primary response (needs "
                         "--replication >= 2; default off)")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: reduced same-family config for CPU smoke runs")
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
    from ..configs import GNN_ARCHS

    args = build_parser().parse_args(argv)
    if args.arch in GNN_ARCHS:
        summary = run_gnn(args)
        summary.pop("trainer")
    else:
        summary = run_lm(args)
        summary.pop("params")
    return summary


if __name__ == "__main__":
    main()
