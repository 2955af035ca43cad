"""Quickstart on PyTorch: the canonical DGL training loop against the
port (``repro_torch``), on the card unless ``--device cpu`` is given::

    for input_nodes, seeds, blocks in loader:
        ...

``DistGraph`` partitions a synthetic power-law graph for a simulated
2-machine cluster and stands up the distributed KVStore; ``node_split``
hands this trainer its owner-aligned seed set; ``NodeDataLoader`` drives
the 5-stage asynchronous mini-batch pipeline underneath the loop and
stages each batch on the device (one packed copy). The multi-trainer
synchronous-SGD driver (``repro_torch.api.DistGNNTrainer``) is built from
exactly these pieces. The loop is ``examples/quickstart.py``'s.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--smoke]
          [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.api import DistGraph, NodeDataLoader
from repro_torch.api.inference import resolve_device
from repro_torch.graph import get_dataset
from repro_torch.kernels import device_stage
from repro_torch.models.gnn import (GNNConfig, apply_gnn, init_gnn,
                                    nc_accuracy, nc_loss)
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.optimizers import tree_leaves, tree_map


def train(scale=12, epochs=5, batch_size=32, hidden=128, lr=3e-3, seed=0,
          device="cuda"):
    device = resolve_device(device)
    ds = get_dataset("product-sim", scale=scale)
    cfg = GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                    hidden_dim=hidden, num_classes=ds.num_classes,
                    fanouts=[10, 5], batch_size=batch_size)

    # the distributed graph: hierarchical partition + KVStore shards
    g = DistGraph(ds, num_machines=2, trainers_per_machine=1,
                  partition_method="metis", seed=seed)
    train_nids = g.node_split()          # this trainer's owner-aligned seeds
    loader = NodeDataLoader(g, train_nids, cfg.fanouts,
                            batch_size=batch_size,
                            labels=g.labels[train_nids], seed=seed,
                            device_prefetch=True, device=device)
    print(f"{g.num_trainers} trainers | rank {g.rank} holds "
          f"{len(train_nids)} seeds, {len(loader)} batches/epoch | "
          f"features: {g.ndata['feat'].shape} via lazy DistTensor pulls | "
          f"device {device}")

    params = init_gnn(cfg, torch.Generator().manual_seed(seed),
                      device=device)
    opt = adamw_init(params)

    def step(params, opt, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        logits = apply_gnn(cfg, tree_map(lambda _p: next(it), params), batch)
        loss = nc_loss(logits, batch["labels"], batch["seed_mask"])
        acc = nc_accuracy(logits, batch["labels"], batch["seed_mask"])
        grads = iter(torch.autograd.grad(loss, leaves))
        params, opt = adamw_update(params,
                                   tree_map(lambda _p: next(grads), params),
                                   opt, lr=lr)
        return params, opt, loss.detach(), acc

    hist = []
    with loader:                          # context manager: clean teardown
        for epoch in range(epochs):
            losses, accs = [], []
            # THE loop -- each iteration of `loader` is one epoch of
            # device-ready mini-batches from the async pipeline
            for batch in loader:
                input_nodes, seeds, blocks = batch      # DGL's triple
                params, opt, loss, acc = step(params, opt,
                                              batch.model_input())
                losses.append(float(loss))
                accs.append(float(acc))
            hist.append(float(np.mean(losses)))
            print(f"epoch {epoch}: loss={hist[-1]:.4f} "
                  f"acc={np.mean(accs):.2f}")

    # evaluation: a deterministic sequential loader over the val split
    val_nids = g.val_nids
    ev = NodeDataLoader(g, val_nids, cfg.fanouts, batch_size=batch_size,
                        labels=g.labels[val_nids], mode="eval",
                        sampler_seed=seed + 999)
    accs = []
    with torch.no_grad():
        for b in ev:
            staged = device_stage(b.model_input(), device).unpack()
            accs.append(float(nc_accuracy(apply_gnn(cfg, params, staged),
                                          staged["labels"],
                                          staged["seed_mask"])))
    print(f"val acc: {np.mean(accs):.3f}")
    print("loader stats:", {k: v for k, v in loader.stats_report().items()
                            if k != "stages"})
    assert np.all(np.isfinite(hist)), "training diverged"
    return {"losses": hist, "val_acc": float(np.mean(accs))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configuration for CI smoke runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises without a card")
    args = ap.parse_args(argv)
    if args.smoke:
        return train(scale=11, epochs=3, batch_size=16, hidden=32,
                     device=args.device)
    return train(device=args.device)


if __name__ == "__main__":
    main()
