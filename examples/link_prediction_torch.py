"""Link prediction on PyTorch with DistDGLv2-style edge mini-batches (the
paper's second task, §6: "for link prediction, we may use all edges to
train a model"), in the SAME DGL loop shape node classification uses::

    for input_nodes, pair_graph, blocks in loader:
        ...

``EdgeDataLoader`` schedules positive-edge batches over this trainer's
owned edges (``DistGraph.edge_split``), draws uniform negatives with
static (B, K) shapes, samples endpoint ego-networks through the
distributed sampler and prefetches features through the async pipeline
onto the device; the yielded ``pair_graph`` carries the scoring-head
index arrays. The multi-trainer synchronous driver is
``repro_torch.api.DistGNNTrainer`` with ``task="link_prediction"``. The
loop is ``examples/link_prediction.py``'s, on the card unless ``--device
cpu`` is given.

Run:  PYTHONPATH=src python examples/link_prediction_torch.py [--smoke]
          [--device cuda|cpu]
"""
import argparse
import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.api import DistGraph, EdgeDataLoader
from repro_torch.api.inference import resolve_device
from repro_torch.core.sampler import EdgeBatchSampler
from repro_torch.graph import get_dataset
from repro_torch.kernels import device_stage
from repro_torch.models.gnn import (GNNConfig, apply_gnn, init_gnn,
                                    init_lp_head, lp_loss_from_scores,
                                    lp_metrics, lp_pair_scores, lp_ranks)
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.optimizers import tree_leaves, tree_map


def train(scale=10, epochs=3, batch_edges=16, num_negs=16, seed=0,
          device="cuda"):
    device = resolve_device(device)
    ds = get_dataset("product-sim", scale=scale)
    # 2-layer GraphSAGE encoder at the derived endpoint capacity
    # (2B + B*K seeds per node batch); the model's output is an
    # embedding, so num_classes doubles as the embedding dim
    node_bs = EdgeBatchSampler.required_node_batch(batch_edges, num_negs)
    cfg = GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                    hidden_dim=64, num_classes=64,
                    fanouts=[10, 5], batch_size=node_bs)

    g = DistGraph(ds, num_machines=2, trainers_per_machine=1, seed=seed)
    loader = EdgeDataLoader(g, g.edge_split(), cfg.fanouts,
                            batch_size=batch_edges, num_negs=num_negs,
                            seed=seed, device_prefetch=True, device=device)
    print(f"rank {g.rank}: {len(g.edge_split())} owned edges, "
          f"{len(loader)} edge-batches/epoch, node batch {node_bs}, "
          f"device {device}")

    params = {"gnn": init_gnn(cfg, torch.Generator().manual_seed(seed),
                              device=device),
              "lp": init_lp_head("dot", 1, cfg.num_classes, device=device)}
    opt = adamw_init(params)

    def scores(p, batch, cfg):
        h = apply_gnn(cfg, p["gnn"], batch)
        kw = dict(head=p["lp"], score_fn="dot", etypes=batch["edge_etypes"])
        pos = lp_pair_scores(h, batch["pos_u"], batch["pos_v"], **kw)
        neg = lp_pair_scores(h, batch["pos_u"], batch["neg_v"], **kw)
        return pos, neg

    def step(params, opt, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        pos, neg = scores(tree_map(lambda _p: next(it), params), batch, cfg)
        loss = lp_loss_from_scores(pos, neg, batch["pair_mask"])
        mrr = lp_metrics(lp_ranks(pos, neg), batch["pair_mask"])["mrr"]
        grads = iter(torch.autograd.grad(loss, leaves))
        params, opt = adamw_update(params,
                                   tree_map(lambda _p: next(grads), params),
                                   opt, lr=3e-3)
        return params, opt, loss.detach(), mrr

    hist = []
    with loader:
        for epoch in range(epochs):
            losses, mrrs = [], []
            for batch in loader:
                input_nodes, pair_graph, blocks = batch     # DGL's triple
                params, opt, loss, mrr = step(params, opt,
                                              batch.model_input())
                losses.append(float(loss))
                mrrs.append(float(mrr))
            hist.append(float(np.mean(losses)))
            print(f"epoch {epoch}: loss={hist[-1]:.4f} "
                  f"train_mrr={np.mean(mrrs):.3f}")

    # deterministic evaluation: fresh uniform candidates over every edge,
    # ranks in [1, 50] so hits@10 is a real metric (the protocol of
    # DistGNNTrainer.evaluate_lp)
    B, K = batch_edges, 49
    eval_cfg = GNNConfig(arch="graphsage", in_dim=cfg.in_dim,
                         hidden_dim=cfg.hidden_dim,
                         num_classes=cfg.num_classes, fanouts=cfg.fanouts,
                         batch_size=EdgeBatchSampler.required_node_batch(B, K))
    ev = EdgeDataLoader(g, np.arange(g.num_edges(), dtype=np.int64),
                        eval_cfg.fanouts, batch_size=B, num_negs=K,
                        mode="eval", sampler_seed=seed + 998,
                        edge_seed=seed + 977)
    ranks = []
    with torch.no_grad():
        for batch in itertools.islice(ev, 10):
            staged = device_stage(batch.model_input(), device).unpack()
            pos, neg = scores(params, staged, eval_cfg)
            ranks.append(lp_ranks(pos, neg).cpu().numpy()[batch.pair_mask])
    r = np.concatenate(ranks).astype(np.float64)
    print(f"eval: mrr={(1.0 / r).mean():.3f} "
          f"hits@1={(r <= 1).mean():.3f} hits@10={(r <= 10).mean():.3f} "
          f"({len(r)} edges)")
    assert np.all(np.isfinite(hist)), "training diverged"
    assert hist[-1] < hist[0], "link prediction failed to learn"
    print(f"link prediction learned: {hist[0]:.3f} -> {hist[-1]:.3f}")
    return {"losses": hist, "mrr": float((1.0 / r).mean())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configuration for CI smoke runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda raises without a card")
    args = ap.parse_args(argv)
    if args.smoke:
        return train(scale=9, epochs=2, batch_edges=8, num_negs=8,
                     device=args.device)
    return train(device=args.device)


if __name__ == "__main__":
    main()
