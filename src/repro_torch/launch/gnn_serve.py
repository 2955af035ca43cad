"""GNN serving launcher (the port of ``repro/launch/gnn_serve.py``).

Stands up a :class:`repro_torch.api.InferenceServer` over a partitioned
graph, on the card unless ``--device cpu`` is given, and drives it with an
open-loop request load (Poisson arrivals at ``--rate`` requests/s for
``--duration`` seconds), then prints latency percentiles, throughput,
micro-batch occupancy and cache hit rates as JSON.

    PYTHONPATH=src python -m repro_torch.launch.gnn_serve --arch graphsage \
        --dataset product-sim --scale 14 --rate 200 --duration 2

The full-graph layer-wise pass (``--offline`` and its ``--chunk-size``)
is not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import argparse
import json
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.gnn_serve")
    ap.add_argument("--arch", default="graphsage",
                    choices=["graphsage", "gat", "rgcn"],
                    help="GNN architecture to serve (graphsage is ported)")
    ap.add_argument("--dataset", default="product-sim",
                    help="named synthetic dataset (repro_torch.graph.datasets)")
    ap.add_argument("--scale", type=int, default=10,
                    help="dataset scale exponent (graph has ~2^scale nodes)")
    ap.add_argument("--machines", type=int, default=2,
                    help="simulated machines (level-1 partitions)")
    ap.add_argument("--hetero", action="store_true",
                    help="typed relations end-to-end (not ported yet)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="seeds per §2 capacity block (requests larger "
                         "than this are chunked)")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="open-loop request rate (requests/s, Poisson "
                         "arrivals)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="load-generation window in seconds")
    ap.add_argument("--request-size", type=int, default=1,
                    help="seed nodes per predict request")
    ap.add_argument("--micro-batch-window", type=float, default=2.0,
                    help="scheduler coalescing window in milliseconds")
    ap.add_argument("--micro-batch-capacity", type=int, default=8,
                    help="max chunks stacked into one forward tick")
    ap.add_argument("--cache-budget-mb", type=float, default=4.0,
                    help="serving feature-cache budget (0 disables)")
    ap.add_argument("--replication", type=int, default=1,
                    help="KVStore feature-plane replica count")
    ap.add_argument("--max-rpc-retries", type=int, default=8,
                    help="per-destination transient-RPC retry budget "
                         "before a peer is treated as dead")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedged reads: race a replica after this many ms "
                         "without a primary response (needs "
                         "--replication >= 2; default off)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline budget: chunks still "
                         "queued past it are shed (DeadlineExceeded) "
                         "instead of served late (default off)")
    ap.add_argument("--max-pending-chunks", type=int, default=None,
                    help="admission control: reject requests "
                         "(ServerOverloaded) once this many chunks are "
                         "queued (default off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="parameters + request-trace seed")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed load (CI smoke)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the forward runs; cuda raises when no card "
                         "is present")
    return ap


def build_world(args):
    """(DistGraph, GNNConfig, params on ``args.device``) for ``args``."""
    import dataclasses

    import torch

    from ..api import DistGraph
    from ..api.inference import resolve_device
    from ..configs import get_config
    from ..graph import get_dataset
    from ..models.gnn import init_gnn

    device = resolve_device(args.device)
    if args.hetero:
        raise NotImplementedError("--hetero is not ported to repro_torch "
                                  "yet: ROADMAP queue A item 4 (RGCN and "
                                  "the typed path)")
    cfg = get_config(args.arch)
    ds = get_dataset(args.dataset, scale=args.scale)
    cfg = dataclasses.replace(cfg, in_dim=ds.feats.shape[1],
                              num_classes=ds.num_classes,
                              batch_size=min(cfg.batch_size,
                                             args.batch_size))
    g = DistGraph(ds, num_machines=args.machines, trainers_per_machine=1,
                  seed=args.seed, replication=args.replication,
                  max_rpc_retries=args.max_rpc_retries,
                  hedge_ms=args.hedge_ms)
    params = init_gnn(cfg, torch.Generator().manual_seed(args.seed),
                      device=device)
    return g, cfg, params


def make_server(args, world):
    """The :class:`InferenceServer` that ``args`` configure over
    ``world``."""
    from ..api import InferenceServer
    from ..core.kvstore import CacheConfig

    g, cfg, params = world
    cache = (CacheConfig.from_mb(args.cache_budget_mb)
             if args.cache_budget_mb > 0 else None)
    return InferenceServer(
        g, cfg, params, cache=cache,
        micro_batch_capacity=args.micro_batch_capacity,
        micro_batch_window_ms=args.micro_batch_window,
        sampler_seed=args.seed, deadline_ms=args.deadline_ms,
        max_pending_chunks=args.max_pending_chunks, device=args.device)


def run_serving(args, world=None) -> dict:
    """Serve ``args``' load over ``world`` (built from ``args`` when not
    given) and print the JSON summary."""
    import numpy as np
    import torch

    from ..api import DeadlineExceeded, ServerOverloaded

    world = build_world(args) if world is None else world
    g = world[0]
    rng = np.random.default_rng(args.seed)
    n_req = (8 if args.smoke
             else max(1, int(args.rate * args.duration)))
    gaps = (np.zeros(n_req) if args.smoke
            else rng.exponential(1.0 / args.rate, size=n_req))
    nid_trace = rng.integers(0, g.num_nodes(),
                             size=(n_req, args.request_size))

    with make_server(args, world) as srv:
        # one warmup request builds the kernels and warms the allocator
        # outside the measured window
        srv.predict(nid_trace[0])
        if srv.cache is not None:
            srv.cache.reset_stats()
        handles = []
        rejected = 0
        t0 = time.perf_counter()
        for i in range(n_req):
            time.sleep(float(gaps[i]))
            try:
                handles.append(srv.submit(nid_trace[i]))
            except ServerOverloaded:
                rejected += 1     # admission control shed the request
        served, degraded, shed = 0, 0, 0
        for h in handles:
            try:
                h.result(timeout=120)
                served += 1
                degraded += int(h.degraded)
            except DeadlineExceeded:
                shed += 1
        wall = time.perf_counter() - t0
        done = [h for h in handles if h.latency_s is not None]
        lat = (np.sort(np.asarray([h.latency_s for h in done]))
               if done else np.array([float("nan")]))
        stats = srv.stats()

    device = srv.device
    out = {"mode": "serving", "requests": n_req,
           "rate_req_s": args.rate, "wall_s": round(wall, 4),
           "throughput_req_s": round(n_req / wall, 1),
           "p50_ms": round(float(lat[len(lat) // 2]) * 1e3, 3),
           "p99_ms": round(float(lat[min(len(lat) - 1,
                                         int(len(lat) * 0.99))]) * 1e3, 3),
           "served": served, "degraded": degraded,
           "shed": shed, "rejected": rejected,
           "mean_tick_occupancy": round(stats["mean_tick_occupancy"], 2),
           "cache": stats["cache"],
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    print(json.dumps(out, indent=2))
    return out


def main(argv=None):
    return run_serving(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
