#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # one card; about two minutes

Phases, each of which exits non-zero when it fails:

1. device   -- requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build    -- builds every CUDA kernel of the serving path with ``nvcc``
               for sm_90a from ``src/repro_torch/csrc`` (one process per
               source, all at once).
3. kernels  -- builds the product-sim ``DistGraph`` (scale 14), samples one
               real batch at the paper's GraphSAGE config (batch 1000,
               fanouts 15/10/5) and holds each kernel against its plain
               PyTorch version on the card at the shapes that batch gives:
               K1 ``fused_gather_aggregate`` on each of the 3 layers, K2
               ``segment_sum`` as ``_degrees`` (F = 1) on each layer and
               in its general form (F = 256, float32 and bfloat16). Two
               runs of a kernel must be bitwise equal. Each case prints
               the kernel's time, the plain version's, one PyTorch library
               call's (a yardstick the port never calls), the bound from
               the bytes it must move, and the max error.
4. serving  -- the main path: ``repro_torch.launch.gnn_serve`` at its
               defaults (batch 8, micro-batch capacity 8) with GraphSAGE
               at full width (in 100, hidden 256, 16 classes, 3 layers),
               with every kernel's launch count set to 0 just before and
               read just after; then served logits against the same
               server with ``impl="ref"``, and one request served alone
               against the same request co-batched (identical bytes);
               then where one full tick's time goes, from the spans of a
               server built as ``gnn_serve`` builds it (sampling, pulls,
               stacking, staging, forward and copy back), and both
               kernels again on that server's last tick, as in phase 3.
5. paper    -- one 1000-node request with ``batch_size=1000`` and capacity
               1; the kernel path against ``impl="ref"``.
6. report   -- a JSON line of every ported kernel (its times summed over
               the 3 layers of one serving tick, and of one batch-1000
               forward under ``paper_batch``; its launches on the main
               path), the ``nvidia-smi`` line, and last
               ``{"ok": true, "device": {...}}``.

Tolerances: a kernel against its plain version in float32 rtol = atol =
1e-5 (degrees are integers and compare exactly), in bfloat16 rtol = 0.1,
atol = 0.5; served logits against ``impl="ref"`` rtol = 1e-4, atol = 1e-5
(the plain version's ``index_add_`` adds with atomics, in another order).
Times are CUDA-event medians over launches, with L2 flushed before each.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE = 14                 # product-sim's default scale
PAPER_BATCH = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
REPS = 30

KERNELS = {
    "fused_gather_aggregate": {
        "source": "src/repro_torch/csrc/fused_gather_aggregate.cu",
        "replaces": "src/repro/kernels/fused_gather_aggregate/kernel.py:58",
    },
    "segment_sum": {
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum/kernel.py:55",
    },
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    a 256 MB write that evicts the 50 MB L2 (the serving forward finds its
    inputs freshly copied, not cached). The median, because launches of a
    few microseconds vary from one launch to the next."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(torch, got, want, rtol, atol, what) -> None:
    ok = bool(torch.isclose(got.float(), want.float(), rtol=rtol,
                            atol=atol).all())
    require(ok, f"{what}: kernel disagrees with its plain version "
                f"(max abs err {max_err(torch, got, want):.3e}, "
                f"rtol={rtol}, atol={atol})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch) -> str:
    require(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s)")
    return line


def phase_build() -> None:
    from repro_torch.kernels import _cuda

    t0 = time.perf_counter()
    built = _cuda.build(_cuda.KERNELS)
    log(f"[build] {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s with {_cuda.nvcc_path()}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    for name in _cuda.KERNELS:
        _cuda.load(name)


def sample_paper_batch(g, cfg):
    """One real batch at the paper's config, featurized on the host."""
    import numpy as np

    from repro_torch.api.inference import _model_blocks
    from repro_torch.core.sampler import (DistributedSampler,
                                          sample_ego_networks)

    sampler = DistributedSampler(g.book, g.partitions, cfg.fanouts,
                                 cfg.batch_size, machine=g.machine,
                                 transport=None, seed=0)
    seeds = np.random.default_rng(0).choice(g.num_nodes(), cfg.batch_size,
                                            replace=False)
    mb = next(sample_ego_networks(sampler, g.new_client(), g.feat_name,
                                  seeds, drop_last=False))
    return {"input_feats": mb.input_feats, "blocks": _model_blocks(mb)}


def k1_case(torch, label, h, block, num_dst, groups, results):
    from repro_torch.kernels import (fused_gather_aggregate_cuda,
                                     fused_gather_aggregate_ref)

    es, ed, em = block["edge_src"], block["edge_dst"], block["edge_mask"]
    out1 = fused_gather_aggregate_cuda(h, es, groups)
    out2 = fused_gather_aggregate_cuda(h, es, groups)
    plain = fused_gather_aggregate_ref(h, es, ed, em, num_dst)
    torch.cuda.synchronize()
    what = f"fused_gather_aggregate {label}"
    require(torch.equal(out1, out2), f"{what}: two runs differ")
    check_close(torch, out1, plain, 1e-5, 1e-5, what)

    live = em.nonzero().squeeze(1)
    v, f = h.shape
    e = es.numel()
    # library yardstick: one cuSPARSE CSR x dense product computing the
    # same function (duplicate edges summed into counts)
    a = torch.sparse_coo_tensor(
        torch.stack([ed[live].long(), es[live].long()]),
        torch.ones(live.numel(), device="cuda"), (num_dst, v)
    ).coalesce().to_sparse_csr()
    # the least the function moves: the mask of every slot, the source and
    # destination index of every live edge, each referenced source row
    # once, and the output
    n_ref_rows = int(torch.unique(es[live]).numel())
    nbytes = (e + live.numel() * (4 + 4) + n_ref_rows * f * 4
              + num_dst * f * 4)
    bound_ms, bound_by = bound(nbytes, live.numel() * f)
    case = {
        "case": f"K1 {label}", "V": v, "F": f, "E": e,
        "E_live": int(live.numel()), "num_dst": num_dst,
        "kernel_ms": cuda_ms(torch, lambda: fused_gather_aggregate_cuda(
            h, es, groups)),
        "plain_ms": cuda_ms(torch, lambda: fused_gather_aggregate_ref(
            h, es, ed, em, num_dst)),
        "library_ms": cuda_ms(torch, lambda: torch.sparse.mm(a, h)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": max_err(torch, out1, plain),
    }
    results.append(case)
    log(f"[kernels] {json.dumps(case)}")


def k2_case(torch, label, msg, block, num_dst, groups, results, rtol, atol):
    from repro_torch.kernels import segment_sum_cuda, segment_sum_ref

    ed, em = block["edge_dst"], block["edge_mask"]
    out1 = segment_sum_cuda(msg, groups)
    out2 = segment_sum_cuda(msg, groups)
    plain = segment_sum_ref(msg, ed, em, num_dst)
    torch.cuda.synchronize()
    what = f"segment_sum {label}"
    require(torch.equal(out1, out2), f"{what}: two runs differ")
    check_close(torch, out1, plain, rtol, atol, what)

    e, f = msg.shape
    isz = msg.element_size()
    n_live = int(em.sum())
    # library yardstick: one index_add_ over the masked keys, padded
    # edges sent to a spare row
    keys = ed.long().masked_fill(~em, num_dst)
    lib_out = torch.zeros((num_dst + 1, f), dtype=msg.dtype, device="cuda")
    # the least the function moves: the mask of every slot, the
    # destination index and message row of every live edge, and the output
    nbytes = e + n_live * (4 + f * isz) + num_dst * f * isz
    bound_ms, bound_by = bound(nbytes, n_live * f)
    case = {
        "case": f"K2 {label}", "F": f, "dtype": str(msg.dtype), "E": e,
        "E_live": n_live, "num_dst": num_dst,
        "kernel_ms": cuda_ms(torch, lambda: segment_sum_cuda(msg, groups)),
        "plain_ms": cuda_ms(torch, lambda: segment_sum_ref(msg, ed, em,
                                                           num_dst)),
        "library_ms": cuda_ms(torch, lambda: lib_out.index_add_(0, keys,
                                                                msg)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": max_err(torch, out1, plain),
    }
    results.append(case)
    log(f"[kernels] {json.dumps(case)}")
    return out1


def layer_cases(torch, tag, batch, caps, params, general=False) -> dict:
    """K1, and K2 as ``_degrees``, on every layer of one staged batch
    (with or without the serving stack axis, flattened as ``sage_layer``
    flattens it), each layer's input from the plain forward; with
    ``general``, K2 in its general form on layer 0's edges too."""
    from repro_torch.kernels import dst_groups
    from repro_torch.models.gnn import sage_layer
    from repro_torch.models.gnn.layers import _flat_edges

    results = {"fused_gather_aggregate": [], "segment_sum": []}
    h = batch["input_feats"]
    for layer, block in enumerate(batch["blocks"]):
        hs = h if h.dim() == 3 else h[None]
        s, v, f = hs.shape
        n = s * caps[layer]
        es, ed, em = _flat_edges(block, s, v, caps[layer])
        flat = {"edge_src": es, "edge_dst": ed, "edge_mask": em}
        groups = dst_groups(ed, em, n)
        label = f"{tag} layer {layer}"
        order_ms = cuda_ms(torch, lambda: dst_groups(ed, em, n))
        log(f"[kernels] {label}: destination-grouped order (torch.sort + "
            f"searchsorted over E={ed.numel()}) {order_ms:.4f} ms")
        k1_case(torch, label, hs.reshape(s * v, f), flat, n, groups,
                results["fused_gather_aggregate"])
        deg = k2_case(torch, f"degrees {label}", em.to(torch.float32)[:, None],
                      flat, n, groups, results["segment_sum"], 0.0, 0.0)
        require(bool((deg == deg.round()).all()),
                f"degrees {label} are not integers")
        if general and layer == 0:
            gen = torch.Generator(device="cuda").manual_seed(0)
            msg = torch.randn((ed.numel(), 256), generator=gen,
                              device="cuda")
            k2_case(torch, f"general F=256 float32 {label}", msg, flat, n,
                    groups, [], 1e-5, 1e-5)
            k2_case(torch, f"general F=256 bfloat16 {label}",
                    msg.to(torch.bfloat16), flat, n, groups, [], 0.1, 0.5)
            del msg
        with torch.inference_mode():
            h = sage_layer(params["layers"][layer], h, block, caps[layer],
                           activation=torch.relu, impl="ref")
    return results


def phase_kernels(torch, g, cfg, params) -> dict:
    """Both kernels at the paper's batch on the card."""
    from repro_torch.kernels.pack import device_stage

    t0 = time.perf_counter()
    batch = device_stage(sample_paper_batch(g, cfg), "cuda").unpack()
    torch.cuda.synchronize()
    log(f"[kernels] sampled, pulled and staged one batch of "
        f"{cfg.batch_size} in {time.perf_counter() - t0:.2f} s")
    return layer_cases(torch, "paper", batch, cfg.dst_caps(), params,
                       general=True)


def phase_serving(torch, world, args) -> dict:
    """The main path through gnn_serve, counted; then ref parity and
    co-batched bytes."""
    import numpy as np

    from repro_torch.api import InferenceServer
    from repro_torch.kernels import (fused_gather_aggregate_cuda,
                                     segment_sum_cuda)
    from repro_torch.launch import gnn_serve

    g, cfg, params = world
    wrappers = {"fused_gather_aggregate": fused_gather_aggregate_cuda,
                "segment_sum": segment_sum_cuda}
    for w in wrappers.values():
        w.launches = 0
    summary = gnn_serve.run_serving(args, world=world)
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"[serving] launches on the main path: {json.dumps(launches)}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the serving path was never launched: {launches}")
    require(summary["served"] == summary["requests"],
            f"served {summary['served']} of {summary['requests']} requests")
    log(f"[serving] p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms, "
        f"throughput {summary['throughput_req_s']} req/s")

    rng = np.random.default_rng(1)
    nids = rng.integers(0, g.num_nodes(), size=20)
    ref_cfg = dataclasses.replace(cfg, impl="ref")
    with InferenceServer(g, cfg, params, micro_batch_window_ms=50.0,
                         device="cuda") as srv:
        served = srv.predict(nids)
        alone = [srv.predict([n]) for n in nids[:6]]
        handles = [srv.submit([n]) for n in nids[:6]]
        co = [h.result(timeout=120) for h in handles]
        most = max(srv.tick_chunks)
    with InferenceServer(g, ref_cfg, params, device="cuda") as srv:
        ref = srv.predict(nids)
    require(served.shape == (len(nids), cfg.num_classes)
            and bool(np.isfinite(served).all()),
            f"served logits have shape {served.shape} or are not finite")
    err = float(np.abs(served - ref).max())
    require(bool(np.allclose(served, ref, rtol=1e-4, atol=1e-5)),
            f"served logits disagree with impl='ref' (max abs err {err:.3e})")
    require(most > 1, "the co-batching check never co-batched")
    same = all(np.array_equal(a, c) for a, c in zip(alone, co))
    require(same, "a request co-batched returned other bytes than alone")
    log(f"[serving] logits vs impl='ref' max abs err {err:.3e}; "
        f"co-batched == alone bytes over 6 requests (up to {most} chunks "
        f"in a tick)")
    return launches


def phase_breakdown(torch, world, args, reps: int = 5) -> dict:
    """Where one full serving tick's time goes in the server ``gnn_serve``
    builds from ``args`` (its cache, capacity and window), read from the
    server's own spans: each request fills one tick, so a tick's share of
    each span is its sum over ``reps`` requests over ``reps``. Returns the
    last tick's stacked tree, taken from the server and staged as it
    stages it."""
    import numpy as np

    from repro_torch.kernels.pack import device_stage
    from repro_torch.launch import gnn_serve

    g, cfg, _ = world
    capacity = args.micro_batch_capacity
    rng = np.random.default_rng(3)
    last = {}
    with gnn_serve.make_server(args, world) as srv:
        forward = srv._forward

        def forward_keeping_tree(tree):
            last["tree"] = tree
            return forward(tree)

        srv._forward = forward_keeping_tree
        for rep in range(reps + 1):
            if rep == 1:                   # the first request warms up
                before = srv.stats()
            srv.predict(rng.choice(g.num_nodes(), capacity * cfg.batch_size,
                                   replace=False), timeout=600)
        after = srv.stats()
    require(after["ticks"] - before["ticks"] == reps
            and all(n == capacity for n in srv.tick_chunks[-reps:]),
            f"the breakdown's requests did not fill one tick each: "
            f"{srv.tick_chunks}")
    spans = {k: (after["spans_ms"][k] - before["spans_ms"][k]) / reps
             for k in after["spans_ms"]}
    total = sum(v for k, v in spans.items() if k != "device_forward")
    staged = device_stage(last["tree"], "cuda")
    log(f"[breakdown] one tick of {capacity} chunks x {cfg.batch_size} "
        f"seeds ({staged.total_bytes()} staged bytes, cache "
        f"{args.cache_budget_mb} MB), server spans, mean of {reps}: "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                    for k, v in spans.items() if k != "device_forward")
        + f"; of forward, on the card {spans['device_forward']:.3f} ms")
    return staged.unpack()


def phase_paper(torch, g, cfg, params) -> None:
    import numpy as np

    from repro_torch.api import InferenceServer

    nids = np.random.default_rng(2).choice(g.num_nodes(), PAPER_BATCH,
                                           replace=False)
    out = {}
    for impl in ("auto", "ref"):
        c = dataclasses.replace(cfg, batch_size=PAPER_BATCH, impl=impl)
        with InferenceServer(g, c, params, micro_batch_capacity=1,
                             device="cuda") as srv:
            srv.predict(nids[:2])           # warm the allocator
            t0 = time.perf_counter()
            out[impl] = srv.predict(nids, timeout=600)
            dt = time.perf_counter() - t0
        log(f"[paper] impl={impl}: one {len(nids)}-node request in "
            f"{dt * 1e3:.1f} ms (host sampling and pulls included)")
    require(out["auto"].shape == (len(nids), cfg.num_classes)
            and bool(np.isfinite(out["auto"]).all()),
            "paper-batch logits have the wrong shape or are not finite")
    err = float(np.abs(out["auto"] - out["ref"]).max())
    require(bool(np.allclose(out["auto"], out["ref"], rtol=1e-4, atol=1e-5)),
            f"paper-batch logits disagree with impl='ref' (max abs err "
            f"{err:.3e})")
    log(f"[paper] logits vs impl='ref' max abs err {err:.3e}")


def _sums(cases: list) -> dict:
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["kernel_ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": ("bytes" if all(c["bound_by"] == "bytes"
                                        for c in cases) else "operations"),
            "library_ms": sum(c["library_ms"] for c in cases)}


def report(tick: dict, paper: dict, launches: dict) -> dict:
    """Per kernel: its times summed over the 3 layers of one full serving
    tick at the gnn_serve defaults (the main path's shapes), and the same
    sums for one batch-1000 forward under ``paper_batch``."""
    out = []
    for name, meta in KERNELS.items():
        out.append({"name": name, "route": "cuda", "status": "ok",
                    "source": meta["source"], "replaces": meta["replaces"],
                    "launches": launches[name], **_sums(tick[name]),
                    "shapes": "sum over the 3 layers of one serving tick "
                              "(8 chunks x 8 seeds)" + (
                                  ", as _degrees (F=1)"
                                  if name == "segment_sum" else ""),
                    "paper_batch": _sums(paper[name])})
    return {"kernels": out}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    smi = phase_device(torch)
    require((ROOT / "src" / "repro_torch").is_dir(),
            "src/repro_torch is missing: run from a checkout of the repo")
    from repro_torch.launch import gnn_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    args = gnn_serve.build_parser().parse_args(
        ["--scale", str(SCALE), "--device", "cuda"])
    t0 = time.perf_counter()
    world = gnn_serve.build_world(args)
    g, cfg, params = world
    log(f"[world] product-sim scale {SCALE}: {g.num_nodes()} nodes, "
        f"{g.num_edges()} edges, partitioned in {g.partition_time_s:.2f} s "
        f"(world built in {time.perf_counter() - t0:.2f} s); GraphSAGE "
        f"in {cfg.in_dim}, hidden {cfg.hidden_dim}, {cfg.num_classes} "
        f"classes, fanouts {list(cfg.fanouts)}")

    paper_cfg = dataclasses.replace(cfg, batch_size=PAPER_BATCH)
    paper = phase_kernels(torch, g, paper_cfg, params)
    launches = phase_serving(torch, world, args)
    tick = layer_cases(torch, "tick", phase_breakdown(torch, world, args),
                       cfg.dst_caps(), params)
    phase_paper(torch, g, cfg, params)

    print(json.dumps(report(tick, paper, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, ImportError) as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
