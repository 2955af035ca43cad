"""Choose ``csrc/src_scatter.cu``'s design constants on the card.

    python -m repro_torch.kernels.src_scatter.sweep [--scale 14]

Builds one library per variant of (C edges per chunk, U edges gathered
before they are added, column vectors per lane at most, blocks per SM
that write the zeros of empty rows): a generated source that includes
``src_scatter.cu`` and exports ``src_scatter_sweep`` for that choice, all
compiled at once by ``nvcc`` into ``build/kernels/sweep/``. Then samples
the paper batch that ``chip_smoke.py`` holds the kernels on (product-sim,
batch 1000, fanouts 15/10/5, seed 0) and, on each layer, times every
variant as K1's backward (weight 1, F = hidden or input width) and as
K3's backward into h_proj (weights (E, 2), F = 256, and 16 on the last
layer) against the wrapper's kernel, and on one source row of 20,000
edges, whose carries make one chain: CUDA-event medians with L2 flushed,
each output bitwise equal to the wrapper's (every variant sums in the
same order). Prints one JSON line a case and a variant, then the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import _cuda
from ..dst_groups import src_groups
from .kernel import _ARGTYPES, _scratch_for, src_scatter_cuda

# (C, U, column vectors per lane at most, zero-writing blocks per SM)
VARIANTS = [(32, 32, 1, 1), (32, 32, 1, 2), (32, 16, 1, 1), (16, 16, 1, 1),
            (16, 16, 1, 2), (16, 8, 1, 1), (8, 8, 1, 1), (32, 8, 2, 1),
            (32, 1, 1, 1)]
STAR_EDGES = 20_000
SWEEP_DIR = _cuda.BUILD_DIR / "sweep"


def _name(v) -> str:
    c, u, nv, z = v
    return f"C{c}_U{u}_NV{nv}_Z{z}"


def build(variants) -> dict:
    """One library per variant, all ``nvcc`` processes at once."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    src = _cuda.CSRC / "src_scatter.cu"
    procs = {}
    for v in variants:
        c, u, nv, z = v
        cu = SWEEP_DIR / f"{_name(v)}.cu"
        cu.write_text(
            f'#include "{src}"\n'
            'extern "C" int src_scatter_sweep(\n'
            '    const void* g, const void* r, const void* w, const void* o,\n'
            '    const void* k, const void* off, void* out, void* carry,\n'
            '    void* tickets, long long v, long long e, long long f,\n'
            '    int h, long long dh, int vec4, void* s) {\n'
            f'  return src_scatter<{c}, {u}, {nv}, {z}>(g, r, w, o, k, off,\n'
            '      out, carry, tickets, v, e, f, h, dh, vec4, s);\n'
            '}\n')
        lib = cu.with_suffix(".so")
        procs[v] = (subprocess.Popen(
            [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for v, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_name(v)}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        fn = ctypes.CDLL(str(lib)).src_scatter_sweep
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        libs[v] = (fn, spills)
    return libs


def call(fn, chunk, grad, edge_dst, groups, weights=None) -> torch.Tensor:
    """The wrapper's launch with variant ``fn`` and chunk size ``chunk``."""
    e, f = edge_dst.numel(), grad.shape[1]
    h = 1 if weights is None else weights.shape[1]
    out = torch.empty((groups.num_groups, f), device=grad.device)
    vec4 = int(f % 4 == 0 and (f // h) % 4 == 0)
    stream = _cuda.stream_ptr(grad.device)
    carry, tickets = _scratch_for(grad.device, stream, -(-e // chunk) * f,
                                  -(-(f // 4 if vec4 else f) // 32))
    err = fn(grad.data_ptr(), edge_dst.data_ptr(),
             None if weights is None else weights.data_ptr(),
             groups.order.data_ptr(), groups.keys.data_ptr(),
             groups.offsets.data_ptr(), out.data_ptr(), carry.data_ptr(),
             tickets.data_ptr(), groups.num_groups, e, f, h, f // h, vec4,
             stream)
    _cuda.check(err, "src_scatter_sweep")
    return out


def cuda_ms(fn, reps: int = 30) -> float:
    """Median CUDA-event time over ``reps`` launches, each after a 256 MB
    write that evicts the 50 MB L2."""
    flush = torch.empty(64 * 2 ** 20, device="cuda")
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


def paper_cases(scale: int) -> list:
    """(label, grad, edge_dst, source groups, weights) of each layer of one
    paper batch: K1's backward and K3's backward into h_proj."""
    from ...core.sampler import DistributedSampler, sample_ego_networks
    from ...launch import gnn_serve

    g, cfg, _params = gnn_serve.build_world(gnn_serve.build_parser()
                                            .parse_args(["--scale",
                                                         str(scale)]))
    caps = dataclasses.replace(cfg, batch_size=1000).dst_caps()
    sampler = DistributedSampler(g.book, g.partitions, cfg.fanouts, 1000,
                                 machine=g.machine, transport=None, seed=0)
    seeds = np.random.default_rng(0).choice(g.num_nodes(), 1000,
                                            replace=False)
    mb = next(sample_ego_networks(sampler, g.new_client(), g.feat_name,
                                  seeds, drop_last=False))
    gen = torch.Generator(device="cuda").manual_seed(0)
    widths = [cfg.in_dim, cfg.hidden_dim, cfg.hidden_dim]
    cases = []
    for layer, b in enumerate(mb.blocks):
        es, ed, em = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                      for x in (b.edge_src, b.edge_dst, b.edge_mask))
        es, ed = es.to(torch.int32), ed.to(torch.int32)
        v = len(mb.input_feats) if layer == 0 else caps[layer - 1]
        groups = src_groups(es, em, v)
        deg = int(torch.bincount(es[em].long()).max()) if em.any() else 0
        n = caps[layer]
        f = widths[layer]
        grad = torch.randn((n, f), generator=gen, device="cuda")
        cases.append((f"K1 backward layer {layer} (F={f}, max degree "
                      f"{deg})", grad, ed, groups, None))
        f3 = 16 if layer == len(mb.blocks) - 1 else 256
        grad3 = torch.randn((n, f3), generator=gen, device="cuda")
        alpha = torch.rand((ed.numel(), 2), generator=gen, device="cuda")
        cases.append((f"K3 backward d h_proj layer {layer} (F={f3}, max "
                      f"degree {deg})", grad3, ed, groups, alpha))
    # one source row with every edge: a chain of STAR_EDGES / C carries
    ed = torch.randint(0, 1000, (STAR_EDGES,), generator=gen,
                       device="cuda", dtype=torch.int32)
    star = src_groups(torch.zeros_like(ed), torch.ones_like(ed, dtype=bool),
                      8)
    cases.append((f"star of {STAR_EDGES} edges (F=256)",
                  torch.randn((1000, 256), generator=gen, device="cuda"), ed,
                  star, None))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA card")
    t0 = time.perf_counter()
    libs = build(VARIANTS)
    print(f"[sweep] built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cases = paper_cases(args.scale)
    rows = []
    for label, grad, ed, groups, w in cases:
        want = src_scatter_cuda(grad, ed, groups, w)
        row = {"case": label, "kernel_ms": cuda_ms(
            lambda: src_scatter_cuda(grad, ed, groups, w))}
        for v, (fn, _spills) in libs.items():
            got = call(fn, v[0], grad, ed, groups, w)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{_name(v)} disagrees on {label}: max "
                                 f"{float((got - want).abs().max()):.3e}")
            row[_name(v)] = cuda_ms(lambda: call(fn, v[0], grad, ed,
                                                 groups, w))
        rows.append(row)
        print(f"[sweep] {json.dumps(row)}", flush=True)
    k1 = [r for r in rows if r["case"].startswith("K1")][1:]  # layers 1-2
    k3 = [r for r in rows if r["case"].startswith("K3")]
    for v, (_fn, spills) in libs.items():
        print(json.dumps({
            "variant": _name(v), "spills": spills,
            "k1_bwd_layers_1_2_ms": sum(r[_name(v)] for r in k1),
            "k3_bwd_h_layers_0_2_ms": sum(r[_name(v)] for r in k3)}))
    print(json.dumps({"variant": "wrapper", "k1_bwd_layers_1_2_ms": sum(
        r["kernel_ms"] for r in k1), "k3_bwd_h_layers_0_2_ms": sum(
        r["kernel_ms"] for r in k3)}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
