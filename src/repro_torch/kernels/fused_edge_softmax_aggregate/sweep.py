"""Choose the design constants of ``csrc/fused_edge_softmax_aggregate.cu``
(K3's forward and its backward into the scores) on the card.

    python -m repro_torch.kernels.fused_edge_softmax_aggregate.sweep \
        [--scale 14] [--baseline DIR]

Builds one library per variant, all compiled at once by ``nvcc`` into
``build/kernels/sweep/``, each from a generated source that includes
``fused_edge_softmax_aggregate.cu``: ``GF<n>`` exports both kernels for one
budget of gathered floats a lane (which sets U, the rows in flight);
``L<n>`` exports the backward with at least n lanes a head on the sub-warp
route (which sets W); ``B<n>`` the backward with its warp kernel asking
for n resident blocks an SM (a register cap; ``B1`` is none).
Then samples real batches of product-sim (fanouts 15/10/5, seed 0) of 64
seeds (about a serving tick's edges), 512 (a training step's shapes) and
1000 (the paper's), and on each layer times every variant against the
wrappers' kernels at GAT's shapes (2 heads of 128, 2 of 8 in the last
layer): CUDA-event medians with L2 flushed, every output bitwise equal to
the wrapper's (no variant changes the order of an addition). Then holds
every variant, untimed, to the wrapper's bits on a synthetic block (groups
of every length 0-100 and one of 5,000) at every route of the two
kernels: float4 and scalar columns, sub-warp and warp backward, rows past
256 floats, H = 1-12 (:data:`SHAPES`).
``--baseline DIR`` adds another version of the source (DIR holds its
``fused_edge_softmax_aggregate.cu`` and ``vec.cuh``, the parent commit's
say), timed in the same call and held bitwise against the wrappers.
Prints one JSON line a case, one a variant with its sums and its
``-Xptxas -v`` registers and spills by kernel, then the card's
``nvidia-smi`` name and power limit; exits 1 if any output differs.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from ..dst_groups import dst_groups
from ..edge_softmax.kernel import (edge_softmax_norm_cuda,
                                   edge_softmax_stats_cuda)
from ..segment_sum.sweep import SWEEP_DIR, _generated, _nvcc
from ..src_scatter.sweep import cuda_ms
from .kernel import (_ARGTYPES, MAX_HEADS,
                     fused_edge_softmax_aggregate_bwd_cuda,
                     fused_edge_softmax_aggregate_cuda)

GF_VARIANTS = [4, 8, 16, 32]
LANE_VARIANTS = [4, 8, 16]
MIN_BLOCK_VARIANTS = [1, 6, 10]
BATCHES = (64, 512, 1000)
HEADS = 2
# (H, Dh, float4 columns) of the synthetic block; the backward takes H <= 8
SHAPES = [(2, 128, True), (2, 128, False), (2, 8, True), (2, 8, False),
          (1, 3, False), (8, 8, True), (8, 8, False), (8, 128, True),
          (8, 128, False), (1, 1024, False), (1, 2048, True), (3, 4, True),
          (2, 256, True), (2, 256, False), (4, 40, False), (12, 8, True),
          (12, 128, True)]

_ARGS = ('const void* a, const void* b, const void* c, const void* d,\n'
         '    const void* e, const void* f, const void* g, void* h,\n'
         '    long long n, int H, long long Dh, int vec4, void* s')
_PASS = 'a, b, c, d, e, f, g, h, n, H, Dh, vec4, s'


def build(baseline=None) -> dict:
    """{variant name: ({"fwd", "bwd"}: C function, resources by kernel)},
    every ``nvcc`` at once. With ``baseline``, a directory holding another
    version of the source, also "baseline", through its own C entry points
    (whose arguments are the wrappers')."""
    k3 = _cuda.CSRC / "fused_edge_softmax_aggregate.cu"
    procs = {}
    bwd = (f'extern "C" int sweep_bwd({_ARGS}) {{\n'
           f'  const BwdArgs args = bwd_args({_PASS});\n')
    for gf in GF_VARIANTS:
        procs[f"GF{gf}"] = (*_generated(
            f"K3_GF{gf}",
            f'#include "{k3}"\n'
            f'extern "C" int sweep_fwd({_ARGS}) {{\n'
            f'  return forward<{gf}>({_PASS});\n}}\n'
            f'{bwd}  return backward<{gf}, kBwdMinBlocks>(\n'
            f'      args, backward_plan({gf}, H, args.hcols, args.vec));\n'
            '}\n'), ("sweep_fwd", "sweep_bwd"))
    for lanes in LANE_VARIANTS:
        # the library's route rule with each head at least `lanes` lanes
        procs[f"L{lanes}"] = (*_generated(
            f"K3_L{lanes}",
            f'#include "{k3}"\n'
            f'{bwd}  const int lanes = pow2_at_least(\n'
            f'      args.hcols > {lanes} ? args.hcols : {lanes});\n'
            '  return backward<kGatherFloats, kBwdMinBlocks>(\n'
            '      args, args.hcols <= kSmallHeadVecs && H * lanes <= 32\n'
            '                ? subwarp_plan(kGatherFloats, H, lanes, '
            'args.vec)\n'
            '                : warp_plan(kGatherFloats, H, args.hcols, '
            'args.vec));\n'
            '}\n'), (None, "sweep_bwd"))
    for blocks in MIN_BLOCK_VARIANTS:
        procs[f"B{blocks}"] = (*_generated(
            f"K3_B{blocks}",
            f'#include "{k3}"\n'
            f'{bwd}  return backward<kGatherFloats, {blocks}>(\n'
            '      args, backward_plan(kGatherFloats, H, args.hcols, '
            'args.vec));\n'
            '}\n'), (None, "sweep_bwd"))
    if baseline is not None:
        SWEEP_DIR.mkdir(parents=True, exist_ok=True)
        procs["baseline"] = (*_nvcc(
            "K3_baseline",
            Path(baseline).resolve() / "fused_edge_softmax_aggregate.cu"),
            ("fused_edge_softmax_aggregate_f32",
             "fused_edge_softmax_aggregate_bwd_f32"))
    libs = {}
    for name, (proc, lib, syms) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fns = {}
        for kind, sym in zip(("fwd", "bwd"), syms):
            if sym is not None:
                fn = getattr(ctypes.CDLL(str(lib)), sym)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
                fns[kind] = fn
        libs[name] = (fns, _cuda.kernel_resources(log))
    return libs


def call(fn, kind, case) -> torch.Tensor:
    """The wrapper's launch with variant ``fn``."""
    g, hp = case["groups"], case["h_proj"]
    _v, h, dh = hp.shape
    vec4 = int(dh % 4 == 0 and _cuda.aligned16(hp))
    if kind == "fwd":
        out = torch.empty((g.num_groups, h * dh), device="cuda")
        err = fn(hp.data_ptr(), case["scores"].data_ptr(),
                 case["edge_src"].data_ptr(), g.order.data_ptr(),
                 g.offsets.data_ptr(), case["m"].data_ptr(),
                 case["z"].data_ptr(), out.data_ptr(), g.num_groups, h, dh,
                 vec4, _cuda.stream_ptr(hp.device))
    else:
        out = torch.zeros_like(case["alpha"])
        err = fn(case["grad"].data_ptr(), hp.data_ptr(),
                 case["out"].data_ptr(), case["alpha"].data_ptr(),
                 case["edge_src"].data_ptr(), g.order.data_ptr(),
                 g.offsets.data_ptr(), out.data_ptr(), g.num_groups, h, dh,
                 vec4, _cuda.stream_ptr(hp.device))
    _cuda.check(err, f"K3 {kind}")
    return out


def batch_cases(scale: int) -> list:
    """K3's inputs on each layer of one sampled batch of each size: random
    projected rows and scores at GAT's shapes, K4's statistics and alpha,
    a random output gradient and the wrapper's forward output."""
    from ...core.sampler import DistributedSampler, sample_ego_networks
    from ...launch import gnn_serve

    g, cfg, _params = gnn_serve.build_world(gnn_serve.build_parser()
                                            .parse_args(["--scale",
                                                         str(scale)]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    d_h = [cfg.hidden_dim // HEADS, cfg.hidden_dim // HEADS,
           cfg.num_classes // HEADS]
    cases = []
    for batch in BATCHES:
        caps = dataclasses.replace(cfg, batch_size=batch).dst_caps()
        sampler = DistributedSampler(g.book, g.partitions, cfg.fanouts,
                                     batch, machine=g.machine,
                                     transport=None, seed=0)
        seeds = np.random.default_rng(0).choice(g.num_nodes(), batch,
                                                replace=False)
        mb = next(sample_ego_networks(sampler, g.new_client(), g.feat_name,
                                      seeds, drop_last=False))
        for layer, b in enumerate(mb.blocks):
            es, ed, em = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                          for x in (b.edge_src, b.edge_dst, b.edge_mask))
            es, ed = es.to(torch.int32), ed.to(torch.int32)
            v = len(mb.input_feats) if layer == 0 else caps[layer - 1]
            n = caps[layer]
            groups = dst_groups(ed, em, n)
            hp = torch.randn((v, HEADS, d_h[layer]), generator=gen,
                             device="cuda")
            scores = 2 * torch.randn((es.numel(), HEADS), generator=gen,
                                     device="cuda")
            m, z = edge_softmax_stats_cuda(scores, groups)
            case = {"case": f"batch {batch} layer {layer} (H={HEADS}, "
                            f"Dh={d_h[layer]}, {n} dst, "
                            f"{int(em.sum())} live edges)",
                    "batch": batch, "layer": layer, "groups": groups,
                    "h_proj": hp, "scores": scores, "edge_src": es, "m": m,
                    "z": z,
                    "alpha": edge_softmax_norm_cuda(scores, ed, em, m, z),
                    "grad": torch.randn((n, HEADS * d_h[layer]),
                                        generator=gen, device="cuda")}
            case["out"] = fused_edge_softmax_aggregate_cuda(
                hp, scores, es, groups, m, z)
            cases.append(case)
    return cases


def shape_cases() -> list:
    """K3's inputs on a synthetic block (groups of every length 0-100 and
    one of 5,000 live edges, shuffled among 2,000 padded slots) at each of
    :data:`SHAPES`; scalar columns from an h_proj 4 bytes past a 16-byte
    boundary."""
    rng = np.random.default_rng(0)
    lengths = list(range(101)) + [5000]
    n, v = len(lengths), 700
    dst = np.repeat(np.arange(n, dtype=np.int32), lengths)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    mask = np.r_[np.ones(dst.size, bool), np.zeros(2000, bool)]
    src = np.r_[src, np.zeros(2000, np.int32)]
    dst = np.r_[dst, np.zeros(2000, np.int32)]
    perm = rng.permutation(dst.size)
    es, ed, em = (torch.from_numpy(a[perm]).cuda() for a in (src, dst, mask))
    groups = dst_groups(ed, em, n)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for h, dh, float4 in SHAPES:
        hp = torch.randn((v, h, dh), generator=gen, device="cuda")
        if not float4:
            hp = torch.empty(hp.numel() + 1, device="cuda")[1:].view(
                hp.shape).copy_(hp)
        scores = 3 * torch.randn((es.numel(), h), generator=gen,
                                 device="cuda")
        m, z = edge_softmax_stats_cuda(scores, groups)
        case = {"case": f"synthetic H={h} Dh={dh} "
                        f"{'float4' if float4 else 'scalar'}",
                "groups": groups, "h_proj": hp, "scores": scores,
                "edge_src": es, "m": m, "z": z,
                "alpha": edge_softmax_norm_cuda(scores, ed, em, m, z),
                "grad": torch.randn((n, h * dh), generator=gen,
                                    device="cuda")}
        case["out"] = fused_edge_softmax_aggregate_cuda(
            hp, scores, es, groups, m, z)
        cases.append(case)
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--baseline", default=None,
                    help="a directory with another version of "
                         "fused_edge_softmax_aggregate.cu and vec.cuh, "
                         "timed beside the variants and held bitwise")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA card")
    t0 = time.perf_counter()
    libs = build(args.baseline)
    print(f"[sweep] built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wrappers = {
        "fwd": lambda c: fused_edge_softmax_aggregate_cuda(
            c["h_proj"], c["scores"], c["edge_src"], c["groups"], c["m"],
            c["z"]),
        "bwd": lambda c: fused_edge_softmax_aggregate_bwd_cuda(
            c["grad"], c["h_proj"], c["out"], c["alpha"], c["edge_src"],
            c["groups"])}
    rows, differ = [], []
    for case in batch_cases(args.scale) + shape_cases():
        timed = "batch" in case
        for kind, wrapper in wrappers.items():
            if kind == "bwd" and case["h_proj"].shape[1] > MAX_HEADS:
                continue
            want = wrapper(case)
            row = {"case": case["case"], "kernel": kind}
            if timed:
                row["wrapper_ms"] = cuda_ms(lambda: wrapper(case))
            for name, (fns, _res) in libs.items():
                if kind not in fns:
                    continue
                got = call(fns[kind], kind, case)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                if not same:
                    err = float((got - want).abs().max())
                    differ.append(f"{name} {kind} on {case['case']}: max "
                                  f"abs diff {err:.3e}")
                    row[f"{name}_max_abs_diff"] = err
                row[name] = (cuda_ms(lambda: call(fns[kind], kind, case))
                             if timed else "bitwise" if same else "differs")
            rows.append((case, row))
            print(f"[sweep] {json.dumps(row)}", flush=True)
    for name, (_fns, res) in [("wrapper", ({}, None)), *libs.items()]:
        key = "wrapper_ms" if name == "wrapper" else name
        sums = {}
        for batch in BATCHES:
            for kind in ("fwd", "bwd"):
                ms = [r[key] for c, r in rows if c.get("batch") == batch
                      and r["kernel"] == kind and key in r]
                if ms:
                    sums[f"{kind}_batch{batch}_ms"] = sum(ms)
        print(json.dumps({"variant": name, **sums, "resources": res}))
    for line in differ:
        print(f"[sweep] DIFFERS: {line}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
