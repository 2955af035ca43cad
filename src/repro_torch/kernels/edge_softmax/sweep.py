"""Choose the design constants of ``csrc/edge_softmax.cu`` (K4's statistics
and normalize kernels) on the card.

    python -m repro_torch.kernels.edge_softmax.sweep [--scale 14] \
        [--baseline DIR]

Builds one library per variant, all compiled at once by ``nvcc`` into
``build/kernels/sweep/``, each from a generated source that includes
``edge_softmax.cu``: ``U<n>`` exports the statistics with n order entries
a thread loads before its chain, ``W<n>`` with the warp route from groups
of more than n live edges (``Wnever``: no warp route), ``R<n>`` with n
batches in the warp route's ring; the normalize is timed as the wrapper
launches it. Then samples real batches of
product-sim (fanouts 15/10/5, seed 0) of 64 seeds (about a serving tick's
edges), 512 (a training step's shapes) and 1000 (the paper's), and on
each layer times every variant against the wrappers' kernels at GAT's
shapes (H = 2): CUDA-event medians with L2 flushed, every output bitwise
equal to the wrapper's.
Then times and holds them on a synthetic block (groups of every length
0-100, one of 5,000 and one of 100,000 live edges among padded slots) at
H = 1, 2, 8 and 12, on the aligned route and on the scalar one (scores 4
bytes past a 16-byte boundary), and on the 100,000-edge group alone.
``--baseline DIR`` adds another version of the source (DIR holds its
``edge_softmax.cu``, the parent commit's say), timed in the same call and
held bitwise against the wrappers. Prints one JSON line a case, one a
variant with its sums over each batch's layers and its ``-Xptxas -v``
registers and spills by kernel, then the card's ``nvidia-smi`` name and
power limit; exits 1 if any output differs.
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
from ..segment_sum.sweep import SWEEP_DIR, _generated, _nvcc
from ..src_scatter.sweep import cuda_ms
from .kernel import (_NORM_ARGTYPES, _STATS_ARGTYPES, RING, STATS_EDGES,
                     WARP_FROM, edge_softmax_norm_cuda,
                     edge_softmax_stats_cuda)

# (U, warp route from, ring) of the statistics' variants; None: no warp
# route
STATS_VARIANTS = {"U4": (4, WARP_FROM, RING), "U16": (16, WARP_FROM, RING),
                  "W32": (STATS_EDGES, 32, RING),
                  "W256": (STATS_EDGES, 256, RING),
                  "Wnever": (STATS_EDGES, None, RING),
                  "R1": (STATS_EDGES, WARP_FROM, 1),
                  "R2": (STATS_EDGES, WARP_FROM, 2),
                  "R8": (STATS_EDGES, WARP_FROM, 8)}
BATCHES = (64, 512, 1000)
HEADS = 2
SYNTH_HEADS = (1, 2, 8, 12)
STAR_EDGES = 100_000

_STATS_ARGS = ('const void* a, const void* b, const void* c, void* d, '
               'void* e,\n    long long n, int H, void* s')


def build(baseline=None) -> dict:
    """{variant name: ({"stats", "norm"}: C function, resources by
    kernel)}, every ``nvcc`` at once. With ``baseline``, a directory
    holding another version of the source, also "baseline", through its
    own C entry points (whose arguments are the wrappers')."""
    k4 = _cuda.CSRC / "edge_softmax.cu"
    procs = {}
    for name, (u, warp_from, ring) in STATS_VARIANTS.items():
        w = "1 << 30" if warp_from is None else warp_from
        procs[name] = (*_generated(
            f"K4_{name}",
            f'#include "{k4}"\n'
            f'extern "C" int sweep_stats({_STATS_ARGS}) {{\n'
            f'  return stats<{u}, {w}, {ring}>(a, b, c, d, e, n, H, s);\n}}\n'),
            ("sweep_stats", None))
    if baseline is not None:
        SWEEP_DIR.mkdir(parents=True, exist_ok=True)
        procs["baseline"] = (*_nvcc(
            "K4_baseline", Path(baseline).resolve() / "edge_softmax.cu"),
            ("edge_softmax_stats_f32", "edge_softmax_norm_f32"))
    libs = {}
    for name, (proc, lib, syms) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fns = {}
        for kind, sym, argtypes in zip(("stats", "norm"), syms,
                                       (_STATS_ARGTYPES, _NORM_ARGTYPES)):
            if sym is not None:
                fn = getattr(ctypes.CDLL(str(lib)), sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[kind] = fn
        libs[name] = (fns, _cuda.kernel_resources(log))
    return libs


def call(fn, kind, case):
    """The wrapper's launch with variant ``fn``: (m, z) or alpha."""
    g, scores = case["groups"], case["scores"]
    stream = _cuda.stream_ptr(scores.device)
    if kind == "stats":
        m = torch.empty((g.num_groups, scores.shape[1]), device="cuda")
        z = torch.empty_like(m)
        err = fn(scores.data_ptr(), g.order.data_ptr(), g.offsets.data_ptr(),
                 m.data_ptr(), z.data_ptr(), g.num_groups, scores.shape[1],
                 stream)
        out = (m, z)
    else:
        out = torch.empty_like(scores)
        err = fn(scores.data_ptr(), case["edge_dst"].data_ptr(),
                 case["edge_mask"].data_ptr(), case["m"].data_ptr(),
                 case["z"].data_ptr(), out.data_ptr(), scores.shape[0],
                 scores.shape[1], stream)
    _cuda.check(err, f"K4 {kind}")
    return out


def _case(label, ed, em, num_dst, scores, **extra) -> dict:
    groups = dst_groups(ed, em, num_dst)
    m, z = edge_softmax_stats_cuda(scores, groups)
    return {"case": label, "groups": groups, "scores": scores,
            "edge_dst": ed, "edge_mask": em, "m": m, "z": z, **extra}


def batch_cases(scale: int) -> list:
    """K4's inputs on each layer of one sampled batch of each size: random
    scores at GAT's H = 2 (spread like its logits)."""
    from ...core.sampler import DistributedSampler, sample_ego_networks
    from ...launch import gnn_serve

    g, cfg, _params = gnn_serve.build_world(gnn_serve.build_parser()
                                            .parse_args(["--scale",
                                                         str(scale)]))
    gen = torch.Generator(device="cuda").manual_seed(0)
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
            ed, em = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                      for x in (b.edge_dst, b.edge_mask))
            ed = ed.to(torch.int32)
            n = caps[layer]
            scores = 2 * torch.randn((ed.numel(), HEADS), generator=gen,
                                     device="cuda")
            cases.append(_case(
                f"batch {batch} layer {layer} (H={HEADS}, {n} dst, "
                f"{int(em.sum())} live edges, E={ed.numel()})", ed, em, n,
                scores, batch=batch, layer=layer))
    return cases


def _block(rng, lengths, pad):
    """Destination-keyed slots: group d holds ``lengths[d]`` live edges;
    ``pad`` masked slots (dst 0, as ``pad_block`` pads) mixed in."""
    dst = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    mask = np.r_[np.ones(dst.size, bool), np.zeros(pad, bool)]
    dst = np.r_[dst, np.zeros(pad, np.int32)]
    perm = rng.permutation(dst.size)
    return (torch.from_numpy(dst[perm]).cuda(),
            torch.from_numpy(mask[perm]).cuda())


def shape_cases() -> list:
    """K4's inputs on a synthetic block (groups of every length 0-100, one
    of 5,000 and one of 100,000 live edges among 3,001 padded slots, so
    that E is odd) at each of :data:`SYNTH_HEADS`, on the aligned route and
    on the scalar one (scores 4 bytes past a 16-byte boundary); and on the
    100,000-edge group alone at H = 2."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lengths = list(range(101)) + [5000, STAR_EDGES]
    ed, em = _block(rng, lengths, 3001)
    cases = []
    for h in SYNTH_HEADS:
        scores = (torch.rand((ed.numel(), h), generator=gen, device="cuda")
                  * 160 - 80)
        odd = torch.empty(scores.numel() + 1, device="cuda")[1:].view(
            scores.shape).copy_(scores)
        for route, s in (("aligned", scores), ("scalar", odd)):
            cases.append(_case(f"synthetic H={h} {route} (groups 0-100, "
                               f"5000, {STAR_EDGES})", ed, em,
                               len(lengths), s))
    ed, em = _block(rng, [STAR_EDGES], 0)
    scores = torch.randn((ed.numel(), HEADS), generator=gen, device="cuda")
    cases.append(_case(f"one group of {STAR_EDGES} (H={HEADS})", ed, em, 1,
                       scores))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--baseline", default=None,
                    help="a directory with another version of "
                         "edge_softmax.cu, timed beside the variants and "
                         "held bitwise")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA card")
    t0 = time.perf_counter()
    libs = build(args.baseline)
    print(f"[sweep] built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wrappers = {
        "stats": lambda c: edge_softmax_stats_cuda(c["scores"], c["groups"]),
        "norm": lambda c: edge_softmax_norm_cuda(
            c["scores"], c["edge_dst"], c["edge_mask"], c["m"], c["z"])}
    rows, differ = [], []
    for case in batch_cases(args.scale) + shape_cases():
        for kind, wrapper in wrappers.items():
            want = wrapper(case)
            want = want if kind == "stats" else (want,)
            row = {"case": case["case"], "kernel": kind,
                   "wrapper_ms": cuda_ms(lambda: wrapper(case))}
            for name, (fns, _res) in libs.items():
                if kind not in fns:
                    continue
                got = call(fns[kind], kind, case)
                got = got if kind == "stats" else (got,)
                torch.cuda.synchronize()
                if not all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(got, want)):
                    err = max(float((a - b).abs().nan_to_num().max())
                              for a, b in zip(got, want))
                    differ.append(f"{name} {kind} on {case['case']}: max "
                                  f"abs diff {err:.3e}")
                    row[f"{name}_max_abs_diff"] = err
                row[name] = cuda_ms(lambda: call(fns[kind], kind, case))
            rows.append((case, row))
            print(f"[sweep] {json.dumps(row)}", flush=True)
    for name, (_fns, res) in [("wrapper", ({}, None)), *libs.items()]:
        key = "wrapper_ms" if name == "wrapper" else name
        sums = {}
        for batch in BATCHES:
            for kind in ("stats", "norm"):
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
