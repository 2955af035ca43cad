"""Choose the design constants of ``csrc/segment_sum.cu`` (K2) and of K1's
forward (``csrc/fused_gather_aggregate.cu``) on the card.

    python -m repro_torch.kernels.segment_sum.sweep [--scale 14] \
        [--baseline DIR]

Builds one library per variant, all compiled at once by ``nvcc`` into
``build/kernels/sweep/``: for K2, a generated source that includes
``segment_sum.cu`` and exports its call for one choice of (W lanes a
group, R edges a lane loads a batch) on the lanes-across-edges schedule;
for K1, one that includes ``fused_gather_aggregate.cu`` for one choice of
gathered floats a lane (which sets the U rows in flight). Then samples
real batches of product-sim (fanouts 15/10/5, seed 0) of 64 seeds (about
a serving tick's edges), 512 (a training step's) and 1000 (the paper's),
and on each layer times every variant against the wrapper's kernel: K1 at
the layer's width, K2 as ``_degrees`` (F = 1) and at F = 2 keyed by
destination and by source (GAT's logit gradients); CUDA-event medians
with L2 flushed, every output bitwise equal to the wrapper's (every
variant sums in the same order).
``--baseline`` adds another version of the two sources (the parent
commit's, say), timed in the same call. Prints one JSON line a case, one a
variant with its sums and its ``-Xptxas -v`` register counts, then the
card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import _cuda
from ..dst_groups import dst_groups, src_groups
from ..fused_gather_aggregate.kernel import _ARGTYPES as K1_ARGTYPES
from ..fused_gather_aggregate.kernel import fused_gather_aggregate_cuda
from ..src_scatter.sweep import cuda_ms
from .kernel import _ARGTYPES as K2_ARGTYPES
from .kernel import segment_sum_cuda

# K2: (W lanes a group, R edges a lane loads a batch); K1: gathered floats
# a lane
K2_VARIANTS = [(8, 4), (4, 4), (8, 2), (8, 8), (16, 2), (16, 4), (32, 1),
               (32, 2)]
K1_VARIANTS = [16, 32, 64, 128]
BATCHES = (64, 512, 1000)
SWEEP_DIR = _cuda.BUILD_DIR / "sweep"


def _nvcc(name: str, cu: Path):
    lib = SWEEP_DIR / f"{name}.so"
    proc = subprocess.Popen(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def _generated(name: str, text: str):
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    cu = SWEEP_DIR / f"{name}.cu"
    cu.write_text(text)
    return _nvcc(name, cu)


def build(baseline=None) -> dict:
    """{variant name: (C function, register counts)}, every ``nvcc`` at
    once; with ``baseline``, a directory holding another version of the
    two sources, also "K2_baseline" and "K1_baseline", called through
    their own C entry points (whose arguments are the wrapper's)."""
    k2 = _cuda.CSRC / "segment_sum.cu"
    k1 = _cuda.CSRC / "fused_gather_aggregate.cu"
    procs = {}
    for w, r in K2_VARIANTS:
        procs[f"K2_W{w}_R{r}"] = (*_generated(
            f"K2_W{w}_R{r}",
            f'#include "{k2}"\n'
            'extern "C" int sweep(const void* m, const void* o,\n'
            '    const void* off, void* out, long long n, long long f,\n'
            '    void* s) {\n'
            f'  return segment_sum<float, {w}, {r}, kGatherFloats,\n'
            '      kMaxVecsPerLane>(m, o, off, out, n, f, s);\n'
            '}\n'), "sweep")
    for gf in K1_VARIANTS:
        procs[f"K1_GF{gf}"] = (*_generated(
            f"K1_GF{gf}",
            f'#include "{k1}"\n'
            'extern "C" int sweep(const void* h, const void* es,\n'
            '    const void* o, const void* off, void* out, long long n,\n'
            '    long long f, int vec4, void* s) {\n'
            f'  return fused_gather_aggregate<{gf}, kMaxVecsPerLane>(\n'
            '      h, es, o, off, out, n, f, vec4, s);\n'
            '}\n'), "sweep")
    if baseline is not None:
        SWEEP_DIR.mkdir(parents=True, exist_ok=True)
        base = Path(baseline).resolve()
        procs["K2_baseline"] = (*_nvcc("K2_baseline",
                                       base / "segment_sum.cu"),
                                "segment_sum_f32")
        procs["K1_baseline"] = (*_nvcc("K1_baseline",
                                       base / "fused_gather_aggregate.cu"),
                                "fused_gather_aggregate_f32")
    libs = {}
    for name, (proc, lib, sym) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  log)})
        fn = getattr(ctypes.CDLL(str(lib)), sym)
        fn.argtypes = K2_ARGTYPES if name.startswith("K2") else K1_ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = (fn, regs)
    return libs


def call(name, fn, case) -> torch.Tensor:
    """The wrapper's launch with variant ``fn``."""
    groups = case["groups"]
    if name.startswith("K2"):
        msg = case["msg"]
        out = torch.empty((groups.num_groups, msg.shape[1]),
                          device=msg.device)
        err = fn(msg.data_ptr(), groups.order.data_ptr(),
                 groups.offsets.data_ptr(), out.data_ptr(),
                 groups.num_groups, msg.shape[1],
                 _cuda.stream_ptr(msg.device))
    else:
        h, es = case["h"], case["edge_src"]
        f = h.shape[1]
        out = torch.empty((groups.num_groups, f), device=h.device)
        err = fn(h.data_ptr(), es.data_ptr(), groups.order.data_ptr(),
                 groups.offsets.data_ptr(), out.data_ptr(),
                 groups.num_groups, f, int(f % 4 == 0),
                 _cuda.stream_ptr(h.device))
    _cuda.check(err, name)
    return out


def batch_cases(scale: int) -> list:
    """K1 and K2 on each layer of one sampled batch of each size."""
    from ...core.sampler import DistributedSampler, sample_ego_networks
    from ...launch import gnn_serve

    g, cfg, _params = gnn_serve.build_world(gnn_serve.build_parser()
                                            .parse_args(["--scale",
                                                         str(scale)]))
    gen = torch.Generator(device="cuda").manual_seed(0)
    widths = [cfg.in_dim, cfg.hidden_dim, cfg.hidden_dim]
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
            by_dst = dst_groups(ed, em, n)
            by_src = src_groups(es, em, v)
            tag = f"batch {batch} layer {layer}"
            h = torch.randn((v, widths[layer]), generator=gen, device="cuda")
            cases.append({"case": f"K1 {tag} (F={widths[layer]})",
                          "kind": "K1", "batch": batch, "h": h,
                          "edge_src": es, "groups": by_dst})
            cases.append({"case": f"K2 degrees {tag}", "kind": "K2",
                          "batch": batch, "groups": by_dst,
                          "msg": em.to(torch.float32)[:, None]})
            msg = torch.randn((es.numel(), 2), generator=gen, device="cuda")
            for key, groups in (("dst", by_dst), ("src", by_src)):
                deg = int((groups.offsets[1:] - groups.offsets[:-1]).max())
                cases.append({"case": f"K2 F=2 by {key} {tag} (largest "
                                      f"group {deg})", "kind": "K2",
                              "batch": batch, "groups": groups,
                              "msg": msg})
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--baseline", default=None,
                    help="a directory with another version of "
                         "segment_sum.cu and fused_gather_aggregate.cu, "
                         "timed beside the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA card")
    t0 = time.perf_counter()
    libs = build(args.baseline)
    print(f"[sweep] built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for case in batch_cases(args.scale):
        kind = case["kind"]
        if kind == "K1":
            wrapper = lambda: fused_gather_aggregate_cuda(  # noqa: E731
                case["h"], case["edge_src"], case["groups"])
        else:
            wrapper = lambda: segment_sum_cuda(case["msg"],  # noqa: E731
                                               case["groups"])
        want = wrapper()
        row = {"case": case["case"], "kernel_ms": cuda_ms(wrapper)}
        for name, (fn, _regs) in libs.items():
            if not name.startswith(kind):
                continue
            got = call(name, fn, case)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{name} disagrees on {case['case']}")
            row[name] = cuda_ms(lambda: call(name, fn, case))
        rows.append((case, row))
        print(f"[sweep] {json.dumps(row)}", flush=True)
    for name, (_fn, regs) in [("wrapper", (None, None)), *libs.items()]:
        key = "kernel_ms" if name == "wrapper" else name
        sums = {}
        for batch in BATCHES:
            for label, pick in (
                    ("K1", lambda c: c["kind"] == "K1"),
                    ("K2_degrees", lambda c: "degrees" in c["case"]),
                    ("K2_F2", lambda c: "F=2 by" in c["case"])):
                ms = [r[key] for c, r in rows
                      if c["batch"] == batch and pick(c) and key in r]
                if ms:
                    sums[f"{label}_batch{batch}_ms"] = sum(ms)
        print(json.dumps({"variant": name, "registers": regs, **sums}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
