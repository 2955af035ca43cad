"""Roofline analysis from the dry-run's traces; the port of
``repro.launch.roofline``, with the H100 SXM 80 GB's constants.

Three terms per (arch × shape × mesh), each "seconds per step if this
resource were the only bottleneck":

  compute    = FLOPs / (ranks × 989e12)     [H100 SXM dense bfloat16]
  memory     = HBM bytes / 3.35e12          [H100 SXM HBM3, per rank]
  collective = collective bytes per rank / 50e9
               [one H100's InfiniBand: 400 Gb/s NDR a GPU on a DGX H100;
               both 16-wide mesh axes cross 8-GPU nodes, so the link a
               rank's collectives cross is its InfiniBand port]

The compute and memory terms are ANALYTIC, as the reference's:
    - compute: 8·N_active·D for train (fwd 2 + bwd 4 + full-remat re-fwd 2),
      2·N_active·D for prefill/decode, D = tokens per step.
    - memory (per rank): train: 22 B/param (bf16 read+write, bf16 grad,
      f32 m/v read+write) × N/ranks + remat-residual traffic
      (4·L·tokens_loc·d_model bytes); decode: 2·N/ranks + KV/state cache
      read+write; prefill: 2·N/ranks + cache write + activation traffic.
The trace's own FLOPs and op bytes (every layer: the trace unrolls
them) are reported beside them as ``*_trace`` columns; the trace's bytes
are unfused, an upper bound. The collective term reads the trace's
collective bytes. All three are bounds from counts, not measurements.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline            # table
    PYTHONPATH=src python -m repro_torch.launch.roofline --markdown
"""
from __future__ import annotations

import argparse
import json
import os

from ..configs import get_config
from .input_specs import SHAPES, cache_len_for

PEAK_FLOPS = 989e12          # H100 SXM, dense bfloat16 / rank
HBM_BW = 3.35e12             # H100 SXM HBM3, B/s
LINK_BW = 50e9               # B/s: one H100's InfiniBand (400 Gb/s NDR)

RESULTS_PATH = os.path.join(os.path.dirname(__file__),
                            "../../../build/dryrun/dryrun_torch.json")


def tokens_per_step(shape: str) -> int:
    info = SHAPES[shape]
    return info["batch"] * (1 if info["kind"] == "decode" else info["seq"])


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    n = cfg.active_param_count()
    d = tokens_per_step(shape)
    factor = 8 if SHAPES[shape]["kind"] == "train" else 2
    return factor * n * d


def cache_bytes(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    info = SHAPES[shape]
    b = info["batch"]
    w = cache_len_for(cfg, shape)
    kv, hd = cfg.num_kv_heads, cfg.hd
    total = 0.0
    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        total += cfg.num_layers * b * w * kv * hd * 2 * 2      # k+v bf16
    if cfg.arch_type == "hybrid":
        sites = cfg.num_layers // cfg.hybrid_attn_every
        total += sites * b * w * kv * hd * 2 * 2
    if cfg.ssm_state:
        total += (cfg.num_layers * b * cfg.ssm_heads * cfg.ssm_head_dim
                  * cfg.ssm_state * 4)
    return total


def memory_bytes(arch: str, shape: str, chips: int) -> float:
    cfg = get_config(arch)
    info = SHAPES[shape]
    n = cfg.param_count()
    d_tokens = tokens_per_step(shape)
    kind = info["kind"]
    if kind == "train":
        weight_traffic = 22.0 * n / chips
        act = 4.0 * cfg.num_layers * (d_tokens / chips * max(
            1, 16)) * cfg.d_model * 2 / 16  # residuals, seq-sharded /16
        return weight_traffic + act
    if kind == "prefill":
        act = 4.0 * cfg.num_layers * d_tokens / chips * cfg.d_model * 2
        return 2.0 * n / chips + cache_bytes(arch, shape) / chips + act
    # decode: every step touches all (sharded) weights + the whole cache
    return 2.0 * n / chips + 2.0 * cache_bytes(arch, shape) / chips


def analyze(entry: dict, chips: int) -> dict:
    arch, shape = entry["arch"], entry["shape"]
    mf = model_flops(arch, shape)
    t_compute = mf / (chips * PEAK_FLOPS)
    t_memory = memory_bytes(arch, shape, chips) / HBM_BW
    t_coll = entry["collectives"].get("total", 0) / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    trace_flops = entry["flops_per_device"]
    step_time = max(terms.values())
    mfu = (mf / chips / PEAK_FLOPS) / step_time if step_time else 0.0
    return dict(arch=arch, shape=shape, mesh=entry["mesh"],
                t_compute=t_compute, t_memory=t_memory,
                t_collective=t_coll, dominant=dominant,
                model_flops=mf,
                trace_flops_per_dev=trace_flops,
                trace_bytes_per_dev=entry["bytes_per_device"],
                useful_flops_ratio=((mf / chips) / trace_flops
                                    if trace_flops else 0),
                roofline_mfu=mfu,
                peak_gib=entry.get("memory", {}).get("peak_bytes", 0)
                / 2**30,
                coll_counts=entry["collectives"])


def load(path=RESULTS_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def improvement_hint(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        return ("compute-bound: cut remat re-forward (policy remat), "
                "reduce MoE capacity waste, or grow the mesh")
    if d == "memory":
        return ("HBM-bound: shrink optimizer/cache traffic (shard further, "
                "quantize cache, fuse reads) or raise arithmetic intensity")
    return ("collective-bound: reshard to cut per-layer all-gathers "
            "(sequence-parallel boundaries, a2a expert dispatch, overlap "
            "collectives with compute)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--results", default=RESULTS_PATH)
    args = ap.parse_args(argv)
    data = load(args.results)
    chips = 512 if args.mesh.startswith("2x") else 256
    rows = []
    for key, e in sorted(data.items()):
        if not e.get("ok") or e["mesh"] != args.mesh:
            continue
        rows.append(analyze(e, chips))
    if args.markdown:
        print("| arch | shape | compute s | memory s | collective s | "
              "dominant | roofline-MFU | coll GB/rank | peak GiB/rank |")
        print("|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['arch']} | {r['shape']} | {r['t_compute']:.4f} | "
                  f"{r['t_memory']:.4f} | {r['t_collective']:.4f} | "
                  f"**{r['dominant']}** | {r['roofline_mfu']:.2f} | "
                  f"{r['coll_counts'].get('total', 0) / 1e9:.1f} | "
                  f"{r['peak_gib']:.2f} |")
    else:
        for r in rows:
            print(f"{r['arch']:22s} {r['shape']:12s} "
                  f"C={r['t_compute']:.4f}s M={r['t_memory']:.4f}s "
                  f"X={r['t_collective']:.4f}s -> {r['dominant']:10s} "
                  f"MFU={r['roofline_mfu']:.2f}")
            print(f"   hint: {improvement_hint(r)}")


if __name__ == "__main__":
    main()
