#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # one card; about 15 minutes

Phases, each of which exits non-zero when it fails:

1. device   -- requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build    -- builds every CUDA kernel of the port with ``nvcc`` for
               sm_90a from ``src/repro_torch/csrc`` (one process per
               source, all at once).
3. src_scatter -- the source-keyed kernel (K1's backward, K3's backward
               into h_proj) on synthetic blocks at the edges of its
               chunking: one source row with all of 100,000 live edges,
               rows of exactly C, C - 1, C + 1 and 3C edges at and off
               chunk boundaries, a skewed power-law block, a block with no
               live edge, F = 100 on the scalar path and F = 16 with 2
               heads of 8 and F = 1024 (RGCN's hidden width); unweighted
               and weighted, each against ``src_scatter_ref``, empty rows
               exactly 0, two launches bitwise equal.
   segments -- K2 and K1's forward on a synthetic block at the edges of
               their schedules: groups of 0, 1, 15, 31, 32, 33, 64 and 308
               live edges and one of 100,000, and of one less, as many and
               one more than each schedule's batch; F = 1, 2, 3, 100
               (float4 and scalar columns), 256 and 1024; K2 in float32 and
               bfloat16; unit-scale values that nearly cancel. Each output
               bitwise the plain version's computed on the CPU (in
               bfloat16 the float32 sum rounded once) and a second
               launch's.
   k3_segments -- K3's forward and its backward into the scores on a
               synthetic block at the edges of their schedules: groups of
               0, 1, 31, 32, 33, 64 and 308 live edges and one of 100,000;
               H = 1, 2, 8 and 12 (the forward only) by Dh = 8, 128 and 3
               (and H = 2, Dh = 128 on scalar columns); scores uniform over
               +-80, so that exp underflows inside a group. Each output
               within rtol = atol = 1e-5 of the plain version on the card,
               equal to a second launch, empty groups and padded edges 0.
   k4_segments -- K4's statistics and normalize kernels on a synthetic
               block: groups of every length 0-308 live edges and one of
               100,000, padded slots with out-of-range destinations, H =
               1, 2, 8 and 12, each on the aligned route and from a scores
               view 4 bytes past a 16-byte boundary; m exactly the plain
               version's, z and alpha within rtol = atol = 1e-5 of the
               plain version summed on the CPU in the stable order, equal
               to a second launch; each case timed, beside the cold-launch
               floor (a one-element op after the L2 flush) of the same
               run.
4. kernels  -- builds the product-sim ``DistGraph`` (scale 14), samples one
               real batch at the paper's config (batch 1000, fanouts
               15/10/5; GraphSAGE and GAT share it) and holds each kernel
               against its plain PyTorch version on the card at the shapes
               that batch gives: K1 ``fused_gather_aggregate`` and its
               backward, K2 ``segment_sum`` as ``_degrees`` (F = 1) and in
               its general form (F = 256, float32 and bfloat16) with the
               GraphSAGE weights; K4's statistics and normalize kernels,
               K3's forward and its backward into the scores and into
               h_proj with the GAT weights (in 100, hidden 256, 2 heads),
               and K2 as GAT's logit gradients (F = 2, keyed by source and
               by destination), on each of the 3 layers. Backward kernels
               are held against ``torch.autograd.grad`` through the plain
               versions. Two runs
               of a kernel must be bitwise equal. Each case prints the
               kernel's time, the plain version's, one PyTorch library
               call's where one computes the same function (a yardstick the
               port never calls; for K4, ``torch.sparse.softmax`` over a
               hybrid COO tensor computes statistics and normalize
               together), the bound from the bytes it must move,
               and the max error. Then K5 ``sparse_adam`` at table scale
               (100,000 unique rows of a 1,134,649 x 128 float32 table,
               three steps, each bitwise equal to the plain version on the
               card, to the NumPy update on host copies and to a second
               launch, untouched rows unchanged; timed against one
               ``torch.optim.SparseAdam.step``) and K6 ``gather_rows``
               (1,056,000 seeded indices into a 2,449,029 x 100 table, in
               float32 with int32 and int64 indices and in bfloat16,
               exactly equal to ``table[idx]``; timed against
               ``torch.index_select``).
5. serving  -- a main path: ``repro_torch.launch.gnn_serve`` at its
               defaults (batch 8, micro-batch capacity 8) with GraphSAGE
               at full width (in 100, hidden 256, 16 classes, 3 layers),
               with every kernel's launch count set to 0 just before and
               read just after; then served logits against the same
               server with ``impl="ref"``, and one request served alone
               against the same request co-batched (identical bytes);
               then where one full tick's time goes, from the spans of a
               server built as ``gnn_serve`` builds it, and K1 and K2
               again on that server's last tick, as in phase 4.
6. paper    -- one 1000-node request with ``batch_size=1000`` and capacity
               1; the kernel path against ``impl="ref"``.
7. training -- the other main paths: ``repro_torch.launch.train`` for one
               epoch of synchronous training on product-sim scale 14, GAT
               and then GraphSAGE at full width, 2 machines x 2 trainers,
               batch 128 (3 steps), each with every launch count set to 0
               just before and read just after; every kernel of the path
               must have launched. Then the first step's loss and
               gradients against the same step with ``impl="ref"``, a
               second identical run that must end with bitwise-identical
               parameters, where one step's time goes (from the second
               run's spans), and the path's kernels again on the first
               step's stacked batch, as in phase 4.
8. recovery -- kill-and-revive through ``repro_torch.launch.train``
               (GraphSAGE as in phase 7, 2 epochs, a 64 MB cache,
               checkpoints every 2 steps) killed at (epoch 1, batch 2):
               it must revive from the (epoch 1, batch 1) checkpoint and
               end with parameters bitwise equal to the same command
               without the fault; the revived run is counted.
9. embedding -- the slice-3 path: ``DistEmbedding(device="cuda")`` over
               the same 1,134,649 x 128 rows on 2 owners with replication
               2, 4 pushes of 250,000 seeded ids with duplicates from
               client 0, counted (K5 must launch once for each owner a
               push touches); after every push the table, its moments,
               step counts and every replica byte-identical to a dense
               NumPy oracle; a checkpoint after push 2, restored into a
               fresh store, gives the same bytes after pushes 3-4; then
               where a push's time goes.
10. rgcn     -- the typed main paths, RGCN at the paper's width (hidden
               1024, fanouts 25/15 per relation, 4 relations) on
               mag-hetero: ``serving_rgcn``, ``gnn_serve --arch rgcn
               --hetero`` at its defaults on scale 14 (batch 8, capacity
               8), counted (K1 and K2 launch), served logits against
               ``impl="ref"``, alone against co-batched, the tick's spans
               and K1 and K2 on its last tick for each relation and layer;
               ``train_rgcn``, ``launch.train --arch rgcn --hetero`` on
               scale 12, 2 machines x 2 trainers, batch 32, one epoch (3
               steps), counted (K1, its backward and K2 launch), then as
               phase 7 with the peak device memory, and the kernels on the
               first step's batch for each relation and layer (K1's
               backward at both layers: layer 0's projections need a
               gradient for ``w_rel``); ``recover_rgcn``, that command for
               2 epochs killed at (1, 2) as phase 8; and one untyped RGCN
               forward on mag-sim (one fused edge axis, an ``edge_types``
               mask a relation) against ``impl="ref"``.
11. link prediction -- the edge mini-batch main paths, each timed:
               ``train_lp``, ``launch.train --task link_prediction`` with
               GraphSAGE + dot at the paper's widths on product-sim scale
               7, 2 machines x 2 trainers, 32 positive edges a trainer x
               16 uniform negatives (576 endpoint seeds; layer 0 of the
               stacked step 2,433,024 source rows), one epoch and
               ``evaluate_lp`` at its default depth (MRR, Hits@1/3/10
               over 20 batches of 16 edges x 49 negatives), as phase 7:
               counted (K1, its backward and K2 launch; K2 also sums the
               head's gathers' gradients), the first step's loss, MRR and
               gradients against ``impl="ref"``, a second run bitwise
               equal, the step's breakdown and launches, and K1, its
               backward and K2 (as ``_degrees`` and as each of the head's
               gathers, keyed by the batch's ``pos_u``, ``pos_v``,
               ``neg_v`` and ``edge_etypes``) on the first step's batch;
               ``train_lp_rgcn``, typed RGCN + distmult with exclusion on
               mag-hetero scale 5 (8 edges x 2 negatives, 32 seeds a
               trainer, evaluation over 20 batches of 8 edges), the same
               checks, ``rel_emb`` in the bitwise comparison;
               ``lp_batch``, the same kernels on one first-step batch of
               ``train_lp``'s command on scale 14, where the ego-networks
               do not cover the graph (scale 7's are mostly padding);
               ``train_lp_gat``, the same command with GAT + dot (2
               heads; K3, its backward and K4 launch, K2 sums the logits'
               and the head's gradients), the same checks;
               ``recover_lp``,
               ``train_lp`` on scale 6 for 2 epochs killed at (1, 2) as
               phase 8; ``lp_heads``, the score head alone at
               ``train_lp``'s shapes for {dot, distmult} x {uniform,
               in-batch}, twice, bitwise equal between runs and within
               rtol 1e-4, atol 1e-5 of the CPU plain path.
12. offline  -- the layer-wise pass, ``gnn_serve --offline``:
               ``offline_graphsage`` and ``offline_gat`` at the paper's
               widths on product-sim scale 12 (4,096 nodes, in-degrees up
               to 1,164) in chunks of 64, ``offline_rgcn`` typed at hidden
               1024 on mag-hetero scale 10 (2,580 nodes, in-degrees up to
               2,051) in chunks of 16; each counted (launches by layer),
               with its spans (sampling, pulls, staging, forward and the
               card's share of it, pushes) and peak device memory; every
               layer's rows finite; 16 nodes, the longest group's among
               them, bitwise the full-neighbour mini-batch forward of each
               layer at the same chunk size and within rtol 1e-4, atol
               1e-5 of it with ``impl="ref"``; GraphSAGE's bytes equal at
               chunks of 64, 16 and 7; one more pass under
               ``torch.profiler`` (the card's busy share, the operators
               that take the most time); and the pass's kernels (K1 and K2,
               or K4's statistics and K3's forward) on each layer's chunk
               that holds the longest group, as phase 4; first, at each
               product shape of the runs, whether one ``torch.bmm``
               changes a row's bits with the number of rows (logged) and
               that the pass's row tiles do not (required).
13. lm_serve -- the LM serving path (``repro_torch.models.lm``,
               ``repro_torch.launch.serve``), which launches none of
               K1-K6 (every count 0 just after): (a) each of the ten LM
               ids at ``smoke_variant`` width in float32, parameters drawn
               on the CPU and copied to the card, prefill 2 x 24 and 4
               decode steps on the card within rtol 1e-4, atol 1e-5 (atol
               scaled by max|logit| / 4 above 4, as the CPU tests) of the
               same on the CPU, and every step within 5e-3 of ``forward``
               over the whole sequence; (b) llama3-8b, mamba2-2.7b and
               zamba2-7b at full width in float32 (32, 11 and 27 GB of
               weights), prefill 2 x 64 and one decode step within 5e-3
               of the full forward's last positions (with tied
               embeddings, times max|logit| / 4 above 4); (c)
               ``launch.serve`` at full width in bfloat16, greedy, batch
               4, prompt 64, 16 tokens, for every id whose weights fit the
               card (all but qwen3-moe-235b-a22b's 470 GB; qwen3-32b
               is left out for time, see ``LM_SERVE_LEFT_OUT``), twice: the
               same tokens and logits bit for bit, and every step of the
               first run against ``forward`` over the prompt and the
               generated tokens within the id's ``LM_BF16_BOUND_U``;
               prefill ms, decode ms
               a step, tok/s and peak memory per id, each model freed
               before the next; llama3-8b and granite-moe-3b-a800m's
               prefill and 7 decode steps once more under
               ``torch.profiler`` (the card's busy share, its kernels).
14. lm_train -- the LM training path (``repro_torch.models.lm.steps``,
               ``repro_torch.data``, ``launch.train``'s LM branch),
               counted: K2 sums the gradient of the token embedding and of
               each MoE layer's dispatch gather, over the token ids in a
               fixed order. (a) each of the ten LM ids at
               ``smoke_variant`` width in float32, parameters drawn on the
               CPU and copied to the card, 3 steps of
               ``make_train_step`` on 2 x 24 tokens of the launcher's
               stream on the card and on the CPU: per-step loss, ce, aux
               and grad_norm within rtol 1e-4, atol 1e-5, the step-1
               gradients leaf by leaf within 1e-4 x the leaf's max |g| +
               1e-5; qwen2-0.5b once more at 4 microbatches; (b)
               ``launch.train`` at full width in bfloat16 (remat as
               configured) for qwen2-0.5b, whisper-base, mamba2-2.7b and
               granite-moe-3b-a800m, 20 steps of 4 x 256 tokens: the loss
               finite, the mean of steps 16-20 below that of steps 1-5;
               ms a step, tok/s, MFU (8 N_active D, 6 without remat, over
               989 TFLOP/s) beside the analytic bound, peak memory; (c)
               llama3-8b, qwen3-8b, qwen3-32b, pixtral-12b, zamba2-7b and
               qwen3-moe-235b-a22b at their published widths, 3 steps,
               ``num_layers`` cut until 12 bytes a parameter fit 48 GB
               (printed); (d) two 3-step runs of qwen2-0.5b and
               granite-moe-3b-a800m end with bitwise-equal parameters,
               and one bfloat16 step of qwen2-0.5b against the float32
               step from the same parameters (loss and grad_norm in units
               of u = 2^-8); then for those two ids one staged step's K2
               launches, its split (loss and gradients; clipping and
               AdamW) and the step under ``torch.profiler``; and K2 at
               those steps' shapes (bfloat16 rows of the model width keyed
               by the tokens, and for MoE every token once for each of its
               k experts) against its plain version, as phase 4.
15. report  -- a JSON line of every ported kernel (its times summed over
               the layers of one serving tick or training step, the main
               path's shapes, and of one batch-1000 forward and backward
               under ``paper_batch``; its launches on each main path; the
               RGCN tick's and step's, the link-prediction steps' and
               the offline passes' longest chunks' sums beside; K5 at
               table scale, K6
               at its float32 shape), the ``nvidia-smi`` line, and last
               ``{"ok": true, "device": {...}}``.

Tolerances: a kernel against its plain version in float32 rtol = atol =
1e-5 (degrees are integers and compare exactly), in bfloat16 rtol = 0.1,
atol = 0.5; K1 and K2 besides bitwise (float32; K2 in bfloat16 against
the float32 sum rounded once), since they add in the plain version's
order; served logits against ``impl="ref"`` rtol = 1e-4, atol = 1e-5,
and a training step's loss and gradients against ``impl="ref"`` rtol =
1e-4, atol = 1e-5 (the plain versions' ``index_add_`` adds with atomics,
in another order). K5, K6, the embedding path and recovery compare
bitwise: no tolerance. A kernel is held against its plain version computed
with PyTorch's deterministic algorithms (:func:`stable_order`), so that the
check gives the same answer on every run. Times are CUDA-event medians
over launches, with L2 flushed before each.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SCALE = 14                 # product-sim's default scale
PAPER_BATCH = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
REPS = 30
DEVICE = "cuda"
# K5 and the embedding path: ogbn-mag's 1,134,649 authors, whose
# featureless rows get learnable embeddings, at configs/rgcn.py's in_dim
EMB_ROWS, EMB_DIM = 1_134_649, 128
K5_ROWS = 100_000
# pushes of the embedding path, each about the input rows of one RGCN
# batch of 1000 at fanouts 25/15
EMB_PUSHES, EMB_IDS = 4, 250_000
# K6: ogbn-products' nodes and feature width (product-sim mimics it), and
# the padded layer-0 input rows of one paper batch (PERF.md section 4)
K6_TABLE_ROWS, K6_WIDTH, K6_ROWS = 2_449_029, 100, 1_056_000

K1 = "src/repro/kernels/fused_gather_aggregate/kernel.py:58"
K2 = "src/repro/kernels/segment_sum/kernel.py:55"
K3 = "src/repro/kernels/fused_edge_softmax_aggregate/kernel.py:63"
K4 = "src/repro/kernels/edge_softmax/kernel.py:69"
CSRC = "src/repro_torch/csrc/"
# report name -> the wrapper whose count it reads, its source, the TPU
# kernel it replaces, and the main paths that launch it there
KERNELS = {
    "fused_gather_aggregate": dict(
        wrapper="fused_gather_aggregate",
        source=CSRC + "fused_gather_aggregate.cu", replaces=K1,
        paths=("serving", "train_graphsage", "train_recover",
               "serving_rgcn", "train_rgcn", "recover_rgcn", "train_lp",
               "train_lp_rgcn", "recover_lp", "offline_graphsage",
               "offline_rgcn")),
    # K2 as `_degrees` (F = 1), as the GAT step's logit gradients (F = 2,
    # keyed by source and by destination), and as the gradients of the
    # link-prediction head's gathers (F = the embedding width)
    "segment_sum": dict(
        wrapper="segment_sum", source=CSRC + "segment_sum.cu",
        replaces=K2, paths=("serving", "train_graphsage", "train_recover",
                            "serving_rgcn", "train_rgcn", "recover_rgcn",
                            "train_lp", "train_lp_rgcn", "recover_lp",
                            "offline_graphsage", "offline_rgcn",
                            "lm_train")),
    "segment_sum_gat": dict(
        wrapper="segment_sum", source=CSRC + "segment_sum.cu",
        replaces=K2, paths=("train_gat", "train_lp_gat")),
    "fused_gather_aggregate_bwd": dict(
        wrapper="src_scatter", source=CSRC + "src_scatter.cu", replaces=K1,
        paths=("train_graphsage", "train_recover", "train_rgcn",
               "recover_rgcn", "train_lp", "train_lp_rgcn", "recover_lp")),
    "edge_softmax_stats": dict(
        wrapper="edge_softmax_stats", source=CSRC + "edge_softmax.cu",
        replaces=K4, paths=("train_gat", "train_lp_gat", "offline_gat")),
    "edge_softmax_norm": dict(
        wrapper="edge_softmax_norm", source=CSRC + "edge_softmax.cu",
        replaces=K4, paths=("train_gat", "train_lp_gat")),
    "fused_edge_softmax_aggregate": dict(
        wrapper="fused_edge_softmax_aggregate",
        source=CSRC + "fused_edge_softmax_aggregate.cu", replaces=K3,
        paths=("train_gat", "train_lp_gat", "offline_gat")),
    "fused_edge_softmax_aggregate_bwd": dict(
        wrapper="fused_edge_softmax_aggregate_bwd",
        source=CSRC + "fused_edge_softmax_aggregate.cu", replaces=K3,
        paths=("train_gat", "train_lp_gat")),
    "fused_edge_softmax_aggregate_bwd_h": dict(
        wrapper="src_scatter", source=CSRC + "src_scatter.cu", replaces=K3,
        paths=("train_gat", "train_lp_gat")),
    "sparse_adam": dict(
        wrapper="sparse_adam", source=CSRC + "sparse_adam.cu",
        replaces="src/repro/kernels/sparse_adam/kernel.py:72",
        paths=("embedding",)),
    # no path of the system gathers rows with K6 (the JAX package's tests
    # and micro-benchmark call it); it is held in the kernels phase
    "gather_rows": dict(
        wrapper="gather_rows", source=CSRC + "gather_rows.cu",
        replaces="src/repro/kernels/gather/kernel.py:29", paths=()),
}
TRAIN_BATCH = 128
# the typed paths: RGCN at full width on mag-hetero; training at batch 32,
# where each relation's layer-0 projection of the stacked step is S x
# 197,152 x 1024 floats (3.2 GB), and K1's backward writes as many
RGCN_SERVE_SCALE, RGCN_TRAIN_SCALE, RGCN_TRAIN_BATCH = 14, 12, 32
RGCN_TRAIN = ["--arch", "rgcn", "--dataset", "mag-hetero", "--hetero",
              "--scale", str(RGCN_TRAIN_SCALE), "--batch-size",
              str(RGCN_TRAIN_BATCH)]
# link prediction: GraphSAGE + dot at the paper's widths, 32 positive
# edges a trainer with 16 uniform negatives each (576 endpoint seeds); typed
# RGCN + distmult with exclusion, 8 edges x 2 negatives (32 seeds, the
# node batch of train_rgcn); the evaluation ranks 49 negatives a positive
LP_BATCH, LP_NEGS = 32, 16
LP_TRAIN = ["--arch", "graphsage", "--task", "link_prediction",
            "--dataset", "product-sim", "--batch-size", str(LP_BATCH),
            "--num-negs", str(LP_NEGS)]
LP_RGCN_TRAIN = ["--arch", "rgcn", "--dataset", "mag-hetero", "--hetero",
                 "--task", "link_prediction", "--score-fn", "distmult",
                 "--neg-exclude", "--scale", "5", "--batch-size", "8",
                 "--num-negs", "2"]
LP_GAT_TRAIN = ["--arch", "gat"] + LP_TRAIN[2:] + ["--scale", "7"]
# the offline layer-wise pass: GraphSAGE and GAT on product-sim scale 12
# (4,096 nodes, max in-degree 1,164: 74,560 source rows a chunk of 64),
# GraphSAGE's bytes held across three chunk sizes; typed RGCN at hidden
# 1024 on mag-hetero scale 10 (2,580 nodes, in-degrees up to 2,051 /
# 9 / 752 / 1 by relation: 45,024 source rows a chunk of 16)
OFFLINE_SCALE, OFFLINE_CHUNKS = 12, (64, 16, 7)
RGCN_OFFLINE_SCALE, RGCN_OFFLINE_CHUNK = 10, 16
OFFLINE_CHECK_NODES = 16
# the LM serving path: smoke-width parity (batch, prompt, decode steps),
# llama3-8b in float32 at full width, and the launcher at full width in
# bfloat16; decode against the full forward within the bound of
# tests/test_lm_archs.py
LM_SMOKE = (2, 24, 4)
LM_F32_ARCHS, LM_F32_SHAPE = ("llama3-8b", "mamba2-2.7b", "zamba2-7b"), (2, 64)
# batch, prompt, generated tokens (32 until lm_train joined the smoke:
# 16 keeps the whole inside its time limit)
LM_SERVE = (4, 64, 16)
LM_TOO_LARGE = ("qwen3-moe-235b-a22b",)
# (c) leaves qwen3-32b out to keep the whole smoke inside its time limit
# once lm_train runs: 61 GB of weights and the slowest decode (about 12 s
# of the phase); qwen3-8b runs its family (dense, GQA, qk-norm), and
# lm_train runs qwen3-32b at its published width
LM_SERVE_LEFT_OUT = ("qwen3-32b",)
LM_PROFILED = ("llama3-8b", "granite-moe-3b-a800m")
LM_DECODE_BOUND = 5e-3
# (c)'s bfloat16 decode against the full forward in units of u = 2^-8:
# (largest difference over max |forward|, mean over mean |forward|) for
# each id, 1.5 times what an H100 showed, rounded up. These are rounding,
# not faults: the same pairs in float32 ((b), with mamba2-2.7b and
# zamba2-7b) agree within 7e-5 of max |logit|. Random weights let
# bfloat16's rounding grow over the depth; mamba2-2.7b's 64 SSM layers
# take its logits to 240 and its decode to 28% of them on average.
# the LM training path: (a) smoke width, every id, float32, card vs CPU
# (batch, sequence, steps; qwen2-0.5b once more at 4 microbatches of 2
# rows); (b) the launcher at full width in bfloat16 for the ids whose
# parameters, gradients and float32 moments fit one card whole; (c) the
# others at their published widths, num_layers cut until 12 bytes a
# parameter fit LM_CUT_BYTES (a hybrid keeps one super-block); (d) two
# 3-step launcher runs bitwise equal, and a bfloat16 step against the
# float32 one in units of u = 2^-8
LM_TRAIN_SMOKE = (2, 24, 3)
LM_TRAIN_FULL = ("qwen2-0.5b", "whisper-base", "mamba2-2.7b",
                 "granite-moe-3b-a800m")
LM_TRAIN_ARGV = ["--batch-size", "4", "--seq-len", "256", "--steps", "20"]
LM_TRAIN_CUT = ("llama3-8b", "qwen3-8b", "qwen3-32b", "pixtral-12b",
                "zamba2-7b", "qwen3-moe-235b-a22b")
LM_CUT_BYTES = 48e9
LM_TRAIN_PROFILED = ("qwen2-0.5b", "granite-moe-3b-a800m")
BF16_OPS_PER_S = 989e12    # H100 SXM dense bfloat16, published
# (loss, grad_norm) of one bfloat16 step against float32: 1.5 times what
# an H100 showed (0.091 u and 0.436 u), rounded up
LM_BF16_STEP_BOUND_U = (0.2, 0.7)
LM_BF16_BOUND_U = {"zamba2-7b": (57, 48), "qwen3-32b": (22, 20),
                   "llama3-8b": (15, 13), "whisper-base": (3.3, 2.8),
                   "mamba2-2.7b": (155, 110),
                   "granite-moe-3b-a800m": (13, 13), "qwen2-0.5b": (11, 10),
                   "pixtral-12b": (18, 15), "qwen3-8b": (17, 15)}


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


@contextlib.contextmanager
def stable_order(torch):
    """Compute the plain versions that a kernel is held against with
    PyTorch's deterministic algorithms: ``index_add_`` on the card then
    sums each row's terms in the stable sorted order of its index, not
    with atomics in an order that changes from run to run. Where hundreds
    of unit-scale terms nearly cancel (K1's backward at layer 0, a source
    row read by hundreds of edges), two orders differ by more than the
    1e-5 tolerance (5.3e-5 seen), and the check would pass or fail by
    chance. The tolerance stays as stated."""
    was_on = torch.are_deterministic_algorithms_enabled()
    was_warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was_on, warn_only=was_warn_only)


def max_degree(torch, keys) -> int:
    """The most live edges any one key holds (0 for none)."""
    return int(torch.bincount(keys.long()).max()) if keys.numel() else 0


def check_close(torch, got, want, rtol, atol, what) -> None:
    close = torch.isclose(got.float(), want.float(), rtol=rtol, atol=atol)
    if bool(close.all()):
        return
    bad = (~close).nonzero()
    first = tuple(int(i) for i in bad[0])
    require(False, f"{what}: kernel disagrees with its plain version "
                   f"(max abs err {max_err(torch, got, want):.3e}, "
                   f"rtol={rtol}, atol={atol}; {bad.shape[0]} elements "
                   f"outside, the first at {first}: {float(got[first])!r} "
                   f"against {float(want[first])!r})")


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
        for fn, resources in _cuda.kernel_resources(info["log"]).items():
            log(f"[build] {name}: {fn}: {resources}")
    for name in _cuda.KERNELS:
        _cuda.load(name)


def sample_paper_batch(g, cfg):
    """One real batch at the paper's config, featurized on the host."""
    import numpy as np

    from repro_torch.core.pipeline.minibatch import host_blocks
    from repro_torch.core.sampler import (DistributedSampler,
                                          sample_ego_networks)

    sampler = DistributedSampler(g.book, g.partitions, cfg.fanouts,
                                 cfg.batch_size, machine=g.machine,
                                 transport=None, seed=0)
    seeds = np.random.default_rng(0).choice(g.num_nodes(), cfg.batch_size,
                                            replace=False)
    mb = next(sample_ego_networks(sampler, g.new_client(), g.feat_name,
                                  seeds, drop_last=False))
    return {"input_feats": mb.input_feats, "blocks": host_blocks(mb)}


def k1_case(torch, label, h, block, num_dst, groups, results):
    from repro_torch.kernels import (fused_gather_aggregate_cuda,
                                     fused_gather_aggregate_ref)

    es, ed, em = block["edge_src"], block["edge_dst"], block["edge_mask"]
    out1 = fused_gather_aggregate_cuda(h, es, groups)
    out2 = fused_gather_aggregate_cuda(h, es, groups)
    with stable_order(torch):
        plain = fused_gather_aggregate_ref(h, es, ed, em, num_dst)
    torch.cuda.synchronize()
    what = f"fused_gather_aggregate {label}"
    require(torch.equal(out1, out2), f"{what}: two runs differ")
    check_close(torch, out1, plain, 1e-5, 1e-5, what)
    require(torch.equal(out1, plain), f"{what}: not bitwise the plain "
                                      f"version's sum in the stable order")

    live = em.nonzero().squeeze(1)
    v, f = h.shape
    e = es.numel()
    # library yardstick: one cuSPARSE CSR x dense product computing the
    # same function (duplicate edges summed into counts)
    a = torch.sparse_coo_tensor(
        torch.stack([ed[live].long(), es[live].long()]),
        torch.ones(live.numel(), device=DEVICE), (num_dst, v)
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


def require_exact_sum(torch, got, plain, msg, keys, mask, num_groups, what):
    """K2 sums every group in float32 from 0, one edge at a time in the
    stable order: in float32 its output is bitwise the plain version's
    under ``stable_order``; in bfloat16, bitwise the plain version's
    float32 sum rounded once (the bfloat16 plain version rounds after
    every add, so it is held within the bfloat16 tolerance instead)."""
    from repro_torch.kernels import segment_sum_ref

    if msg.dtype != torch.float32:
        with stable_order(torch):
            plain = segment_sum_ref(msg.float(), keys, mask,
                                    num_groups).to(msg.dtype)
    require(torch.equal(got, plain), f"{what}: not bitwise the plain "
                                     f"version's sum in the stable order")


def k2_case(torch, label, msg, block, num_dst, groups, results, rtol, atol):
    from repro_torch.kernels import segment_sum_cuda, segment_sum_ref

    ed, em = block["edge_dst"], block["edge_mask"]
    out1 = segment_sum_cuda(msg, groups)
    out2 = segment_sum_cuda(msg, groups)
    with stable_order(torch):
        plain = segment_sum_ref(msg, ed, em, num_dst)
    torch.cuda.synchronize()
    what = f"segment_sum {label}"
    require(torch.equal(out1, out2), f"{what}: two runs differ")
    check_close(torch, out1, plain, rtol, atol, what)
    require_exact_sum(torch, out1, plain, msg, ed, em, num_dst, what)

    e, f = msg.shape
    isz = msg.element_size()
    n_live = int(em.sum())
    # library yardstick: one index_add_ over the masked keys, padded
    # edges sent to a spare row
    keys = ed.long().masked_fill(~em, num_dst)
    lib_out = torch.zeros((num_dst + 1, f), dtype=msg.dtype, device=DEVICE)
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


def k1_bwd_case(torch, label, h, block, num_dst, groups, on_path,
                results):
    """K1's backward, the source-keyed kernel with weight 1: through
    autograd against autograd through the plain version, and alone."""
    from repro_torch.kernels import (fused_gather_aggregate,
                                     fused_gather_aggregate_ref, src_groups,
                                     src_scatter_cuda, src_scatter_ref)

    es, ed, em = block["edge_src"], block["edge_dst"], block["edge_mask"]
    v, f = h.shape
    hg = h.detach().requires_grad_()
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    grad_out = torch.randn((num_dst, f), generator=gen, device=DEVICE)
    (got,) = torch.autograd.grad(fused_gather_aggregate(
        hg, es, ed, em, num_dst, impl="cuda", groups=groups), hg, grad_out)
    with stable_order(torch):
        plain_out = fused_gather_aggregate_ref(hg, es, ed, em, num_dst)
        (want,) = torch.autograd.grad(plain_out, hg, grad_out,
                                      retain_graph=True)
        plain_scatter = src_scatter_ref(grad_out, es, ed, em, v)
    by_src = src_groups(es, em, v)
    out1 = src_scatter_cuda(grad_out, ed, by_src)
    out2 = src_scatter_cuda(grad_out, ed, by_src)
    torch.cuda.synchronize()
    what = f"fused_gather_aggregate backward {label}"
    require(torch.equal(out1, out2) and torch.equal(out1, got),
            f"{what}: two runs differ")
    check_close(torch, got, want, 1e-5, 1e-5, what)
    check_close(torch, out1, plain_scatter, 1e-5, 1e-5,
                what + " (plain version)")

    live = em.nonzero().squeeze(1)
    # library yardstick: one cuSPARSE CSR x dense product with the
    # transposed (source x destination) live-edge matrix
    at = torch.sparse_coo_tensor(
        torch.stack([es[live].long(), ed[live].long()]),
        torch.ones(live.numel(), device=DEVICE), (v, num_dst)
    ).coalesce().to_sparse_csr()
    # the least the function moves: the mask of every slot, both indices
    # of every live edge, each gradient row a live edge reads once, and
    # the whole output (V x F, zeros included)
    n_ref_rows = int(torch.unique(ed[live]).numel())
    nbytes = (es.numel() + live.numel() * 8 + n_ref_rows * f * 4
              + v * f * 4)
    bound_ms, bound_by = bound(nbytes, live.numel() * f)
    case = {
        "case": f"K1 backward {label}", "V": v, "F": f, "E": es.numel(),
        "E_live": int(live.numel()), "num_dst": num_dst,
        "max_src_degree": max_degree(torch, es[live]), "on_path": on_path,
        "kernel_ms": cuda_ms(torch, lambda: src_scatter_cuda(grad_out, ed,
                                                             by_src)),
        "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            plain_out, hg, grad_out, retain_graph=True)),
        "library_ms": cuda_ms(torch, lambda: torch.sparse.mm(at, grad_out)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "max_abs_err": max_err(torch, got, want),
    }
    results.append(case)
    log(f"[kernels] {json.dumps(case)}")


def layer_cases(torch, tag, batch, caps, params, general=False,
                backward=False) -> dict:
    """K1, and K2 as ``_degrees``, on every layer of one staged batch
    (with or without the stack axis, flattened as ``sage_layer`` flattens
    it), each layer's input from the plain forward; with ``general``, K2
    in its general form on layer 0's edges too; with ``backward``, K1's
    backward on every layer (training runs it on layers 1 and 2: layer 0's
    input is features)."""
    from repro_torch.kernels import dst_groups
    from repro_torch.models.gnn import sage_layer
    from repro_torch.models.gnn.layers import _flat_edges

    results = {"fused_gather_aggregate": [], "segment_sum": [],
               "fused_gather_aggregate_bwd": []}
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
        if backward:
            k1_bwd_case(torch, label, hs.reshape(s * v, f), flat, n, groups,
                        layer > 0, results["fused_gather_aggregate_bwd"])
        if general and layer == 0:
            gen = torch.Generator(device="cuda").manual_seed(0)
            msg = torch.randn((ed.numel(), 256), generator=gen,
                              device="cuda")
            k2_case(torch, f"general F=256 float32 {label}", msg, flat, n,
                    groups, [], 1e-5, 1e-5)
            k2_case(torch, f"general F=256 bfloat16 {label}",
                    msg.to(torch.bfloat16), flat, n, groups, [], 0.1, 0.5)
            del msg
        with torch.no_grad():
            h = sage_layer(params["layers"][layer], h, block, caps[layer],
                           activation=torch.relu, impl="ref")
    return results


def rgcn_cases(torch, tag, batch, cfg, params, etype_id,
               backward=False) -> dict:
    """K1 and K2 as ``_degrees`` on every relation of every layer of one
    staged RGCN batch (each relation's edges cut and flattened as
    ``rgcn_layer`` cuts them, its input the relation's projection of the
    layer's input from the plain forward); with ``backward``, K1's
    backward on each too (training runs it at both layers: layer 0's
    projections need a gradient for ``w_rel``)."""
    from repro_torch.kernels import dst_groups
    from repro_torch.models.gnn import rgcn_layer
    from repro_torch.models.gnn.layers import _dense, rgcn_relation_edges

    results = {"fused_gather_aggregate": [], "segment_sum": [],
               "fused_gather_aggregate_bwd": []}
    caps = cfg.dst_caps()
    offsets = cfg.layer_rel_offsets(etype_id)
    h = batch["input_feats"]
    h = h if h.dim() == 3 else h[None]
    for layer, block in enumerate(batch["blocks"]):
        s, v, _ = h.shape
        n = s * caps[layer]
        p = params["layers"][layer]
        for r in range(cfg.num_rels):
            edges = rgcn_relation_edges(block, s, v, caps[layer], r,
                                        offsets[layer])
            if edges is None:
                continue
            es, ed, em = edges
            flat = {"edge_src": es, "edge_dst": ed, "edge_mask": em}
            with torch.no_grad():
                proj = _dense(h, p["w_rel"][r]).reshape(s * v, -1)
            groups = dst_groups(ed, em, n)
            label = f"{tag} layer {layer} relation {r}"
            k1_case(torch, label, proj, flat, n, groups,
                    results["fused_gather_aggregate"])
            deg = k2_case(torch, f"degrees {label}",
                          em.to(torch.float32)[:, None], flat, n, groups,
                          results["segment_sum"], 0.0, 0.0)
            require(bool((deg == deg.round()).all()),
                    f"degrees {label} are not integers")
            if backward:
                k1_bwd_case(torch, label, proj, flat, n, groups, True,
                            results["fused_gather_aggregate_bwd"])
            del proj, groups
        with torch.no_grad():
            h = rgcn_layer(p, h, block, caps[layer], cfg.num_rels,
                           activation=torch.relu, impl="ref",
                           rel_offsets=offsets[layer])
    return results


def _plain_stats(torch, scores, ed, em, n):
    """K4's statistics as the plain version computes them: the masked max
    (0 for a destination with no live edge) and the denominator."""
    s = torch.where(em[:, None], scores, -1e30)
    m = torch.full((n, s.shape[1]), -1e30, device=s.device).scatter_reduce(
        0, ed.long()[:, None].expand_as(s), s, "amax")
    m = torch.where(m <= -5e29, 0.0, m)
    ex = torch.where(em[:, None], torch.exp(s - m[ed.long()]), 0.0)
    return m, torch.zeros_like(m).index_add_(0, ed.long(), ex)


def gat_cases(torch, tag, batch, caps, params, backward=True) -> dict:
    """K4 (statistics, normalize), K3's forward and, with ``backward``,
    K3's backward (into the scores, and into h_proj through the
    source-keyed kernel) and K2 as the logits' gradients on every GAT
    layer of one staged batch, each layer's input from the plain forward.
    The backward is held against ``torch.autograd.grad`` through the plain
    version."""
    import torch.nn.functional as F

    from repro_torch.kernels import (
        dst_groups, edge_softmax_norm_cuda, edge_softmax_ref,
        edge_softmax_stats_cuda, fused_edge_softmax_aggregate,
        fused_edge_softmax_aggregate_bwd_cuda,
        fused_edge_softmax_aggregate_cuda, fused_edge_softmax_aggregate_ref,
        src_groups, src_scatter_cuda)
    from repro_torch.models.gnn import gat_layer
    from repro_torch.models.gnn.layers import gat_attention_inputs

    names = ("edge_softmax_stats", "edge_softmax_norm",
             "fused_edge_softmax_aggregate",
             "fused_edge_softmax_aggregate_bwd",
             "fused_edge_softmax_aggregate_bwd_h", "segment_sum_gat")
    results = {k: [] for k in names}
    h = batch["input_feats"]
    last = len(batch["blocks"]) - 1
    for layer, block in enumerate(batch["blocks"]):
        p = params["layers"][layer]
        with torch.no_grad():
            hp, el, er, es, ed, em = gat_attention_inputs(p, h, block,
                                                          caps[layer])
            scores = F.leaky_relu(el[es.long()] + er[ed.long()], 0.2)
        v, heads, d_h = hp.shape
        f = heads * d_h
        e = es.numel()
        n = er.shape[0]
        by_dst = dst_groups(ed, em, n)
        by_src = src_groups(es, em, v)
        label = f"{tag} layer {layer}"
        live = em.nonzero().squeeze(1)
        e_live = int(live.numel())
        n_dst_live = int(torch.unique(ed[live]).numel())
        n_src_rows = int(torch.unique(es[live]).numel())
        idx_bytes = e + e_live * 8            # mask of every slot, indices
        gen = torch.Generator(device="cuda").manual_seed(2)
        grad_out = torch.randn((n, f), generator=gen, device="cuda")

        # K4: statistics, then normalize
        m1, z1 = edge_softmax_stats_cuda(scores, by_dst)
        m2, z2 = edge_softmax_stats_cuda(scores, by_dst)
        a1 = edge_softmax_norm_cuda(scores, ed, em, m1, z1)
        a2 = edge_softmax_norm_cuda(scores, ed, em, m2, z2)
        with stable_order(torch):
            pm, pz = _plain_stats(torch, scores, ed, em, n)
            plain_alpha = edge_softmax_ref(scores, ed, em, n)
        torch.cuda.synchronize()
        require(torch.equal(m1, m2) and torch.equal(z1, z2)
                and torch.equal(a1, a2), f"K4 {label}: two runs differ")
        check_close(torch, m1, pm, 0.0, 0.0, f"K4 statistics max {label}")
        check_close(torch, z1, pz, 1e-5, 1e-5,
                    f"K4 statistics denominator {label}")
        check_close(torch, a1, plain_alpha, 1e-5, 1e-5, f"K4 {label}")
        # library yardstick for K4 as a whole (statistics and normalize):
        # one torch.sparse.softmax over a hybrid COO tensor (num_dst, E, H)
        # keyed by (destination, edge id), built outside the timed region
        # (the port never calls it)
        x = torch.sparse_coo_tensor(torch.stack([ed[live].long(), live]),
                                    scores[live], (n, e, heads)).coalesce()
        try:
            lib_out = torch.sparse.softmax(x, 1)
        except RuntimeError as exc:       # no hybrid tensors on the card
            log(f"[kernels] K4 {label}: no library yardstick: "
                f"torch.sparse.softmax refuses a hybrid COO tensor ({exc})")
            lib_ms = None
        else:
            lib_alpha = torch.zeros_like(scores)
            lib_alpha[lib_out.indices()[1]] = lib_out.values()
            check_close(torch, lib_alpha, plain_alpha, 1e-5, 1e-5,
                        f"K4 {label} library yardstick")
            lib_ms = cuda_ms(torch, lambda: torch.sparse.softmax(x, 1))
            del lib_out, lib_alpha
        del x
        stats_bytes = (e + e_live * (4 + 4 * heads) + 2 * n * heads * 4)
        add_case(results["edge_softmax_stats"], f"K4 statistics {label}",
                 dict(E=e, E_live=e_live, H=heads, num_dst=n,
                      library="torch.sparse.softmax (statistics and "
                              "normalize together)"),
                 cuda_ms(torch, lambda: edge_softmax_stats_cuda(scores,
                                                                by_dst)),
                 cuda_ms(torch, lambda: _plain_stats(torch, scores, ed, em,
                                                     n)),
                 lib_ms, bound(stats_bytes, 4 * e_live * heads),
                 max(max_err(torch, m1, pm), max_err(torch, z1, pz)))
        norm_bytes = (e + e_live * 4 + e_live * heads * 4
                      + 2 * n_dst_live * heads * 4 + e * heads * 4)
        add_case(results["edge_softmax_norm"], f"K4 normalize {label}",
                 dict(E=e, E_live=e_live, H=heads, num_dst=n,
                      library="torch.sparse.softmax (statistics and "
                              "normalize together)"),
                 cuda_ms(torch, lambda: edge_softmax_norm_cuda(
                     scores, ed, em, m1, z1)),
                 cuda_ms(torch, lambda: edge_softmax_ref(scores, ed, em, n)),
                 lib_ms, bound(norm_bytes, 3 * e_live * heads),
                 max_err(torch, a1, plain_alpha))

        # library yardstick for K3's aggregate and its backward into
        # h_proj: one cuSPARSE product with the attention weights as a
        # (num_dst*H) x (V*H) matrix, given alpha (the port never calls it)
        rows = (ed[live].long() * heads)[:, None] + torch.arange(
            heads, device="cuda")
        cols = (es[live].long() * heads)[:, None] + torch.arange(
            heads, device="cuda")
        att = torch.sparse_coo_tensor(
            torch.stack([rows.reshape(-1), cols.reshape(-1)]),
            a1[live].reshape(-1), (n * heads, v * heads)).coalesce()
        att_t = att.t().coalesce().to_sparse_csr()
        att = att.to_sparse_csr()

        # K3's forward (after the statistics)
        out1 = fused_edge_softmax_aggregate_cuda(hp, scores, es, by_dst, m1,
                                                 z1)
        out2 = fused_edge_softmax_aggregate_cuda(hp, scores, es, by_dst, m1,
                                                 z1)
        with stable_order(torch):
            plain_out = fused_edge_softmax_aggregate_ref(hp, scores, es, ed,
                                                         em, n)
        torch.cuda.synchronize()
        require(torch.equal(out1, out2), f"K3 {label}: two runs differ")
        check_close(torch, out1, plain_out, 1e-5, 1e-5, f"K3 {label}")
        check_close(torch, torch.sparse.mm(att, hp.view(v * heads, d_h)
                                           ).view(n, f), plain_out,
                    1e-5, 1e-5, f"K3 {label} library yardstick")
        fwd_bytes = (idx_bytes + e_live * heads * 4 + 2 * n * heads * 4
                     + n_src_rows * f * 4 + n * f * 4)
        add_case(results["fused_edge_softmax_aggregate"], f"K3 {label}",
                 dict(V=v, H=heads, Dh=d_h, E=e, E_live=e_live, num_dst=n),
                 cuda_ms(torch, lambda: fused_edge_softmax_aggregate_cuda(
                     hp, scores, es, by_dst, m1, z1)),
                 cuda_ms(torch, lambda: fused_edge_softmax_aggregate_ref(
                     hp, scores, es, ed, em, n)),
                 cuda_ms(torch, lambda: torch.sparse.mm(
                     att, hp.view(v * heads, d_h))),
                 bound(fwd_bytes, e_live * (2 * f + 3 * heads)),
                 max_err(torch, out1, plain_out))

        if backward:
            # K3's backward, through autograd against autograd through the
            # plain version, then each kernel alone
            hp_g = hp.detach().requires_grad_()
            sc_g = scores.detach().requires_grad_()
            got = torch.autograd.grad(fused_edge_softmax_aggregate(
                hp_g, sc_g, es, ed, em, n, impl="cuda", groups=by_dst,
                by_src=by_src), (hp_g, sc_g), grad_out)
            with stable_order(torch):
                plain_graph = fused_edge_softmax_aggregate_ref(hp_g, sc_g, es,
                                                               ed, em, n)
                want = torch.autograd.grad(plain_graph, (hp_g, sc_g), grad_out,
                                           retain_graph=True)
            ds1 = fused_edge_softmax_aggregate_bwd_cuda(grad_out, hp, out1, a1,
                                                        es, by_dst)
            ds2 = fused_edge_softmax_aggregate_bwd_cuda(grad_out, hp, out1, a1,
                                                        es, by_dst)
            dh1 = src_scatter_cuda(grad_out, ed, by_src, weights=a1)
            dh2 = src_scatter_cuda(grad_out, ed, by_src, weights=a1)
            torch.cuda.synchronize()
            require(torch.equal(ds1, ds2) and torch.equal(dh1, dh2)
                    and torch.equal(ds1, got[1])
                    and torch.equal(dh1.view_as(hp), got[0]),
                    f"K3 backward {label}: two runs differ")
            check_close(torch, got[1], want[1], 1e-5, 1e-5,
                        f"K3 backward d scores {label}")
            check_close(torch, got[0], want[0], 1e-5, 1e-5,
                        f"K3 backward d h_proj {label}")
            check_close(torch, torch.sparse.mm(
                att_t, grad_out.view(n * heads, d_h)).view_as(hp), want[0],
                        1e-5, 1e-5, f"K3 backward d h_proj {label} library "
                                    "yardstick")
            bwd_bytes = (idx_bytes + e_live * heads * 4 + 2 * n_dst_live * f * 4
                         + n_src_rows * f * 4 + e * heads * 4)
            add_case(results["fused_edge_softmax_aggregate_bwd"],
                     f"K3 backward d scores {label}",
                     dict(V=v, H=heads, Dh=d_h, E=e, E_live=e_live, num_dst=n),
                     cuda_ms(torch, lambda: fused_edge_softmax_aggregate_bwd_cuda(
                         grad_out, hp, out1, a1, es, by_dst)),
                     cuda_ms(torch, lambda: torch.autograd.grad(
                         plain_graph, sc_g, grad_out, retain_graph=True)),
                     None, bound(bwd_bytes, 2 * f * (e_live + n_dst_live)),
                     max_err(torch, got[1], want[1]))
            bwd_h_bytes = (idx_bytes + e_live * heads * 4 + n_dst_live * f * 4
                           + v * f * 4)
            add_case(results["fused_edge_softmax_aggregate_bwd_h"],
                     f"K3 backward d h_proj {label}",
                     dict(V=v, H=heads, Dh=d_h, E=e, E_live=e_live, num_dst=n,
                          max_src_degree=max_degree(torch, es[live])),
                     cuda_ms(torch, lambda: src_scatter_cuda(grad_out, ed, by_src,
                                                             weights=a1)),
                     cuda_ms(torch, lambda: torch.autograd.grad(
                         plain_graph, hp_g, grad_out, retain_graph=True)),
                     cuda_ms(torch, lambda: torch.sparse.mm(
                         att_t, grad_out.view(n * heads, d_h))),
                     bound(bwd_h_bytes, 2 * f * e_live),
                     max_err(torch, got[0], want[0]))
            del plain_graph, want, got, hp_g, sc_g, att, att_t

            # K2 as the GAT step runs it, in gather_edges' backward: the
            # gradients (E, H) of the source and the destination logits summed
            # by source row (groups of up to hundreds of edges) and by
            # destination
            msg = torch.randn((e, heads), generator=gen, device="cuda")
            for key, keys, groups, num in (("source", es, by_src, v),
                                           ("destination", ed, by_dst, n)):
                k2_case(torch, f"GAT logit gradient by {key} {label} (largest "
                               f"group {max_degree(torch, keys[live])})", msg,
                        {"edge_dst": keys, "edge_mask": em}, num, groups,
                        results["segment_sum_gat"], 1e-5, 1e-5)
            del msg
        with torch.no_grad():
            h = gat_layer(p, h, block, caps[layer],
                          activation=None if layer == last else F.elu,
                          impl="ref")
    return results


def add_case(results, label, shapes, kernel_ms, plain_ms, library_ms,
             bound_pair, err) -> None:
    case = {"case": label, **shapes, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
            "max_abs_err": err}
    results.append(case)
    log(f"[kernels] {json.dumps(case)}")


def _scatter_block(torch, rng, degrees, v, num_dst, pad):
    """A synthetic source-keyed block: ``degrees`` maps a source row to its
    live edges, each to a seeded destination; ``pad`` masked slots (src 0,
    dst 0, as ``pad_block`` pads) are mixed in; the slots are shuffled, so
    the source-grouped order is not the slot order."""
    src = np.repeat(np.array(list(degrees), dtype=np.int32),
                    list(degrees.values()))
    dst = rng.integers(0, num_dst, src.size).astype(np.int32)
    mask = np.r_[np.ones(src.size, bool), np.zeros(pad, bool)]
    src = np.r_[src, np.zeros(pad, np.int32)]
    dst = np.r_[dst, np.zeros(pad, np.int32)]
    perm = rng.permutation(src.size)
    return [torch.from_numpy(np.ascontiguousarray(a[perm])).to(DEVICE)
            for a in (src, dst, mask)]


def phase_src_scatter(torch) -> list:
    """The source-keyed kernel (K1's backward, K3's backward into h_proj)
    on synthetic blocks that put its chunk and carry bookkeeping to the
    test: one source row holding all of 100,000 live edges; rows of
    exactly C, C - 1, C + 1 and 3C edges, rows that start at a chunk
    boundary and mid-chunk; a block with no live edge; F = 100 on the
    scalar path (H = 2 heads of 50, and unweighted from an unaligned
    gradient); F = 16 with H = 2, Dh = 8; F = 1024 (RGCN's hidden width:
    8 slabs of 128 columns). Unweighted and weighted, each
    held against ``src_scatter_ref`` under ``stable_order`` within
    rtol = atol = 1e-5 (the kernel sums in the plain version's order, so
    the error is expected to be 0), rows with no live edge exactly 0, and
    two launches bitwise equal."""
    from repro_torch.kernels import (src_groups, src_scatter_cuda,
                                     src_scatter_ref)
    from repro_torch.kernels.src_scatter.kernel import CHUNK as C

    rng = np.random.default_rng(5)
    edge_degrees = [C, C - 1, 1, C + 1, 3 * C, 2, C + 1, C - 1, 3 * C, C,
                    5, 2 * C + 3]
    boundary = {r * 4 + 1: d for r, d in enumerate(edge_degrees)}
    skewed = {int(r): int(d) for r, d in enumerate(
        rng.zipf(1.6, 3000).clip(0, 900)) if d and r % 3}
    # (name, degrees by row, V, num_dst, masked slots, F, H of the
    #  weighted case, unaligned unweighted gradient)
    specs = [
        ("star", {11: 100_000}, 64, 4096, 5000, 256, 2, False),
        ("degrees C-1..3C at and off chunk boundaries", boundary,
         4 * len(edge_degrees) + 3, 300, 700, 256, 2, False),
        ("skewed", skewed, 3000, 500, 2000, 256, 2, False),
        ("no live edge", {}, 300, 40, 500, 256, 2, False),
        ("F=100 scalar", skewed, 3000, 500, 2000, 100, 2, True),
        ("F=16 H=2 Dh=8", skewed, 3000, 500, 2000, 16, 2, False),
        ("F=1024", skewed, 3000, 500, 2000, 1024, 2, False),
    ]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cases = []
    for name, degrees, v, n, pad, f, heads, unaligned in specs:
        es, ed, em = _scatter_block(torch, rng, degrees, v, n, pad)
        by_src = src_groups(es, em, v)
        offsets = by_src.offsets.cpu().numpy()
        starts = offsets[:-1][np.diff(offsets) > 0]
        if name.startswith("degrees"):
            deg = np.diff(offsets)
            require(bool(((offsets[:-1] % C == 0) & (offsets[:-1] > 0)
                          & (deg > 1)).any())
                    and bool((starts % C != 0).any())
                    and bool(np.isin([C - 1, C, C + 1, 3 * C], deg).all()),
                    "the boundary block lacks a row of degree C-1, C, C+1 "
                    "or 3C, or one starting at or off a chunk boundary")
        grad = torch.randn((n, f), generator=gen, device=DEVICE)
        w = torch.rand((es.numel(), heads), generator=gen, device=DEVICE)
        # unweighted F = 100 takes float4 columns when the gradient is
        # aligned: 4 bytes past a 16-byte boundary sends it to scalars
        g_u = (torch.empty(n * f + 1, device=DEVICE)[1:].view(n, f)
               .copy_(grad) if unaligned else grad)
        empty = torch.from_numpy(np.diff(offsets) == 0).to(DEVICE)
        for weights in (None, w):
            g = g_u if weights is None else grad
            kind = "unweighted" if weights is None else f"weighted, H={heads}"
            label = f"src_scatter {name} ({kind})"
            out1 = src_scatter_cuda(g, ed, by_src, weights)
            out2 = src_scatter_cuda(g, ed, by_src, weights)
            with stable_order(torch):
                plain = src_scatter_ref(g, es, ed, em, v, weights)
            torch.cuda.synchronize()
            require(torch.equal(out1, out2), f"{label}: two runs differ")
            check_close(torch, out1, plain, 1e-5, 1e-5, label)
            require(not bool(out1[empty].any()),
                    f"{label}: a row with no live edge is not zero")
            dh = f if weights is None else f // heads
            case = {"case": label, "V": v, "F": f, "E": es.numel(),
                    "E_live": int(em.sum()),
                    "max_src_degree": max_degree(torch, es[em]),
                    "chunk": C,
                    "float4": f % 4 == 0 and dh % 4 == 0
                    and g.data_ptr() % 16 == 0,
                    "kernel_ms": cuda_ms(torch, lambda: src_scatter_cuda(
                        g, ed, by_src, weights)),
                    "max_abs_err": max_err(torch, out1, plain)}
            cases.append(case)
            log(f"[src_scatter] {json.dumps(case)}")
    return cases


STAR_EDGES = 100_000


def _cancelling(rng, keys, mask, f, num_keys):
    """Unit-scale rows whose live ones nearly cancel within each key (the
    key's float64 mean taken off before rounding to float32): each group's
    sum is rounding noise, whose last bits depend on the order of the
    adds."""
    x = rng.standard_normal((keys.size, f))
    live = np.flatnonzero(mask)
    sums = np.zeros((num_keys, f))
    np.add.at(sums, keys[live], x[live])
    counts = np.bincount(keys[live], minlength=num_keys)[:, None]
    x[live] -= (sums / np.maximum(counts, 1))[keys[live]]
    return x.astype(np.float32)


def phase_segments(torch) -> list:
    """K2 and K1's forward on a synthetic destination-keyed block at the
    edges of their schedules: groups of 0, 1, 15, 31, 32, 33, 64 and 308
    live edges, of one less, as many and one more than each schedule's
    batch (sub-warp lanes and a lanes-across-edges batch; U rows in flight
    at each width), every other group empty, and one group of 100,000
    edges; K1 also on that run repeated past FEW_DST and past MANY_DST
    destinations (its two smaller register budgets); F = 1, 2 and 3 (K2's
    lanes across edges), 100 (float4 columns, and scalar ones from a view
    4 bytes past a 16-byte boundary), 256 and 1024 (RGCN's hidden width:
    8 column vectors a lane, and U = 1 past FEW_DST); K2 in float32 and
    bfloat16. Values are unit-scale and nearly cancel
    within each group. K1 gathers each live slot's own row (``edge_src``
    is the slot), so it sums the same values as K2, in the same order.
    Every float32 output is bitwise the plain version's computed on the
    CPU, where ``index_add_`` adds each group's edges one at a time in
    order (on the card, PyTorch's deterministic ``index_add_`` sums a
    group of 32 or more with a warp tree where F = 1, so there it is no
    sequential oracle), and equal to a second launch; K1's equals K2's;
    in bfloat16 K2 is bitwise the plain float32 sum rounded once, and
    within rtol = 0.1, atol = 0.5 of the bfloat16 plain version on the
    card on the groups of at most 64 edges (that version rounds after
    every add: on a 308-edge group of cancelling values it drifts by
    about 0.9); empty groups are exactly 0."""
    from repro_torch.kernels.fused_gather_aggregate import kernel as k1
    from repro_torch.kernels.segment_sum import kernel as k2

    rng = np.random.default_rng(6)
    edges = {k2.SUB_WARP, k2.SUB_WARP * k2.EDGE_LOADS}
    rows = {k2.row_tiling(f // vec, vec, *consts)[2]
            for f, vec in ((100, 4), (100, 1), (256, 4), (256, 1))
            for consts in [(k2.GATHER_FLOATS, k2.MAX_VECS_PER_LANE)]
            + [(gf, k1.MAX_VECS_PER_LANE) for gf in (
                k1.GATHER_FLOATS_FEW, k1.GATHER_FLOATS_MID,
                k1.GATHER_FLOATS_MANY)]}
    lengths = sorted({0, 1, 15, 31, 32, 33, 64, 308}
                     | {u + d for u in edges | rows for d in (-1, 0, 1)})
    run = [x for n in lengths for x in (n, 0)]
    cases = []
    # K1's register budget follows the launch's size: the run repeated
    # past FEW_DST and past MANY_DST destinations takes the other two
    # (K1 alone)
    for launch, reps in (("few", 1), ("mid", k1.FEW_DST // len(run) + 1),
                         ("many", k1.MANY_DST // len(run) + 1)):
        cases += _segment_cases(torch, rng, run * reps + [STAR_EDGES],
                                launch)
    return cases


def _segment_cases(torch, rng, lengths, launch) -> list:
    from repro_torch.kernels import (dst_groups, fused_gather_aggregate_cuda,
                                     fused_gather_aggregate_ref,
                                     segment_sum_cuda, segment_sum_ref)
    from repro_torch.kernels.fused_gather_aggregate import kernel as k1
    from repro_torch.kernels.segment_sum import kernel as k2

    n = len(lengths)
    dst = np.repeat(np.arange(n, dtype=np.int32), lengths)
    mask = np.r_[np.ones(dst.size, bool), np.zeros(3000, bool)]
    dst = np.r_[dst, np.zeros(3000, np.int32)]
    perm = rng.permutation(dst.size)
    dst, mask = dst[perm], mask[perm]
    host = (torch.from_numpy(dst), torch.from_numpy(mask))
    ed, em = (a.to(DEVICE) for a in host)
    slots = torch.arange(dst.size, dtype=torch.int32, device=DEVICE)
    groups = dst_groups(ed, em, n)
    short = torch.from_numpy(np.array(lengths) <= 64).to(DEVICE)
    empty = torch.from_numpy(np.array(lengths) == 0).to(DEVICE)
    log(f"[segments] {n} groups of {sorted(set(lengths))} live edges, "
        f"E={dst.size}; K1 gathers {k1.gather_floats(n)} floats a lane")

    def held(label, got, again, plain, plain_bf16=None):
        require(torch.equal(got, again), f"{label}: two runs differ")
        require(torch.equal(got.cpu(), plain),
                f"{label}: not bitwise the plain version's sum in the "
                f"stable order (max abs err "
                f"{max_err(torch, got.cpu(), plain):.3e})")
        require(not bool(got[empty].any()),
                f"{label}: a group with no live edge is not zero")
        if plain_bf16 is not None:
            check_close(torch, got[short], plain_bf16[short], 0.1, 0.5,
                        label)

    cases = []
    for f in (1, 2, 3, 100, 256, 1024):
        x = torch.from_numpy(_cancelling(rng, dst, mask, f, n)).to(DEVICE)
        views = [("aligned", x)]
        if f == 100:
            odd = torch.empty(x.numel() + 1, device=DEVICE)[1:].view(
                x.shape).copy_(x)
            views.append(("4 bytes past 16", odd))
        for where, m in views:
            runs = [("K1", lambda: fused_gather_aggregate_cuda(m, slots,
                                                               groups),
                     fused_gather_aggregate_ref(m.cpu(), slots.cpu(), *host,
                                                n))]
            if launch == "few":
                runs.append(("K2", lambda: segment_sum_cuda(m, groups),
                             segment_sum_ref(m.cpu(), *host, n)))
            if launch == "few" and where == "aligned":
                mb = m.to(torch.bfloat16)
                plain_b = segment_sum_ref(mb.float().cpu(), *host, n).to(
                    torch.bfloat16)
                with stable_order(torch):
                    plain_bb = segment_sum_ref(mb, ed, em, n)
                runs.append(("K2 bfloat16", lambda: segment_sum_cuda(
                    mb, groups), plain_b))
            outs = {}
            for kernel, fn, want in runs:
                label = f"{kernel} F={f} {where}, {n} groups"
                outs[kernel] = fn()
                again = fn()
                torch.cuda.synchronize()
                held(label, outs[kernel], again, want,
                     plain_bb if kernel == "K2 bfloat16" else None)
                case = {"case": label, "F": f, "E": dst.size,
                        "E_live": int(mask.sum()), "groups": n,
                        "schedule": (k2.schedule(f) if kernel != "K1"
                                     else "rows"),
                        "kernel_ms": cuda_ms(torch, fn),
                        "max_abs_err": max_err(torch, outs[kernel].cpu(),
                                               want)}
                cases.append(case)
                log(f"[segments] {json.dumps(case)}")
            if "K2" in outs:
                require(torch.equal(outs["K1"], outs["K2"]),
                        f"K1 and K2 F={f} {where}: the same sums differ")
        del x, views
    return cases


K3_LENGTHS = (0, 1, 31, 32, 33, 64, 308)


def phase_k3_segments(torch) -> list:
    """K3's forward and its backward into the scores on a synthetic
    destination-keyed block at the edges of their schedules: groups of 0,
    1, 31, 32, 33, 64 and 308 live edges, every other group empty, and one
    of 100,000; H = 1, 2, 8 and 12 (12 the forward only: the backward
    takes at most 8 heads) by Dh = 8, 128 and 3 (Dh = 3 on scalar columns,
    the others on float4, and H = 2, Dh = 128 also on scalar columns from
    a view 4 bytes past a 16-byte boundary); scores uniform over +-80, so
    that exp underflows inside a group. K4's statistics and normalize
    kernels give m, z and alpha as on the training path. Each output is
    held within rtol = atol = 1e-5 of the plain version on the card under
    ``stable_order`` (the forward against
    ``fused_edge_softmax_aggregate_ref``, the backward against
    ``torch.autograd.grad`` through it), equal to a second launch, empty
    groups and padded edges exactly 0."""
    from repro_torch.kernels import (
        dst_groups, edge_softmax_norm_cuda, edge_softmax_stats_cuda,
        fused_edge_softmax_aggregate_bwd_cuda,
        fused_edge_softmax_aggregate_cuda, fused_edge_softmax_aggregate_ref)
    from repro_torch.kernels.fused_edge_softmax_aggregate import kernel as k3

    rng = np.random.default_rng(7)
    lengths = [x for n in K3_LENGTHS for x in (n, 0)] + [STAR_EDGES]
    n = len(lengths)
    v = 4096
    dst = np.repeat(np.arange(n, dtype=np.int32), lengths)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    mask = np.r_[np.ones(dst.size, bool), np.zeros(3000, bool)]
    src = np.r_[src, np.zeros(3000, np.int32)]
    dst = np.r_[dst, np.zeros(3000, np.int32)]
    perm = rng.permutation(dst.size)
    es, ed, em = (torch.from_numpy(a[perm]).to(DEVICE)
                  for a in (src, dst, mask))
    groups = dst_groups(ed, em, n)
    empty = torch.from_numpy(np.array(lengths) == 0).to(DEVICE)
    e = es.numel()
    log(f"[k3_segments] {n} groups of {sorted(set(lengths))} live edges, "
        f"E={e}; {k3.GATHER_FLOATS} gathered floats a lane")
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    cases = []
    for heads in (1, 2, 8, 12):
        for d_h in (8, 128, 3):
            hp = torch.randn((v, heads, d_h), generator=gen, device=DEVICE)
            scores = (torch.rand((e, heads), generator=gen, device=DEVICE)
                      * 160 - 80)
            grad = torch.randn((n, heads * d_h), generator=gen,
                               device=DEVICE)
            views = [("aligned", hp)]
            if (heads, d_h) == (2, 128):
                views.append(("4 bytes past 16", torch.empty(
                    hp.numel() + 1, device=DEVICE)[1:].view(hp.shape)
                    .copy_(hp)))
            m, z = edge_softmax_stats_cuda(scores, groups)
            alpha = edge_softmax_norm_cuda(scores, ed, em, m, z)
            sc_g = scores.detach().requires_grad_()
            with stable_order(torch):
                plain_graph = fused_edge_softmax_aggregate_ref(
                    hp, sc_g, es, ed, em, n)
                plain_ds = (torch.autograd.grad(plain_graph, sc_g, grad)[0]
                            if heads <= k3.MAX_HEADS else None)
            plain_out = plain_graph.detach()
            del plain_graph
            for where, h_in in views:
                vec = 4 if d_h % 4 == 0 and where == "aligned" else 1
                label = f"K3 H={heads} Dh={d_h} {where}"
                fwd = lambda: fused_edge_softmax_aggregate_cuda(  # noqa: E731
                    h_in, scores, es, groups, m, z)
                out = fwd()
                again = fwd()
                torch.cuda.synchronize()
                require(torch.equal(out, again), f"{label}: two runs differ")
                check_close(torch, out, plain_out, 1e-5, 1e-5, label)
                require(not bool(out[empty].any()),
                        f"{label}: a group with no live edge is not zero")
                case = {"case": label, "kernel": "forward", "H": heads,
                        "Dh": d_h, "E": e, "groups": n,
                        "plan": k3.launch_plan(False, heads, d_h,
                                               vec == 4),
                        "kernel_ms": cuda_ms(torch, fwd, reps=3),
                        "max_abs_err": max_err(torch, out, plain_out)}
                cases.append(case)
                log(f"[k3_segments] {json.dumps(case)}")
                if plain_ds is None:
                    continue
                bwd = lambda: fused_edge_softmax_aggregate_bwd_cuda(  # noqa: E731,E501
                    grad, h_in, out, alpha, es, groups)
                ds = bwd()
                again = bwd()
                torch.cuda.synchronize()
                label = f"K3 backward d scores H={heads} Dh={d_h} {where}"
                require(torch.equal(ds, again), f"{label}: two runs differ")
                check_close(torch, ds, plain_ds, 1e-5, 1e-5, label)
                require(not bool(ds[~em].any()),
                        f"{label}: a padded edge's gradient is not zero")
                case = {"case": label, "kernel": "backward", "H": heads,
                        "Dh": d_h, "E": e, "groups": n,
                        "plan": k3.launch_plan(True, heads, d_h,
                                               vec == 4),
                        "kernel_ms": cuda_ms(torch, bwd, reps=3),
                        "max_abs_err": max_err(torch, ds, plain_ds)}
                cases.append(case)
                log(f"[k3_segments] {json.dumps(case)}")
            del hp, scores, grad, views, plain_out, plain_ds, sc_g
    return cases


K4_MAX_SHORT = 308       # groups of every length 0-308 edges


def phase_k4_segments(torch) -> list:
    """K4's statistics and normalize kernels on a synthetic
    destination-keyed block at the edges of their schedules: groups of
    every length 0-308 live edges and one of 100,000, among 3,001 padded
    slots (so that E is odd and a normalize thread takes the tail) whose
    destination is out of range (the op never indexes by a padded slot's
    destination); H = 1, 2, 8 and 12, each on the aligned route and from a
    scores view 4 bytes past a 16-byte boundary (the scalar route); scores
    uniform over +-80. m is held exactly to the plain version's max, z and
    alpha within rtol = atol = 1e-5 of the plain version computed on the
    CPU, whose ``index_add_`` sums each group one edge at a time in the
    stable order as the kernel does (on the card the deterministic
    ``index_add_`` sums a long group with a tree where H = 1, and a
    100,000-term float32 sum in one order differs from one in another by
    about 1e-5); each output equal to a second launch, empty groups m = z
    = 0 and padded slots 0. Also logs the cold-launch floor: one
    one-element op on a tensor the L2 flush has evicted, timed as the
    kernels are."""
    from repro_torch.kernels import (dst_groups, edge_softmax_norm_cuda,
                                     edge_softmax_ref,
                                     edge_softmax_stats_cuda)
    from repro_torch.kernels.edge_softmax import kernel as k4

    rng = np.random.default_rng(8)
    lengths = list(range(K4_MAX_SHORT + 1)) + [STAR_EDGES]
    n = len(lengths)
    pad = 3001
    dst = np.r_[np.repeat(np.arange(n, dtype=np.int32), lengths),
                np.full(pad, 2 ** 30, np.int32)]
    mask = np.r_[np.ones(dst.size - pad, bool), np.zeros(pad, bool)]
    perm = rng.permutation(dst.size)
    ed, em = (torch.from_numpy(a[perm]).to(DEVICE) for a in (dst, mask))
    groups = dst_groups(ed, em, n)
    empty = torch.from_numpy(np.array(lengths) == 0).to(DEVICE)
    e = ed.numel()
    # the plain versions index by every slot's destination: in range there
    cpu_ed, cpu_em = torch.where(em, ed, 0).cpu(), em.cpu()
    one = torch.zeros(1, device=DEVICE)
    floor_ms = cuda_ms(torch, lambda: one.add_(1.0))
    log(f"[k4_segments] {n} groups of 0-{K4_MAX_SHORT} and {STAR_EDGES} "
        f"live edges, E={e}; design {k4.DESIGN}; cold-launch floor (one "
        f"one-element op after the L2 flush) {floor_ms:.4f} ms")
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    cases = []
    for heads in (1, 2, 8, 12):
        scores = (torch.rand((e, heads), generator=gen, device=DEVICE)
                  * 160 - 80)
        cpu_scores = scores.cpu()
        pm, pz = (x.to(DEVICE) for x in _plain_stats(torch, cpu_scores,
                                                      cpu_ed, cpu_em, n))
        plain_alpha = edge_softmax_ref(cpu_scores, cpu_ed, cpu_em, n).to(
            DEVICE)
        for where, s in (("aligned", scores),
                         ("4 bytes past 16", torch.empty(
                             scores.numel() + 1, device=DEVICE)[1:].view(
                                 scores.shape).copy_(scores))):
            label = f"K4 H={heads} {where}"
            stats = lambda: edge_softmax_stats_cuda(s, groups)  # noqa: E731
            m, z = stats()
            m2, z2 = stats()
            norm = lambda: edge_softmax_norm_cuda(  # noqa: E731
                s, ed, em, m, z)
            alpha = norm()
            again = norm()
            torch.cuda.synchronize()
            require(torch.equal(m, m2) and torch.equal(z, z2)
                    and torch.equal(alpha, again),
                    f"{label}: two runs differ")
            check_close(torch, m, pm, 0.0, 0.0, f"{label} statistics max")
            check_close(torch, z, pz, 1e-5, 1e-5,
                        f"{label} statistics denominator")
            check_close(torch, alpha, plain_alpha, 1e-5, 1e-5,
                        f"{label} normalize")
            require(not bool(m[empty].any() or z[empty].any()),
                    f"{label}: a group with no live edge is not 0")
            require(not bool(alpha[~em].any()),
                    f"{label}: a padded slot's alpha is not 0")
            for kernel, fn, err in (
                    ("statistics", stats,
                     max(max_err(torch, m, pm), max_err(torch, z, pz))),
                    ("normalize", norm, max_err(torch, alpha,
                                                plain_alpha))):
                case = {"case": f"{label} {kernel}", "H": heads, "E": e,
                        "groups": n, "kernel_ms": cuda_ms(torch, fn,
                                                          reps=5),
                        "floor_ms": floor_ms, "max_abs_err": err}
                cases.append(case)
                log(f"[k4_segments] {json.dumps(case)}")
        del scores, cpu_scores, pm, pz, plain_alpha
    return cases


def phase_kernels(torch, g, cfg, params) -> tuple:
    """K1 (and its backward) and K2 at the paper's batch on the card, with
    the GraphSAGE weights; returns their cases and the staged batch."""
    from repro_torch.kernels.pack import device_stage

    t0 = time.perf_counter()
    batch = device_stage(sample_paper_batch(g, cfg), "cuda").unpack()
    torch.cuda.synchronize()
    log(f"[kernels] sampled, pulled and staged one batch of "
        f"{cfg.batch_size} in {time.perf_counter() - t0:.2f} s")
    return layer_cases(torch, "paper", batch, cfg.dst_caps(), params,
                       general=True, backward=True), batch


def counted(path: str, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before and
    read just after; fail unless every kernel of ``path`` launched.
    Returns (fn's result, the counts)."""
    from repro_torch.kernels import CUDA_WRAPPERS

    for w in CUDA_WRAPPERS.values():
        w.launches = 0
    out = fn()
    counts = {name: w.launches for name, w in CUDA_WRAPPERS.items()}
    log(f"[{path}] launches on the main path: {json.dumps(counts)}")
    needed = {m["wrapper"] for m in KERNELS.values() if path in m["paths"]}
    missing = sorted(w for w in needed if counts[w] == 0)
    require(not missing, f"kernels of the {path} path never launched: "
                         f"{missing}")
    return out, counts


def phase_serving(torch, world, args, path="serving") -> dict:
    """A main path through gnn_serve, counted; then ref parity and
    co-batched bytes."""
    import numpy as np

    from repro_torch.api import InferenceServer
    from repro_torch.launch import gnn_serve

    g, cfg, params = world
    summary, launches = counted(
        path, lambda: gnn_serve.run_serving(args, world=world))
    require(summary["served"] == summary["requests"],
            f"served {summary['served']} of {summary['requests']} requests")
    log(f"[{path}] p50 {summary['p50_ms']} ms, p99 {summary['p99_ms']} ms, "
        f"throughput {summary['throughput_req_s']} req/s")

    rng = np.random.default_rng(1)
    nids = rng.integers(0, g.num_nodes(), size=20)
    ref_cfg = dataclasses.replace(cfg, impl="ref")
    with InferenceServer(g, cfg, params, micro_batch_window_ms=50.0,
                         device=DEVICE) as srv:
        served = srv.predict(nids)
        alone = [srv.predict([n]) for n in nids[:6]]
        handles = [srv.submit([n]) for n in nids[:6]]
        co = [h.result(timeout=120) for h in handles]
        most = max(srv.tick_chunks)
    with InferenceServer(g, ref_cfg, params, device=DEVICE) as srv:
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
    log(f"[{path}] logits vs impl='ref' max abs err {err:.3e}; "
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
    staged = device_stage(last["tree"], DEVICE)
    log(f"[breakdown] {cfg.arch}, one tick of {capacity} chunks x "
        f"{cfg.batch_size} "
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


def phase_training(torch, path: str, argv: list) -> tuple:
    """One epoch of ``repro_torch.launch.train`` with ``argv`` on the card,
    counted, with its peak device memory; then the first step against
    ``impl="ref"``, a second identical run (bitwise-identical parameters),
    one step's breakdown from the second run's spans, and the path's
    kernels on the first step's stacked batch. Returns (launch counts,
    kernel cases)."""
    import math

    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    args = train.build_parser().parse_args(argv + ["--epochs", "1",
                                                   "--device", DEVICE])

    def run():
        _ds, tr = train.build_trainer(args)
        params0 = tree_map(lambda p: p.clone(), tr.params)
        stack, first = tr._stack, []

        def stack_keeping_first(batches):
            out = stack(batches)
            if not first:
                first.append(out)
            return out

        tr._stack = stack_keeping_first
        t0 = time.perf_counter()
        summary = train.run_gnn(args, trainer=tr)
        return tr, params0, first[0], summary, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    (tr, params0, first, summary, wall), launches = counted(path, run)
    peak = torch.cuda.max_memory_allocated()
    losses = summary["epochs"][0]["losses"]
    lp = tr.task == "link_prediction"
    if lp:
        val = summary["val_lp"]
        val_ok = (0.0 < val["mrr"] <= 1.0
                  and val["hits@1"] <= val["hits@3"] <= val["hits@10"] <= 1)
        shown = "val " + ", ".join(f"{k} {v:.4f}" for k, v in val.items()
                                   if k != "num_edges") + (
            f" over {val['num_edges']} edges x 49 negatives")
        width = (f"edge batch {tr.cfg.batch_size} x {tr.job.num_negs} "
                 f"{tr.job.neg_mode} negatives ({tr.node_cfg.batch_size} "
                 f"seeds), {tr.job.score_fn} head")
    else:
        val_ok = 0.0 <= summary["val_acc"] <= 1.0
        shown = f"val_acc {summary['val_acc']:.4f}"
        width = f"batch {tr.cfg.batch_size}"
    require(len(losses) == tr.batches_per_epoch >= 1
            and all(math.isfinite(x) for x in losses) and val_ok,
            f"{path}: losses {losses}, {shown}")
    log(f"[{path}] {tr.cfg.arch} in {tr.cfg.in_dim}, hidden "
        f"{tr.cfg.hidden_dim}, {tr.cfg.num_classes} outputs, fanouts "
        f"{list(tr.cfg.fanouts)}, {tr.num_trainers} trainers x {width}: "
        f"{len(losses)} steps, losses {losses}, {shown}, epoch "
        f"{summary['epochs'][0]['time_s']:.3f} s, run with evaluation "
        f"{wall:.3f} s; peak device memory {peak / 2**30:.3f} GiB ({peak} "
        f"bytes)")

    # the first step against the plain versions, on the same card
    loss, acc, grads = tr.loss_and_grads(first, params=params0)
    ref_loss, ref_acc, ref_grads = tr.loss_and_grads(first, params=params0,
                                                     impl="ref")
    require(float(loss) == losses[0],
            f"{path}: the first step's loss recomputed ({float(loss)!r}) "
            f"differs from the run's ({losses[0]!r})")
    check_close(torch, loss, ref_loss, 1e-4, 1e-5, f"{path} first-step loss")
    if lp:
        check_close(torch, acc, ref_acc, 1e-4, 1e-5,
                    f"{path} first-step MRR")
    errs = []
    for i, (a, b) in enumerate(zip(tree_leaves(grads),
                                   tree_leaves(ref_grads))):
        check_close(torch, a, b, 1e-4, 1e-5, f"{path} first-step grad {i}")
        errs.append(max_err(torch, a, b))
    log(f"[{path}] first step vs impl='ref': loss {float(loss):.6f} vs "
        f"{float(ref_loss):.6f}, {'MRR' if lp else 'accuracy'} "
        f"{float(acc):.6f} vs {float(ref_acc):.6f}, max grad abs err "
        f"{max(errs):.3e} over {len(errs)} tensors")

    # a second identical run ends with the same bytes
    tr2, _, _, summary2, _ = run()
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params),
                                                 tree_leaves(tr2.params)))
    require(same and summary2["epochs"][0]["losses"] == losses,
            f"{path}: two identical runs ended with different parameters "
            f"or losses")
    log(f"[{path}] a second identical run: bitwise-identical parameters "
        f"({sum(p.numel() for p in tree_leaves(tr.params))} values"
        f"{', rel_emb included' if 'rel_emb' in tr.params.get('lp', {}) else ''}"
        f") and losses")

    steps = tr2.global_step
    spans = {k: v / steps for k, v in tr2.spans_ms().items()}
    host = {k: v for k, v in spans.items() if not k.startswith("device_")}
    total = sum(host.values())
    log(f"[breakdown] {path}, one step of {tr2.num_trainers} x "
        f"{tr2.node_cfg.batch_size} seeds, mean of the second run's {steps} "
        f"steps (host clock): "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                    for k, v in host.items())
        + "; on the card (CUDA events): "
        + ", ".join(f"{k[7:]} {v:.3f} ms" for k, v in spans.items()
                    if k.startswith("device_")))
    profile_step(torch, path, tr2, first)
    # the encoder's kernels on the first step's batch, at the node batch
    # (for link prediction the endpoints of the edge batch)
    cfg = tr.node_cfg
    gnn0 = params0["gnn"] if lp else params0
    tag = "train lp" if lp else "train"
    if cfg.arch == "gat":
        cases = gat_cases(torch, tag, first, cfg.dst_caps(), gnn0)
    elif cfg.arch == "rgcn":
        cases = rgcn_cases(torch, f"{tag} rgcn", first, cfg, gnn0,
                           tr.etype_id, backward=True)
    else:
        cases = layer_cases(torch, tag, first, cfg.dst_caps(), gnn0,
                            backward=True)
    if lp:
        key = "segment_sum_gat" if cfg.arch == "gat" else "segment_sum"
        cases[key] = cases[key] + lp_head_cases(
            torch, tag, first, cfg.num_classes, tr.job.score_fn,
            cfg.num_rels)
    del tr, tr2, first, grads, ref_grads
    torch.cuda.empty_cache()
    return launches, cases


def profile_step(torch, path: str, tr, stacked) -> None:
    """One more training step on ``stacked`` under ``torch.profiler``: the
    card's busy time (kernels and copies) against the step's wall time,
    and the operators that take the most host and device time."""
    from repro_torch.kernels import CUDA_WRAPPERS

    for w in CUDA_WRAPPERS.values():
        w.launches = 0
    tr.train_step(stacked)                       # warm
    torch.cuda.synchronize()
    log(f"[profile] {path}: launches in one step: " + json.dumps(
        {n: w.launches for n, w in CUDA_WRAPPERS.items() if w.launches}))
    profiled(torch, path, "one step (stacked batch already staged)",
             lambda: tr.train_step(stacked))


def profiled(torch, path: str, what: str, fn) -> None:
    """``fn`` under ``torch.profiler``: the card's busy time (kernels and
    copies) against the wall time, and the operators that take the most
    host and device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def on_card(e):
        return e.device_type == DeviceType.CUDA

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    # kernels and copies run on one stream, so their times add up
    device_events = [e for e in prof.events() if on_card(e)]
    busy_ms = sum(e.time_range.elapsed_us() for e in device_events) / 1e3
    log(f"[profile] {path}: {what} {wall_ms:.3f} ms wall, the card busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; idle "
        f"{100 - 100 * busy_ms / wall_ms:.1f}%) over "
        f"{len(device_events)} kernels and copies")
    events = prof.key_averages()
    top_dev = sorted((e for e in events if on_card(e)), key=dev_ms,
                     reverse=True)[:10]
    log(f"[profile] {path}: most device time: " + "; ".join(
        f"{e.key[:60]} {dev_ms(e):.3f} ms x{e.count}" for e in top_dev))
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:12]
    log(f"[profile] {path}: most host time (self): " + "; ".join(
        f"{e.key[:60]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}"
        for e in top_cpu))


# ---------------------------------------------------------------------------
# slice 3: sparse embeddings (K5), the row gather (K6), recovery
# ---------------------------------------------------------------------------

def _adam_numpy(w, m, v, rows, g, bc1, bc2, cfg) -> None:
    """The NumPy float32 expressions of ``repro/kernels/sparse_adam/
    ref.py``, in place on host tables; bc1/bc2 are (R, 1)."""
    m[rows] = cfg["beta1"] * m[rows] + (1 - cfg["beta1"]) * g
    v[rows] = cfg["beta2"] * v[rows] + (1 - cfg["beta2"]) * g * g
    mhat = m[rows] / bc1
    vhat = v[rows] / bc2
    w[rows] -= (cfg["lr"] * mhat / (np.sqrt(vhat) + cfg["eps"])
                ).astype(w.dtype)


def phase_sparse_adam(torch, n=EMB_ROWS, d=EMB_DIM, r=K5_ROWS,
                      steps=3) -> list:
    """K5 at table scale: three successive steps of ``r`` unique seeded
    rows of an (n, d) table on the card, each bitwise against the plain
    version on the card, against the NumPy expressions on host copies,
    and against a second launch from the same state; untouched rows keep
    their bytes. Then the kernel's time, the plain version's, one
    ``torch.optim.SparseAdam.step`` over the same rows (a time yardstick
    only: it scales eps by the square root of the bias correction, so it
    is not the same function bit for bit) and the bound."""
    from repro_torch.kernels import sparse_adam_cuda, sparse_adam_ref

    cfg = dict(beta1=0.9, beta2=0.999, lr=1e-2, eps=1e-8)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    w = torch.randn((n, d), generator=gen, device=DEVICE)
    m = torch.randn((n, d), generator=gen, device=DEVICE) * 0.1
    v = torch.rand((n, d), generator=gen, device=DEVICE) * 0.01
    plain = [x.clone() for x in (w, m, v)]
    host = [x.cpu().numpy().copy() for x in (w, m, v)]
    w0 = w.clone()
    t = np.zeros(n, dtype=np.int64)
    touched = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    rng = np.random.default_rng(13)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    for step in range(steps):
        rows = np.sort(rng.choice(n, r, replace=False))
        g = rng.standard_normal((r, d)).astype(np.float32)
        t[rows] += 1
        tr = t[rows].astype(np.float32)[:, None]
        bc1, bc2 = 1 - cfg["beta1"] ** tr, 1 - cfg["beta2"] ** tr
        args = (put(rows.astype(np.int32)), put((1 - cfg["beta1"]) * g),
                put((1 - cfg["beta2"]) * g * g), put(bc1[:, 0]),
                put(bc2[:, 0]))
        again = [x.clone() for x in (w, m, v)]
        sparse_adam_cuda(w, m, v, *args, **cfg)
        sparse_adam_cuda(*again, *args, **cfg)
        sparse_adam_ref(*plain, put(rows), put(g), put(bc1), put(bc2), **cfg)
        _adam_numpy(*host, rows, g, bc1, bc2, cfg)
        touched[put(rows)] = True
        torch.cuda.synchronize()
        what = f"sparse_adam step {step + 1}"
        require(all(torch.equal(a, b) for a, b in zip((w, m, v), again)),
                f"{what}: two runs differ")
        require(all(torch.equal(a, b) for a, b in zip((w, m, v), plain)),
                f"{what}: kernel differs from its plain version "
                f"(max abs err {max_err(torch, w, plain[0]):.3e})")
        require(all(np.array_equal(a.cpu().numpy(), b)
                    for a, b in zip((w, m, v), host)),
                f"{what}: kernel differs from the NumPy update")
        require(torch.equal(w[~touched], w0[~touched]),
                f"{what}: untouched rows changed")
        del again
    log(f"[kernels] sparse_adam: {steps} steps of {r} rows of a ({n}, {d}) "
        f"table bitwise equal to the plain version, to NumPy and to a "
        f"second launch; {int((~touched).sum())} untouched rows unchanged")

    # time the last step's update on scratch copies of the tables
    scratch = [x.clone() for x in (w, m, v)]
    kernel_ms = cuda_ms(torch, lambda: sparse_adam_cuda(*scratch, *args,
                                                        **cfg))
    rows_d, g_d = put(rows), put(g)
    bc1_d, bc2_d = put(bc1), put(bc2)
    plain_ms = cuda_ms(torch, lambda: sparse_adam_ref(
        *scratch, rows_d, g_d, bc1_d, bc2_d, **cfg))
    p = torch.nn.Parameter(scratch[0])
    opt = torch.optim.SparseAdam([p], lr=cfg["lr"], betas=(cfg["beta1"],
                                                           cfg["beta2"]),
                                 eps=cfg["eps"])
    p.grad = torch.sparse_coo_tensor(rows_d[None], g_d, (n, d))
    library_ms = cuda_ms(torch, opt.step)
    # the least traffic: each touched row of w, m, v read and written,
    # cm and cv read, and a row id and two corrections a row
    nbytes = r * d * 4 * 8 + r * 12
    case = {"case": f"K5 table scale, step {steps}", "N": n, "D": d, "R": r,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **dict(zip(
                ("bound_ms", "bound_by"), bound(nbytes, 10 * r * d))),
            "max_abs_err": max_err(torch, w, plain[0])}
    log(f"[kernels] {json.dumps(case)}")
    del w, m, v, plain, w0, scratch, p, opt, touched
    torch.cuda.empty_cache()
    return [case]


def phase_gather(torch, v=K6_TABLE_ROWS, f=K6_WIDTH, n=K6_ROWS) -> list:
    """K6 on a (v, f) table far past L2 and ``n`` seeded indices, in
    float32 with int32 and int64 indices and in bfloat16: exactly equal
    to ``table[idx]`` and to a second launch. Times of the kernel, the
    plain version, ``torch.index_select`` and the bound."""
    from repro_torch.kernels import gather_rows_cuda, gather_rows_ref

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    table = torch.randn((v, f), generator=gen, device=DEVICE)
    idx = torch.randint(0, v, (n,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    cases = []
    for tab, ix in ((table, idx), (table, idx.long()),
                    (table.to(torch.bfloat16), idx)):
        out1 = gather_rows_cuda(tab, ix)
        out2 = gather_rows_cuda(tab, ix)
        want = gather_rows_ref(tab, ix)
        torch.cuda.synchronize()
        what = f"gather_rows {tab.dtype} {ix.dtype}"
        require(torch.equal(out1, out2), f"{what}: two runs differ")
        require(torch.equal(out1, want), f"{what}: differs from table[idx]")
        nbytes = n * (ix.element_size() + 2 * f * tab.element_size())
        case = {"case": f"K6 {str(tab.dtype)[6:]} rows, "
                        f"{str(ix.dtype)[6:]} indices",
                "V": v, "F": f, "N": n,
                "kernel_ms": cuda_ms(torch, lambda: gather_rows_cuda(tab,
                                                                     ix)),
                "plain_ms": cuda_ms(torch, lambda: gather_rows_ref(tab, ix)),
                "library_ms": cuda_ms(torch, lambda: torch.index_select(
                    tab, 0, ix)),
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0))),
                "max_abs_err": max_err(torch, out1, want)}
        cases.append(case)
        log(f"[kernels] {json.dumps(case)}")
    del table, idx, out1, out2, want
    torch.cuda.empty_cache()
    return cases


class DenseAdamOracle:
    """Single-table row-sparse Adam: the exact update DistEmbedding's
    servers apply shard by shard (the float32 expressions and the
    duplicate coalescing of tests/test_embedding_oracle.py), on one dense
    NumPy table."""

    def __init__(self, w0, cfg):
        self.w = w0.copy()
        self.m = np.zeros_like(w0, dtype=np.float32)
        self.v = np.zeros_like(w0, dtype=np.float32)
        self.t = np.zeros(len(w0), dtype=np.int64)
        self.cfg = cfg

    def push(self, ids, grad) -> None:
        ids = np.asarray(ids, dtype=np.int64)
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((len(uniq), grad.shape[1]), dtype=np.float32)
        np.add.at(g, inv, grad.astype(np.float32))
        cfg, rows = self.cfg, uniq
        self.t[rows] += 1
        tr = self.t[rows].astype(np.float32)[:, None]
        self.m[rows] = cfg.beta1 * self.m[rows] + (1 - cfg.beta1) * g
        self.v[rows] = cfg.beta2 * self.v[rows] + (1 - cfg.beta2) * g * g
        mhat = self.m[rows] / (1 - cfg.beta1 ** tr)
        vhat = self.v[rows] / (1 - cfg.beta2 ** tr)
        self.w[rows] -= (cfg.lr * mhat / (np.sqrt(vhat) + cfg.eps)
                         ).astype(self.w.dtype)


def _embedding_world(n, d):
    from repro_torch.core.kvstore import (DistEmbedding, DistKVStore,
                                          PartitionPolicy)

    store = DistKVStore({"node": PartitionPolicy(
        "node", np.array([0, n // 2, n]))}, replication=2)
    return store, DistEmbedding(store, "emb", n, d, "node", seed=0,
                                device=DEVICE)


def _check_embedding(store, oracle, what) -> None:
    for suffix, want in (("", oracle.w), ("__m", oracle.m),
                         ("__v", oracle.v), ("__t", oracle.t)):
        got = store.gather_all("emb" + suffix)
        require(got.dtype == want.dtype and np.array_equal(got, want),
                f"{what}: emb{suffix} differs from the dense oracle")
        for p in range(store.num_parts):
            primary = store.servers[p].local_view("emb" + suffix)
            for h in store.replicas_of(p)[1:]:
                require(np.array_equal(store.servers[h].replica_view(
                    "emb" + suffix, p), primary),
                        f"{what}: replica {h} of emb{suffix} part {p} "
                        f"differs from its primary")


def phase_embedding(torch, n=EMB_ROWS, d=EMB_DIM, pushes=EMB_PUSHES,
                    ids_per_push=EMB_IDS) -> dict:
    """The slice's path: ``DistEmbedding.push_grad`` on the card, through
    a 2-owner KVStore with replication 2, ``pushes`` pushes from client 0
    of seeded ids with duplicates, counted; after every push the table,
    its moments and step counts byte-identical to a dense NumPy oracle,
    and every replica to its primary; K5 launched once for each owner a
    push touched. A checkpoint after push 2 restored into a fresh store
    must give the same bytes after the remaining pushes. Then where a
    push's time goes."""
    import tempfile

    from repro_torch.checkpoint import load_kvstore, save_kvstore

    t0 = time.perf_counter()
    store, emb = _embedding_world(n, d)
    oracle = DenseAdamOracle(store.gather_all("emb"), emb.optim)
    rng = np.random.default_rng(21)
    traffic = [(rng.integers(0, n, ids_per_push),
                rng.standard_normal((ids_per_push, d)).astype(np.float32))
               for _ in range(pushes)]
    log(f"[embedding] ({n}, {d}) table on 2 owners, replication 2, built "
        f"in {time.perf_counter() - t0:.2f} s; {pushes} pushes of "
        f"{ids_per_push} ids")
    client = store.client(0)
    owners, ckpt = 0, tempfile.TemporaryDirectory(prefix="chip_smoke_kv")
    warm = None

    def run():
        nonlocal owners, warm
        for i, (ids, grad) in enumerate(traffic):
            if i == 1:
                warm = dict(emb.spans)
            t1 = time.perf_counter()
            emb.push_grad(client, ids, grad)
            dt = time.perf_counter() - t1
            owners += len(np.unique(store.policy_for("emb").part_of(ids)))
            oracle.push(ids, grad)
            _check_embedding(store, oracle, f"embedding push {i + 1}")
            log(f"[embedding] push {i + 1}: {len(np.unique(ids))} unique "
                f"rows in {dt * 1e3:.3f} ms; table, moments, step counts "
                f"and replicas byte-identical to the dense oracle")
            if i == 1:
                save_kvstore(store, ckpt.name)

    try:
        _, launches = counted("embedding", run)
        require(launches["sparse_adam"] == owners,
                f"sparse_adam launched {launches['sparse_adam']} times for "
                f"{owners} owner updates")
        t1 = time.perf_counter()
        fresh, emb2 = _embedding_world(n, d)
        load_kvstore(fresh, ckpt.name)
        for ids, grad in traffic[2:]:
            emb2.push_grad(fresh.client(0), ids, grad)
        _check_embedding(fresh, oracle, "embedding restored from push 2")
        log(f"[embedding] restored the push-2 checkpoint into a fresh "
            f"store and replayed pushes 3-{pushes}: byte-identical "
            f"({time.perf_counter() - t1:.2f} s)")
    finally:
        ckpt.cleanup()
    done = pushes - 1
    spans = {k: (emb.spans[k] - warm[k]) / done * 1e3 for k in emb.spans}
    host = {k: v for k, v in spans.items() if not k.startswith("device_")}
    total = sum(host.values())
    log(f"[breakdown] embedding, one push of {ids_per_push} ids (mean of "
        f"pushes 2-{pushes}, host clock): "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                    for k, v in host.items())
        + "; on the card (CUDA events): "
        + ", ".join(f"{k[7:]} {v:.3f} ms" for k, v in spans.items()
                    if k.startswith("device_")))
    del store, emb, fresh, emb2, oracle
    return launches


def phase_recovery(torch, path: str, argv: list) -> dict:
    """Kill-and-revive through the entry point: ``repro_torch.launch.
    train`` with ``argv`` (2 epochs, checkpoints every 2 steps, a 64 MB
    cache) killed at (epoch 1, batch 2) must revive in process from the
    last checkpoint before it and end with parameters bitwise equal to the
    same command without the fault. The revived run is counted."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves

    def args(ck, *fault):
        return train.build_parser().parse_args(
            argv + ["--epochs", "2", "--cache-budget-mb", "64",
                    "--checkpoint-dir", ck, "--checkpoint-interval", "2",
                    "--device", DEVICE, *fault])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ck") as tmp:
        t0 = time.perf_counter()
        plain = train.run_gnn(args(f"{tmp}/plain"))
        t1 = time.perf_counter()
        chaos, launches = counted(path, lambda: train.run_gnn(
            args(f"{tmp}/chaos", "--inject-fault", "1:2")))
        t2 = time.perf_counter()
    # a checkpoint lands before every even global step, ahead of the death
    # check at the same boundary: the last at or before the death at (1, 2)
    bpe = plain["trainer"].batches_per_epoch
    revived_at = divmod(2 * ((bpe + 2) // 2), bpe)
    require(chaos["revived"] == [revived_at],
            f"the killed run revived from {chaos['revived']}, not from the "
            f"{revived_at} checkpoint")
    a, b = (tree_leaves(s["trainer"].params) for s in (plain, chaos))
    require(all(torch.equal(x, y) for x, y in zip(a, b)),
            "the revived run's parameters differ from the uninterrupted "
            "run's")
    log(f"[{path}] killed at (1, 2), revived from {revived_at}: "
        f"bitwise-identical parameters ({sum(x.numel() for x in a)} "
        f"values) to the uninterrupted run; runs {t1 - t0:.2f} s and "
        f"{t2 - t1:.2f} s")
    del plain, chaos
    torch.cuda.empty_cache()
    return launches


def phase_serving_rgcn(torch) -> tuple:
    """The typed serving path: ``gnn_serve --arch rgcn --dataset
    mag-hetero --hetero`` on scale 14 at its defaults, as phase 5 (counted,
    logits against ``impl="ref"``, alone against co-batched, one tick's
    spans). Returns (launch counts, K1 and K2 on the last tick for each
    relation and layer)."""
    from repro_torch.launch import gnn_serve

    args = gnn_serve.build_parser().parse_args(
        ["--arch", "rgcn", "--dataset", "mag-hetero", "--hetero", "--scale",
         str(RGCN_SERVE_SCALE), "--device", DEVICE])
    t0 = time.perf_counter()
    world = gnn_serve.build_world(args)
    g, cfg, params = world
    log(f"[serving_rgcn] mag-hetero scale {RGCN_SERVE_SCALE}: "
        f"{g.num_nodes()} nodes, {g.num_edges()} edges, relations "
        f"{list(g.schema.etypes)} (world built in "
        f"{time.perf_counter() - t0:.2f} s); RGCN in {cfg.in_dim}, hidden "
        f"{cfg.hidden_dim}, {cfg.num_classes} classes, fanouts "
        f"{list(cfg.fanouts)}, relation slots by layer "
        f"{cfg.layer_rel_offsets(g.schema.etype_id)}")
    launches = phase_serving(torch, world, args, "serving_rgcn")
    tick = phase_breakdown(torch, world, args)
    cases = rgcn_cases(torch, "tick rgcn", tick, cfg, params,
                       g.schema.etype_id)
    del world, tick
    torch.cuda.empty_cache()
    return launches, cases


def phase_rgcn_untyped(torch) -> None:
    """RGCN in the untyped layout: ``gnn_serve``'s server on mag-sim (one
    fused edge axis, each relation's sums masked by ``edge_types == r``),
    one request of 20 nodes through the kernels against ``impl="ref"``
    (rtol 1e-4, atol 1e-5); K1 and K2 must launch."""
    from repro_torch.api import InferenceServer
    from repro_torch.launch import gnn_serve

    args = gnn_serve.build_parser().parse_args(
        ["--arch", "rgcn", "--dataset", "mag-sim", "--scale",
         str(RGCN_TRAIN_SCALE), "--device", DEVICE])
    g, cfg, params = gnn_serve.build_world(args)
    nids = np.random.default_rng(4).integers(0, g.num_nodes(), size=20)

    def predict(impl):
        with InferenceServer(g, dataclasses.replace(cfg, impl=impl), params,
                             device=DEVICE) as srv:
            return srv.predict(nids, timeout=600)

    got, launches = counted("rgcn_untyped", lambda: predict("auto"))
    want = predict("ref")
    require(launches["fused_gather_aggregate"] > 0
            and launches["segment_sum"] > 0,
            "the untyped RGCN forward launched no K1 or K2")
    require(got.shape == (len(nids), cfg.num_classes)
            and bool(np.isfinite(got).all()),
            f"untyped RGCN logits have shape {got.shape} or are not finite")
    err = float(np.abs(got - want).max())
    require(bool(np.allclose(got, want, rtol=1e-4, atol=1e-5)),
            f"untyped RGCN logits disagree with impl='ref' (max abs err "
            f"{err:.3e})")
    log(f"[rgcn_untyped] mag-sim scale {RGCN_TRAIN_SCALE}, fanouts "
        f"{list(cfg.fanouts)} over {cfg.num_rels} relations: logits vs "
        f"impl='ref' max abs err {err:.3e}")


def phase_lp_heads(torch) -> None:
    """The link-prediction head on the card at ``train_lp``'s shapes (4
    trainers x 32 positive edges, embeddings of 256; 16 uniform negatives
    or in-batch draws; distmult over mag-hetero's 4 relations, one a
    slot): ``lp_pair_scores``, the BCE loss and ``lp_ranks``, for {dot,
    distmult} x {uniform, in-batch}, twice. Scores, ranks and gradients
    must be bitwise equal between the two runs (the gathers' gradients
    sum repeated rows with K2 in a fixed order: in-batch draws repeat
    destinations, and a typed batch reads one relation row B times) and
    within rtol 1e-4, atol 1e-5 of the CPU plain path; the ranks of the
    card's scores must equal the CPU's ranks of the same scores. The
    plain path on the card (``impl="ref"``, ``index_select``, whose
    backward adds with atomics) is run twice too, and whether its bits
    repeat is logged."""
    from repro_torch.kernels import CUDA_WRAPPERS
    from repro_torch.models.gnn import (lp_loss_from_scores, lp_pair_scores,
                                        lp_ranks)

    s, b, k, d, r = 4, LP_BATCH, LP_NEGS, 256, 4
    rng = np.random.default_rng(5)
    for neg_mode in ("uniform", "in-batch"):
        n = 2 * b + (0 if neg_mode == "in-batch" else b * k)
        h = rng.standard_normal((s, n, d)).astype(np.float32)
        pos_u = np.tile(np.arange(b, dtype=np.int32), (s, 1))
        if neg_mode == "in-batch":
            neg_v = (b + rng.integers(0, b, size=(s, b, k))).astype(np.int32)
        else:
            neg_v = np.broadcast_to(
                (2 * b + np.arange(b * k, dtype=np.int32)).reshape(b, k),
                (s, b, k)).copy()
        etypes = np.repeat(rng.integers(0, r, size=(s, 1)), b,
                           axis=1).astype(np.int32)
        rel_emb = (1 + 0.1 * rng.standard_normal((r, d))).astype(np.float32)
        mask = np.ones((s, b), dtype=bool)
        mask[-1, -5:] = False
        for score_fn in ("dot", "distmult"):
            def run(device, impl="auto"):
                th = torch.from_numpy(h).to(device).requires_grad_()
                rel = torch.from_numpy(rel_emb).to(device).requires_grad_()
                head = {"rel_emb": rel} if score_fn == "distmult" else {}
                kw = dict(head=head, score_fn=score_fn, impl=impl,
                          etypes=torch.from_numpy(etypes).to(device))
                u = torch.from_numpy(pos_u).to(device)
                pos = lp_pair_scores(th, u, u + b, **kw)
                neg = lp_pair_scores(th, u, torch.from_numpy(neg_v).to(
                    device), **kw)
                loss = lp_loss_from_scores(
                    pos, neg, torch.from_numpy(mask).to(device)).mean()
                grads = torch.autograd.grad(loss, (th, rel) if head
                                            else (th,))
                out = [pos.detach(), neg.detach(), lp_ranks(pos, neg),
                       loss.detach(), *grads]
                return [t.cpu() for t in out]

            what = f"lp_heads {score_fn} {neg_mode}"
            for w in CUDA_WRAPPERS.values():
                w.launches = 0
            first = run(DEVICE)
            k2 = CUDA_WRAPPERS["segment_sum"].launches
            second, plain = run(DEVICE), run("cpu")
            require(k2 == (6 if score_fn == "distmult" else 4),
                    f"{what}: K2 launched {k2} times, not once a gather")
            require(all(torch.equal(x, y) for x, y in zip(first, second)),
                    f"{what}: two runs on the card differ")
            require(torch.equal(lp_ranks(first[0], first[1]), first[2]),
                    f"{what}: the CPU's ranks of the card's scores differ")
            errs = []
            for i, (x, y) in enumerate(zip(first, plain)):
                if i == 2:
                    continue
                check_close(torch, x, y, 1e-4, 1e-5, f"{what} output {i}")
                errs.append(max_err(torch, x, y))
            ref1, ref2 = run(DEVICE, "ref"), run(DEVICE, "ref")
            same = all(torch.equal(x, y) for x, y in zip(ref1, ref2))
            ranks_equal = int((first[2] == plain[2]).sum())
            log(f"[lp_heads] {score_fn} {neg_mode}: scores (4, {b}) and (4, "
                f"{b}, {k}) at width {d}, K2 {k2} launches a run, two runs "
                f"bitwise equal; against the CPU plain path max abs err "
                f"{max(errs):.3e}, ranks equal on {ranks_equal} of "
                f"{first[2].numel()}; the card's plain path (index_select) "
                f"{'repeats its bits' if same else 'differs between runs'}")


def lp_head_cases(torch, tag, batch, width, score_fn, num_rels) -> list:
    """K2 as the gradients of the link-prediction head's gathers on one
    staged stacked batch, one case for each launch of a step in launch
    order (``lp_pair_scores`` for the positives, then the negatives: the
    rows of ``pos_u``, with distmult ``rel_emb[etypes]``, then those of
    ``pos_v`` or ``neg_v``), each keyed as ``_rows`` keys it (the stack
    slot's offset added, every key live) over gradient rows of the
    embedding width from a seeded generator; a launch repeated with the
    same keys (``pos_u``, ``rel_emb``) is timed once and listed again."""
    from repro_torch.kernels import edge_groups

    s, n = batch["seed_mask"].shape
    base = torch.arange(s, device=DEVICE) * n
    keyed = {"pos_u": (batch["pos_u"] + base[:, None], s * n, width),
             "pos_v": (batch["pos_v"] + base[:, None], s * n, width),
             "neg_v": (batch["neg_v"] + base[:, None, None], s * n, width)}
    if score_fn == "distmult":
        keyed["rel_emb"] = (batch["edge_etypes"], num_rels, width)
    order = ["pos_u", "rel_emb", "pos_v", "pos_u", "rel_emb", "neg_v"]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    timed, cases = {}, []
    for name in order:
        if name not in keyed:
            continue
        if name not in timed:
            idx, groups_n, f = keyed[name]
            keys = idx.reshape(-1).to(torch.int32)
            live = torch.ones_like(keys, dtype=torch.bool)
            grad = torch.randn((keys.numel(), f), generator=gen,
                               device=DEVICE)
            flat = {"edge_dst": keys, "edge_mask": live}
            out = []
            k2_case(torch, f"head {name} {tag}", grad, flat, groups_n,
                    edge_groups(keys, live, groups_n), out, 1e-5, 1e-5)
            timed[name] = out[0]
            del grad
        cases.append(timed[name])
    return cases


def phase_lp_batch(torch) -> dict:
    """The ``train_lp`` step's kernels on one first-step batch of a graph
    whose ego-networks do not cover it: ``train_lp``'s command on
    product-sim scale 14 (the kernels phase's graph), the trainer built and
    one stacked batch drawn, no epoch run. Scale 7's 128 nodes make most
    of the step's slots padding; here they are mostly live. Returns K1, its
    backward and K2 (as ``_degrees`` and as the head's gathers) on every
    layer, as ``phase_training`` times them."""
    from repro_torch.launch import train

    args = train.build_parser().parse_args(
        LP_TRAIN + ["--scale", str(SCALE), "--device", DEVICE])
    t0 = time.perf_counter()
    _ds, tr = train.build_trainer(args)
    try:
        first = tr._stack([next(ld.epoch(0)).model_input()
                           for ld in tr.loaders])
    finally:
        tr.stop()
    torch.cuda.synchronize()
    cfg = tr.node_cfg
    log(f"[lp_batch] product-sim scale {SCALE}: trainer built and one "
        f"stacked batch of {tr.num_trainers} x {tr.cfg.batch_size} edges x "
        f"{tr.job.num_negs} negatives ({cfg.batch_size} seeds a trainer) "
        f"drawn and staged in {time.perf_counter() - t0:.2f} s")
    cases = layer_cases(torch, "lp s14", first, cfg.dst_caps(),
                        tr.params["gnn"], backward=True)
    cases["segment_sum"] += lp_head_cases(
        torch, "lp s14", first, cfg.num_classes, tr.job.score_fn,
        cfg.num_rels)
    del tr, first
    torch.cuda.empty_cache()
    return cases


def phase_link_prediction(torch, launches: dict, extra: dict) -> None:
    """The link-prediction main paths (GraphSAGE + dot, GAT + dot, typed
    RGCN + distmult, recovery) and the score head alone, each timed; their
    launch counts go to ``launches`` and their steps' kernel cases to
    ``extra``."""
    for path, argv in (("train_lp", LP_TRAIN + ["--scale", "7"]),
                       ("train_lp_gat", LP_GAT_TRAIN),
                       ("train_lp_rgcn", LP_RGCN_TRAIN)):
        t0 = time.perf_counter()
        launches[path], extra[f"{path}_step"] = phase_training(
            torch, path, argv)
        log(f"[{path}] phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    extra["lp_step_scale14"] = phase_lp_batch(torch)
    log(f"[lp_batch] phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches["recover_lp"] = phase_recovery(
        torch, "recover_lp", LP_TRAIN + ["--scale", "6"])
    log(f"[recover_lp] phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_lp_heads(torch)
    log(f"[lp_heads] phase {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# slice 10: the offline layer-wise pass
# ---------------------------------------------------------------------------

def longest_group_node(g) -> tuple:
    """(node, relation, in-degree) of the longest full-neighbour group in
    ``g``: the node (in the partition's id space) with the most in-edges
    of one relation (relation 0 on an untyped graph)."""
    csr = g.ds.graph
    r = csr.num_etypes if g.hetero else 1
    keys = csr.indices * r + (csr.etypes if g.hetero else 0)
    deg = np.bincount(keys, minlength=csr.num_nodes * r)
    old, rel = divmod(int(deg.argmax()), r)
    return int(g.to_new_nids(np.array([old]))[0]), rel, int(deg.max())


def offline_chunk(torch, g, cfg, params, layer, nids, chunk, impl="auto"):
    """Layer ``layer`` of the pass recomputed for ``nids`` (at most
    ``chunk``) as one full-neighbour mini-batch of capacity ``chunk``:
    sampled, its inputs pulled (the features, or the pass's own previous
    tensor), staged and run as ``offline_embeddings`` runs a chunk. The
    mini-batch oracle of ``tests/test_inference.py``, one layer at a time:
    a full-neighbour forward through all layers at once would pad to
    chunk x (1 + D) ^ L source rows. Returns (the nids' rows on the host,
    the staged batch as the kernel cases take it, the layer's fanout)."""
    from repro_torch.api.inference import OFFLINE_ROW_TILE
    from repro_torch.core.pipeline.minibatch import host_blocks
    from repro_torch.core.sampler import (DistributedSampler,
                                          full_neighbor_fanouts,
                                          pull_batch_feats,
                                          sample_ego_networks)
    from repro_torch.kernels.pack import device_stage
    from repro_torch.models.gnn import apply_gnn_layer, apply_head

    schema = g.schema if g.hetero else None
    fanout = full_neighbor_fanouts(g.partitions, cfg.num_layers,
                                   schema=schema)[layer]
    sampler = DistributedSampler(
        g.book, g.partitions, [fanout], chunk, machine=g.machine,
        transport=None, seed=0, schema=schema,
        ntype_of_node=g.typed.ntype_of_node if g.hetero else None)
    client = g.new_client()
    mb = next(sample_ego_networks(sampler, client, g.feat_name,
                                  np.asarray(nids, dtype=np.int64),
                                  drop_last=False, pull_feats=False))
    if layer == 0:
        h = pull_batch_feats(client, g.feat_name, mb,
                             typed=g.typed if g.hetero else None)
    else:
        h = client.pull(f"emb{layer - 1}", mb.input_gids)
    staged = device_stage({"input_feats": h, "blocks": host_blocks(mb)},
                          DEVICE).unpack()
    rel = sampler.rel_caps[0]
    rel = None if rel is None else tuple(int(x) for x in rel)
    c = dataclasses.replace(cfg, impl=impl)
    with torch.inference_mode():
        out = apply_gnn_layer(c, params, layer, staged["input_feats"],
                              staged["blocks"][0], chunk, rel_offsets=rel,
                              row_tile=OFFLINE_ROW_TILE)
        if layer == cfg.num_layers - 1:
            out = apply_head(params, out, OFFLINE_ROW_TILE)
    return out[:len(nids)].cpu().numpy(), staged, fanout


def offline_kernel_cases(torch, path, g, cfg, params, staged, fanout,
                         layer, chunk) -> dict:
    """The pass's kernels on one staged chunk of one layer, as the
    training phases time them: K1 and K2 as ``_degrees`` (GraphSAGE; RGCN
    for each relation), K4's statistics and K3's forward (GAT). Only the
    cases of kernels that ``path`` launches are kept."""
    one = {"layers": [params["layers"][layer]]}
    tag = f"{path} pass layer {layer}:"
    if cfg.arch == "gat":
        cases = gat_cases(torch, tag, staged, [chunk], one, backward=False)
    elif cfg.arch == "rgcn":
        one_cfg = dataclasses.replace(cfg, fanouts=[fanout],
                                      batch_size=chunk)
        cases = rgcn_cases(torch, tag, staged, one_cfg, one,
                           g.schema.etype_id if g.hetero else None)
    else:
        cases = layer_cases(torch, tag, staged, [chunk], one)
    return {n: c for n, c in cases.items() if path in KERNELS[n]["paths"]}


def phase_offline_run(torch, path: str, argv: list, chunks: tuple) -> tuple:
    """One offline main path: ``gnn_serve --offline`` with ``argv`` at
    ``chunks[0]`` nodes a chunk, counted (each layer's launches logged),
    its spans and peak device memory; every layer's rows finite; 16 nodes
    (the longest group's among them) bitwise the full-neighbour mini-batch
    forward of each layer and within rtol 1e-4, atol 1e-5 of it with
    ``impl="ref"``; the pass's bytes equal at every other chunk size of
    ``chunks``; the kernels on each layer's chunk that holds the longest
    group. Returns (launch counts, kernel cases by layer)."""
    import functools

    import repro_torch.api as api
    from repro_torch.api import inference
    from repro_torch.kernels import CUDA_WRAPPERS
    from repro_torch.launch import gnn_serve

    chunk = chunks[0]
    args = gnn_serve.build_parser().parse_args(
        argv + ["--offline", "--chunk-size", str(chunk), "--device",
                DEVICE])
    t0 = time.perf_counter()
    world = gnn_serve.build_world(args)
    g, cfg, params = world
    node, rel_of_node, degree = longest_group_node(g)
    log(f"[{path}] {args.dataset} scale {args.scale}: {g.num_nodes()} "
        f"nodes, {g.num_edges()} edges (world built in "
        f"{time.perf_counter() - t0:.2f} s); {cfg.arch} in {cfg.in_dim}, "
        f"hidden {cfg.hidden_dim}, {cfg.num_classes} classes, "
        f"{cfg.num_layers} layers; the longest group: node {node}, "
        f"relation {rel_of_node}, {degree} in-edges")

    spans, by_layer = {}, []
    layer_fn = inference.apply_gnn_layer

    def layer_counted(cfg_, params_, layer, *a, **kw):
        before = {n: w.launches for n, w in CUDA_WRAPPERS.items()}
        out = layer_fn(cfg_, params_, layer, *a, **kw)
        while len(by_layer) <= layer:
            by_layer.append(dict.fromkeys(CUDA_WRAPPERS, 0))
        for n, w in CUDA_WRAPPERS.items():
            by_layer[layer][n] += w.launches - before[n]
        return out

    pass_fn = api.offline_embeddings
    api.offline_embeddings = functools.partial(pass_fn, spans=spans)
    inference.apply_gnn_layer = layer_counted
    torch.cuda.reset_peak_memory_stats()
    try:
        summary, launches = counted(
            path, lambda: gnn_serve.run_offline(args, world=world))
    finally:
        api.offline_embeddings = pass_fn
        inference.apply_gnn_layer = layer_fn
    peak = torch.cuda.max_memory_allocated()
    for layer, counts in enumerate(by_layer):
        log(f"[{path}] layer {layer} launches: " + json.dumps(
            {n: c for n, c in counts.items() if c}))
    host = {k: v for k, v in spans.items() if k != "device_forward"}
    total = sum(host.values())
    log(f"[{path}] {summary['num_nodes']} nodes x {cfg.num_layers} layers "
        f"in chunks of {chunk}: wall {summary['wall_s']} s, "
        f"{summary['nodes_per_s']} node-layers/s; spans (host clock) "
        + ", ".join(f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
                    for k, v in host.items())
        + f"; of forward, on the card (CUDA events) "
        f"{spans['device_forward']:.3f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB ({peak} bytes)")
    all_nids = np.arange(g.num_nodes(), dtype=np.int64)
    rows = [np.ascontiguousarray(g.ndata[f"emb{l}"][all_nids])
            for l in range(cfg.num_layers)]
    require(summary["layers"] == [list(r.shape) for r in rows]
            and rows[-1].shape == (g.num_nodes(), cfg.num_classes)
            and all(bool(np.isfinite(r).all()) for r in rows),
            f"{path}: layer shapes {summary['layers']} or values not finite")

    rng = np.random.default_rng(6)
    others = rng.choice(np.delete(all_nids, node),
                        min(chunk, OFFLINE_CHECK_NODES) - 1, replace=False)
    check = np.concatenate([[node], others])
    errs = []
    for layer in range(cfg.num_layers):
        got, *_ = offline_chunk(torch, g, cfg, params, layer, check, chunk)
        want, *_ = offline_chunk(torch, g, cfg, params, layer, check, chunk,
                                 impl="ref")
        require(got.tobytes() == rows[layer][check].tobytes(),
                f"{path} layer {layer}: the pass's rows of {len(check)} "
                f"nodes are not bitwise their full-neighbour mini-batch "
                f"forward's")
        check_close(torch, torch.from_numpy(got), torch.from_numpy(want),
                    1e-4, 1e-5, f"{path} layer {layer} against impl='ref'")
        errs.append(float(np.abs(got - want).max()))
    log(f"[{path}] {len(check)} nodes (the longest group's among them) "
        f"bitwise their full-neighbour mini-batch forward at every layer; "
        f"against impl='ref' max abs err by layer {errs}")

    profiled(torch, path, f"the pass once more at chunks of {chunk}",
             lambda: api.offline_embeddings(g, cfg, params, chunk_size=chunk,
                                            prefix="emb_prof_",
                                            device=DEVICE))
    for other in chunks[1:]:
        t1 = time.perf_counter()
        embs = api.offline_embeddings(g, cfg, params, chunk_size=other,
                                      prefix=f"emb_c{other}_",
                                      device=DEVICE)
        same = all(np.ascontiguousarray(e[all_nids]).tobytes()
                   == r.tobytes() for e, r in zip(embs, rows))
        require(same, f"{path}: chunks of {other} give other bytes than "
                      f"chunks of {chunk}")
        log(f"[{path}] chunks of {other}: every layer's bytes equal to "
            f"chunks of {chunk} ({time.perf_counter() - t1:.2f} s)")

    cases = {}
    first = node // chunk * chunk
    seeds = all_nids[first:first + chunk]
    for layer in range(cfg.num_layers):
        _, staged, fanout = offline_chunk(torch, g, cfg, params, layer,
                                          seeds, chunk)
        ed = staged["blocks"][0]["edge_dst"]
        em = staged["blocks"][0]["edge_mask"]
        log(f"[{path}] layer {layer}, the chunk of node {node}: "
            f"{staged['input_feats'].shape[0]} source rows, "
            f"{int(em.sum())} live edges, largest group "
            f"{max_degree(torch, ed[em])}")
        for name, got in offline_kernel_cases(
                torch, path, g, cfg, params, staged, fanout, layer,
                chunk).items():
            cases.setdefault(name, []).extend(got)
        del staged
    del world, rows
    torch.cuda.empty_cache()
    return launches, cases


def row_count_probe(torch) -> None:
    """Why the pass runs its products in fixed row tiles: at each product
    shape of the offline runs, the first rows of one ``torch.bmm`` against
    the same rows in products of other row counts (logged), and the same
    through ``_dense``'s row tiles (must be bitwise)."""
    from repro_torch.api.inference import OFFLINE_ROW_TILE
    from repro_torch.models.gnn.layers import _dense

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rows = (1, 4, 7, 33, 64, 1024, 4096, 8155, 74560)
    for k, n in ((100, 256), (256, 256), (256, 16), (64, 1024),
                 (1024, 1024), (1024, 16)):
        w = torch.randn((k, n), generator=gen, device=DEVICE)
        x = torch.randn((1, rows[-1], k), generator=gen, device=DEVICE)
        base = torch.bmm(x[:, :1], w[None])[0]
        differ = [m for m in rows[1:]
                  if not torch.equal(torch.bmm(x[:, :m], w[None])[0, :1],
                                     base)]
        tiled = _dense(x[:, :1], w, OFFLINE_ROW_TILE)[0]
        require(all(torch.equal(_dense(x[:, :m], w, OFFLINE_ROW_TILE)[0, :1],
                                tiled) for m in rows[1:]),
                f"row tiles of {OFFLINE_ROW_TILE}: a row's bytes changed "
                f"with the row count at {k} x {n}")
        log(f"[offline] one torch.bmm at {k} x {n}: row 0 differs from "
            f"its 1-row product at row counts {differ} of {list(rows[1:])}; "
            f"in tiles of {OFFLINE_ROW_TILE} rows equal at all")


def phase_offline(torch, launches: dict, extra: dict) -> None:
    """The offline main paths (GraphSAGE and GAT on product-sim scale 12,
    typed RGCN on mag-hetero scale 10), each timed; their launch counts go
    to ``launches`` and the kernel cases on their longest groups to
    ``extra``."""
    row_count_probe(torch)
    product = ["--dataset", "product-sim", "--scale", str(OFFLINE_SCALE)]
    for path, argv, chunks in (
            ("offline_graphsage", ["--arch", "graphsage"] + product,
             OFFLINE_CHUNKS),
            ("offline_gat", ["--arch", "gat"] + product, OFFLINE_CHUNKS[:1]),
            ("offline_rgcn", ["--arch", "rgcn", "--dataset", "mag-hetero",
                              "--hetero", "--scale",
                              str(RGCN_OFFLINE_SCALE)],
             (RGCN_OFFLINE_CHUNK,))):
        t0 = time.perf_counter()
        launches[path], extra[f"{path}_longest_chunk"] = phase_offline_run(
            torch, path, argv, chunks)
        log(f"[{path}] phase {time.perf_counter() - t0:.2f} s")


def lm_close(torch, got, want, what) -> float:
    """rtol 1e-4, atol 1e-5 with atol scaled by max|want| / 4 above 4 (a
    float32 sum's error scales with its terms: tied-embedding logits reach
    70); returns the max abs error."""
    want = want.float()
    scale = max(1.0, float(want.abs().max()) / 4)
    check_close(torch, got.float(), want, 1e-4, 1e-5 * scale, what)
    return max_err(torch, got, want)


def lm_run(torch, cfg, params, batch, steps, cache_len) -> list:
    """Prefill ``batch``, then feed ``steps`` (K, B, 1) one at a time:
    [prefill's last logits, each decode step's logits]."""
    from repro_torch.models.lm import decode_step, prefill

    extras = {k: v for k, v in batch.items() if k != "tokens"}
    logits, cache = prefill(cfg, params, batch["tokens"], cache_len,
                            **extras)
    out = [logits]
    for t in steps:
        logits, cache = decode_step(cfg, params, cache, t)
        out.append(logits)
    return out


def lm_forward_check(torch, cfg, params, batch, steps, logits, what,
                     bound: float = LM_DECODE_BOUND) -> float:
    """Each of ``lm_run``'s logits against ``forward`` over the prompt and
    the fed tokens at its position, within ``bound``."""
    from repro_torch.models.lm import forward

    extras = {k: v for k, v in batch.items() if k != "tokens"}
    seq = torch.cat([batch["tokens"]] + list(steps), dim=1)
    full, _ = forward(cfg, params, seq, **extras)
    first = full.shape[1] - len(steps) - 1
    err = max(max_err(torch, got, full[:, first + i])
              for i, got in enumerate(logits))
    require(bool(torch.isfinite(full).all()), f"{what}: forward not finite")
    require(err < bound, f"{what}: prefill / decode differ from the full "
                         f"forward by {err:.3e} (bound {bound:.3e})")
    return err


def lm_smoke_parity(torch, arch_id) -> None:
    """(a): one id at smoke width, on the card against the CPU."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_params
    from repro_torch.optim.optimizers import tree_map

    cfg = smoke_variant(get_config(arch_id))
    b, s, k = LM_SMOKE
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = serve.make_batch(cfg, b, s, "cpu")
    steps = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (k, b, 1)))
    cache_len = serve.serve_cache_len(cfg, s, k)
    cpu = lm_run(torch, cfg, params, batch, steps, cache_len)
    params = tree_map(lambda t: t.to(DEVICE), params)
    batch = {n: v.to(DEVICE) for n, v in batch.items()}
    steps = steps.to(DEVICE)
    card = lm_run(torch, cfg, params, batch, steps, cache_len)
    err = max(lm_close(torch, g, c, f"lm {arch_id} step {i}: card vs CPU")
              for i, (g, c) in enumerate(zip(card, [t.to(DEVICE)
                                                    for t in cpu])))
    derr = lm_forward_check(torch, cfg, params, batch, steps, card,
                            f"lm {arch_id}")
    log(f"[lm_serve] {arch_id} smoke width ({cfg.num_layers} layers, d "
        f"{cfg.d_model}): prefill {b}x{s} + {k} decode steps, card vs "
        f"CPU max abs err {err:.3e} (max |logit| "
        f"{max(float(c.abs().max()) for c in cpu):.2f}); decode vs "
        f"forward {derr:.3e}")


def lm_full_f32(torch, cfg) -> None:
    """(b): ``cfg`` at full width in float32, prefill and one decode step
    against the full forward."""
    from repro_torch.models.lm import init_params
    from repro_torch.optim.optimizers import tree_leaves

    b, s = LM_F32_SHAPE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (b, s)), device=DEVICE)}
    steps = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, b, 1)),
                            device=DEVICE)
    logits = lm_run(torch, cfg, params, batch, steps, s + 8)
    top = max(float(t.abs().max()) for t in logits)
    # tied embeddings take mamba2-2.7b's logits to 240: its bound scales
    # by max |logit| / 4 above 4, as (a) scales its atol
    bound = LM_DECODE_BOUND * (max(1.0, top / 4) if cfg.tie_embeddings
                               else 1.0)
    err = lm_forward_check(torch, cfg, params, batch, steps, logits,
                           f"lm {cfg.name} float32", bound)
    torch.cuda.synchronize()
    log(f"[lm_serve] {cfg.name} full width float32 ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, {nbytes / 1e9:.2f} GB of weights): "
        f"prefill {b}x{s} and one decode step against the full forward, "
        f"max abs err {err:.3e} (bound {bound:.3e}; max |logit| "
        f"{top:.2f}); peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"{time.perf_counter() - t0:.2f} s")
    del params, logits
    torch.cuda.empty_cache()


def lm_serve_run(torch, arch_id, argv) -> None:
    """(c): ``launch.serve`` twice on one id; the same tokens and logits
    bit for bit."""
    from repro_torch.launch import serve

    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        runs.append(serve.main(["--arch", arch_id, *argv]))
        torch.cuda.empty_cache()
    a, b = runs
    require(torch.equal(a["tokens"], b["tokens"]),
            f"lm {arch_id}: two runs generated other tokens")
    require(all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"])),
            f"lm {arch_id}: two runs' logits differ in their bits")
    require(all(bool(torch.isfinite(x).all()) for x in a["logits"]),
            f"lm {arch_id}: logits not finite")
    bsz, gen = a["tokens"].shape
    max_u, mean_u = lm_bf16_forward_check(torch, arch_id, a)
    for i, r in enumerate(runs):
        log(f"[lm_serve] {arch_id} run {i + 1}: prefill "
            f"{r['prefill_s'] * 1e3:.3f} ms, decode "
            f"{r['decode_s'] * 1e3 / (gen - 1):.3f} ms a step, "
            f"{bsz * (gen - 1) / r['decode_s']:.1f} tok/s")
    log(f"[lm_serve] {arch_id}: tokens and logits bitwise equal over 2 "
        f"runs; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"decode vs forward in bfloat16 max {max_u:.3f} u, mean "
        f"{mean_u:.3f} u (bound {LM_BF16_BOUND_U[arch_id]} u)")


def lm_bf16_forward_check(torch, arch_id, res) -> tuple:
    """(c): every step of one ``launch.serve`` run (``res``) against
    ``forward`` over the prompt and the tokens it generated, in units of
    u = 2^-8: the largest difference over the step's max |forward| and the
    mean over its mean |forward|, each the worst step's. The launcher's
    parameters and batch are drawn again from its seeds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.lm import forward, init_params

    cfg = get_config(arch_id)
    bsz, gen = res["tokens"].shape
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0))
    batch = serve.make_batch(cfg, bsz, LM_SERVE[1], DEVICE)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    seq = torch.cat([batch["tokens"], res["tokens"][:, :-1]], dim=1)
    with torch.no_grad():
        full, _ = forward(cfg, params, seq, **extras)
    first = full.shape[1] - gen
    max_u = mean_u = 0.0
    for i, got in enumerate(res["logits"]):
        want = full[:, first + i].float()
        d = (got.float() - want).abs()
        max_u = max(max_u, float(d.max() / want.abs().max()) / 2 ** -8)
        mean_u = max(mean_u, float(d.mean() / want.abs().mean()) / 2 ** -8)
    require(bool(torch.isfinite(full).all()), f"lm {arch_id}: bfloat16 "
                                              f"forward not finite")
    bound = LM_BF16_BOUND_U[arch_id]
    require(max_u <= bound[0] and mean_u <= bound[1],
            f"lm {arch_id}: bfloat16 decode differs from the full forward "
            f"by max {max_u:.3f} u, mean {mean_u:.3f} u")
    del params, full
    torch.cuda.empty_cache()
    return max_u, mean_u


def lm_profile(torch, cfg, shape, steps: int = 8) -> None:
    """Where the launcher's time goes: ``generate`` over ``steps`` tokens
    (prefill and steps - 1 decode steps) at ``shape`` (batch, prompt)
    under ``torch.profiler``, after one warm run."""
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_params

    b, s = shape
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0))
    batch = serve.make_batch(cfg, b, s, DEVICE)
    cache_len = serve.serve_cache_len(cfg, s, steps)
    serve.generate(cfg, params, batch, steps, cache_len)
    profiled(torch, f"lm_{cfg.name}", f"prefill {b}x{s} and {steps - 1} "
             f"decode steps", lambda: serve.generate(cfg, params, batch,
                                                     steps, cache_len))
    del params
    torch.cuda.empty_cache()


def phase_lm_serve(torch) -> None:
    """(a), (b) and (c), with every kernel count 0 just before and read
    just after: the LM path launches none of K1-K6."""
    import dataclasses as dc

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import CUDA_WRAPPERS
    from repro_torch.models.lm import torch_dtype

    b, s, gen = LM_SERVE
    argv = ["--batch", str(b), "--prompt-len", str(s), "--gen", str(gen)]
    t0 = time.perf_counter()
    for w in CUDA_WRAPPERS.values():
        w.launches = 0
    for arch_id in ARCH_IDS:
        lm_smoke_parity(torch, arch_id)
    gc.collect()
    torch.cuda.empty_cache()
    for arch_id in LM_F32_ARCHS:
        lm_full_f32(torch, dc.replace(get_config(arch_id), dtype="float32"))
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        need = cfg.param_count() * torch_dtype(cfg.dtype).itemsize
        free = torch.cuda.mem_get_info()[0]
        log(f"[lm_serve] {arch_id}: {need / 2 ** 30:.2f} GiB of "
            f"{cfg.dtype} weights against {free / 2 ** 30:.2f} GiB free")
        if arch_id in LM_SERVE_LEFT_OUT:
            log(f"[lm_serve] {arch_id}: left out of (c) for time")
            continue
        if arch_id in LM_TOO_LARGE:
            require(need > free, f"{arch_id} was expected not to fit")
            log(f"[lm_serve] {arch_id}: does not fit one card; not run")
            continue
        require(need + 2 ** 31 < free, f"{arch_id} does not fit the card")
        lm_serve_run(torch, arch_id, argv)
        if arch_id in LM_PROFILED:
            lm_profile(torch, cfg, (b, s))
    counts = {name: w.launches for name, w in CUDA_WRAPPERS.items()}
    require(not any(counts.values()),
            f"the LM path launched GNN kernels: {counts}")
    log(f"[lm_serve] launches on the path: {json.dumps(counts)}; phase "
        f"{time.perf_counter() - t0:.2f} s")


def _lm_batches(torch, cfg, b, s, n, device, seed=0) -> list:
    """``n`` batches of the launcher's token stream (seed 0) on
    ``device``."""
    from repro_torch.data import TokenStream

    stream = TokenStream(vocab=cfg.vocab_size, batch=b, seq=s, seed=seed,
                         cfg=cfg, device=device, sync=True)
    try:
        return [next(stream) for _ in range(n)]
    finally:
        stream.stop()


def lm_train_smoke_parity(torch, arch_id, microbatches=1) -> None:
    """(a): one id at smoke width in float32, 3 steps on the card against
    the same steps on the CPU from the same parameters; the step-1
    gradients leaf by leaf."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models.lm import init_train_state, make_train_step
    from repro_torch.models.lm.steps import loss_and_grads
    from repro_torch.optim import AdamWState
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = smoke_variant(get_config(arch_id))
    b, s, n = LM_TRAIN_SMOKE
    b *= microbatches
    params, opt = init_train_state(cfg, seed=0, device="cpu")

    def to(tree, device):      # a copy: the step updates in place
        return tree_map(lambda t: t.to(device, copy=True), tree)

    def state_to(st, device):
        return AdamWState(st.step.to(device), to(st.mu, device),
                          to(st.nu, device))
    batches = _lm_batches(torch, cfg, b, s, n, "cpu")
    runs = {}
    for device in ("cpu", DEVICE):
        p, o = to(params, device), state_to(opt, device)
        bs = [to(x, device) for x in batches]
        _, g = loss_and_grads(cfg, p, bs[0])
        step = make_train_step(cfg, microbatches=microbatches)
        mets = []
        for x in bs:
            p, o, m = step(p, o, x)
            mets.append({k: float(v) for k, v in m.items()})
        runs[device] = (g, mets, p)
    worst = 0.0
    for a, c in zip(tree_leaves(runs[DEVICE][0]), tree_leaves(runs["cpu"][0])):
        atol = 1e-4 * float(c.abs().max()) + 1e-5
        err = max_err(torch, a.cpu(), c)
        require(err <= atol, f"lm_train {arch_id}: step-1 gradient on the "
                             f"card {err:.3e} from the CPU's (atol {atol:.3e})")
        worst = max(worst, err / atol)
    for i, (mc, mg) in enumerate(zip(runs["cpu"][1], runs[DEVICE][1])):
        for k in ("loss", "ce", "aux", "grad_norm"):
            require(abs(mg[k] - mc[k]) <= 1e-5 + 1e-4 * abs(mc[k]),
                    f"lm_train {arch_id} step {i + 1}: {k} {mg[k]!r} on the "
                    f"card against {mc[k]!r} on the CPU")
    log(f"[lm_train] {arch_id} smoke width ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, {microbatches} microbatch(es)): {n} steps of "
        f"{b}x{s}, card vs CPU: losses "
        f"{[round(m['loss'], 6) for m in runs[DEVICE][1]]} (CPU "
        f"{[round(m['loss'], 6) for m in runs['cpu'][1]]}), step-1 "
        f"gradients within {worst:.3f} of the bound")


def _lm_cut(cfg):
    """``cfg`` with ``num_layers`` cut until 12 bytes a parameter fit
    ``LM_CUT_BYTES`` (a hybrid keeps whole super-blocks, at least one)."""
    step = cfg.hybrid_attn_every or 1
    layers = cfg.num_layers
    while layers > step and dataclasses.replace(
            cfg, num_layers=layers).param_count() * 12 > LM_CUT_BYTES:
        layers -= step
    return dataclasses.replace(cfg, num_layers=layers)


def lm_train_run(torch, arch_id, argv, cfg=None) -> dict:
    """(b) and (c): ``launch.train``'s ``run_lm`` on one id (on ``cfg``
    when given: the launcher's config with its depth cut), with the
    checks of (b); returns its summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli

    args = train_cli.build_parser().parse_args(
        ["--arch", arch_id, "--device", DEVICE, *argv])
    full = get_config(arch_id)
    cfg = cfg or full
    t0 = time.perf_counter()
    out = train_cli.run_lm(args, cfg=cfg)
    wall = time.perf_counter() - t0
    loss = out["loss"]
    require(all(np.isfinite(loss)), f"lm_train {arch_id}: loss not finite")
    tokens = args.batch_size * args.seq_len
    if cfg.arch_type == "vlm":
        tokens += args.batch_size * cfg.num_image_tokens
    n_act = cfg.active_param_count()
    factor = 8 if cfg.remat else 6
    step_s = out["ms_per_step"] / 1e3
    mfu = factor * n_act * tokens / step_s / BF16_OPS_PER_S
    compute_ms = factor * n_act * tokens / BF16_OPS_PER_S * 1e3
    memory_ms = 22 * cfg.param_count() / HBM_BYTES_PER_S * 1e3
    cut = "" if cfg is full else (f" (num_layers cut from "
                                  f"{full.num_layers} to {cfg.num_layers})")
    peak = ("not measured" if out["peak_gib"] is None
            else f"{out['peak_gib']:.2f} GiB")
    log(f"[lm_train] {arch_id}{cut}: {args.steps} steps of "
        f"{args.batch_size}x{args.seq_len} in {cfg.dtype}, remat "
        f"{cfg.remat}, N {cfg.param_count() / 1e9:.3f} B (active "
        f"{n_act / 1e9:.3f} B): {out['ms_per_step']:.3f} ms a step, "
        f"{out['tok_s']:.1f} tok/s, MFU {100 * mfu:.3f}% ({factor} N_active "
        f"x {tokens} tokens against {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; "
        f"bound {max(compute_ms, memory_ms):.3f} ms: compute "
        f"{compute_ms:.3f}, memory {memory_ms:.3f}), peak "
        f"{peak}; losses "
        f"{[round(x, 4) for x in loss]}; {wall:.2f} s")
    return out


def lm_bf16_step(torch) -> None:
    """(d): one bfloat16 step of qwen2-0.5b at (b)'s shape against the
    float32 step from the same parameters (the float32 ones rounded):
    loss and grad_norm in units of u = 2^-8 of the float32 values."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_train_state, make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.optimizers import tree_map

    cfg = get_config("qwen2-0.5b")
    f32 = dataclasses.replace(cfg, dtype="float32")
    params, opt = init_train_state(cfg, seed=0, device=DEVICE)
    batch = _lm_batches(torch, cfg, 4, 256, 1, DEVICE)[0]
    p32 = tree_map(lambda t: t.float(), params)
    _, _, m16 = make_train_step(cfg)(params, opt, batch)
    del params, opt
    _, _, m32 = make_train_step(f32)(p32, adamw_init(p32), batch)
    u = 2.0 ** -8
    du = [abs(float(m16[k]) - float(m32[k])) / abs(float(m32[k])) / u
          for k in ("loss", "grad_norm")]
    log(f"[lm_train] qwen2-0.5b one step in bfloat16 against float32 from "
        f"the same parameters: loss {float(m16['loss']):.6f} / "
        f"{float(m32['loss']):.6f} ({du[0]:.3f} u), grad_norm "
        f"{float(m16['grad_norm']):.6f} / {float(m32['grad_norm']):.6f} "
        f"({du[1]:.3f} u; bound {LM_BF16_STEP_BOUND_U} u)")
    require(du[0] <= LM_BF16_STEP_BOUND_U[0]
            and du[1] <= LM_BF16_STEP_BOUND_U[1],
            f"lm_train qwen2-0.5b: bfloat16 step departs from float32 by "
            f"{du} u")
    del p32
    torch.cuda.empty_cache()


def lm_train_profile(torch, arch_id) -> list:
    """One staged training step of ``arch_id`` at (b)'s shape: its K2
    launches, its split (loss and gradients; clipping and AdamW) and,
    once more, under ``torch.profiler``. Returns the K2 keys of the step's
    launches as (label, keys, num_groups, width) in launch order."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import CUDA_WRAPPERS
    from repro_torch.models.lm import init_train_state, make_train_step
    from repro_torch.models.lm.steps import adamw_update_, loss_and_grads
    from repro_torch.optim.optimizers import (clip_scale, global_norm,
                                              tree_leaves)

    cfg = get_config(arch_id)
    params, opt = init_train_state(cfg, seed=0, device=DEVICE)
    batch = _lm_batches(torch, cfg, 4, 256, 1, DEVICE)[0]
    step = make_train_step(cfg)
    params, opt, _ = step(params, opt, batch)          # warm
    before = {n: w.launches for n, w in CUDA_WRAPPERS.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gn = global_norm(grads)
    leaves = tree_leaves(grads)
    del grads
    opt = adamw_update_(params, leaves, opt, clip_scale(gn, 1.0), lr=3e-4,
                        weight_decay=0.1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = {n: w.launches - before[n] for n, w in CUDA_WRAPPERS.items()
              if w.launches > before[n]}
    log(f"[profile] lm_train_{arch_id}: launches in one step: "
        f"{json.dumps(counts)}; loss and gradients "
        f"{(t1 - t0) * 1e3:.3f} ms, clipping and AdamW "
        f"{(t2 - t1) * 1e3:.3f} ms")
    profiled(torch, f"lm_train_{arch_id}", "one step (batch staged)",
             lambda: step(params, opt, batch))
    tokens = batch["tokens"].reshape(-1)
    keys = [("embedding", tokens, cfg.padded_vocab, cfg.d_model)]
    if cfg.arch_type == "moe":
        # the dispatch gathers each token once for each of its k experts:
        # every token id k times, in expert order (here a seeded order)
        t, k = tokens.numel(), cfg.experts_per_tok
        gen = torch.Generator(device=DEVICE).manual_seed(2)
        moe = torch.arange(t, device=DEVICE).repeat_interleave(k)[
            torch.randperm(t * k, generator=gen, device=DEVICE)]
        keys += [("moe dispatch", moe, t, cfg.d_model)] * cfg.num_layers
    require(counts.get("segment_sum", 0) == len(keys),
            f"lm_train {arch_id}: K2 launched {counts} in one step, "
            f"expected {len(keys)}")
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return keys


def lm_train_k2_cases(torch, arch_id, keys) -> list:
    """K2 at one LM step's shapes, one case a launch in launch order (a
    repeated launch timed once): bfloat16 gradient rows of the model
    width from a seeded generator, keyed as the step keys them."""
    from repro_torch.kernels import edge_groups

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    timed, cases = {}, []
    for label, idx, groups_n, width in keys:
        name = (label, id(idx))
        if name not in timed:
            flat_keys = idx.to(torch.int32)
            live = torch.ones_like(flat_keys, dtype=torch.bool)
            grad = torch.randn((flat_keys.numel(), width), generator=gen,
                               device=DEVICE).to(torch.bfloat16)
            out = []
            k2_case(torch, f"lm {arch_id} {label}", grad,
                    {"edge_dst": flat_keys, "edge_mask": live}, groups_n,
                    edge_groups(flat_keys, live, groups_n), out, 0.1, 0.5)
            timed[name] = out[0]
        cases.append(timed[name])
    return cases


def lm_train_paths(torch) -> dict:
    """(a)-(d) and the profiles; returns the profiled steps' K2 keys."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.optim.optimizers import tree_leaves

    marks = [("start", time.perf_counter())]
    for arch_id in ARCH_IDS:
        lm_train_smoke_parity(torch, arch_id)
    lm_train_smoke_parity(torch, "qwen2-0.5b", microbatches=4)
    marks.append(("(a)", time.perf_counter()))
    for arch_id in LM_TRAIN_FULL:
        out = lm_train_run(torch, arch_id, LM_TRAIN_ARGV)
        loss = out["loss"]
        require(np.mean(loss[15:20]) < np.mean(loss[:5]),
                f"lm_train {arch_id}: the loss did not fall "
                f"({np.mean(loss[:5]):.4f} -> {np.mean(loss[15:20]):.4f})")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    marks.append(("(b)", time.perf_counter()))
    for arch_id in LM_TRAIN_CUT:
        cfg = _lm_cut(get_config(arch_id))
        argv = LM_TRAIN_ARGV[:-1] + ["3"]
        lm_train_run(torch, arch_id, argv, cfg=cfg)
        gc.collect()
        torch.cuda.empty_cache()
    marks.append(("(c)", time.perf_counter()))
    for arch_id in LM_TRAIN_PROFILED:
        runs = []
        for _ in range(2):
            out = lm_train_run(torch, arch_id, LM_TRAIN_ARGV[:-1] + ["3"])
            runs.append(tree_leaves(out.pop("params")))
            del out
        require(all(torch.equal(a, b) for a, b in zip(*runs)),
                f"lm_train {arch_id}: two 3-step runs end with other bits")
        log(f"[lm_train] {arch_id}: two 3-step runs end with bitwise-equal "
            f"parameters ({len(runs[0])} leaves)")
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    lm_bf16_step(torch)
    marks.append(("(d)", time.perf_counter()))
    keys = {arch_id: lm_train_profile(torch, arch_id)
            for arch_id in LM_TRAIN_PROFILED}
    marks.append(("profiles", time.perf_counter()))
    log("[lm_train] seconds: " + ", ".join(
        f"{name} {t - marks[i][1]:.2f}"
        for i, (name, t) in enumerate(marks[1:])))
    return keys


def phase_lm_train(torch, launches: dict, extra: dict) -> None:
    """The LM training path, counted (K2 sums the token embedding's and
    the MoE dispatch's gradients), then K2 at its profiled steps'
    shapes."""
    t0 = time.perf_counter()
    keys, launches["lm_train"] = counted("lm_train",
                                         lambda: lm_train_paths(torch))
    for arch_id, k in keys.items():
        extra[f"lm_train_{arch_id}_step"] = {
            "segment_sum": lm_train_k2_cases(torch, arch_id, k)}
    log(f"[lm_train] phase {time.perf_counter() - t0:.2f} s")


def _sums(cases: list) -> dict:
    """Times summed over the cases the main path runs; ``library_ms`` is
    null where no single PyTorch call computes the same function."""
    cases = [c for c in cases if c.get("on_path", True)]
    libs = [c["library_ms"] for c in cases]
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["kernel_ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": ("bytes" if all(c["bound_by"] == "bytes"
                                        for c in cases) else "operations"),
            "library_ms": None if None in libs else sum(libs)}


SHAPES = {
    "fused_gather_aggregate": "sum over the 3 layers of one serving tick "
                              "(8 chunks x 8 seeds)",
    "segment_sum": "sum over the 3 layers of one serving tick (8 chunks x "
                   "8 seeds), as _degrees (F=1)",
    "segment_sum_gat": "sum over the 3 layers of one GAT training step (4 "
                       "trainers x 128 seeds), F=2 keyed by source and by "
                       "destination (6 launches)",
    "fused_gather_aggregate_bwd": "sum over layers 1 and 2 of one "
                                  "GraphSAGE training step (4 trainers x "
                                  "128 seeds)",
    "sparse_adam": f"one step of {K5_ROWS} unique rows of a ({EMB_ROWS} x "
                   f"{EMB_DIM}) float32 table (on the embedding path the "
                   f"kernel updates the staged rows 0..R-1 of each owner)",
    "gather_rows": f"{K6_ROWS} int32 indices into a ({K6_TABLE_ROWS} x "
                   f"{K6_WIDTH}) float32 table",
}
GAT_SHAPES = ("sum over the 3 layers of one GAT training step (4 trainers "
              "x 128 seeds)")


def report(primary: dict, paper: dict, launches: dict,
           sage_step: dict, extra: dict) -> dict:
    """Per kernel: its times summed over the layers of the main path's
    shapes (a serving tick at the gnn_serve defaults, or a training step
    of launch.train), the same sums for one batch-1000 forward (and
    backward) under ``paper_batch``, and its launches on each main path;
    K1's forward and K2 as ``_degrees`` also at one GraphSAGE training
    step (``train_graphsage_step``), and K1, its backward and K2 summed
    over the relations and layers of one RGCN tick and step
    (``serving_rgcn_tick``, ``train_rgcn_step``) and of one
    link-prediction step (``train_lp_step``, ``train_lp_rgcn_step``; K2
    there with the head's gathers) and of one first-step batch of
    ``train_lp``'s command on scale 14 (``lp_step_scale14``)."""
    out = []
    for name, meta in KERNELS.items():
        by_path = {p: launches[p][meta["wrapper"]] for p in meta["paths"]}
        row = {"name": name, "route": "cuda", "status": "ok",
               "source": meta["source"], "replaces": meta["replaces"],
               "launches": sum(by_path.values()),
               "launches_by_path": by_path, **_sums(primary[name]),
               "shapes": SHAPES.get(name, GAT_SHAPES),
               "paper_batch": (_sums(paper[name]) if name in paper
                               else None)}
        if name in ("fused_gather_aggregate", "segment_sum"):
            row["train_graphsage_step"] = _sums(sage_step[name])
        for key, cases in extra.items():
            if cases.get(name):
                row[key] = _sums(cases[name])
        out.append(row)
    return {"kernels": out}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    smi = phase_device(torch)
    require((ROOT / "src" / "repro_torch").is_dir(),
            "src/repro_torch is missing: run from a checkout of the repo")
    from repro_torch.configs import get_config
    from repro_torch.launch import gnn_serve
    from repro_torch.models.gnn import init_gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_src_scatter(torch)
    phase_segments(torch)
    phase_k3_segments(torch)
    phase_k4_segments(torch)

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
    paper, paper_batch = phase_kernels(torch, g, paper_cfg, params)
    gat_cfg = dataclasses.replace(get_config("gat"), in_dim=cfg.in_dim,
                                  num_classes=cfg.num_classes,
                                  batch_size=PAPER_BATCH)
    gat_params = init_gnn(gat_cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    paper.update(gat_cases(torch, "paper", paper_batch, gat_cfg.dst_caps(),
                           gat_params))
    del paper_batch, gat_params
    torch.cuda.empty_cache()
    k5 = phase_sparse_adam(torch)
    k6 = phase_gather(torch)

    launches = {"serving": phase_serving(torch, world, args)}
    primary = layer_cases(torch, "tick", phase_breakdown(torch, world, args),
                          cfg.dst_caps(), params)
    phase_paper(torch, g, cfg, params)
    product = ["--scale", str(SCALE), "--batch-size", str(TRAIN_BATCH)]
    launches["train_gat"], gat_train = phase_training(
        torch, "train_gat", ["--arch", "gat"] + product)
    launches["train_graphsage"], sage_train = phase_training(
        torch, "train_graphsage", ["--arch", "graphsage"] + product)
    launches["train_recover"] = phase_recovery(
        torch, "train_recover", ["--arch", "graphsage"] + product)
    launches["embedding"] = phase_embedding(torch)
    extra = {}
    launches["serving_rgcn"], extra["serving_rgcn_tick"] = \
        phase_serving_rgcn(torch)
    launches["train_rgcn"], extra["train_rgcn_step"] = phase_training(
        torch, "train_rgcn", RGCN_TRAIN)
    launches["recover_rgcn"] = phase_recovery(torch, "recover_rgcn",
                                              RGCN_TRAIN)
    phase_rgcn_untyped(torch)
    phase_link_prediction(torch, launches, extra)
    phase_offline(torch, launches, extra)
    phase_lm_serve(torch)
    phase_lm_train(torch, launches, extra)
    primary.update(gat_train)
    primary["fused_gather_aggregate_bwd"] = \
        sage_train["fused_gather_aggregate_bwd"]
    primary["sparse_adam"] = k5
    primary["gather_rows"] = k6[:1]

    print(json.dumps(report(primary, paper, launches, sage_train, extra)))
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
