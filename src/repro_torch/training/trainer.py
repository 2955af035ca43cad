"""Distributed synchronous mini-batch GNN training (§5.1, §5.6), the port of
``repro/training/trainer.py``.

``DistGNNTrainer`` composes the port's public surface: one
:class:`~repro_torch.api.DistGraph` world (partition book + KVStore),
per-trainer :class:`~repro_torch.api.NodeDataLoader` (node classification)
or :class:`~repro_torch.api.EdgeDataLoader` (link prediction) instances
over the async pipeline, and one *synchronous* AdamW step per iteration
across all trainers (data parallelism).

The reference ``vmap``s the loss over the T trainers' stacked batches and
takes the mean, which is exactly synchronous SGD. The port stacks the T
batches on the leading axis the layers already take, so each kernel
launches once per layer for all trainers; it computes one loss per slot,
averages them, and calls ``backward`` once. Accuracy is the mean of the
per-slot accuracies, as in the reference (for link prediction: the
per-slot BCE losses and MRRs). The step runs on the card unless the
trainer is built with ``device="cpu"``.

The constructor options are the reference's Fig. 14 ablation axes
(``partition_method``, ``use_level2``, ``sync``, ``non_stop``), and the
elastic fault tolerance of DESIGN.md §10: consistent checkpoints every
``checkpoint_interval`` steps, a seeded ``fault_injector`` on the world's
transport, and :meth:`DistGNNTrainer.recover`, which restores a
checkpoint and replays the rest of the run byte for byte. A config with
per-relation fanouts (``GNNConfig.typed``, RGCN on a schema'd dataset)
builds a typed world: per-relation sampling, per-node-type features and
relation-major blocks.

Link prediction (``task="link_prediction"``) trains on each trainer's
owned edges: ``batch_size`` counts positive edges, ``num_negs`` negatives
a positive (uniform or in-batch, optionally excluding the batch's
positives), the ``dot`` or ``distmult`` head on the encoder's output
embeddings, and :meth:`DistGNNTrainer.evaluate_lp` ranks held-out
candidates (MRR, Hits@k).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..api.dataloader import EdgeDataLoader, NodeDataLoader
from ..api.dist_graph import DistGraph
from ..api.inference import resolve_device
from ..checkpoint import (load_cache, load_kvstore, load_pytree, save_cache,
                          save_kvstore, save_pytree)
from ..core.kvstore import CacheConfig, FaultInjector, NetworkModel
from ..core.sampler import EdgeBatchSampler
from ..graph.datasets import GraphDataset
from ..kernels.pack import device_stage, host_stage, stack_trees
from ..models.gnn import (GNNConfig, apply_gnn, init_gnn, init_lp_head,
                          lp_loss_from_scores, lp_metrics, lp_pair_scores,
                          lp_ranks, nc_accuracy, nc_loss, params_to)
from ..models.gnn.models import _check_arch
from ..optim import adamw_init, adamw_update
from ..optim.optimizers import tree_leaves, tree_map

TASKS = ("node_classification", "link_prediction")
# host-clock spans of a step, and on the card the device's time between
# the same marks (CUDA events)
HOST_SPANS = ("wait_loaders", "stack_stage", "forward", "backward",
              "optimizer", "read_loss")
DEVICE_SPANS = ("device_stack_stage", "device_forward", "device_backward",
                "device_optimizer")
# inside stack_stage on the trainer's thread (packed staging): the host
# stack of the trainers' batches and the pack into the pinned arena; and
# the thread's CPU time over the whole of stack_stage
STAGE_SPANS = ("stack_host", "stage_pack", "stack_stage_cpu")
# the loaders' sample and feature-pull (cpu_prefetch) stages: wall and
# thread CPU time of each call, summed over the trainers' pipelines
LOADER_SPANS = ("sample", "sample_cpu", "pull", "pull_cpu")
# counts, not seconds: the arena bytes of every step staged packed
COUNTERS = ("staged_bytes",)
# the prefix of the trainer thread's profiler ranges
RANGE_PREFIX = "repro_torch."
# a profiler range that records no GPU annotation: record_function's
# user-scope ranges add one, a device-typed event, for every range that
# encloses a launch
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


@dataclasses.dataclass
class TrainJobConfig:
    num_machines: int = 2
    trainers_per_machine: int = 2
    partition_method: str = "metis"      # "metis" | "random" (Euler baseline)
    use_level2: bool = True              # 2-level partition seed split
    sync: bool = False                   # disable the async pipeline
    non_stop: bool = True                # non-stop pipeline across epochs
    lr: float = 3e-3
    network: Optional[NetworkModel] = None
    pipeline_depths: Optional[dict] = None
    cache: Optional[CacheConfig] = None  # per-trainer hot-vertex cache
    # sampling-stage worker pool per trainer (§5.5's multiple sampling
    # workers); batches are byte-identical for any value
    sample_workers: int = 1
    # device staging: True = the stacked step batch is packed into one
    # pinned host arena and staged with ONE copy; False = the per-array
    # ablation baseline, one copy a trainer's leaf, stacked on the device.
    # The bytes reaching the step are identical.
    packed_staging: bool = True
    # kernel implementation for the model's aggregations (GNNConfig.impl):
    # None keeps the model config's own choice ("auto": the CUDA kernels
    # on the card, the plain versions on the CPU); "ref" / "cuda" force
    impl: Optional[str] = None
    # link_prediction: positive-edge batches over each trainer's owned
    # edges, `num_negs` corrupted dsts per edge, the `score_fn` head (dot |
    # distmult per relation), MRR/Hits@k eval. For this task the model
    # config's batch_size is the EDGE batch B; the node batch the samplers
    # and the model use is derived (2B + B*K, 2B for in-batch negatives).
    task: str = "node_classification"
    # 16: with few uniform negatives the BCE objective can settle at the
    # all-scores-zero fixed point (the reference's measurement)
    num_negs: int = 16
    score_fn: str = "dot"                # "dot" | "distmult"
    neg_mode: str = "uniform"            # "uniform" | "in-batch"
    neg_exclude: bool = False            # re-draw batch-positive collisions
    # consistent checkpoints every `checkpoint_interval` global steps into
    # `checkpoint_dir`; a replacement trainer's recover() restores them
    # and fast-forwards the deterministic schedule to the saved coordinate
    checkpoint_dir: Optional[str] = None
    checkpoint_interval: int = 0         # global steps between saves; 0 = off
    # seeded failure schedule (kill_at death + transient RPC faults),
    # attached to the world's shared transport
    fault_injector: Optional[FaultInjector] = None
    seed: int = 0
    # r-way replica placement for the KVStore feature plane
    replication: int = 1
    max_rpc_retries: int = 8
    hedge_ms: Optional[float] = None

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; have {TASKS}")
        if self.checkpoint_interval and not self.checkpoint_dir:
            raise ValueError("checkpoint_interval > 0 needs a checkpoint_dir")


class _Spans:
    """The training path's tracer: per-step spans on the host clock
    between marks, and on the card CUDA events at the same marks, read
    once the events have completed; sub-spans of ``stack_stage``; the
    loaders' stage times; the bytes staged.

    Every total is in ``totals`` (seconds, ``staged_bytes`` a count), each
    key created here: the loaders' threads add to it while others copy it,
    and every addition holds one lock. While a ``torch.profiler`` session
    records the trainer's thread, each of its spans is also a range named
    ``repro_torch.<span>`` whose arguments are ``step_id`` (epoch and
    step)."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.totals = dict.fromkeys(
            HOST_SPANS + STAGE_SPANS + LOADER_SPANS
            + (DEVICE_SPANS if on_card else ()), 0.0)
        self.totals.update(dict.fromkeys(COUNTERS, 0))
        self.step_id = {"epoch": 0, "step": 0}
        self._lock = threading.Lock()
        self._pending: List[tuple] = []   # (name, start event, end event)
        self._t = 0.0
        self._event = None

    def start(self) -> None:
        self._t = time.perf_counter()
        self._event = self._record() if self.on_card else None

    def _record(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, name: str, amount, cpu: Optional[float] = None) -> None:
        """Add ``amount`` to ``name`` and ``cpu`` seconds to
        ``<name>_cpu``, from any thread."""
        with self._lock:
            self.totals[name] += amount
            if cpu is not None:
                self.totals[name + "_cpu"] += cpu

    def mark(self, name: str, device: bool = False) -> None:
        now = time.perf_counter()
        self.add(name, now - self._t)
        self._t = now
        if self.on_card:
            ev = self._record()
            if device:
                self._pending.append((f"device_{name}", self._event, ev))
            self._event = ev

    def _open(self, name: str):
        if _RANGE is None or not torch._C._autograd._profiler_enabled():
            return None
        r = _RANGE(RANGE_PREFIX + name, (), self.step_id)
        r.__enter__()
        return r

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False, cpu: bool = False):
        """The step span ``name``, from the previous boundary to the end of
        the block, where it calls ``self.mark(name, device)``; with
        ``cpu``, the thread's CPU time inside the block goes to
        ``<name>_cpu``."""
        r = self._open(name)
        c0 = time.thread_time() if cpu else 0.0
        try:
            yield
        finally:
            if r is not None:
                r.__exit__(None, None, None)
        if cpu:
            self.add(name + "_cpu", time.thread_time() - c0)
        self.mark(name, device)

    @contextlib.contextmanager
    def child(self, name: str):
        """A span nested in the current step span, timed on its own: it
        counts toward both and moves no boundary."""
        r = self._open(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if r is not None:
                r.__exit__(None, None, None)
        self.add(name, time.perf_counter() - t0)

    def resolve(self) -> None:
        """Add the device spans of the completed steps (after a
        synchronize)."""
        for name, a, b in self._pending:
            self.add(name, a.elapsed_time(b) / 1e3)
        self._pending.clear()


class DistGNNTrainer:
    """Synchronous data-parallel node classification or link prediction
    over T = machines x trainers_per_machine trainers. ``params`` (a tree
    of tensors, e.g. the reference's initial parameters through
    :func:`~repro_torch.models.gnn.params_from_numpy`; ``{"gnn": ...,
    "lp": ...}`` for link prediction) replaces the seeded
    :func:`~repro_torch.models.gnn.init_gnn` draw."""

    def __init__(self, ds: GraphDataset, model_cfg: GNNConfig,
                 job: TrainJobConfig, *, device="cuda", params=None):
        self.device = resolve_device(device)
        self.ds = ds
        if job.impl is not None:
            model_cfg = dataclasses.replace(model_cfg, impl=job.impl)
        _check_arch(model_cfg.arch)
        self.cfg = model_cfg
        self.job = job
        self.task = job.task
        if self.task == "link_prediction":
            # cfg.batch_size is the EDGE batch; the node samplers and the
            # model's capacities run at the derived endpoint-seed capacity
            node_bs = EdgeBatchSampler.required_node_batch(
                model_cfg.batch_size, job.num_negs, job.neg_mode)
            self.node_cfg = dataclasses.replace(model_cfg,
                                                batch_size=node_bs)
        else:
            self.node_cfg = model_cfg

        # the world: partition + KVStore + typed views, behind one handle
        self.graph = DistGraph(
            ds, num_machines=job.num_machines,
            trainers_per_machine=job.trainers_per_machine,
            partition_method=job.partition_method, hetero=model_cfg.typed,
            seed=job.seed, network=job.network,
            replication=job.replication,
            max_rpc_retries=job.max_rpc_retries, hedge_ms=job.hedge_ms)
        self.hp = self.graph.hp
        self.partition_time_s = self.graph.partition_time_s
        self.transport = self.graph.transport
        if job.fault_injector is not None:
            # every RPC in the world — feature pulls, gradient pushes —
            # flows through this one transport, so attaching the injector
            # here puts the whole stack under the failure schedule
            self.transport.fault_injector = job.fault_injector
        self.store = self.graph.store
        self.labels_new = self.graph.labels
        self.schema = self.graph.schema
        self.hetero = self.graph.hetero
        self.typed = self.graph.typed
        # resolves the typed config's name-keyed fanouts to relation ids
        self.etype_id = self.schema.etype_id if self.hetero else None

        # per-trainer seed split (§5.6.1): node tasks split the training
        # vertices; link prediction splits each machine's OWNED edge range
        # into equal per-trainer pools ("we may use all edges to train a
        # model", §6)
        lp = self.task == "link_prediction"
        if lp:
            self.e_src, self.e_dst = self.graph.edge_endpoints()
            self.trainer_edges: List[np.ndarray] = self.graph.edge_splits()
            # locality of the positive SOURCES (dsts are local by
            # construction: edges are owned by their dst's machine)
            self.locality = self.graph.locality_report(
                [self.e_src[e] for e in self.trainer_edges])
        else:
            self.trainer_seeds = self.graph.node_splits(
                self.graph.train_nids, use_level2=job.use_level2,
                seed=job.seed)
            self.locality = self.graph.locality_report(self.trainer_seeds)

        self.spans = _Spans(self.device.type == "cuda")
        # per-trainer loaders (each owns its sampler, client, cache and
        # async pipeline); the trainer only stacks their batches
        self.num_trainers = self.graph.num_trainers
        self.loaders: List[NodeDataLoader] = []
        for ti in range(self.num_trainers):
            gt = self.graph.trainer_view(ti)
            common = dict(sync=job.sync, non_stop=job.non_stop,
                          depths=job.pipeline_depths, device_prefetch=False,
                          cache=gt.feature_cache(job.cache),
                          sample_workers=job.sample_workers,
                          seed=job.seed + 200 + ti,
                          sampler_seed=job.seed + 100 + ti,
                          tracer=self.spans)
            if lp:
                self.loaders.append(EdgeDataLoader(
                    gt, self.trainer_edges[ti], self.node_cfg.fanouts,
                    batch_size=model_cfg.batch_size, num_negs=job.num_negs,
                    neg_mode=job.neg_mode, neg_exclude=job.neg_exclude,
                    edge_seed=job.seed + 300 + ti, **common))
            else:
                seeds = self.trainer_seeds[ti]
                self.loaders.append(NodeDataLoader(
                    gt, seeds, model_cfg.fanouts,
                    batch_size=model_cfg.batch_size,
                    labels=self.labels_new[seeds], **common))
        # component views (stats, tests, benchmarks)
        self.samplers = [ld.sampler for ld in self.loaders]
        self.edge_samplers = [ld.edge_sampler for ld in self.loaders
                              if isinstance(ld, EdgeDataLoader)]
        self.pipelines = [ld.pipeline for ld in self.loaders]
        self.caches = [ld.cache for ld in self.loaders]

        self.batches_per_epoch = min(len(ld) for ld in self.loaders)
        if self.batches_per_epoch < 1:
            self.stop()
            if lp:
                fewest = min(len(e) for e in self.trainer_edges)
                raise ValueError(
                    f"edge batch {model_cfg.batch_size} exceeds the "
                    f"per-trainer owned-edge pool ({fewest} edges/trainer)"
                    f" — shrink the batch or the trainer count")
            fewest = min(len(s) for s in self.trainer_seeds)
            raise ValueError(
                f"batch_size {model_cfg.batch_size} exceeds the per-trainer "
                f"training-set split ({fewest} seeds/trainer) — shrink the "
                f"batch or the trainer count")

        if params is not None:
            self.params = params_to(params, self.device)
        else:
            self.params = init_gnn(self.node_cfg,
                                   torch.Generator().manual_seed(job.seed),
                                   device=self.device)
            if lp:
                self.params = {"gnn": self.params,
                               "lp": init_lp_head(job.score_fn,
                                                  self.node_cfg.num_rels,
                                                  self.node_cfg.num_classes,
                                                  device=self.device)}
        self.opt = adamw_init(self.params)
        # optimizer steps taken since construction (or since recover());
        # the checkpoint cadence counts these, not per-epoch batches
        self.global_step = 0
        # (epoch, batch_index) a recover() restored — the next
        # train_epoch() call must target that epoch and fast-forwards to
        # that batch (DESIGN.md §10)
        self._resume: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _stage(self, tree: dict) -> dict:
        """One host batch on the device, packed or per array as the job
        says."""
        if self.job.packed_staging:
            return device_stage(tree, self.device).unpack()
        return device_stage(tree, self.device, packed=False)

    def _stack(self, batches: List[dict]) -> dict:
        """Stack the T trainers' host batches on a leading axis and stage
        them on the device. Packed staging stacks in host memory and makes
        ONE copy of the whole step's input; the per-array path copies each
        trainer's leaf on its own and stacks on the device. The device
        bytes are identical either way."""
        if self.job.packed_staging:
            spans = self.spans
            with spans.child("stack_host"):
                tree = stack_trees(batches)
            with spans.child("stage_pack"):
                packed = host_stage(tree, pin=self.device.type == "cuda")
            spans.add("staged_bytes", packed.total_bytes())
            return packed.to(self.device).unpack()
        return stack_trees([device_stage(b, self.device, packed=False)
                            for b in batches], torch.stack)

    def _lp_scores(self, params, batch: dict, cfg: GNNConfig):
        """Embeddings -> (pos, neg) scores; shared by training and
        evaluation (which passes its own cfg: its endpoint capacity
        differs)."""
        h = apply_gnn(cfg, params["gnn"], batch, etype_id=self.etype_id)
        kw = dict(head=params["lp"], score_fn=self.job.score_fn,
                  etypes=batch["edge_etypes"], impl=cfg.impl)
        pos = lp_pair_scores(h, batch["pos_u"], batch["pos_v"], **kw)
        neg = lp_pair_scores(h, batch["pos_u"], batch["neg_v"], **kw)
        return pos, neg

    def _forward(self, params, stacked: dict, cfg: GNNConfig):
        """(mean loss, mean accuracy or MRR, the leaf tensors the loss is
        differentiated against)."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _p: next(it), params)
        if self.task == "link_prediction":
            pos, neg = self._lp_scores(live, stacked, cfg)
            mask = stacked["pair_mask"]
            losses = lp_loss_from_scores(pos, neg, mask)
            accs = lp_metrics(lp_ranks(pos, neg), mask)["mrr"]
        else:
            logits = apply_gnn(cfg, live, stacked, etype_id=self.etype_id)
            losses = nc_loss(logits, stacked["labels"], stacked["seed_mask"])
            accs = nc_accuracy(logits, stacked["labels"],
                               stacked["seed_mask"])
        return losses.mean(), accs.mean(), leaves

    def loss_and_grads(self, stacked: dict, params=None,
                       impl: Optional[str] = None):
        """The step's loss, accuracy (MRR for link prediction) and gradient
        tree on ``stacked`` (the trainer's own params unless given;
        ``impl`` overrides the model config's kernel choice), without
        updating anything."""
        params = self.params if params is None else params
        cfg = (self.node_cfg if impl is None
               else dataclasses.replace(self.node_cfg, impl=impl))
        loss, acc, leaves = self._forward(params, stacked, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
        return loss.detach(), acc, tree_map(lambda _p: next(grads), params)

    def train_step(self, stacked: dict):
        """One synchronous AdamW step on the stacked batch -> (loss, acc or
        MRR) as tensors on the device."""
        spans = self.spans
        with spans.span("forward", device=True):
            loss, acc, leaves = self._forward(self.params, stacked,
                                              self.node_cfg)
        with spans.span("backward", device=True):
            grads = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _p: next(grads), self.params)
        with spans.span("optimizer", device=True):
            self.params, self.opt = adamw_update(self.params, grads,
                                                 self.opt, lr=self.job.lr)
        self.global_step += 1
        return loss.detach(), acc

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> dict:
        start = 0
        if self._resume is not None:
            r_epoch, r_batch = self._resume
            if epoch != r_epoch:
                raise ValueError(
                    f"recovered at epoch {r_epoch}, batch {r_batch}; the "
                    f"next train_epoch() must target epoch {r_epoch}, "
                    f"got {epoch}")
            self._resume = None
            start = r_batch
        iters = [ld.epoch(epoch, start_batch=start) for ld in self.loaders]
        inj = self.job.fault_injector
        ckpt_every = self.job.checkpoint_interval
        spans = self.spans
        t0 = time.perf_counter()
        losses, accs = [], []
        for k in range(start, self.batches_per_epoch):
            # checkpoint BEFORE consuming batch k: coordinate (epoch, k)
            # means "everything up to batch k-1 is applied", so recovery
            # resumes AT batch k (skip step 0 — that's the initial state)
            if (ckpt_every and self.global_step
                    and self.global_step % ckpt_every == 0):
                self.save_checkpoint(self.job.checkpoint_dir,
                                     epoch=epoch, batch_index=k)
            # injected trainer death fires at the same boundary, so a
            # killed trainer's last completed step is unambiguous
            if inj is not None:
                inj.check_death(epoch, k)
            spans.step_id = {"epoch": epoch, "step": k}
            spans.start()
            with spans.span("wait_loaders"):
                batches = [next(it).model_input() for it in iters]
            with spans.span("stack_stage", device=True, cpu=True):
                stacked = self._stack(batches)
            loss, acc = self.train_step(stacked)
            with spans.span("read_loss"):
                losses.append(float(loss))
                accs.append(float(acc))
        # drain every iterator to ITS epoch boundary. With equal
        # per-trainer batch counts this pulls nothing in non-stop mode and
        # just exhausts finite pipelines; on the typed link-prediction path
        # per-relation tail dropping can leave a trainer a few surplus
        # batches, and abandoning those mid-epoch would serve the next
        # epoch stale batches
        for it in iters:
            for _ in it:
                pass
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        spans.resolve()
        dt = time.perf_counter() - t0
        out = {"epoch": epoch, "loss": float(np.mean(losses)),
               "acc": float(np.mean(accs)), "time_s": dt,
               "batches": self.batches_per_epoch - start, "losses": losses}
        if self.task == "link_prediction":
            out["train_mrr"] = out["acc"]   # the step's aux metric is MRR
        return out

    @torch.no_grad()
    def lp_eval_batches(self, num_batches: int = 20, seed: int = 977,
                        num_negs: Optional[int] = None,
                        batch_edges: Optional[int] = None):
        """The evaluation batches of :meth:`evaluate_lp`, each staged and
        scored: yields (:class:`~repro_torch.api.EdgeBatch`, pos (B,),
        neg (B, K)) with the scores on the trainer's device."""
        if self.task != "link_prediction":
            raise ValueError("evaluate_lp needs a link-prediction trainer "
                             f"(task={self.task!r})")
        b = batch_edges or min(self.cfg.batch_size, 16)
        k = num_negs or 49
        eval_cfg = dataclasses.replace(
            self.node_cfg,
            batch_size=EdgeBatchSampler.required_node_batch(b, k, "uniform"))
        g0 = self.graph.trainer_view(0)
        loader = EdgeDataLoader(
            g0, np.arange(g0.num_edges(), dtype=np.int64), eval_cfg.fanouts,
            batch_size=b, num_negs=k, neg_mode="uniform", neg_exclude=False,
            mode="eval", sampler_seed=self.job.seed + 998,
            edge_seed=self.job.seed + seed)
        with loader:
            for batch in itertools.islice(loader, num_batches):
                staged = self._stage(batch.model_input())
                pos, neg = self._lp_scores(self.params, staged, eval_cfg)
                yield batch, pos, neg

    def evaluate_lp(self, num_batches: int = 20, seed: int = 977,
                    num_negs: Optional[int] = None,
                    batch_edges: Optional[int] = None) -> dict:
        """MRR / Hits@k over a deterministic sample of the graph's edges,
        always against fresh uniform negatives (rank the true destination
        against corrupted ones), whatever the training ``neg_mode``.

        Evaluation uses its own candidate count (``num_negs`` defaults to
        49, so ranks span [1, 50] and Hits@10 is a real metric), batch
        (``batch_edges`` defaults to min(batch, 16)) and endpoint capacity;
        exclusion is off. The protocol is an ``EdgeDataLoader(mode="eval")``
        over every edge on trainer view 0 with its own sampler (the
        trainers' samplers are owned by their pipeline threads)."""
        ranks: List[np.ndarray] = []
        for batch, pos, neg in self.lp_eval_batches(num_batches, seed,
                                                    num_negs, batch_edges):
            r = lp_ranks(pos, neg).cpu().numpy()
            ranks.append(r[batch.pair_mask])
        if not ranks:   # fewer edges than one batch: degenerate eval
            return {"mrr": float("nan"), "num_edges": 0,
                    **{f"hits@{k}": float("nan") for k in (1, 3, 10)}}
        r = np.concatenate(ranks).astype(np.float64)
        out = {"mrr": float((1.0 / r).mean()), "num_edges": int(len(r))}
        for k in (1, 3, 10):
            out[f"hits@{k}"] = float((r <= k).mean())
        return out

    @torch.no_grad()
    def evaluate(self, nids_old: np.ndarray, max_batches: int = 50) -> float:
        """Node-classification accuracy over ``nids_old`` through a
        ``NodeDataLoader(mode="eval")``: sequential batches, dedicated
        sampler (the trainers' samplers are owned by their possibly still
        running non_stop pipeline threads)."""
        nids = self.graph.to_new_nids(np.asarray(nids_old))
        g0 = self.graph.trainer_view(0)
        loader = NodeDataLoader(
            g0, nids, self.cfg.fanouts, batch_size=self.cfg.batch_size,
            labels=self.labels_new[nids], mode="eval",
            sampler_seed=self.job.seed + 999)
        accs = []
        with loader:
            for batch in itertools.islice(loader, max_batches):
                staged = self._stage(batch.model_input())
                logits = apply_gnn(self.cfg, self.params, staged,
                                   etype_id=self.etype_id)
                accs.append(float(nc_accuracy(logits, staged["labels"],
                                              staged["seed_mask"])))
        return float(np.mean(accs)) if accs else float("nan")

    # ---- elastic fault tolerance (DESIGN.md §10) ----------------------
    def save_checkpoint(self, directory: str, *, epoch: int,
                        batch_index: int) -> None:
        """Consistent checkpoint at coordinate ``(epoch, batch_index)``:
        dense params + optimizer, every KVStore shard WITH its row-version
        tables, and each trainer's feature-cache snapshot. Coordinates
        name the state BEFORE batch ``batch_index`` is consumed. The
        coordinate file is written atomically LAST, so a crash mid-save
        leaves the previous checkpoint intact rather than a torn one."""
        os.makedirs(directory, exist_ok=True)
        save_pytree(self.params, os.path.join(directory, "params"))
        save_pytree(self.opt, os.path.join(directory, "opt"))
        save_kvstore(self.store, os.path.join(directory, "kvstore"))
        for ti, cache in enumerate(self.caches):
            if cache is not None:
                save_cache(cache, os.path.join(directory, f"cache{ti}"))
        state = {"epoch": int(epoch), "batch_index": int(batch_index),
                 "global_step": int(self.global_step),
                 "seed": int(self.job.seed), "task": self.task,
                 "num_trainers": int(self.num_trainers),
                 "batches_per_epoch": int(self.batches_per_epoch)}
        tmp = os.path.join(directory, "state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(directory, "state.json"))

    def recover(self, directory: str) -> dict:
        """Restore a :meth:`save_checkpoint` into THIS trainer and arm the
        deterministic fast-forward: the next ``train_epoch()`` must target
        the saved epoch and resumes at the saved batch, after which every
        remaining batch — schedules, neighbor draws and negatives — is
        byte-identical to the uninterrupted run's (the counter-based RNG
        keys every draw by (seed, epoch, batch, stream), DESIGN.md §7).
        The world must match the checkpoint (same seed/task/trainer
        count/batch count) — anything else cannot replay byte-exactly and
        raises. Returns the checkpoint's coordinate metadata."""
        with open(os.path.join(directory, "state.json")) as f:
            state = json.load(f)
        mine = {"seed": int(self.job.seed), "task": self.task,
                "num_trainers": int(self.num_trainers),
                "batches_per_epoch": int(self.batches_per_epoch)}
        for key, want in mine.items():
            if state[key] != want:
                raise ValueError(
                    f"checkpoint {key}={state[key]!r} does not match this "
                    f"trainer's {key}={want!r} — deterministic replay "
                    f"needs an identically-configured world")
        # fast-forward needs fresh pipelines: drain whatever is in flight
        self.stop()
        self.params = load_pytree(self.params,
                                  os.path.join(directory, "params"))
        self.opt = load_pytree(self.opt, os.path.join(directory, "opt"))
        # order matters: restoring the shards flushes every live cache and
        # reinstates the version tables the cache snapshots validate
        # against — so a restored cache can never serve stale rows
        load_kvstore(self.store, os.path.join(directory, "kvstore"))
        for ti, cache in enumerate(self.caches):
            cdir = os.path.join(directory, f"cache{ti}")
            if cache is not None and os.path.isdir(cdir):
                load_cache(cache, cdir)
        self.global_step = int(state["global_step"])
        self._resume = (int(state["epoch"]), int(state["batch_index"]))
        return state

    def stop(self):
        for ld in self.loaders:
            ld.close()

    def spans_ms(self) -> dict:
        """Every span summed over the steps taken so far, in ms (the
        ``*_cpu`` ones: CPU time of the thread that ran the span)."""
        return {k: v * 1e3 for k, v in self.spans.totals.items()
                if k not in COUNTERS}

    def counters(self) -> dict:
        """Every counter summed over the steps taken so far."""
        return {k: self.spans.totals[k] for k in COUNTERS}

    def sampling_stats(self) -> dict:
        remote = sum(s.stats.seeds_remote for s in self.samplers)
        total = sum(s.stats.seeds_total for s in self.samplers)
        owner_req = sum(s.stats.owner_requests for s in self.samplers)
        rel_req = sum(s.stats.relation_requests for s in self.samplers)
        out = {"remote_seed_frac": remote / max(total, 1),
               "transport": self.transport.stats(),
               "sampler_requests": {
                   "owner_requests": owner_req,
                   "relation_requests": rel_req,
                   "coalescing_factor": rel_req / max(owner_req, 1),
               },
               "mean_seed_locality": self.locality["mean_local_frac"],
               "partition_time_s": self.partition_time_s}
        if self.hetero:
            per = sum(s.stats.edges_per_etype for s in self.samplers)
            out["edges_per_etype"] = {
                rel: int(per[r]) for r, rel in enumerate(self.schema.etypes)}
        live = [c for c in self.caches if c is not None]
        if live:
            per = [c.stats() for c in live]
            hits = sum(p["hits"] for p in per)
            misses = sum(p["misses"] for p in per)
            out["cache"] = {
                "hit_rate": hits / max(hits + misses, 1),
                "used_bytes": sum(p["used_bytes"] for p in per),
                "evictions": sum(p["evictions"] for p in per),
                "stale_hits": sum(p["stale_hits"] for p in per),
                "per_trainer": per,
            }
        return out
