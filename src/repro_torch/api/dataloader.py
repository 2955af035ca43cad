"""DGL-compatible mini-batch loaders over the async pipeline, the port of
``repro/api/dataloader.py``.

:class:`NodeDataLoader` / :class:`EdgeDataLoader` are true Python iterables
wrapping :class:`~repro_torch.core.pipeline.NodeMinibatchPipeline` /
:class:`~repro_torch.core.pipeline.LinkMinibatchPipeline`, so the
canonical DGL training loop works against the distributed stack::

    loader = NodeDataLoader(g, train_nids, [10, 5], batch_size=32)
    for epoch in range(E):
        for input_nodes, seeds, blocks in loader:      # one epoch
            ...

The contract is the reference's: each ``iter(loader)`` serves ONE epoch
and ends with a clean ``StopIteration``; the item unpacks as
``(input_nodes, seeds, blocks)`` (node) / ``(input_nodes, pair_graph,
blocks)`` (edge) and also exposes the padded batch and
``model_input()``; breaking out mid-epoch is safe (``close()`` drains,
joins and rewinds, so the next iteration re-serves the SAME epoch
byte-identically); ``mode="eval"`` runs the deterministic inline
evaluation protocol (sequential batches, ad-hoc sampler coordinates,
sampling RPCs uncharged, no threads). The host batches are byte-identical
to the reference loader's for the same seeds.

On a typed graph (``g.hetero``) the sampler draws per relation and the
features of each node type come through ``KVClient.pull_typed``; the edge
loader then schedules one relation a batch and draws its negatives from
the relation's destination node type.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..core.pipeline.minibatch import (LinkMinibatchPipeline,
                                       NodeMinibatchPipeline, edge_model_tree,
                                       host_blocks)
from ..core.sampler import (DistributedSampler, EdgeBatchSampler,
                            sample_ego_networks)
from ..kernels.pack import PackedBatch
from .dist_graph import DistGraph

__all__ = ["NodeBatch", "NodeDataLoader", "EdgeBatch", "EdgeDataLoader"]

_MODES = ("train", "eval")


class NodeBatch:
    """One node mini-batch: unpacks as DGL's ``(input_nodes, seeds,
    blocks)`` triple; attribute access reaches the full padded batch."""

    __slots__ = ("minibatch", "device")

    def __init__(self, minibatch, device=None):
        self.minibatch = minibatch
        # the staged batch, if device_prefetch: a PackedBatch, or with
        # packed_staging=False a tree of one tensor an array
        self.device = device

    def __iter__(self):
        return iter((self.input_nodes, self.seeds, self.blocks))

    input_nodes = property(lambda self: self.minibatch.input_gids)
    input_ntypes = property(lambda self: self.minibatch.input_ntypes)
    input_feats = property(lambda self: self.minibatch.input_feats)
    seeds = property(lambda self: self.minibatch.seeds)
    seed_mask = property(lambda self: self.minibatch.seed_mask)
    labels = property(lambda self: self.minibatch.labels)
    blocks = property(lambda self: self.minibatch.blocks)
    epoch = property(lambda self: self.minibatch.epoch)
    batch_index = property(lambda self: self.minibatch.batch_index)

    _model_keys = ("input_feats", "labels", "seed_mask", "blocks")

    def model_input(self, packed: bool = False):
        """The dict the training step consumes: host arrays, or the staged
        tensors when the loader has ``device_prefetch``. ``packed=True``
        (needs ``device_prefetch=True`` with ``packed_staging=True``)
        returns the staged :class:`~repro_torch.kernels.pack.PackedBatch`
        itself (one arena on the device)."""
        if packed:
            if not isinstance(self.device, PackedBatch):
                raise ValueError(
                    "packed model_input needs a loader built with "
                    "device_prefetch=True and packed_staging=True")
            return self.device
        if self.device is not None:
            return {k: self.device[k] for k in self._model_keys}
        return self._host_input()

    def _host_input(self) -> dict:
        mb = self.minibatch
        return dict(input_feats=mb.input_feats, labels=mb.labels,
                    seed_mask=mb.seed_mask, blocks=host_blocks(mb))


class EdgeBatch(NodeBatch):
    """One edge (link-prediction) mini-batch: unpacks as DGL's
    ``(input_nodes, pair_graph, blocks)`` triple."""

    __slots__ = ()

    def __iter__(self):
        return iter((self.input_nodes, self.pair_graph, self.blocks))

    pair_graph = property(lambda self: self.minibatch.pair_graph)
    pos_u = property(lambda self: self.minibatch.pos_u)
    pos_v = property(lambda self: self.minibatch.pos_v)
    neg_v = property(lambda self: self.minibatch.neg_v)
    pair_mask = property(lambda self: self.minibatch.pair_mask)
    edge_etypes = property(lambda self: self.minibatch.edge_etypes)
    pos_src = property(lambda self: self.minibatch.pos_src)
    pos_dst = property(lambda self: self.minibatch.pos_dst)
    neg_dst = property(lambda self: self.minibatch.neg_dst)
    pos_eids = property(lambda self: self.minibatch.pos_eids)
    etype = property(lambda self: self.minibatch.etype)

    _model_keys = ("input_feats", "seed_mask", "pos_u", "pos_v", "neg_v",
                   "pair_mask", "edge_etypes", "blocks")

    def _host_input(self) -> dict:
        return edge_model_tree(self.minibatch)


class _BaseLoader:
    """Shared loader protocol: epoch iteration, teardown, stats."""

    _wrap_cls = NodeBatch

    def __init__(self, g: DistGraph, mode: str):
        if mode not in _MODES:
            raise ValueError(f"unknown loader mode {mode!r}; have {_MODES}")
        self.g = g
        self.mode = mode
        self.pipeline = None       # set by subclasses (train mode only)
        self.sampler: Optional[DistributedSampler] = None
        self.cache = None
        self._next_epoch = 0
        self._mid_epoch = False

    # -- iteration ------------------------------------------------------
    def __len__(self) -> int:
        raise NotImplementedError

    def _eval_iter(self) -> Iterator:
        raise NotImplementedError

    def _wrap(self, item):
        if isinstance(item, tuple):   # device-prefetch stage: (batch, dev)
            mb, dev = item
            return self._wrap_cls(mb, device=dev)
        return self._wrap_cls(item)

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator:
        """Iterate one specific epoch's batches (what the trainer iterates;
        in non-stop mode epochs must be requested consecutively).
        ``start_batch=k`` derives the epoch's schedule in full and begins
        emission at batch k."""
        if self.mode == "eval":
            if start_batch:
                raise ValueError("start_batch is a train-mode feature; "
                                 "eval loaders always run in full")
            yield from self._eval_iter()
            return
        if self._mid_epoch:
            # previous iteration abandoned mid-epoch: drain + rewind so
            # this epoch starts from a clean schedule (byte-identical to
            # a fresh run of the same epoch)
            self.close(_rewind_epoch=False)
        n = len(self)
        served = start_batch
        for item in self.pipeline.epoch(epoch, start_batch=start_batch):
            # only a stream some batch actually left is mid-epoch; a call
            # that errors before its first batch leaves the stream intact
            self._mid_epoch = True
            served += 1
            if served >= n:
                # epoch boundary reached the moment the last batch left
                # the pipeline
                self._mid_epoch = False
                self._next_epoch = epoch + 1
            yield self._wrap(item)

    def __iter__(self) -> Iterator:
        """One epoch per iteration, auto-advancing; an epoch abandoned
        mid-way does not count and is re-served from scratch."""
        return self.epoch(self._next_epoch)

    # -- teardown -------------------------------------------------------
    def close(self, _rewind_epoch: bool = True) -> None:
        """Drain in-flight batches, join every pipeline thread, rewind.
        A closed loader is reusable; plain iteration restarts from epoch
        0 (explicit ``epoch()`` callers drive their own numbering)."""
        if self.pipeline is not None:
            self.pipeline.stop()
        self._mid_epoch = False
        if _rewind_epoch:
            self._next_epoch = 0

    # alias matching the pipelines' own verb
    stop = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- stats ----------------------------------------------------------
    @property
    def non_stop(self) -> bool:
        return self.pipeline is not None and self.pipeline.non_stop

    def stats_report(self) -> dict:
        """Loader-level observability: per-stage pipeline times, cache
        hit rate, sampler request coalescing."""
        out = {"batches_per_epoch": len(self),
               "stages": ({} if self.pipeline is None
                          else self.pipeline.stats_report()),
               "sampler": self.sampler.stats.as_dict(),
               "cache": None}
        if self.cache is not None:
            c = self.cache.stats()
            c["hit_rate"] = c["hits"] / max(c["hits"] + c["misses"], 1)
            out["cache"] = c
        return out


class NodeDataLoader(_BaseLoader):
    """DGL's ``NodeDataLoader`` over the distributed stack.

    Parameters mirror the reference's: ``fanouts`` (per layer; int or
    ``{etype: fanout}``),
    ``batch_size`` seeds per batch, ``labels`` aligned with ``nids``
    (host-resident), optional per-trainer hot-vertex ``cache``
    (:meth:`DistGraph.feature_cache`), ``sample_workers`` pool threads,
    ``device_prefetch`` to stage batches on ``device`` from the pipeline
    (``packed_staging=False``: one copy an array instead of one packed
    arena; the same bytes on the device).
    ``seed`` drives the epoch schedule + pipeline, and ``sampler_seed``
    the neighbor draws (defaults keep them disjoint). ``tracer`` (the
    trainer's span object) receives the pipeline's sampling and
    feature-pull times.

    ``mode="eval"`` is the deterministic inline evaluation protocol:
    sequential (unshuffled) batches over ``nids``, ad-hoc sampler
    coordinates, no pipeline threads, sampling RPCs uncharged.
    """

    def __init__(self, g: DistGraph, nids: np.ndarray, fanouts, *,
                 batch_size: int, labels: Optional[np.ndarray] = None,
                 shuffle: bool = True, sample_workers: int = 1,
                 cache=None, device_prefetch: bool = False,
                 packed_staging: bool = True, device="cuda",
                 sync: bool = False, non_stop: bool = True,
                 depths: Optional[dict] = None, seed: int = 0,
                 sampler_seed: Optional[int] = None, mode: str = "train",
                 tracer=None):
        super().__init__(g, mode)
        self.nids = np.asarray(nids, dtype=np.int64)
        self.labels = labels
        self.batch_size = int(batch_size)
        eval_mode = mode == "eval"
        self.sampler = DistributedSampler(
            g.book, g.partitions, fanouts, self.batch_size,
            machine=g.machine,
            transport=None if eval_mode else g.transport,
            seed=seed + 100 if sampler_seed is None else sampler_seed,
            schema=g.schema if g.hetero else None,
            ntype_of_node=g.typed.ntype_of_node if g.hetero else None)
        self._client = g.new_client()
        self.cache = cache
        if not eval_mode:
            self.pipeline = NodeMinibatchPipeline(
                self.sampler, self._client, g.feat_name, self.nids,
                labels=labels, sync=sync, non_stop=non_stop, depths=depths,
                to_device=device_prefetch, packed=packed_staging,
                device=device, seed=seed, typed=g.typed, cache=cache,
                sample_workers=sample_workers, shuffle=shuffle,
                tracer=tracer)

    def __len__(self) -> int:
        if self.pipeline is not None:
            return self.pipeline.batches_per_epoch
        return len(self.nids) // self.batch_size

    def _eval_iter(self) -> Iterator[NodeBatch]:
        # the shared ad-hoc protocol (core.sampler.ego): the inference
        # server runs the SAME function
        for mb in sample_ego_networks(self.sampler, self._client,
                                      self.g.feat_name, self.nids,
                                      labels=self.labels,
                                      typed=self.g.typed if self.g.hetero
                                      else None):
            yield NodeBatch(mb)



class EdgeDataLoader(_BaseLoader):
    """DGL's ``EdgeDataLoader``: positive-edge mini-batches with negative
    sampling and endpoint ego-networks, over the same async pipeline.
    ``batch_size`` counts POSITIVE EDGES; the node sampler runs at the
    derived endpoint capacity ``2B + B*K`` (``2B`` for in-batch negatives).

    ``eids`` is this trainer's positive-edge pool (NEW edge-id space,
    :meth:`DistGraph.edge_split`). On the typed path each scheduled batch
    carries one relation and negatives are drawn type-correctly from the
    relation's destination node type. ``edge_seed`` drives the positive
    schedule and negative draws; ``mode="eval"`` runs the deterministic
    evaluation protocol (a fresh schedule from ``edge_seed`` each
    iteration, ad-hoc sampler coordinates, sampling RPCs uncharged, no
    threads). The batches are byte-identical to the reference loader's
    for the same seeds. ``tracer`` as :class:`NodeDataLoader`'s.
    """

    _wrap_cls = EdgeBatch

    def __init__(self, g: DistGraph, eids: np.ndarray, fanouts, *,
                 batch_size: int, num_negs: int = 16,
                 neg_mode: str = "uniform", neg_exclude: bool = False,
                 sample_workers: int = 1, cache=None,
                 device_prefetch: bool = False, packed_staging: bool = True,
                 device="cuda", sync: bool = False, non_stop: bool = True,
                 depths: Optional[dict] = None, seed: int = 0,
                 sampler_seed: Optional[int] = None,
                 edge_seed: Optional[int] = None, mode: str = "train",
                 tracer=None):
        super().__init__(g, mode)
        self.batch_size = int(batch_size)
        self.num_negs = int(num_negs)
        eval_mode = mode == "eval"
        node_bs = EdgeBatchSampler.required_node_batch(
            batch_size, num_negs, neg_mode)
        self.sampler = DistributedSampler(
            g.book, g.partitions, fanouts, node_bs, machine=g.machine,
            transport=None if eval_mode else g.transport,
            seed=seed + 100 if sampler_seed is None else sampler_seed,
            schema=g.schema if g.hetero else None,
            ntype_of_node=g.typed.ntype_of_node if g.hetero else None)
        neg_pools = etype_of_edge = schema = None
        if g.hetero:
            schema = g.schema
            etype_of_edge = g.typed.etype_of_edge
            neg_pools = [g.typed.type2node[schema.dst_ntype_id(r)]
                         for r in range(schema.num_etypes)]
        e_src, e_dst = g.edge_endpoints()
        self._edge_seed = seed + 300 if edge_seed is None else edge_seed
        self.edge_sampler = EdgeBatchSampler(
            self.sampler, e_src, e_dst, np.asarray(eids, dtype=np.int64),
            batch_size, num_negs, neg_mode=neg_mode,
            etype_of_edge=etype_of_edge, schema=schema, neg_pools=neg_pools,
            exclude_batch_positives=neg_exclude, seed=self._edge_seed)
        self._client = g.new_client()
        self.cache = cache
        if not eval_mode:
            self.pipeline = LinkMinibatchPipeline(
                self.edge_sampler, self._client, g.feat_name, sync=sync,
                non_stop=non_stop, depths=depths, to_device=device_prefetch,
                packed=packed_staging, device=device, seed=seed,
                typed=g.typed, cache=cache, sample_workers=sample_workers,
                tracer=tracer)

    def __len__(self) -> int:
        return self.edge_sampler.batches_per_epoch

    def _pull_feats(self, mb) -> np.ndarray:
        g = self.g
        if g.hetero:
            return self._client.pull_typed(g.feat_name, mb.input_gids,
                                           g.typed, ntypes=mb.input_ntypes)
        return self._client.pull(g.feat_name, mb.input_gids)

    def _eval_iter(self) -> Iterator[EdgeBatch]:
        # the trainer's link-prediction evaluation protocol: a fresh
        # deterministic schedule per iteration, so evaluations before and
        # after training rank the same edges against the same candidates
        rng = np.random.default_rng(self._edge_seed)
        for _e, b, et, eids in self.edge_sampler.schedule(rng, 0):
            emb = self.edge_sampler.sample_edges(eids, etype=et,
                                                 batch_index=b)
            emb.input_feats = self._pull_feats(emb)
            yield EdgeBatch(emb)
