"""DGL-compatible node mini-batch loader over the async pipeline, the port
of ``repro/api/dataloader.py``'s :class:`NodeDataLoader`.

:class:`NodeDataLoader` is a true Python iterable wrapping
:class:`~repro_torch.core.pipeline.NodeMinibatchPipeline`, so the
canonical DGL training loop works against the distributed stack::

    loader = NodeDataLoader(g, train_nids, [10, 5], batch_size=32)
    for epoch in range(E):
        for input_nodes, seeds, blocks in loader:      # one epoch
            ...

The contract is the reference's: each ``iter(loader)`` serves ONE epoch
and ends with a clean ``StopIteration``; the item unpacks as
``(input_nodes, seeds, blocks)`` and also exposes the padded batch and
``model_input()``; breaking out mid-epoch is safe (``close()`` drains,
joins and rewinds, so the next iteration re-serves the SAME epoch
byte-identically); ``mode="eval"`` runs the deterministic inline
evaluation protocol (sequential batches, ad-hoc sampler coordinates,
sampling RPCs uncharged, no threads). The host batches are byte-identical
to the reference loader's for the same seeds.

On a typed graph (``g.hetero``) the sampler draws per relation and the
features of each node type come through ``KVClient.pull_typed``. The edge
loader (link prediction) is not ported yet (ROADMAP queue A item 5).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..core.pipeline.minibatch import NodeMinibatchPipeline, host_blocks
from ..core.sampler import DistributedSampler, sample_ego_networks
from .dist_graph import DistGraph

__all__ = ["NodeBatch", "NodeDataLoader"]

_MODES = ("train", "eval")


class NodeBatch:
    """One node mini-batch: unpacks as DGL's ``(input_nodes, seeds,
    blocks)`` triple; attribute access reaches the full padded batch."""

    __slots__ = ("minibatch", "device")

    def __init__(self, minibatch, device=None):
        self.minibatch = minibatch
        self.device = device   # the staged PackedBatch, if device_prefetch

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
        returns the staged :class:`~repro_torch.kernels.pack.PackedBatch`
        itself (one arena on the device)."""
        if packed:
            if self.device is None:
                raise ValueError("packed model_input needs a loader built "
                                 "with device_prefetch=True")
            return self.device
        if self.device is not None:
            tree = self.device.unpack()
            return {k: tree[k] for k in self._model_keys}
        mb = self.minibatch
        return dict(input_feats=mb.input_feats, labels=mb.labels,
                    seed_mask=mb.seed_mask, blocks=host_blocks(mb))


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
    ``device_prefetch`` to stage batches on ``device`` from the pipeline.
    ``seed`` drives the epoch schedule + pipeline, and ``sampler_seed``
    the neighbor draws (defaults keep them disjoint).

    ``mode="eval"`` is the deterministic inline evaluation protocol:
    sequential (unshuffled) batches over ``nids``, ad-hoc sampler
    coordinates, no pipeline threads, sampling RPCs uncharged.
    """

    def __init__(self, g: DistGraph, nids: np.ndarray, fanouts, *,
                 batch_size: int, labels: Optional[np.ndarray] = None,
                 shuffle: bool = True, sample_workers: int = 1,
                 cache=None, device_prefetch: bool = False, device="cuda",
                 sync: bool = False, non_stop: bool = True,
                 depths: Optional[dict] = None, seed: int = 0,
                 sampler_seed: Optional[int] = None, mode: str = "train"):
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
                to_device=device_prefetch, device=device, seed=seed,
                typed=g.typed, cache=cache, sample_workers=sample_workers,
                shuffle=shuffle)

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

