"""The 5-stage GNN mini-batch generation pipeline (§5.5, Fig. 7), the port
of ``repro/core/pipeline/minibatch.py``'s node pipeline, built on
:class:`AsyncPipeline`:

  1. **batch scheduling** -- permute the trainer's seed set each epoch, cut
     into fixed-size batches (runs in the feeder thread);
  2. **neighbor sampling** -- multi-hop owner-compute sampling
     (``sample_workers`` pool threads sharing the stage queue; batches come
     out in order and byte-identical for any pool size);
  3. **CPU prefetch** -- pull input-node features (local shared-memory +
     remote KVStore) into one contiguous buffer (sampling thread);
  4. **device prefetch** -- stage the padded arrays on ``device`` with one
     packed copy (:func:`~repro_torch.kernels.pack.device_stage`; depth 1:
     device memory is scarce);
  5. **subgraph compaction** -- runs on the device in the consumer's
     thread, inside the training step.

``non_stop=True`` keeps one pipeline alive across epochs (the paper's
"non-stop asynchronous pipeline"); ``sync=True`` gives the unpipelined
baseline. The host stages and their schedule are the reference's, so the
batches are byte-identical to its pipeline's for the same seeds. On a
typed graph (``typed``, the world's ``TypedPartitionData``) the CPU
prefetch pulls each node type's features through its own policy.
:class:`LinkMinibatchPipeline` drives edge (link-prediction) mini-batches
through the same stages. Both classes have their own names: the
API-boundary check (``tools/check_docs.py``) keeps every construction of
the reference's pipeline classes inside ``repro/api``, and the port's
loaders are the only place these are built.
"""
from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np

from ...kernels.pack import device_stage
from ..kvstore.store import KVClient
from ..sampler.dispatch import DistributedSampler
from ..sampler.edge_batch import EdgeBatchSampler, EdgeMiniBatch
from ..sampler.mfg import MiniBatch
from ..sampler.prng import STREAM_SCHEDULE, batch_rng
from .async_pipeline import AsyncPipeline, Stage


def host_blocks(mb) -> list:
    """A mini-batch's padded block arrays as a plain host tree."""
    return [dict(edge_src=b.edge_src, edge_dst=b.edge_dst,
                 edge_mask=b.edge_mask, edge_types=b.edge_types)
            for b in mb.blocks]


def _epoch_schedule(seeds: np.ndarray, labels: Optional[np.ndarray],
                    batch_size: int, rng: np.random.Generator, epoch: int,
                    drop_last: bool = True, shuffle: bool = True,
                    start_batch: int = 0):
    """Stage 1: uniform random batch schedule over this trainer's seed set
    (``shuffle=False``: fixed sequential batches -- inference/eval order).

    ``start_batch`` fast-forwards the schedule: the permutation is drawn in
    full -- identical rng consumption -- and only the emission is skipped,
    so batch k's seed selection is byte-identical whether reached live or
    by fast-forward.
    """
    perm = (rng.permutation(len(seeds)) if shuffle
            else np.arange(len(seeds), dtype=np.int64))
    n_batches = (len(seeds) // batch_size if drop_last
                 else -(-len(seeds) // batch_size))
    for b in range(start_batch, n_batches):
        sel = perm[b * batch_size:(b + 1) * batch_size]
        yield (epoch, b, seeds[sel], None if labels is None else labels[sel])


class NodeMinibatchPipeline:
    """The node mini-batch pipeline. ``to_device`` adds the device-prefetch
    stage, which stages each batch on ``device``."""

    def __init__(self, sampler: DistributedSampler, kv_client: KVClient,
                 feat_name: str, seeds: np.ndarray,
                 labels: Optional[np.ndarray] = None, *,
                 batch_size: Optional[int] = None,
                 depths: dict | None = None,
                 sync: bool = False, non_stop: bool = True,
                 to_device: bool = True, device="cuda", seed: int = 0,
                 typed=None, cache=None, sample_workers: int = 1,
                 shuffle: bool = True):
        self.sampler = sampler
        self.kv_client = kv_client
        self.feat_name = feat_name
        # heterograph runs: features are registered per node type
        # ("<feat_name>:<ntype>") and the prefetch stage routes each type
        # through its own policy
        self.typed = typed
        # per-trainer hot-vertex cache (kvstore.cache): the CPU-prefetch
        # stage's pulls consult it for remote rows; hits never touch the
        # transport. None = uncached (byte-identical batches either way).
        self.cache = cache
        if cache is not None:
            kv_client.attach_cache(cache)
        self.seeds = np.asarray(seeds, dtype=np.int64)
        self.labels = labels
        self.batch_size = batch_size or sampler.batch_size
        d = {"sample": 8, "cpu_prefetch": 4, "device_prefetch": 1}
        d.update(depths or {})
        self.depths = d
        self.sync = sync
        self.non_stop = non_stop
        self.to_device = to_device
        self.device = device
        # counter-based schedule randomness: each epoch's permutation
        # derives from (seed, epoch) so schedules are replayable and
        # independent of how many epochs ran before
        self.seed = seed
        self.sample_workers = max(int(sample_workers), 1)
        self.shuffle = shuffle
        self.batches_per_epoch = len(self.seeds) // self.batch_size
        self._pipe: Optional[AsyncPipeline] = None
        self._out_iter = None
        self._nonstop_epoch: Optional[int] = None
        # batches pulled off the non-stop stream within the current epoch:
        # the mid-epoch abandonment guard (see epoch()) keys on it
        self._epoch_pos = 0
        self._lock = threading.Lock()

    # ---- stages -------------------------------------------------------
    def _stage_sample(self, item) -> MiniBatch:
        epoch, b, seeds, labels = item
        return self.sampler.sample(seeds, labels=labels, batch_index=b,
                                   epoch=epoch)

    def _stage_cpu_prefetch(self, mb: MiniBatch) -> MiniBatch:
        # one contiguous buffer, exactly the paper's "collect data from both
        # local machines and remote machines ... store in contiguous memory"
        if self.typed is not None:
            # the sampler already typed the frontier (mb.input_ntypes)
            mb.input_feats = self.kv_client.pull_typed(
                self.feat_name, mb.input_gids, self.typed,
                ntypes=mb.input_ntypes)
        else:
            mb.input_feats = self.kv_client.pull(self.feat_name,
                                                 mb.input_gids)
        return mb

    def _stage_device_prefetch(self, mb: MiniBatch):
        if not self.to_device:
            return mb
        tree = dict(input_feats=mb.input_feats, seeds=mb.seeds,
                    seed_mask=mb.seed_mask, labels=mb.labels,
                    blocks=host_blocks(mb))
        return mb, device_stage(tree, self.device)

    # ---- driving ------------------------------------------------------
    def _epoch_rng(self, epoch: int) -> np.random.Generator:
        return batch_rng(self.seed, epoch, 0, STREAM_SCHEDULE)

    def _schedule_source(self, epochs: Iterator[int], start_batch: int = 0):
        for e in epochs:
            yield from _epoch_schedule(self.seeds, self.labels,
                                       self.batch_size, self._epoch_rng(e), e,
                                       shuffle=self.shuffle,
                                       start_batch=start_batch)
            # fast-forward applies to the FIRST epoch of the stream only:
            # subsequent epochs replay from their own batch 0
            start_batch = 0

    def _build(self, epochs, start_batch: int = 0) -> AsyncPipeline:
        stages = [
            Stage("sample", self._stage_sample, depth=self.depths["sample"],
                  workers=self.sample_workers),
            Stage("cpu_prefetch", self._stage_cpu_prefetch,
                  depth=self.depths["cpu_prefetch"]),
            Stage("device_prefetch", self._stage_device_prefetch,
                  depth=self.depths["device_prefetch"]),
        ]
        return AsyncPipeline(self._schedule_source(epochs, start_batch),
                             stages, sync=self.sync, name="minibatch")

    def epoch(self, epoch: int, start_batch: int = 0):
        """Iterate one epoch's mini-batches.

        Non-stop mode keeps ONE pipeline alive across epochs: the internal
        epoch stream starts at the first requested epoch and advances by
        one per completed epoch, so callers MUST ask for consecutive
        epochs (e, e+1, e+2, ...). A non-consecutive request raises
        instead of silently serving batches labeled (and permuted) for a
        different epoch. Abandoning an epoch iterator mid-epoch leaves the
        remaining batches in flight: a later ``epoch()`` call raises;
        ``stop()`` drains the in-flight work and rewinds (the port's
        loaders do exactly that on early ``close()``).

        ``start_batch=k`` derives the epoch's full schedule as usual but
        begins emission at batch k. Only valid on a fresh pipeline:
        batches already in flight were scheduled from batch 0."""
        if self.non_stop and not self.sync:
            with self._lock:
                if start_batch and self._pipe is not None:
                    raise ValueError(
                        "fast-forward (start_batch != 0) requires a fresh "
                        "pipeline -- stop() first")
                if (self._pipe is not None and self._epoch_pos
                        not in (0, self.batches_per_epoch)):
                    raise ValueError(
                        f"non-stop pipeline abandoned mid-epoch (batch "
                        f"{self._epoch_pos}/{self.batches_per_epoch} of epoch "
                        f"{self._nonstop_epoch - 1}) -- stop() to drain and "
                        f"rewind before starting another epoch")
                if self._pipe is None:
                    self._nonstop_epoch = epoch

                    # infinite epoch stream; the pipeline never drains
                    def forever():
                        e = epoch
                        while True:
                            yield e
                            e += 1
                    self._pipe = self._build(forever(), start_batch)
                    self._out_iter = iter(self._pipe)
                elif epoch != self._nonstop_epoch:
                    raise ValueError(
                        f"non-stop pipeline serves consecutive epochs: "
                        f"expected epoch {self._nonstop_epoch}, got {epoch} "
                        f"(stop() the pipeline to rewind or skip)")
                self._nonstop_epoch = epoch + 1
                self._epoch_pos = start_batch
            for _ in range(self.batches_per_epoch - start_batch):
                item = next(self._out_iter)
                # count at pull time: once off the stream, the stream is
                # past it -- a consumer that stops right after taking the
                # last batch has still cleanly finished the epoch
                self._epoch_pos += 1
                yield item
        else:
            pipe = self._build(iter([epoch]), start_batch)
            self._pipe = pipe
            yield from pipe

    def stop(self):
        if self._pipe is not None:
            self._pipe.stop()
            self._pipe = None
            self._out_iter = None
            self._nonstop_epoch = None
            self._epoch_pos = 0

    def stats_report(self) -> dict:
        return {} if self._pipe is None else self._pipe.stats_report()


class LinkMinibatchPipeline(NodeMinibatchPipeline):
    """The same 5-stage async pipeline driving *edge* mini-batches (link
    prediction), the port of ``repro/core/pipeline/minibatch.py``'s
    ``EdgeMinibatchPipeline``: edge scheduling -> endpoint ego-network
    sampling -> CPU feature prefetch (cached KVStore pulls) -> device
    prefetch -> compaction in the consumer.

    Only stages 1-2 and the staged tree change: the schedule permutes the
    trainer's owned positive edges (per relation on the typed path)
    instead of its seed nodes, and the sample stage wraps the node sampler
    through ``EdgeBatchSampler``. The ``EdgeMiniBatch`` it emits
    duck-types the ``MiniBatch`` surface, so the CPU prefetch (and the
    hot-vertex cache under it) is inherited unchanged.
    """

    def __init__(self, edge_sampler: EdgeBatchSampler, kv_client: KVClient,
                 feat_name: str, **kw):
        self.edge_sampler = edge_sampler
        super().__init__(edge_sampler.node_sampler, kv_client, feat_name,
                         seeds=edge_sampler.owned_eids,
                         batch_size=edge_sampler.batch_edges, **kw)
        # per-relation pools drop their own tails, so the count is not
        # len(owned) // B on typed runs: ask the edge scheduler
        self.batches_per_epoch = edge_sampler.batches_per_epoch

    # ---- stages -------------------------------------------------------
    def _stage_sample(self, item) -> EdgeMiniBatch:
        epoch, b, etype, eids = item
        return self.edge_sampler.sample_edges(eids, etype=etype,
                                              batch_index=b, epoch=epoch)

    def _stage_device_prefetch(self, emb: EdgeMiniBatch):
        if not self.to_device:
            return emb
        return emb, device_stage(edge_model_tree(emb), self.device)

    # ---- driving ------------------------------------------------------
    def _schedule_source(self, epochs: Iterator[int], start_batch: int = 0):
        for e in epochs:
            yield from self.edge_sampler.schedule(self._epoch_rng(e), e,
                                                  start_batch=start_batch)
            start_batch = 0


def edge_model_tree(emb: EdgeMiniBatch) -> dict:
    """The host arrays of an edge mini-batch that the link-prediction step
    consumes (the reference's edge device-prefetch tree)."""
    return dict(input_feats=emb.input_feats, seed_mask=emb.seed_mask,
                pos_u=emb.pos_u, pos_v=emb.pos_v, neg_v=emb.neg_v,
                pair_mask=emb.pair_mask, edge_etypes=emb.edge_etypes,
                blocks=host_blocks(emb))
