"""Online inference service and the offline layer-wise pass (the port of
``repro/api/inference.py``).

:class:`InferenceServer` accepts single-node / small-batch predict
requests, samples each request's ego networks through the SAME
deterministic ad-hoc protocol the eval loader runs
(:func:`~repro_torch.core.sampler.sample_ego_networks`), pulls features
through a long-lived halo-prewarmed :class:`FeatureCache`, and
micro-batches concurrent requests into ONE statically-shaped stacked block
staged with one packed host-to-device copy
(:func:`~repro_torch.kernels.pack.device_stage`), so every scheduler tick
runs one forward: one launch of each kernel per layer.

The host logic -- chunking, the micro-batch window, deadlines, admission
control, degraded pulls -- is the reference's. The reference's jitted
``vmap`` over the stacked chunks is an explicit stack axis here
(:func:`~repro_torch.models.gnn.sage_layer`). A tick is always padded to
the static capacity by repeating its first chunk, and a slot's rows
depend on nothing but its own chunk, so a request returns the same bytes
whether it is served alone or co-batched.

On a typed graph (``g.hetero``) the sampler draws per relation, the
features of each node type come through ``KVClient.pull_typed_degraded``
and the forward resolves the config's name-keyed fanouts with the
schema's ``etype_id``.

:func:`offline_embeddings` is DGL's layer-wise ``inference()``: for each
layer, every chunk's full in-neighbourhood is sampled (fanout = the max
in-degree, :func:`~repro_torch.core.sampler.full_neighbor_fanouts`), the
previous layer's rows are pulled through the KVStore, the training
forward's layer (:func:`~repro_torch.models.gnn.apply_gnn_layer`) runs on
one staged arena, and the chunk's rows are pushed back as a
``DistTensor``. Its dense products run in calls of a fixed
``OFFLINE_ROW_TILE`` rows, so a node's bytes do not depend on the chunk
size.

Both run on the card unless they are given ``device="cpu"``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Union

import numpy as np
import torch

from ..core.kvstore.cache import CacheConfig, FeatureCache
from ..core.pipeline.minibatch import host_blocks
from ..core.sampler import (DistributedSampler, full_neighbor_fanouts,
                            sample_ego_networks)
from ..kernels.pack import device_stage, stack_trees
from ..models.gnn import (GNNConfig, apply_gnn, apply_gnn_layer, apply_head,
                          params_to)
from .dist_graph import DistGraph, DistTensor

# rows per dense product in the layer-wise pass: every product of every
# chunk has this one shape, so BLAS runs the same kernel on each row
OFFLINE_ROW_TILE = 4096


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a card that is absent is an
    error, never a silent switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    if device.type == "cuda":
        # the reference's products are full f32; keep TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


class ServerOverloaded(RuntimeError):
    """Admission control shed this request: the micro-batch queue is past
    ``max_pending_chunks`` (DESIGN.md §12). The request was NOT enqueued;
    the caller may retry with backoff."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline budget expired before its chunks reached a
    scheduler tick; the scheduler shed it instead of serving a stale
    answer late (DESIGN.md §12)."""


class PredictionHandle:
    """Future for one predict request: ``result()`` blocks until every
    chunk of the request has been served and returns the ``(n, C)``
    logits rows in request order.

    ``degraded`` is True when any feature row behind the answer was
    salvaged (stale cache / zero-fill) because every copy of its owner
    was down — the answer is best-effort, not byte-exact (DESIGN.md §12).
    """

    def __init__(self, num_chunks: int):
        self._parts: List[Optional[np.ndarray]] = [None] * num_chunks
        self._remaining = num_chunks
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.submitted_at = time.perf_counter()
        self.completed_at: Optional[float] = None
        self.degraded = False
        self.deadline_at: Optional[float] = None   # absolute perf_counter

    # -- server side ----------------------------------------------------
    def _deliver(self, chunk: int, rows: np.ndarray) -> None:
        with self._lock:
            if self._error is not None:   # already failed (deadline/close):
                return                    # late rows must not "complete" it
            if self._parts[chunk] is None:
                self._parts[chunk] = rows
                self._remaining -= 1
            if self._remaining == 0:
                self.completed_at = time.perf_counter()
                self._event.set()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            self._error = exc
            self.completed_at = time.perf_counter()
            self._event.set()

    # -- client side ----------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("predict request not served within "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return np.concatenate(self._parts, axis=0)


class InferenceServer:
    """Low-latency ego-network serving over a :class:`DistGraph`.

    ``predict(nids)`` / ``submit(nids)`` chunk a request into §2
    capacity blocks (``cfg.batch_size`` seeds each), sample every chunk at
    the deterministic ad-hoc coordinate ``(epoch=-1, batch_index=chunk
    position within the request)`` and hand the featurized blocks to a
    scheduler thread. The scheduler waits up to ``micro_batch_window_ms``
    to coalesce up to ``micro_batch_capacity`` chunks (across requests)
    into one stacked host tree, stages it with one packed copy to
    ``device`` and runs ONE forward; each chunk's live logit rows go back
    to its request's :class:`PredictionHandle`.

    ``params`` is the :func:`~repro_torch.models.gnn.init_gnn` tree (or
    the reference's, carried across with
    :func:`~repro_torch.models.gnn.params_from_numpy`); the server keeps a
    copy on ``device``. ``cache`` is a :class:`CacheConfig` (the server
    builds its own halo-prewarmed cache) or a shared :class:`FeatureCache`.
    """

    def __init__(self, g: DistGraph, cfg: GNNConfig, params, *,
                 cache: Union[CacheConfig, FeatureCache, None] = None,
                 micro_batch_capacity: int = 8,
                 micro_batch_window_ms: float = 2.0,
                 sampler_seed: int = 0,
                 deadline_ms: Optional[float] = None,
                 max_pending_chunks: Optional[int] = None,
                 device="cuda"):
        if micro_batch_capacity < 1:
            raise ValueError("micro_batch_capacity must be >= 1")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        if max_pending_chunks is not None and max_pending_chunks < 1:
            raise ValueError("max_pending_chunks must be >= 1")
        self.device = resolve_device(device)
        self.g = g
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.capacity = int(micro_batch_capacity)
        self.window_s = float(micro_batch_window_ms) / 1e3
        # availability knobs (DESIGN.md §12): a per-request deadline budget
        # (expired chunks are shed at tick assembly, never served late)
        # and an admission bound on the pending-chunk queue
        self.deadline_s = (None if deadline_ms is None
                           else float(deadline_ms) / 1e3)
        self.max_pending_chunks = (None if max_pending_chunks is None
                                   else int(max_pending_chunks))
        self.sampler = DistributedSampler(
            g.book, g.partitions, cfg.fanouts, cfg.batch_size,
            machine=g.machine, transport=None,   # sampling RPCs uncharged,
            seed=sampler_seed,                   # like eval (DESIGN.md §11)
            schema=g.schema if g.hetero else None,
            ntype_of_node=g.typed.ntype_of_node if g.hetero else None)
        if isinstance(cache, CacheConfig):
            cache = g.feature_cache(cache)
        elif isinstance(cache, FeatureCache):
            # shared instance: make sure this graph's feature tensors are
            # registered (idempotent) so pulls take the cached path
            names = ([f"{g.feat_name}:{nt}" for nt in g.schema.ntypes]
                     if g.hetero else [g.feat_name])
            for name in names:
                cache.register(g.store, name)
        self.cache = cache
        self.client = g.new_client()
        if cache is not None:
            self.client.attach_cache(cache)
        self.etype_id = g.schema.etype_id if g.hetero else None

        self._cond = threading.Condition()
        self._pending: List[tuple] = []    # (handle, chunk_idx, tree, live)
        self._stop = False
        self._lock = threading.Lock()      # stats
        self.requests = 0
        self.chunks = 0
        self.ticks = 0
        self.tick_chunks: List[int] = []
        self.latencies_s: List[float] = []
        self.degraded_requests = 0
        self.shed_chunks = 0          # deadline-expired at tick assembly
        self.rejected_requests = 0    # admission control (ServerOverloaded)
        self.failed_requests = 0      # handles failed during submit pulls
        # seconds spent in each step of the request path, summed over the
        # server's life (host clock; "device_forward" by CUDA events, from
        # the staged copy's arrival to the forward's end on the card)
        self.spans_s = dict.fromkeys(("sample", "pull", "stack", "stage",
                                      "forward", "device_forward"), 0.0)
        self._thread = threading.Thread(target=self._loop,
                                        name="inference-scheduler",
                                        daemon=True)
        self._thread.start()

    # -- request path ---------------------------------------------------
    def _pull_feats(self, mb) -> bool:
        """Featurize one sampled chunk through the degraded-tolerant pull
        (DESIGN.md §12): rows whose owner has no reachable copy come back
        stale-cached or zero-filled instead of raising. Returns True when
        any row was salvaged. Retry exhaustion (the data exists, the
        network is flaky) still raises — the caller fails only the
        owning handle."""
        if self.g.hetero:
            feats, fresh = self.client.pull_typed_degraded(
                self.g.feat_name, mb.input_gids, self.g.typed,
                ntypes=mb.input_ntypes)
        else:
            feats, fresh = self.client.pull_degraded(self.g.feat_name,
                                                     mb.input_gids)
        mb.input_feats = feats
        return not bool(fresh.all())

    def submit(self, nids) -> PredictionHandle:
        """Enqueue a predict request (non-blocking); sampling and feature
        pulls run in the caller's thread, the forward on the scheduler's.
        Requests larger than ``cfg.batch_size`` are split into §2 blocks
        (chunk b at ad-hoc coordinate b, exactly the eval loader's
        numbering).

        Raises :class:`ServerOverloaded` when admission control is on and
        the pending queue cannot take the request's chunks. A pull
        failure during featurization fails ONLY this request's handle
        (the error surfaces from ``result()``); rows whose owner is in a
        sustained outage degrade instead of failing, and the returned
        handle is flagged ``degraded``."""
        nids = np.asarray(nids, dtype=np.int64).reshape(-1)
        if len(nids) == 0:
            raise ValueError("empty predict request")
        if self._stop:
            raise RuntimeError("InferenceServer is closed")
        bs = self.cfg.batch_size
        num_chunks = -(-len(nids) // bs)
        if self.max_pending_chunks is not None:
            with self._cond:
                room = self.max_pending_chunks - len(self._pending)
            if num_chunks > room:
                with self._lock:
                    self.rejected_requests += 1
                raise ServerOverloaded(
                    f"pending queue has room for {max(room, 0)} chunks, "
                    f"request needs {num_chunks} (max_pending_chunks="
                    f"{self.max_pending_chunks})")
        handle = PredictionHandle(num_chunks=num_chunks)
        if self.deadline_s is not None:
            handle.deadline_at = handle.submitted_at + self.deadline_s
        entries = []
        sample_s = pull_s = 0.0
        try:
            t0 = time.perf_counter()
            for b, mb in enumerate(sample_ego_networks(
                    self.sampler, self.client, self.g.feat_name, nids,
                    typed=self.g.typed if self.g.hetero else None,
                    drop_last=False, pull_feats=False)):
                t1 = time.perf_counter()
                if self._pull_feats(mb):
                    handle.degraded = True
                tree = {"input_feats": mb.input_feats,
                        "blocks": host_blocks(mb)}
                entries.append((handle, b, tree, int(mb.seed_mask.sum())))
                t2 = time.perf_counter()
                sample_s += t1 - t0
                pull_s += t2 - t1
                t0 = t2
        except Exception as exc:
            # fail THIS handle only — co-batched requests and the
            # scheduler loop never see the error (DESIGN.md §12)
            handle._fail(exc)
            with self._lock:
                self.requests += 1
                self.failed_requests += 1
            return handle
        with self._cond:
            if self._stop:
                raise RuntimeError("InferenceServer is closed")
            self._pending.extend(entries)
            self._cond.notify_all()
        with self._lock:
            self.requests += 1
            self.chunks += len(entries)
            if handle.degraded:
                self.degraded_requests += 1
            self.spans_s["sample"] += sample_s
            self.spans_s["pull"] += pull_s
        return handle

    def predict(self, nids, timeout: Optional[float] = 60.0) -> np.ndarray:
        """Synchronous predict: ``(len(nids), num_classes)`` logits."""
        return self.submit(nids).result(timeout)

    # -- scheduler ------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if not self._pending and self._stop:
                    return
                # first chunk arrived: hold the tick open up to the
                # micro-batch window for co-batchable chunks
                deadline = time.perf_counter() + self.window_s
                while len(self._pending) < self.capacity and not self._stop:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                take = self._pending[:self.capacity]
                del self._pending[:self.capacity]
            # shed chunks whose request deadline already expired: serving
            # them would spend a tick slot on an answer nobody can use,
            # and under overload that pushes EVERY later request past its
            # own deadline (DESIGN.md §12)
            now = time.perf_counter()
            live = []
            for entry in take:
                handle = entry[0]
                if handle.deadline_at is not None and now > handle.deadline_at:
                    handle._fail(DeadlineExceeded(
                        "request shed: deadline budget "
                        f"{self.deadline_s * 1e3:.1f}ms expired before "
                        f"its tick"))
                    with self._lock:
                        self.shed_chunks += 1
                else:
                    live.append(entry)
            if live:
                self._serve_tick(live)

    def _forward(self, host_tree) -> np.ndarray:
        """One tick: stage the stacked host tree with one copy, run the
        forward over its stack axis, return (capacity, batch, C) logits."""
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        staged = device_stage(host_tree, self.device)
        t1 = time.perf_counter()
        if on_card:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        with torch.inference_mode():
            logits = apply_gnn(self.cfg, self.params, staged.unpack(),
                               etype_id=self.etype_id)
        if on_card:
            events[1].record()
        out = logits.cpu().numpy()
        t2 = time.perf_counter()
        with self._lock:
            self.spans_s["stage"] += t1 - t0
            self.spans_s["forward"] += t2 - t1
            if on_card:
                self.spans_s["device_forward"] += (
                    events[0].elapsed_time(events[1]) / 1e3)
        return out

    def _serve_tick(self, take: List[tuple]) -> None:
        try:
            trees = [t for (_h, _b, t, _n) in take]
            # pad to the static stack capacity by repeating the first
            # chunk: slots are independent, so pad contents never reach a
            # live chunk's bytes and every tick has the same shapes
            trees = trees + [trees[0]] * (self.capacity - len(trees))
            t0 = time.perf_counter()
            host_tree = stack_trees(trees)
            with self._lock:
                self.spans_s["stack"] += time.perf_counter() - t0
            logits = self._forward(host_tree)
        except BaseException as exc:   # deliver, don't kill the scheduler
            for handle, _b, _t, _n in take:
                handle._fail(exc)
            return
        with self._lock:
            self.ticks += 1
            self.tick_chunks.append(len(take))
        for i, (handle, b, _tree, n_live) in enumerate(take):
            handle._deliver(b, logits[i, :n_live])
            if handle.done() and handle.latency_s is not None:
                with self._lock:
                    self.latencies_s.append(handle.latency_s)

    # -- lifecycle / observability --------------------------------------
    def stats(self) -> dict:
        with self._lock:
            occ = (float(np.mean(self.tick_chunks))
                   if self.tick_chunks else 0.0)
            out = {"requests": self.requests, "chunks": self.chunks,
                   "ticks": self.ticks, "mean_tick_occupancy": occ,
                   "micro_batch_capacity": self.capacity,
                   "micro_batch_window_ms": self.window_s * 1e3,
                   "deadline_ms": (None if self.deadline_s is None
                                   else self.deadline_s * 1e3),
                   "max_pending_chunks": self.max_pending_chunks,
                   "degraded_requests": self.degraded_requests,
                   "shed_chunks": self.shed_chunks,
                   "rejected_requests": self.rejected_requests,
                   "failed_requests": self.failed_requests,
                   "spans_ms": {k: v * 1e3
                                for k, v in self.spans_s.items()},
                   "cache": None}
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def close(self) -> None:
        """Stop the scheduler. Chunks still queued are failed (their
        ``result()`` raises — a silently-hung future is worse than an
        error), and a scheduler thread that outlives the join timeout is
        an error, not a shrug: a live thread still owns the device and
        the handles it took."""
        with self._cond:
            self._stop = True
            orphaned = self._pending[:]
            self._pending.clear()
            self._cond.notify_all()
        self._thread.join(timeout=30)
        exc = RuntimeError("InferenceServer closed before request served")
        for handle, _b, _t, _n in orphaned:
            handle._fail(exc)
        if self._thread.is_alive():
            raise RuntimeError(
                "inference-scheduler thread did not stop within 30s of "
                "close(); it may still hold the device")

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


# ---------------------------------------------------------------------------
# offline layer-wise inference (DGL's ``inference()`` idiom)
# ---------------------------------------------------------------------------

def _layer_out_dim(cfg: GNNConfig, params: dict, layer: int) -> int:
    p = params["layers"][layer]
    if cfg.arch == "gat":
        return int(p["b"].shape[0])
    return int(p["w_self"].shape[1])


def offline_embeddings(g: DistGraph, cfg: GNNConfig, params, *,
                       chunk_size: Optional[int] = None,
                       prefix: str = "emb", device=None,
                       spans: Optional[dict] = None) -> List[DistTensor]:
    """Full-graph layer-wise inference: materialize every layer's output
    for EVERY node as KVStore-resident ``DistTensor``s.

    Layer ``l`` makes one pass over all nodes in ``chunk_size`` blocks
    (default ``cfg.batch_size``): each chunk's single-hop FULL-neighbor
    block (static capacity ``chunk_size * (1 + max_in_degree)``) is built
    by the owner-compute sampler, the layer's live input rows are pulled
    through the KVStore (layer 0: the features; layer l>0:
    ``"{prefix}{l-1}"``) and staged with one copy to ``device`` (the card
    unless ``"cpu"``), where the padded slots are filled, the training
    forward's layer runs without autograd, and the chunk's live rows are
    pushed back to ``"{prefix}{l}"`` (registered ``mutable=True``). The
    last tensor holds the model's logits (GAT's shared head applied).

    Exactness: per node the result is byte-equal to a full-neighbor
    mini-batch forward run with ``row_tile=OFFLINE_ROW_TILE`` and
    invariant to ``chunk_size``: every aggregation sums a node's edges in
    adjacency order whatever the chunking, and every dense product runs
    in calls of ``OFFLINE_ROW_TILE`` rows. ``spans``, when given, accumulates the
    seconds of each step (host clock; ``device_forward`` by CUDA events).
    """
    chunk_size = int(cfg.batch_size if chunk_size is None else chunk_size)
    if chunk_size < 2:
        # the reference's floor: a 1-node chunk moves XLA's masked segment
        # sum onto another reduction code path; every block the system
        # builds (training, eval, serving) has at least 2 seeds
        raise ValueError("chunk_size must be >= 2")
    device = resolve_device("cuda" if device is None else device)
    on_card = device.type == "cuda"
    params = params_to(params, device)
    schema = g.schema if g.hetero else None
    fanouts = full_neighbor_fanouts(g.partitions, cfg.num_layers,
                                    schema=schema)
    client = g.new_client()
    all_nids = np.arange(g.num_nodes(), dtype=np.int64)
    if spans is None:
        spans = {}
    for k in ("sample", "pull", "stage", "forward", "device_forward",
              "push"):
        spans.setdefault(k, 0.0)

    out: List[DistTensor] = []
    prev_name: Optional[str] = None
    for l in range(cfg.num_layers):
        last = l == cfg.num_layers - 1
        d_out = (cfg.num_classes if last and "head" in params
                 else _layer_out_dim(cfg, params, l))
        name = f"{prefix}{l}"
        g.store.init_data(name, (d_out,), np.float32, "node", mutable=True)

        sampler = DistributedSampler(
            g.book, g.partitions, [fanouts[l]], chunk_size,
            machine=g.machine, transport=None, seed=0, schema=schema,
            ntype_of_node=g.typed.ntype_of_node if g.hetero else None)
        rel_offs = None
        if sampler.rel_caps[0] is not None:
            rel_offs = tuple(int(x) for x in sampler.rel_caps[0])

        t0 = time.perf_counter()
        for mb in sample_ego_networks(sampler, client, g.feat_name,
                                      all_nids, typed=None,
                                      drop_last=False, pull_feats=False):
            t1 = time.perf_counter()
            # only the live input rows are pulled and staged: the padded
            # slots repeat the first input node (``pad_block``), so its
            # row is repeated on the device, the tensor the reference's
            # pull of every slot would give
            n_src = mb.blocks[0].num_src
            gids = mb.input_gids[:n_src]
            if l > 0:
                h_live = client.pull(prev_name, gids)
            elif g.hetero:
                h_live = client.pull_typed(g.feat_name, gids, g.typed,
                                           ntypes=mb.input_ntypes[:n_src])
            else:
                h_live = client.pull(g.feat_name, gids)
            t2 = time.perf_counter()
            staged = device_stage({"h": h_live,
                                   "block": host_blocks(mb)[0]},
                                  device).unpack()
            t3 = time.perf_counter()
            if on_card:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            with torch.inference_mode():
                h_src = staged["h"]
                pad = mb.blocks[0].cap_src - n_src
                if pad:
                    h_src = torch.cat([h_src, h_src[:1].expand(pad, -1)])
                h = apply_gnn_layer(cfg, params, l, h_src,
                                    staged["block"], chunk_size,
                                    rel_offsets=rel_offs,
                                    row_tile=OFFLINE_ROW_TILE)
                if last:
                    h = apply_head(params, h, OFFLINE_ROW_TILE)
            if on_card:
                events[1].record()
            rows = h.cpu().numpy()
            t4 = time.perf_counter()
            n_live = int(mb.seed_mask.sum())
            client.push(name, mb.seeds[:n_live], rows[:n_live],
                        reduce="assign")
            t5 = time.perf_counter()
            spans["sample"] += t1 - t0
            spans["pull"] += t2 - t1
            spans["stage"] += t3 - t2
            spans["forward"] += t4 - t3
            spans["push"] += t5 - t4
            if on_card:
                spans["device_forward"] += (
                    events[0].elapsed_time(events[1]) / 1e3)
            t0 = time.perf_counter()
        prev_name = name
        out.append(g.ndata[name])
    return out
