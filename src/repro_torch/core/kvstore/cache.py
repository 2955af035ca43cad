"""Hot-vertex feature cache on the KVStore read path (ROADMAP "caching").

DistDGLv2 attacks remote feature pulls with min-edge-cut partitioning and
the async pipeline; the next lever — caching frequently accessed *remote*
rows on the trainer — is standard in the distributed-GNN literature
(Vatter et al., arXiv:2305.13854) and directly targets the remote-pull
breakdown of DistDGL's Table 4 (arXiv:2010.05337). This module provides a
per-trainer :class:`FeatureCache` that any :class:`~.store.KVClient` can
consult:

* **scope** — only rows owned by a *remote* partition are ever cached; the
  local partition is shared memory already (caching it would only copy);
* **admission** — pre-warm from the partition book's halo access counts
  (:func:`halo_access_counts`: a halo vertex's local in-edge count is a
  static prediction of its pull frequency), then online frequency — a row
  is admitted once it has been pulled ``admit_after`` times;
* **eviction** — CLOCK (second chance, O(1) amortized) or strict LRU under
  a per-trainer byte budget shared by all registered tensors;
* **consistency** — mutable tables (``DistEmbedding`` rows updated by
  sparse-Adam pushes) carry per-row version counters in the
  ``DistKVStore``; a cached row whose stored version no longer matches is
  a miss and is refreshed, so the cache **never serves stale data**.
  Immutable feature tensors skip version bookkeeping entirely (no counter
  reads on the hot path). See DESIGN.md §5 for the full contract.

The cache-on read path is numerically byte-identical to cache-off (guarded
by the golden-hash tests): a hit returns exactly the bytes the owning
server would have sent.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Per-trainer cache policy knobs (wired through ``TrainJobConfig`` and
    ``launch/train.py --cache-budget-mb / --cache-policy``)."""
    budget_bytes: int = 64 * 1024 * 1024
    policy: str = "clock"          # "clock" | "lru"
    admit_after: int = 1           # admit a row on its admit_after-th miss
    prewarm: bool = True           # pre-warm from halo access counts
    prewarm_frac: float = 1.0      # fraction of the budget prewarm may fill
    # only pre-pull halo rows this many local edges reference: a count-1
    # row may never be sampled at all (fanout subsampling), so paying its
    # pull up front is a pure byte loss; multiply-referenced rows are
    # near-certain repeat pulls and amortize immediately
    prewarm_min_count: int = 2

    @staticmethod
    def from_mb(budget_mb: float, policy: str = "clock",
                **kw) -> "CacheConfig":
        return CacheConfig(budget_bytes=int(budget_mb * 1024 * 1024),
                           policy=policy, **kw)

    def __post_init__(self):
        if self.policy not in ("clock", "lru"):
            raise ValueError(f"unknown cache policy {self.policy!r}")
        if self.budget_bytes <= 0:
            raise ValueError("cache budget must be positive")


def halo_access_counts(partition) -> Tuple[np.ndarray, np.ndarray]:
    """Static pull-frequency prediction from one machine's partition.

    A partition's halo vertices are exactly the remote endpoints its local
    edges reference; each halo vertex's local in-edge count is how many
    edge slots can demand its features, i.e. the partition book's access
    count for that remote vertex. Returns ``(gids, counts)`` sorted by
    count descending (ties broken by gid for determinism).
    """
    n_core = partition.n_core
    halo_local = partition.indices[partition.indices >= n_core] - n_core
    counts = np.bincount(halo_local, minlength=partition.n_halo)
    gids = partition.local2global[n_core:]
    order = np.lexsort((gids, -counts))
    return gids[order], counts[order]


class _TensorCache:
    """One tensor's slab: a growable row array + gid->slot map.

    ``slot_of`` is an ``OrderedDict`` so the LRU policy is O(1)
    (``move_to_end`` on hit, first entry is the victim); CLOCK ignores the
    order and uses the ``ref`` second-chance bits instead.
    """

    def __init__(self, name: str, row_shape: tuple, dtype, row_nbytes: int,
                 mutable: bool, policy: str):
        self.name = name
        self.row_shape = tuple(row_shape)
        self.dtype = np.dtype(dtype)
        self.row_nbytes = row_nbytes
        self.mutable = mutable
        self.policy = policy
        self.rows = np.empty((0,) + self.row_shape, dtype=self.dtype)
        self.slot_gid = np.empty(0, dtype=np.int64)      # slot -> gid
        self.ref = np.empty(0, dtype=bool)               # CLOCK ref bits
        self.version = np.empty(0, dtype=np.int64)       # mutable only
        self.slot_of: "OrderedDict[int, int]" = OrderedDict()
        self.free: List[int] = []
        self.hand = 0
        self.freq: Dict[int, int] = {}

    @property
    def num_rows(self) -> int:
        return len(self.slot_of)

    def _grow(self, min_slots: int, max_slots: int) -> None:
        cur = len(self.slot_gid)
        new = min(max(2 * cur, min_slots, 64), max_slots)
        if new <= cur:
            return
        rows = np.empty((new,) + self.row_shape, dtype=self.dtype)
        rows[:cur] = self.rows
        self.rows = rows
        self.slot_gid = np.concatenate(
            [self.slot_gid, np.full(new - cur, -1, dtype=np.int64)])
        self.ref = np.concatenate([self.ref, np.zeros(new - cur, dtype=bool)])
        self.version = np.concatenate(
            [self.version, np.zeros(new - cur, dtype=np.int64)])
        self.free.extend(range(cur, new))

    def evict_one(self) -> bool:
        """Free one slot per the eviction policy. False if nothing cached."""
        if not self.slot_of:
            return False
        if self.policy == "lru":
            gid, slot = self.slot_of.popitem(last=False)
        else:   # CLOCK: advance the hand, clearing second-chance bits
            n = len(self.slot_gid)
            while True:
                self.hand %= n
                s = self.hand
                self.hand += 1
                if self.slot_gid[s] < 0:
                    continue
                if self.ref[s]:
                    self.ref[s] = False
                    continue
                slot, gid = s, int(self.slot_gid[s])
                del self.slot_of[gid]
                break
        self.slot_gid[slot] = -1
        self.ref[slot] = False
        self.free.append(slot)
        return True

    def invalidate(self, gid: int) -> bool:
        slot = self.slot_of.pop(gid, None)
        if slot is None:
            return False
        self.slot_gid[slot] = -1
        self.ref[slot] = False
        self.free.append(slot)
        return True


class FeatureCache:
    """Per-trainer hot-vertex cache over remote KVStore rows.

    One instance per trainer (attach with ``KVClient.attach_cache``); the
    sampling thread's CPU-prefetch pulls and the training thread's
    embedding pulls may interleave, so all public methods lock.

    ``lookup`` / ``insert`` are the two halves of the read path: the
    client looks up remote ids, fetches the misses from the owning
    servers, and inserts what came back (admission permitting). ``warm``
    force-inserts pre-pulled rows, bypassing frequency admission.
    """

    def __init__(self, config: CacheConfig, store=None):
        self.config = config
        self.store = store          # version authority for mutable tensors
        self._tensors: Dict[str, _TensorCache] = {}
        self._lock = threading.RLock()
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.stale_hits = 0         # version-mismatched entries refreshed
        self.degraded_hits = 0      # stale rows served by lookup_stale
        self.evictions = 0
        self.rejected = 0           # admission-declined inserts

    # -- registration ---------------------------------------------------
    def register(self, store, name: str) -> None:
        """Register one KVStore tensor (idempotent). Row shape/dtype come
        from the store; mutability from the store's version table."""
        with self._lock:
            if name in self._tensors:
                return
            self.store = store
            sample = store.servers[0].local_view(name)
            row_shape = sample.shape[1:]
            row_nbytes = int(sample.dtype.itemsize
                             * int(np.prod(row_shape, initial=1)))
            if row_nbytes > self.config.budget_bytes:
                raise ValueError(
                    f"cache budget {self.config.budget_bytes}B below one "
                    f"{name!r} row ({row_nbytes}B)")
            self._tensors[name] = _TensorCache(
                name, row_shape, sample.dtype, row_nbytes,
                mutable=store.is_mutable(name), policy=self.config.policy)
            store.note_cache_registration(name, self)

    def has(self, name: str) -> bool:
        return name in self._tensors

    # -- read path ------------------------------------------------------
    def lookup(self, name: str, gids: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(hit_mask, rows[hits]) for remote ``gids``; counts frequency on
        every access. Mutable tensors: a version-mismatched entry is
        invalidated and reported as a miss (never stale data)."""
        tc = self._tensors[name]
        gids = np.asarray(gids, dtype=np.int64)
        with self._lock:
            slots = np.fromiter((tc.slot_of.get(int(g), -1) for g in gids),
                                dtype=np.int64, count=len(gids))
            hit = slots >= 0
            if tc.mutable and hit.any():
                cur = self.store.versions_of(name, gids[hit])
                fresh = tc.version[slots[hit]] == cur
                if not fresh.all():
                    for g in gids[hit][~fresh]:
                        if tc.invalidate(int(g)):
                            self.used_bytes -= tc.row_nbytes
                            self.stale_hits += 1
                    idx = np.nonzero(hit)[0][~fresh]
                    hit[idx] = False
                    slots[idx] = -1
            n_hit = int(hit.sum())
            rows = tc.rows[slots[hit]].copy() if n_hit else \
                np.empty((0,) + tc.row_shape, dtype=tc.dtype)
            # touch: CLOCK second-chance bit / LRU recency
            if n_hit:
                tc.ref[slots[hit]] = True
                if tc.policy == "lru":
                    for g in gids[hit]:
                        tc.slot_of.move_to_end(int(g))
            # admission frequency only matters past the first miss; with
            # admit_after <= 1 (the default) skip the bookkeeping — on a
            # billion-scale graph the dict would otherwise accumulate one
            # entry per ever-missed remote vertex
            if self.config.admit_after > 1:
                for g in gids[~hit]:
                    g = int(g)
                    tc.freq[g] = tc.freq.get(g, 0) + 1
                # bound the counter dict to a few multiples of the slot
                # count — admission bookkeeping must not dwarf the row
                # budget it guards; losing partial counts only delays
                # admission, never breaks correctness
                cap = max(4 * (self.config.budget_bytes // tc.row_nbytes),
                          4096)
                if len(tc.freq) > cap:
                    tc.freq = {g: c for g, c in tc.freq.items()
                               if c >= self.config.admit_after}
                    if len(tc.freq) > cap:
                        tc.freq.clear()
            self.hits += n_hit
            self.misses += len(gids) - n_hit
            return hit, rows

    def lookup_stale(self, name: str, gids: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(hit_mask, rows[hits]) with version checks SKIPPED — the
        degraded-serving salvage path (DESIGN.md §12), used only when
        every copy of the owner is unreachable. A possibly-stale row beats
        a zero-filled one: the bytes were valid when cached (bounded
        staleness — at most the writes since this entry was inserted).
        Accounted separately (``degraded_hits``) and touches neither the
        hit/miss counters nor recency/frequency state, so degraded reads
        never perturb the normal cache policy."""
        tc = self._tensors[name]
        gids = np.asarray(gids, dtype=np.int64)
        with self._lock:
            slots = np.fromiter((tc.slot_of.get(int(g), -1) for g in gids),
                                dtype=np.int64, count=len(gids))
            hit = slots >= 0
            n_hit = int(hit.sum())
            rows = tc.rows[slots[hit]].copy() if n_hit else \
                np.empty((0,) + tc.row_shape, dtype=tc.dtype)
            self.degraded_hits += n_hit
            return hit, rows

    def insert(self, name: str, gids: np.ndarray, rows: np.ndarray,
               force: bool = False,
               versions: Optional[np.ndarray] = None) -> int:
        """Admit fetched remote rows; returns how many were admitted.

        Regular inserts respect frequency admission (``admit_after``
        misses recorded by ``lookup``); ``force=True`` (pre-warm) bypasses
        it. For mutable tensors ``versions`` is the caller's snapshot taken
        *before* the fetch — entries whose store version moved since are
        skipped (the rows might predate a concurrent push). ``None`` falls
        back to a snapshot taken now, which is only safe when no writer
        can run concurrently with the caller's fetch."""
        tc = self._tensors[name]
        gids = np.asarray(gids, dtype=np.int64)
        ok = np.ones(len(gids), dtype=bool)
        if tc.mutable:
            cur = self.store.versions_of(name, gids)
            if versions is None:
                versions = cur
            else:
                ok = versions == cur
        admitted = 0
        with self._lock:
            max_slots = self.config.budget_bytes // tc.row_nbytes
            for i, g in enumerate(gids):
                g = int(g)
                if not ok[i]:
                    continue
                if g in tc.slot_of:       # refresh in place (post-invalidate
                    s = tc.slot_of[g]     # re-pull lands here)
                    tc.rows[s] = rows[i]
                    if tc.mutable:
                        tc.version[s] = versions[i]
                    continue
                if (not force and self.config.admit_after > 1
                        and tc.freq.get(g, 0) < self.config.admit_after):
                    self.rejected += 1
                    continue
                if not self._make_room(tc, max_slots):
                    self.rejected += 1
                    continue
                s = tc.free.pop()
                tc.rows[s] = rows[i]
                tc.slot_gid[s] = g
                tc.ref[s] = False
                if tc.mutable:
                    tc.version[s] = versions[i]
                tc.slot_of[g] = s
                self.used_bytes += tc.row_nbytes
                admitted += 1
        return admitted

    def _make_room(self, tc: _TensorCache, max_slots: int) -> bool:
        """Ensure ``tc`` has a free slot within the global byte budget.

        Budget pressure evicts from whichever tensor holds the most bytes
        (possibly ``tc`` itself) — always self-evicting would freeze any
        tensor registered after the budget filled at ~one row while
        earlier tensors kept cold rows forever."""
        if tc.num_rows >= max_slots:
            if not tc.evict_one():
                return False
            self.used_bytes -= tc.row_nbytes
            self.evictions += 1
        while self.used_bytes + tc.row_nbytes > self.config.budget_bytes:
            victim = max((t for t in self._tensors.values() if t.num_rows),
                         key=lambda t: t.num_rows * t.row_nbytes,
                         default=None)
            if victim is None or not victim.evict_one():
                return False
            self.used_bytes -= victim.row_nbytes
            self.evictions += 1
        if not tc.free:
            tc._grow(tc.num_rows + 1, max_slots)
        return bool(tc.free)

    # -- invalidation ---------------------------------------------------
    def drop(self, name: str) -> None:
        """Flush every entry of one tensor (bulk rewrites — checkpoint
        restore — where even immutable bytes change)."""
        if name not in self._tensors:
            return
        tc = self._tensors[name]
        with self._lock:
            for gid in list(tc.slot_of):
                if tc.invalidate(gid):
                    self.used_bytes -= tc.row_nbytes

    def invalidate(self, name: str, gids: np.ndarray) -> None:
        """Drop entries eagerly (e.g. the pushing trainer's own cache);
        version checks already protect correctness without this."""
        if name not in self._tensors:
            return
        tc = self._tensors[name]
        with self._lock:
            for g in np.asarray(gids, dtype=np.int64):
                if tc.invalidate(int(g)):
                    self.used_bytes -= tc.row_nbytes

    # -- checkpoint (DESIGN.md §10) --------------------------------------
    def state_dict(self) -> Dict[str, dict]:
        """Snapshot every registered tensor's cached rows.

        Per tensor: ``gids`` in recency order (oldest first — restoring
        inserts in that order, so the LRU/CLOCK recency structure
        survives), the matching ``rows``, and (mutable tensors only) the
        per-row ``versions`` the entries were stamped with. Restoring is
        only byte-safe together with the store's version tables from the
        SAME checkpoint — ``repro.checkpoint`` saves/loads the pair."""
        with self._lock:
            out: Dict[str, dict] = {}
            for name, tc in self._tensors.items():
                n = len(tc.slot_of)
                gids = np.fromiter(tc.slot_of.keys(), np.int64, count=n)
                slots = np.fromiter(tc.slot_of.values(), np.int64, count=n)
                out[name] = {
                    "gids": gids,
                    "rows": tc.rows[slots].copy(),
                    "versions": (tc.version[slots].copy()
                                 if tc.mutable else None),
                }
            return out

    def load_state_dict(self, state: Dict[str, dict]) -> int:
        """Restore a :meth:`state_dict` snapshot; returns rows admitted.

        Existing entries for the snapshot's tensors are dropped first
        (they predate or postdate the checkpoint — either way they are
        not the checkpoint's). Entries whose saved version no longer
        matches the store's current table are refused by ``insert``'s
        version check, so a snapshot restored against a *different*
        store state degrades to a cold cache instead of serving stale
        bytes."""
        admitted = 0
        for name, s in state.items():
            if name not in self._tensors:
                continue   # tensor not registered in this cache instance
            self.drop(name)
            admitted += self.insert(name, s["gids"], s["rows"], force=True,
                                    versions=s["versions"])
        return admitted

    # -- pre-warm -------------------------------------------------------
    def warm(self, client, name: str, gids: np.ndarray,
             counts: Optional[np.ndarray] = None) -> int:
        """Pre-fill from predicted-hot remote rows (one batched pull, the
        only time the cache itself creates traffic). ``gids``/``counts``
        come from :func:`halo_access_counts`; rows are admitted hottest
        first until ``prewarm_frac`` of the budget is full."""
        self.register(client.store, name)
        tc = self._tensors[name]
        gids = np.asarray(gids, dtype=np.int64)
        if counts is not None:
            counts = np.asarray(counts)
            keep = counts >= self.config.prewarm_min_count
            gids, counts = gids[keep], counts[keep]
            order = np.lexsort((gids, -counts))
            gids = gids[order]
        # prewarm_frac bounds the CUMULATIVE bytes all warms may occupy
        # (per-ntype warms share it), and pulling rows insert() can't
        # retain would charge the transport for bytes that are
        # immediately discarded — so cap by what's still unused
        budget = (min(int(self.config.budget_bytes * self.config.prewarm_frac),
                      self.config.budget_bytes) - self.used_bytes)
        k = min(len(gids), max(budget // tc.row_nbytes, 0))
        if k == 0:
            return 0
        # version snapshot BEFORE the fetch (same ordering as KVClient.pull):
        # otherwise a push landing mid-warm could get its pre-push rows
        # stamped with the post-push version and served as fresh forever
        pre_versions = client.store.versions_of(name, gids[:k])
        rows = client.pull(name, gids[:k], _bypass_cache=True)
        return self.insert(name, gids[:k], rows, force=True,
                           versions=pre_versions)

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction counters WITHOUT touching cached
        rows. A long-lived cache is shared across serving requests (and
        possibly across an eval loader and an `InferenceServer` at once —
        every public method locks, so concurrent clients are safe); the
        serving benchmark brackets a measurement window with this to read
        warm-vs-cold hit rates off one instance instead of rebuilding it."""
        with self._lock:
            self.hits = self.misses = self.stale_hits = 0
            self.degraded_hits = self.evictions = self.rejected = 0

    # -- reporting ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / max(total, 1),
                "stale_hits": self.stale_hits,
                "degraded_hits": self.degraded_hits,
                "evictions": self.evictions,
                "rejected": self.rejected,
                "used_bytes": self.used_bytes,
                "budget_bytes": self.config.budget_bytes,
                "rows": {n: t.num_rows for n, t in self._tensors.items()},
            }
