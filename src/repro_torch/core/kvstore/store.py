"""Distributed in-memory key-value store for vertex/edge data (§5.4).

One ``KVServer`` per machine holds the rows whose global IDs fall in that
machine's partition range (per a ``PartitionPolicy`` — vertex data and edge
data are partitioned differently, and heterographs can register separate
policies per node/edge type). ``KVClient`` is what a trainer uses: ``pull``
gathers rows by global ID (local rows via the shared-memory fast path,
remote rows through the transport), ``push`` scatters values or gradient
updates back to the owning servers.

Replication (DESIGN.md §12): with ``replication=r`` every partition's
shard also lives on its ``r-1`` ring successors. Writes are synchronous —
every copy holder is charged and every copy array mutated before the
write returns — so a failover read from any replica is **byte-identical**
to the primary read, and the store-global version counters stay the
single invalidation authority no matter which copy served a row. Reads
are health-routed: the transport's :class:`~.transport.PeerHealth`
breaker orders candidates available-first, an optional hedge delay races
a replica against a slow primary, and only when EVERY copy is
unreachable does the client surface :class:`~.faults.OwnerUnavailable`.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .faults import (OwnerDownError, OwnerUnavailable, RPCRetriesExhausted,
                     TransientRPCError)
from .transport import Transport

_MASK32 = 0xFFFFFFFF

# transient-RPC retry budget (DESIGN.md §10): 8 attempts with doubling
# backoff spans ~256x the base latency — a schedule that fails past it is
# treated as a dead peer, not a blip, and surfaces RPCRetriesExhausted
MAX_RPC_RETRIES = 8


@dataclasses.dataclass(frozen=True)
class PartitionPolicy:
    """Maps a global ID to (partition, local offset) via contiguous ranges.

    Built from the partition book's node/edge offsets, which is exactly the
    paper's scheme (binary search + subtraction).
    """
    name: str
    offsets: np.ndarray   # (k+1,)

    @property
    def num_parts(self) -> int:
        return len(self.offsets) - 1

    @property
    def total(self) -> int:
        return int(self.offsets[-1])

    def part_of(self, ids: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.offsets, ids, side="right") - 1).astype(np.int32)

    def local_of(self, ids: np.ndarray, parts: Optional[np.ndarray] = None) -> np.ndarray:
        if parts is None:
            parts = self.part_of(ids)
        return ids - self.offsets[parts]

    def part_size(self, p: int) -> int:
        return int(self.offsets[p + 1] - self.offsets[p])


class KVServer:
    """Holds the local shard of every registered tensor."""

    def __init__(self, part_id: int):
        self.part_id = part_id
        self._data: Dict[str, np.ndarray] = {}
        # replica shards this server holds FOR OTHER partitions, keyed by
        # (tensor name, primary part id) — full copies of the primary
        # shard, kept byte-identical by synchronous writes (DESIGN.md §12)
        self._replicas: Dict[Tuple[str, int], np.ndarray] = {}

    def init_data(self, name: str, shape_suffix: tuple, dtype, policy: PartitionPolicy,
                  init: Optional[Callable[[tuple], np.ndarray]] = None,
                  rows: Optional[np.ndarray] = None) -> None:
        n_local = policy.part_size(self.part_id)
        shape = (n_local,) + tuple(shape_suffix)
        if rows is not None:
            assert rows.shape == shape, (rows.shape, shape)
            # explicit copy: the server must own its shard (ascontiguousarray
            # would alias the caller's buffer for contiguous slices)
            self._data[name] = np.array(rows, dtype=dtype, copy=True)
        elif init is not None:
            self._data[name] = np.asarray(init(shape), dtype=dtype)
        else:
            self._data[name] = np.zeros(shape, dtype=dtype)

    def local_view(self, name: str) -> np.ndarray:
        """Shared-memory fast path: the trainer reads this array directly."""
        return self._data[name]

    def fetch(self, name: str, local_ids: np.ndarray) -> np.ndarray:
        return self._data[name][local_ids]

    def apply(self, name: str, local_ids: np.ndarray, values: np.ndarray,
              reduce: str = "assign") -> None:
        if reduce == "assign":
            self._data[name][local_ids] = values
        elif reduce == "sum":
            np.add.at(self._data[name], local_ids, values)
        else:
            raise ValueError(reduce)

    # -- replica shards held for other partitions (DESIGN.md §12) --------
    def init_replica(self, name: str, primary_part: int,
                     rows: np.ndarray) -> None:
        self._replicas[(name, int(primary_part))] = np.array(rows, copy=True)

    def replica_view(self, name: str, primary_part: int) -> np.ndarray:
        return self._replicas[(name, int(primary_part))]

    def fetch_replica(self, name: str, primary_part: int,
                      local_ids: np.ndarray) -> np.ndarray:
        return self._replicas[(name, int(primary_part))][local_ids]


class DistKVStore:
    """The full store: all servers + a per-machine client view.

    In production each machine would construct only its server and a client;
    here the object graph holds all of them (one host), but clients only
    touch remote servers through ``transport``-charged calls.
    """

    def __init__(self, policies: Dict[str, PartitionPolicy],
                 transport: Optional[Transport] = None,
                 replication: int = 1,
                 max_rpc_retries: int = MAX_RPC_RETRIES,
                 hedge_delay_s: Optional[float] = None,
                 jitter_seed: int = 0):
        self.policies = dict(policies)
        num_parts = next(iter(self.policies.values())).num_parts
        for pol in self.policies.values():
            assert pol.num_parts == num_parts
        self.servers = [KVServer(p) for p in range(num_parts)]
        self.transport = transport or Transport()
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        # clamp: r copies need r distinct machines; a 1-machine smoke run
        # with --replication 2 degrades to r=1 instead of crashing
        self.replication = min(int(replication), num_parts)
        if max_rpc_retries < 1:
            raise ValueError(f"max_rpc_retries must be >= 1, "
                             f"got {max_rpc_retries}")
        self.max_rpc_retries = int(max_rpc_retries)
        self.hedge_delay_s = hedge_delay_s
        self.jitter_seed = int(jitter_seed)
        # ring placement: partition p's copies live on machines
        # p, p+1, ..., p+r-1 (mod k) — every machine holds r shards and
        # every shard has r holders, no placement table to persist
        self._replica_map: Tuple[Tuple[int, ...], ...] = tuple(
            tuple((p + i) % num_parts for i in range(self.replication))
            for p in range(num_parts))
        self._meta: Dict[str, tuple] = {}   # name -> (policy_name, dtype)
        # per-row version counters for MUTABLE tensors only — the
        # invalidation authority for trainer-side feature caches (in a real
        # deployment this metadata rides the push acks / an invalidation
        # broadcast; see DESIGN.md §5). Immutable tensors have no entry and
        # pay zero version overhead.
        self._versions: Dict[str, np.ndarray] = {}
        self._version_lock = threading.Lock()
        # tensors ANY trainer cache has registered (cache registration is
        # global metadata, like the policies): writes to a cached tensor
        # without a version table are refused up front — no client can see
        # the other trainers' caches to invalidate them. The weak set of
        # live caches exists for BULK rewrites (checkpoint restore), which
        # legitimately replace even immutable bytes and must flush them.
        self._cached_names: set = set()
        self._cache_refs: "weakref.WeakSet" = weakref.WeakSet()

    @property
    def num_parts(self) -> int:
        return len(self.servers)

    def init_data(self, name: str, shape_suffix: tuple, dtype, policy_name: str,
                  init: Optional[Callable[[tuple], np.ndarray]] = None,
                  full_array: Optional[np.ndarray] = None,
                  mutable: bool = False) -> None:
        pol = self.policies[policy_name]
        self._meta[name] = (policy_name, np.dtype(dtype))
        if mutable:
            self._versions[name] = np.zeros(pol.total, dtype=np.int64)
        for server in self.servers:
            rows = None
            if full_array is not None:
                lo, hi = int(pol.offsets[server.part_id]), int(pol.offsets[server.part_id + 1])
                rows = full_array[lo:hi]
            server.init_data(name, shape_suffix, dtype, pol, init=init, rows=rows)
        # seed the replica copies from the freshly-initialized primaries
        if self.replication > 1:
            for p in range(self.num_parts):
                src = self.servers[p].local_view(name)
                for h in self.replicas_of(p)[1:]:
                    self.servers[h].init_replica(name, p, src)

    # -- replication (DESIGN.md §12) --------------------------------------
    def replicas_of(self, p: int) -> Tuple[int, ...]:
        """Copy holders of partition ``p``, primary first."""
        return self._replica_map[p]

    def apply_update(self, name: str, p: int, local_ids: np.ndarray,
                     values: np.ndarray, reduce: str = "assign") -> None:
        """Apply one delivered write to EVERY copy of partition ``p``.

        The primary takes the real reduction; replicas then copy the
        primary's updated rows, so all copies are byte-identical even for
        ``sum`` reductions with duplicate ids. Copies of a holder inside a
        down window are updated too — this models the write-ahead log the
        holder replays on return; availability is what the down window
        takes away, not durability (the charge was already skipped and
        counted as a deferred replica write by the caller)."""
        self.servers[p].apply(name, local_ids, values, reduce=reduce)
        self.copy_rows_to_replicas(name, p, local_ids)

    def copy_rows_to_replicas(self, name: str, p: int,
                              local_ids: np.ndarray) -> None:
        """Propagate the primary's current bytes for ``local_ids`` to every
        replica copy of partition ``p`` (no-op at r=1)."""
        if self.replication == 1:
            return
        rows = self.servers[p].local_view(name)[local_ids]
        for h in self.replicas_of(p)[1:]:
            self.servers[h].replica_view(name, p)[local_ids] = rows

    def sync_replicas(self) -> None:
        """Bulk re-copy every primary shard to its replicas — the
        checkpoint-restore path, which rewrites primaries in place and
        must bring all copies back to byte-identity."""
        if self.replication == 1:
            return
        for name in self._meta:
            for p in range(self.num_parts):
                src = self.servers[p].local_view(name)
                for h in self.replicas_of(p)[1:]:
                    self.servers[h].replica_view(name, p)[...] = src

    # -- row versioning (cache invalidation authority) ------------------
    def is_mutable(self, name: str) -> bool:
        return name in self._versions

    def note_cache_registration(self, name: str, cache=None) -> None:
        """Called by FeatureCache.register; see check_writable."""
        self._cached_names.add(name)
        if cache is not None:
            self._cache_refs.add(cache)

    def invalidate_caches(self, name: str) -> None:
        """Flush every live trainer cache's entries for ``name`` — the
        bulk-rewrite path (checkpoint restore), where even immutable
        tensors' bytes legitimately change."""
        for cache in list(self._cache_refs):
            cache.drop(name)

    def check_writable(self, name: str) -> None:
        """Refuse writes that would strand stale rows in SOME trainer's
        cache: a cached tensor with no version table has no invalidation
        channel. Runs BEFORE any server mutation."""
        if name in self._cached_names and not self.is_mutable(name):
            raise ValueError(
                f"write to {name!r}, which is cached by a trainer but has "
                f"no version table — register it with "
                f"init_data(..., mutable=True)")

    def versions_of(self, name: str, ids: np.ndarray) -> Optional[np.ndarray]:
        """Current version counter per row, or None for immutable tensors."""
        vers = self._versions.get(name)
        if vers is None:
            return None
        with self._version_lock:
            return vers[np.asarray(ids, dtype=np.int64)].copy()

    def bump_versions(self, name: str, ids: np.ndarray) -> None:
        """Called by writers AFTER applying an update, so a concurrent
        reader can at worst stamp fresh data with a stale version (an
        unnecessary refresh later) — never stale data with a fresh one."""
        vers = self._versions.get(name)
        if vers is None:
            return
        with self._version_lock:
            np.add.at(vers, np.asarray(ids, dtype=np.int64), 1)

    # -- checkpoint access (repro.checkpoint save/load_kvstore) ----------
    def mutable_names(self) -> List[str]:
        """Tensors with a version table, in registration order."""
        return list(self._versions)

    def version_table(self, name: str) -> np.ndarray:
        """A consistent snapshot of one tensor's full version table."""
        with self._version_lock:
            return self._versions[name].copy()

    def set_versions(self, name: str, values: np.ndarray) -> None:
        """Restore a tensor's exact version counters (checkpoint load):
        cache entries saved against these versions validate again, instead
        of the blanket bump a version-less restore must fall back to."""
        vers = self._versions[name]
        values = np.asarray(values, dtype=np.int64)
        assert values.shape == vers.shape, (name, values.shape, vers.shape)
        with self._version_lock:
            vers[...] = values

    def client(self, machine: int) -> "KVClient":
        return KVClient(self, machine)

    def policy_for(self, name: str) -> PartitionPolicy:
        return self.policies[self._meta[name][0]]

    # -- metadata introspection (the repro.api DistTensor façade reads
    #    these instead of poking _meta / server shards directly) ----------
    def has_tensor(self, name: str) -> bool:
        return name in self._meta

    def tensor_names(self) -> List[str]:
        """Registered tensor names, in registration order."""
        return list(self._meta)

    def policy_name_of(self, name: str) -> str:
        return self._meta[name][0]

    def dtype_of(self, name: str) -> np.dtype:
        return self._meta[name][1]

    def row_shape(self, name: str) -> tuple:
        """Per-row feature shape (without the leading id axis)."""
        return tuple(self.servers[0].local_view(name).shape[1:])

    def gather_all(self, name: str) -> np.ndarray:
        """Debug/checkpoint helper: reassemble the full tensor."""
        return np.concatenate([s.local_view(name) for s in self.servers], axis=0)


class KVClient:
    def __init__(self, store: DistKVStore, machine: int, cache=None):
        self.store = store
        self.machine = machine
        self.cache = cache          # Optional[FeatureCache], per trainer
        self.max_rpc_retries = store.max_rpc_retries
        self.hedge_delay_s = store.hedge_delay_s
        # partitions with a copy (primary OR replica) on this machine —
        # served via shared memory; degenerates to {machine} at r=1
        self._local_parts = frozenset(
            p for p in range(store.num_parts)
            if machine in store.replicas_of(p))
        self._local_parts_arr = np.fromiter(sorted(self._local_parts),
                                            dtype=np.int32)
        # backoff-jitter draws are counter-keyed like every other RNG in
        # the repo (seed, machine, draw index) — deterministic per client,
        # desynchronized across clients (DESIGN.md §12)
        self._jitter_lock = threading.Lock()
        self._jitter_calls = 0

    def attach_cache(self, cache) -> "KVClient":
        """Attach a per-trainer hot-vertex cache (see kvstore.cache); only
        tensors registered with the cache take the cached read path."""
        self.cache = cache
        return self

    def _jittered(self, delay_s: float) -> float:
        """Scale one backoff wait by a seeded factor in [0.5, 1.5) so
        synchronized retry storms desynchronize; affects the simulated
        clock only, never retry counts or bytes."""
        with self._jitter_lock:
            n = self._jitter_calls
            self._jitter_calls += 1
        rng = np.random.default_rng(np.random.SeedSequence(
            (self.store.jitter_seed & _MASK32, self.machine & _MASK32,
             n & _MASK32)))
        return delay_s * (0.5 + rng.random())

    def _charge_remote(self, nbytes: int, op: str,
                       dst: Optional[int] = None) -> None:
        """Charge one remote RPC to a single destination, absorbing
        injected transient failures with jittered exponential backoff
        (DESIGN.md §10).

        Every data-plane RPC this client issues routes through here or
        :meth:`_remote_read`, and the charge always runs BEFORE the
        corresponding server mutation (see ``push``) — so a retried call
        never re-applies a ``sum`` reduction, and injected transients
        change accounting but not one byte of training state."""
        transport = self.store.transport
        delay = transport.model.latency_s
        last: Optional[TransientRPCError] = None
        for _ in range(self.max_rpc_retries):
            try:
                transport.charge_remote(nbytes, op=op, dst=dst)
                return
            except TransientRPCError as e:
                last = e
                transport.charge_retry_backoff(self._jittered(delay))
                delay *= 2
        if isinstance(last, OwnerDownError):
            raise OwnerUnavailable(
                f"server {dst} is inside a sustained outage and partition "
                f"has no other copy ({op!r} RPC, {nbytes}B)") from last
        raise RPCRetriesExhausted(
            f"{op!r} RPC ({nbytes}B) failed {self.max_rpc_retries} times — "
            f"treating the peer as dead") from last

    def _remote_read(self, nbytes: int, owner: int, op: str = "pull") -> int:
        """Charge one read addressed to ``owner``, failing over across its
        copy holders (DESIGN.md §12). Returns the server id that served it.

        Routing: candidates are the owner's copy holders primary-first,
        reordered available-first by the transport's health breaker — a
        known-dead primary costs zero attempts. If a hedge delay is
        configured, a first round races the candidates: one attempt at the
        best candidate, and only when that attempt comes back failed (the
        simulated transport surfaces failure after one round trip — a
        successful read never hedges) the hedge timer is charged and the
        next candidate tried, first success winning. After that, the
        retry budget is split evenly across candidates with jittered
        doubling backoff. Only when every copy holder is exhausted does
        the read fail — as :class:`OwnerUnavailable` if the final error
        was a down window, else :class:`RPCRetriesExhausted`."""
        store = self.store
        transport = store.transport
        cands = store.replicas_of(owner)
        if len(cands) == 1:
            self._charge_remote(nbytes, op=op, dst=owner)
            return owner
        health = transport.health
        order = ([c for c in cands if health.available(c)]
                 + [c for c in cands if not health.available(c)])
        last: Optional[TransientRPCError] = None
        if self.hedge_delay_s is not None:
            for i, c in enumerate(order):
                try:
                    transport.charge_remote(nbytes, op=op, dst=c)
                    if i > 0:
                        transport.note_hedge_win()
                    if c != owner:
                        transport.note_failover()
                    return c
                except TransientRPCError as e:
                    last = e
                    if i == 0:
                        transport.charge_hedge_delay(self.hedge_delay_s)
        budget = max(1, self.max_rpc_retries // len(order))
        for c in order:
            delay = transport.model.latency_s
            for _ in range(budget):
                try:
                    transport.charge_remote(nbytes, op=op, dst=c)
                    if c != owner:
                        transport.note_failover()
                    return c
                except TransientRPCError as e:
                    last = e
                    transport.charge_retry_backoff(self._jittered(delay))
                    delay *= 2
        if isinstance(last, OwnerDownError):
            raise OwnerUnavailable(
                f"all {len(order)} copies of partition {owner} unreachable "
                f"({op!r} RPC, {nbytes}B)") from last
        raise RPCRetriesExhausted(
            f"{op!r} RPC ({nbytes}B) to partition {owner} failed on all "
            f"{len(order)} copies — treating the owner as dead") from last

    def pull(self, name: str, ids: np.ndarray, *,
             _bypass_cache: bool = False) -> np.ndarray:
        """Gather rows by global ID. Local rows: direct view indexing
        (shared memory). Remote rows: cache hits served trainer-side
        (saved bytes credited to the transport accountant), misses via one
        batched transport-charged fetch per owning server."""
        store = self.store
        pol = store.policy_for(name)
        ids = np.asarray(ids, dtype=np.int64)
        parts = pol.part_of(ids)
        local_ids = pol.local_of(ids, parts)
        sample = store.servers[self.machine].local_view(name)
        out = np.empty((len(ids),) + sample.shape[1:], dtype=sample.dtype)
        itemrow = sample.dtype.itemsize * int(np.prod(sample.shape[1:], initial=1))

        cache = None if _bypass_cache else self.cache
        if cache is not None and not cache.has(name):
            cache = None
        # rows with ANY copy on this machine (primary or replica shard)
        # take the shared-memory path; at r=1 this is parts == machine
        is_local = np.isin(parts, self._local_parts_arr)
        fetch = np.ones(len(ids), dtype=bool)
        if cache is not None:
            rem_idx = np.nonzero(~is_local)[0]
            if len(rem_idx):
                hit, rows = cache.lookup(name, ids[rem_idx])
                if hit.any():
                    out[rem_idx[hit]] = rows
                    fetch[rem_idx[hit]] = False
                    store.transport.charge_cache_hit(
                        int(hit.sum()) * itemrow, int(hit.sum()))
                store.transport.charge_cache_miss(int((~hit).sum()))
        # version snapshot BEFORE fetching, so a concurrent push can never
        # stamp stale rows with a fresh version (see bump_versions)
        pre_versions = (store.versions_of(name, ids)
                        if cache is not None else None)
        for p in range(store.num_parts):
            m = (parts == p) & fetch
            if not m.any():
                continue
            nbytes = int(m.sum()) * itemrow
            if p in self._local_parts:
                src = (store.servers[self.machine].local_view(name)
                       if p == self.machine else
                       store.servers[self.machine].replica_view(name, p))
                out[m] = src[local_ids[m]]
                store.transport.charge_local(nbytes)
                continue
            served_by = self._remote_read(nbytes, p, op="pull")
            rows = (store.servers[p].fetch(name, local_ids[m])
                    if served_by == p else
                    store.servers[served_by].fetch_replica(
                        name, p, local_ids[m]))
            out[m] = rows
            if cache is not None:
                cache.insert(name, ids[m], rows,
                             versions=None if pre_versions is None
                             else pre_versions[m])
        return out

    def push(self, name: str, ids: np.ndarray, values: np.ndarray,
             reduce: str = "sum") -> None:
        store = self.store
        store.check_writable(name)   # before any server mutation
        pol = store.policy_for(name)
        ids = np.asarray(ids, dtype=np.int64)
        parts = pol.part_of(ids)
        local_ids = pol.local_of(ids, parts)
        itemrow = values.dtype.itemsize * int(np.prod(values.shape[1:], initial=1))
        transport = store.transport
        for p in range(store.num_parts):
            m = parts == p
            if not m.any():
                continue
            nbytes = int(m.sum()) * itemrow
            # charge EVERY copy holder (and absorb transient faults)
            # BEFORE the apply: each copy mutates exactly once per
            # delivered request, so a retried charge can never
            # double-apply a "sum" reduction. Synchronous replication:
            # a holder inside a down window gets its charge skipped and
            # counted as deferred (its copy is still brought up to date —
            # the replayed write-ahead log, see apply_update); the write
            # only fails when NO copy holder accepted it.
            holders = store.replicas_of(p)
            delivered = 0
            last: Optional[Exception] = None
            for h in holders:
                if h == self.machine:
                    transport.charge_local(nbytes)
                    delivered += 1
                    continue
                try:
                    self._charge_remote(nbytes, op="push", dst=h)
                    delivered += 1
                except (OwnerUnavailable, RPCRetriesExhausted) as e:
                    if len(holders) == 1:
                        raise
                    last = e
                    transport.note_deferred_replica_write()
            if delivered == 0:
                raise OwnerUnavailable(
                    f"push to partition {p} failed on all {len(holders)} "
                    f"copy holders") from last
            store.apply_update(name, p, local_ids[m], values[m],
                               reduce=reduce)
        self.notify_write(name, ids)

    def notify_write(self, name: str, ids: np.ndarray) -> None:
        """Post-write protocol shared by every writer (``push``,
        ``DistEmbedding.push_grad``, ...): bump the rows' version counters
        so OTHER trainers' caches refuse their copies, and eagerly drop
        this client's own entries. (``DistKVStore.check_writable`` — run
        before the write — is what refuses cached-but-unversioned
        tensors.)"""
        self.store.bump_versions(name, ids)   # no-op for immutable tensors
        if self.cache is not None and self.cache.has(name):
            self.cache.invalidate(name, ids)

    def local_fraction(self, name: str, ids: np.ndarray) -> float:
        pol = self.store.policy_for(name)
        parts = pol.part_of(np.asarray(ids, dtype=np.int64))
        return float((parts == self.machine).mean()) if len(ids) else 1.0

    # -- heterograph path ----------------------------------------------
    def pull_typed(self, name_prefix: str, fused_ids: np.ndarray,
                   typed, ntypes: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather rows for a mixed-type fused-ID set, routing every node
        type through its own policy (§5.4's per-type registration).

        ``typed`` is a ``core.partition.book.TypedPartitionData``; node type
        t's rows live in tensor ``f"{name_prefix}:{ntype_name}"`` indexed by
        *type-local* IDs under policy ``node:<ntype>``. Rows come back in
        ``fused_ids`` order in one contiguous buffer (the paper's CPU
        prefetch contract) — all per-type tensors must share dtype and
        feature shape. ``ntypes`` (if given) is the caller's precomputed
        node type per id — the sampler's typed frontier bookkeeping — which
        skips the type lookup here.
        """
        fused_ids = np.asarray(fused_ids, dtype=np.int64)
        if ntypes is None:
            types, tids = typed.nid2typed(fused_ids)
        else:
            types = ntypes
            tids = typed.node_type_local[fused_ids]
        out: Optional[np.ndarray] = None
        for t, ntname in enumerate(typed.schema.ntypes):
            m = types == t
            if not m.any():
                continue
            rows = self.pull(f"{name_prefix}:{ntname}", tids[m])
            if out is None:
                out = np.empty((len(fused_ids),) + rows.shape[1:],
                               dtype=rows.dtype)
            out[m] = rows
        if out is None:   # empty id set: use any registered type for shape
            sample = self.store.servers[self.machine].local_view(
                f"{name_prefix}:{typed.schema.ntypes[0]}")
            out = np.empty((0,) + sample.shape[1:], dtype=sample.dtype)
        return out

    # -- degraded-mode reads (DESIGN.md §12) ------------------------------
    def pull_degraded(self, name: str, ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Best-effort gather for serving: rows whose owner has NO
        reachable copy (:class:`OwnerUnavailable` — a sustained outage,
        not a blip) come from the stale cache (version checks skipped —
        bounded staleness, the rows were valid when cached) or zero-fill,
        instead of raising. Failure is isolated per owner, so one dead
        owner never poisons rows healthy owners can serve. Plain retry
        exhaustion still raises — the data exists, the network is just
        misbehaving, and fabricating bytes would mask it.

        Returns ``(rows, fresh)`` where ``fresh[i]`` is False for every
        row that was salvaged; training paths must keep using ``pull``,
        which refuses to fabricate bytes."""
        store = self.store
        pol = store.policy_for(name)
        ids = np.asarray(ids, dtype=np.int64)
        parts = pol.part_of(ids)
        sample = store.servers[self.machine].local_view(name)
        out = np.zeros((len(ids),) + sample.shape[1:], dtype=sample.dtype)
        fresh = np.ones(len(ids), dtype=bool)
        for p in np.unique(parts):
            m = parts == p
            try:
                out[m] = self.pull(name, ids[m])
            except OwnerUnavailable:
                fresh[m] = False
                idx = np.nonzero(m)[0]
                if self.cache is not None and self.cache.has(name):
                    hit, rows = self.cache.lookup_stale(name, ids[m])
                    if hit.any():
                        out[idx[hit]] = rows
                store.transport.note_degraded(int(m.sum()))
        return out, fresh

    def pull_typed_degraded(self, name_prefix: str, fused_ids: np.ndarray,
                            typed, ntypes: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Typed counterpart of :meth:`pull_degraded` — per-type routing
        like :meth:`pull_typed`, salvage masks merged across types."""
        fused_ids = np.asarray(fused_ids, dtype=np.int64)
        if ntypes is None:
            types, tids = typed.nid2typed(fused_ids)
        else:
            types = ntypes
            tids = typed.node_type_local[fused_ids]
        out: Optional[np.ndarray] = None
        fresh = np.ones(len(fused_ids), dtype=bool)
        for t, ntname in enumerate(typed.schema.ntypes):
            m = types == t
            if not m.any():
                continue
            rows, f = self.pull_degraded(f"{name_prefix}:{ntname}", tids[m])
            if out is None:
                out = np.empty((len(fused_ids),) + rows.shape[1:],
                               dtype=rows.dtype)
            out[m] = rows
            fresh[m] = f
        if out is None:
            sample = self.store.servers[self.machine].local_view(
                f"{name_prefix}:{typed.schema.ntypes[0]}")
            out = np.empty((0,) + sample.shape[1:], dtype=sample.dtype)
        return out, fresh
