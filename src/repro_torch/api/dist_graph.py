"""DGL-compatible distributed-graph façade (the paper's §4 usability claim:
"API compatible with DGL's mini-batch training and heterogeneous graph
API, which enables distributed training with almost no code modification").

:class:`DistGraph` is the per-trainer handle onto the whole substrate —
hierarchical partition, KVStore shards, typed relation views — mirroring
``dgl.distributed.DistGraph``:

* ``g.ndata["feat"]`` / ``g.edata[...]`` are **lazy** :class:`DistTensor`
  views: indexing pulls rows through ``KVClient.pull`` (``pull_typed`` on
  the heterograph path), local rows via shared memory, remote rows through
  the transport-charged (and cache-eligible) KVStore read path. Nothing is
  materialized until indexed.
* ``g.node_split(...)`` / ``g.edge_split()`` reproduce the trainer's seed
  splits: §5.6.1's equal-count contiguous-range node split and the
  owned-edge-range equalized-chunk edge split (DESIGN.md §8).
* ``g.trainer_view(rank)`` hands out sibling per-trainer handles over the
  SAME partition + store (this one-host harness simulates every trainer in
  process; on a real cluster each trainer process would construct its own
  handle against the shared servers).

Construction does what ``DistGNNTrainer`` used to do inline: partition the
dataset hierarchically, stand up the KVStore (per-ntype policies + feature
tensors on the typed path), and register node labels — so the trainer is
now a thin composition over this module plus the data loaders.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.kvstore import (CacheConfig, DistKVStore, FeatureCache,
                            KVClient, NetworkModel, PartitionPolicy,
                            Transport, halo_access_counts)
from ..core.kvstore.store import MAX_RPC_RETRIES
from ..core.partition import (build_typed_partition, hierarchical_partition,
                              locality_report, split_training_set)
from ..core.sampler import edge_endpoints
from ..graph.datasets import GraphDataset


class DistTensor:
    """Lazy distributed-tensor view (``dgl.distributed.DistTensor``).

    ``t[ids]`` gathers rows by global ID through the KVStore read path;
    ``t[ids] = values`` scatters back (only when ``writable`` — feature
    tensors are read-only; mutable tensors such as :class:`DistEmbedding`
    tables accept writes, which bump row versions so trainer caches
    invalidate, DESIGN.md §5). With ``typed`` set, ``name`` is a per-ntype
    tensor family prefix (``"feat"`` -> ``"feat:paper"`` ...) and indexing
    takes *fused* node IDs, routed per type via ``KVClient.pull_typed``.
    """

    def __init__(self, client: KVClient, name: str, *, typed=None,
                 writable: Optional[bool] = None):
        self.client = client
        self.name = name
        self.typed = typed
        store = client.store
        if typed is not None:
            first = f"{name}:{typed.schema.ntypes[0]}"
            self._len = int(typed.node_type_local.shape[0])
            self._row_shape = store.row_shape(first)
            self._dtype = store.dtype_of(first)
            mutable = store.is_mutable(first)
        else:
            self._len = store.policy_for(name).total
            self._row_shape = store.row_shape(name)
            self._dtype = store.dtype_of(name)
            mutable = store.is_mutable(name)
        # default: writes allowed exactly where the store can invalidate
        # caches (version-tracked tensors); features stay read-only
        self.writable = mutable if writable is None else writable

    @property
    def shape(self) -> tuple:
        return (self._len,) + self._row_shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, ids) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if self.typed is not None:
            return self.client.pull_typed(self.name, ids, self.typed)
        return self.client.pull(self.name, ids)

    def __setitem__(self, ids, values) -> None:
        if not self.writable:
            raise TypeError(f"DistTensor {self.name!r} is read-only "
                            f"(features are immutable; use DistEmbedding "
                            f"for learnable rows)")
        if self.typed is not None:
            raise TypeError("typed DistTensor views are read-only; write "
                            "through the per-ntype tensor instead")
        ids = np.asarray(ids, dtype=np.int64)
        self.client.push(self.name, ids, np.asarray(values, self._dtype),
                         reduce="assign")

    def __repr__(self) -> str:
        rw = "rw" if self.writable else "ro"
        return (f"DistTensor({self.name!r}, shape={self.shape}, "
                f"dtype={self._dtype}, {rw})")


class _DataView:
    """Mapping-style ``g.ndata`` / ``g.edata`` accessor over one policy
    family. Keys are tensor names; per-ntype families (``feat:paper``,
    ``feat:author``, ...) additionally expose their fused-ID prefix
    (``feat``) as a typed view."""

    def __init__(self, g: "DistGraph", kind: str):
        self._g = g
        self._kind = kind   # "node" | "edge"

    def _names(self) -> Dict[str, bool]:
        """{key: is_typed_prefix} for every accessible tensor."""
        g, out = self._g, {}
        for name in g.store.tensor_names():
            pol = g.store.policy_name_of(name)
            if pol == self._kind:
                out[name] = False
            elif pol.startswith(self._kind + ":") and ":" in name:
                out[name] = False                      # type-local tensor
                out[name.split(":", 1)[0]] = True      # fused-ID prefix
        return out

    def keys(self):
        return sorted(self._names())

    def __contains__(self, name: str) -> bool:
        return name in self._names()

    def __iter__(self):
        return iter(self.keys())

    def __getitem__(self, name: str) -> DistTensor:
        names = self._names()
        if name not in names:
            raise KeyError(f"no {self._kind} tensor {name!r}; "
                           f"have {self.keys()}")
        if names[name]:
            return DistTensor(self._g.client, name, typed=self._g.typed)
        return DistTensor(self._g.client, name)


class DistGraph:
    """Per-trainer handle bundling partition book, graph/relation views and
    KVStore-backed data accessors (see module docstring).

    One construction partitions the dataset and stands up the store; sibling
    trainers share it via :meth:`trainer_view`. ``rank`` is the trainer id
    in ``[0, num_trainers)``; ``machine = rank // trainers_per_machine``
    decides which partition is shared-memory-local.
    """

    def __init__(self, ds: GraphDataset, *, num_machines: int = 2,
                 trainers_per_machine: int = 2,
                 partition_method: str = "metis", hetero: Optional[bool] = None,
                 seed: int = 0, network: Optional[NetworkModel] = None,
                 feat_name: str = "feat", replication: int = 1,
                 max_rpc_retries: Optional[int] = None,
                 hedge_ms: Optional[float] = None):
        self.ds = ds
        self.num_machines = num_machines
        self.trainers_per_machine = trainers_per_machine
        self.seed = seed
        self.feat_name = feat_name
        self.rank = 0
        self.schema = getattr(ds, "schema", None)
        self.hetero = (self.schema is not None
                       if hetero is None else bool(hetero and self.schema))

        t0 = time.perf_counter()
        self.hp = hierarchical_partition(
            ds.graph, num_machines, trainers_per_machine,
            split_mask=ds.split_mask, method=partition_method, seed=seed)
        self.partition_time_s = time.perf_counter() - t0
        book = self.hp.book

        self.transport = Transport(network or NetworkModel())
        feats_new = ds.feats[book.new2old_node]
        self.labels = ds.labels[book.new2old_node]

        policies = {"node": PartitionPolicy("node", book.node_offsets),
                    "edge": PartitionPolicy("edge", book.edge_offsets)}
        self.typed = None
        if self.hetero:
            g = ds.graph
            ntypes_new = (None if g.ntypes is None
                          else g.ntypes[book.new2old_node])
            etypes_new = (None if g.etypes is None
                          else g.etypes[book.new2old_edge])
            self.typed = build_typed_partition(book, self.schema,
                                               ntypes_new, etypes_new)
            policies.update(self.typed.policies())
        # availability knobs (DESIGN.md §12): r-way replica placement,
        # configurable retry budget, optional hedged reads — all defaults
        # preserve the unreplicated byte-and-accounting behavior exactly
        self.store = DistKVStore(
            policies, transport=self.transport,
            replication=replication,
            max_rpc_retries=(MAX_RPC_RETRIES if max_rpc_retries is None
                             else max_rpc_retries),
            hedge_delay_s=None if hedge_ms is None else hedge_ms * 1e-3,
            jitter_seed=seed)
        if self.hetero:
            # per-ntype feature tensors over type-local ID spaces
            for t, nt in enumerate(self.schema.ntypes):
                rows = ds.feats[book.new2old_node[self.typed.type2node[t]]]
                self.store.init_data(f"{feat_name}:{nt}", rows.shape[1:],
                                     np.float32, f"node:{nt}",
                                     full_array=rows)
        else:
            self.store.init_data(feat_name, feats_new.shape[1:], np.float32,
                                 "node", full_array=feats_new)
        # labels ride the store too so ``g.ndata["label"]`` works like
        # DGL's; the data loaders still slice the host-resident array
        # (no transport charge) exactly as the trainer always has
        self.store.init_data("label", (), np.int64, "node",
                             full_array=self.labels)
        self._client: Optional[KVClient] = None
        # mutable cell so sibling trainer views share the lazy endpoint
        # arrays (copy.copy shares the dict, not later attribute writes)
        self._endpoints: dict = {}

    # ---- identity -----------------------------------------------------
    @property
    def book(self):
        return self.hp.book

    @property
    def partitions(self):
        return self.hp.partitions

    @property
    def num_trainers(self) -> int:
        return self.hp.num_trainers

    @property
    def machine(self) -> int:
        return self.rank // self.trainers_per_machine

    def num_nodes(self) -> int:
        return int(self.book.node_offsets[-1])

    def num_edges(self) -> int:
        return int(self.book.edge_offsets[-1])

    def trainer_view(self, rank: int) -> "DistGraph":
        """A sibling per-trainer handle sharing this partition + store."""
        if not 0 <= rank < self.num_trainers:
            raise ValueError(f"rank {rank} outside [0, {self.num_trainers})")
        g = copy.copy(self)
        g.rank = rank
        g._client = None
        return g

    # ---- data access --------------------------------------------------
    @property
    def client(self) -> KVClient:
        """This handle's own (cache-less) KVStore client."""
        if self._client is None:
            self._client = self.store.client(self.machine)
        return self._client

    def new_client(self) -> KVClient:
        """A fresh client for a loader/pipeline to own (the pipeline may
        attach a per-trainer cache to it; handing out fresh clients keeps
        ``g.ndata`` pulls cache-free and loader clients independent)."""
        return self.store.client(self.machine)

    @property
    def ndata(self) -> _DataView:
        return _DataView(self, "node")

    @property
    def edata(self) -> _DataView:
        return _DataView(self, "edge")

    # ---- id spaces ----------------------------------------------------
    def to_new_nids(self, nids_old: np.ndarray) -> np.ndarray:
        """OLD (dataset) node ids -> NEW (partition-relabeled) ids."""
        return self.book.old2new_node[np.asarray(nids_old, dtype=np.int64)]

    @property
    def train_nids(self) -> np.ndarray:
        """The dataset's training vertices in the NEW id space."""
        return self.to_new_nids(self.ds.train_nids)

    @property
    def val_nids(self) -> np.ndarray:
        return self.to_new_nids(self.ds.val_nids)

    @property
    def test_nids(self) -> np.ndarray:
        return self.to_new_nids(self.ds.test_nids)

    def edge_endpoints(self) -> tuple:
        """(src, dst) NEW node ids indexed by NEW edge id (host-resident,
        computed once per world)."""
        if "sd" not in self._endpoints:
            self._endpoints["sd"] = edge_endpoints(self.book, self.ds.graph)
        return self._endpoints["sd"]

    # ---- splits (§5.6.1) ----------------------------------------------
    def node_splits(self, nids: Optional[np.ndarray] = None, *,
                    use_level2: bool = True,
                    seed: Optional[int] = None) -> List[np.ndarray]:
        """All trainers' seed sets: §5.6.1's equal-count contiguous-range
        split of ``nids`` (default: the training vertices)."""
        nids = self.train_nids if nids is None else np.asarray(nids)
        return split_training_set(self.hp, nids, use_level2=use_level2,
                                  seed=self.seed if seed is None else seed)

    def node_split(self, nids: Optional[np.ndarray] = None, *,
                   use_level2: bool = True,
                   seed: Optional[int] = None) -> np.ndarray:
        """This trainer's seed set (DGL's ``node_split`` analogue)."""
        return self.node_splits(nids, use_level2=use_level2,
                                seed=seed)[self.rank]

    def edge_splits(self) -> List[np.ndarray]:
        """All trainers' positive-edge pools: each machine's owned edge
        range (edges live with their dst vertex) cut into contiguous
        per-trainer chunks, equalized to the min chunk size ACROSS machines
        so every trainer schedules the same batch count (sync SGD)."""
        book, T = self.book, self.trainers_per_machine
        spans = [(int(book.edge_offsets[m]), int(book.edge_offsets[m + 1]))
                 for m in range(self.num_machines)]
        per = min((ehi - elo) // T for elo, ehi in spans)
        out: List[np.ndarray] = []
        for elo, ehi in spans:
            chunk = (ehi - elo) // T
            for t in range(T):
                out.append(np.arange(elo + t * chunk, elo + t * chunk + per,
                                     dtype=np.int64))
        return out

    def edge_split(self) -> np.ndarray:
        """This trainer's owned positive-edge pool."""
        return self.edge_splits()[self.rank]

    def locality_report(self, per_trainer_ids: List[np.ndarray]) -> dict:
        """Seed/endpoint locality of per-trainer id sets (§5.3)."""
        return locality_report(self.hp, per_trainer_ids)

    # ---- per-trainer hot-vertex cache (DESIGN.md §5) -------------------
    def feature_cache(self, config: Optional[CacheConfig]
                      ) -> Optional[FeatureCache]:
        """One trainer's hot-vertex cache over remote feature rows,
        registered for every feature tensor and (optionally) pre-warmed
        from the machine partition's halo access counts — the partition
        book's static prediction of which remote rows the sampler will
        keep pulling (§5.3's locality argument, attacked from the other
        side). Returns None when ``config`` is None (cache disabled)."""
        if config is None:
            return None
        cache = FeatureCache(config, self.store)
        names = ([f"{self.feat_name}:{nt}" for nt in self.schema.ntypes]
                 if self.hetero else [self.feat_name])
        for name in names:
            cache.register(self.store, name)
        # NOTE: the loader's pipeline owns the client<->cache binding;
        # warm() pulls with _bypass_cache and needs no attach
        if config.prewarm:
            client = self.new_client()
            gids, counts = halo_access_counts(self.partitions[self.machine])
            if self.hetero:
                types, tids = self.typed.nid2typed(gids)
                for t, nt in enumerate(self.schema.ntypes):
                    m = types == t
                    if m.any():
                        cache.warm(client, f"{self.feat_name}:{nt}",
                                   tids[m], counts[m])
            else:
                cache.warm(client, self.feat_name, gids, counts)
        return cache

    def __repr__(self) -> str:
        return (f"DistGraph({self.ds.name!r}, rank={self.rank}/"
                f"{self.num_trainers}, machine={self.machine}, "
                f"hetero={self.hetero})")
