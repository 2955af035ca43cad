"""First-class heterogeneous graph schema and typed view (DistDGL's
heterograph API, adapted to the fused-ID storage this repro uses).

The storage substrate stays a single fused :class:`~repro.graph.csr.CSRGraph`
— one node-ID space, one CSR, per-edge ``etypes`` and per-node ``ntypes``
arrays — because that is what the partitioner, KVStore relabeling and
samplers operate on. What this module adds on top:

* :class:`HeteroSchema` — the *names*: node types and canonical edge types
  ``(src_ntype, relation, dst_ntype)``. Every typed component (partition
  policies, KVStore tensors, per-relation fanouts, RGCN weights) is keyed by
  this schema, so the homogeneous path is literally the degenerate
  single-ntype/single-etype schema.
* :class:`HeteroCSRGraph` — a view over the fused graph exposing
  per-relation adjacency (lazily materialized sub-CSRs) and per-type node
  sets, plus schema validation (every typed edge must connect the node types
  its canonical type declares).

See DESIGN.md §3 for how typed IDs map onto the fused ID space after
partitioning.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .csr import CSRGraph


CanonicalEtype = Tuple[str, str, str]     # (src_ntype, relation, dst_ntype)
EtypeKey = Union[int, str, CanonicalEtype]


@dataclasses.dataclass(frozen=True)
class HeteroSchema:
    """Node types + canonical edge types of a heterogeneous graph.

    Type IDs are positions in these tuples; the fused graph's ``ntypes`` /
    ``etypes`` arrays hold those IDs. Relation names must be unique (DGL
    allows ambiguous short names; we don't — it keeps KVStore tensor names
    and fanout dicts unambiguous).
    """

    ntypes: Tuple[str, ...]
    canonical_etypes: Tuple[CanonicalEtype, ...]

    def __post_init__(self):
        rels = [c[1] for c in self.canonical_etypes]
        if len(set(rels)) != len(rels):
            raise ValueError(f"duplicate relation names: {rels}")
        for s, r, d in self.canonical_etypes:
            if s not in self.ntypes or d not in self.ntypes:
                raise ValueError(f"canonical etype ({s},{r},{d}) references "
                                 f"unknown ntype (have {self.ntypes})")

    @property
    def num_ntypes(self) -> int:
        return len(self.ntypes)

    @property
    def num_etypes(self) -> int:
        return len(self.canonical_etypes)

    @property
    def etypes(self) -> Tuple[str, ...]:
        return tuple(c[1] for c in self.canonical_etypes)

    def ntype_id(self, name: str) -> int:
        return self.ntypes.index(name)

    def etype_id(self, key: EtypeKey) -> int:
        """Accepts an int ID, a relation name, or a canonical triple."""
        if isinstance(key, int):
            if not 0 <= key < self.num_etypes:
                raise KeyError(key)
            return key
        if isinstance(key, tuple):
            return self.canonical_etypes.index(key)
        return self.etypes.index(key)

    def src_ntype_id(self, et: int) -> int:
        return self.ntype_id(self.canonical_etypes[et][0])

    def dst_ntype_id(self, et: int) -> int:
        return self.ntype_id(self.canonical_etypes[et][2])

    def normalize_fanout(self, fanout: Union[int, Mapping[EtypeKey, int]]
                         ) -> np.ndarray:
        """One layer's fanout -> dense (num_etypes,) int array.

        An int applies to every relation (DGL's semantics); a mapping gives
        per-relation fanouts, missing relations get 0 (not sampled).
        """
        out = np.zeros(self.num_etypes, dtype=np.int64)
        if isinstance(fanout, (int, np.integer)):
            out[:] = int(fanout)
        else:
            for k, v in fanout.items():
                out[self.etype_id(k)] = int(v)
        return out

    @staticmethod
    def homogeneous() -> "HeteroSchema":
        """The degenerate schema every untyped graph implicitly has."""
        return HeteroSchema(ntypes=("_N",),
                            canonical_etypes=(("_N", "_E", "_N"),))


class HeteroCSRGraph:
    """Typed view over a fused CSRGraph (storage is shared, never copied).

    ``g`` keeps the out-neighbor CSR exactly as before; this view adds
    per-relation adjacency (``relation_coo``/``relation_csr``, lazily built
    and cached) and per-ntype node sets. All IDs remain fused global IDs —
    type-local IDs only appear at the KVStore boundary (see
    ``core.partition.book.build_typed_partition``).
    """

    def __init__(self, g: CSRGraph, schema: HeteroSchema,
                 validate: bool = True):
        if g.num_etypes != schema.num_etypes:
            raise ValueError(f"graph has {g.num_etypes} etypes, schema "
                             f"{schema.num_etypes}")
        if g.num_ntypes != schema.num_ntypes:
            raise ValueError(f"graph has {g.num_ntypes} ntypes, schema "
                             f"{schema.num_ntypes}")
        self.g = g
        self.schema = schema
        self._rel_cache: Dict[int, tuple] = {}
        if validate and schema.num_etypes > 1:
            self._validate()

    # -- delegation ----------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return self.g.num_nodes

    @property
    def num_edges(self) -> int:
        return self.g.num_edges

    def ntype_of(self) -> np.ndarray:
        """(n,) int32 node-type IDs (zeros for an untyped substrate)."""
        if self.g.ntypes is None:
            return np.zeros(self.g.num_nodes, dtype=np.int32)
        return self.g.ntypes

    def etype_of(self) -> np.ndarray:
        if self.g.etypes is None:
            return np.zeros(self.g.num_edges, dtype=np.int32)
        return self.g.etypes

    # -- typed accessors -----------------------------------------------
    def nodes_of_type(self, ntype: Union[int, str]) -> np.ndarray:
        t = (ntype if isinstance(ntype, (int, np.integer))
             else self.schema.ntype_id(ntype))
        return np.nonzero(self.ntype_of() == t)[0].astype(np.int64)

    def num_nodes_of_type(self, ntype: Union[int, str]) -> int:
        return len(self.nodes_of_type(ntype))

    def relation_coo(self, etype: EtypeKey
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, edge_positions) of one relation, fused IDs.

        ``edge_positions`` indexes the fused CSR's edge axis (for edge_ids /
        feature lookups).
        """
        et = self.schema.etype_id(etype)
        if et not in self._rel_cache:
            g = self.g
            if g.etypes is None:           # degenerate: the whole graph
                pos = np.arange(g.num_edges, dtype=np.int64)
            else:
                pos = np.nonzero(g.etypes == et)[0].astype(np.int64)
            src_all = np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                                np.diff(g.indptr))
            self._rel_cache[et] = (src_all[pos], g.indices[pos].astype(np.int64),
                                   pos)
        return self._rel_cache[et]

    def relation_csr(self, etype: EtypeKey
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-relation out-CSR (indptr, indices, edge_positions) over the
        full fused node space — rows of non-src-typed nodes are empty."""
        src, dst, pos = self.relation_coo(etype)
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        # relation_coo preserves fused-CSR order, which is sorted by src
        return indptr, dst, pos

    def num_rel_edges(self, etype: EtypeKey) -> int:
        return len(self.relation_coo(etype)[0])

    def type_counts(self) -> dict:
        nt = self.ntype_of()
        et = self.etype_of()
        return {
            "nodes": {self.schema.ntypes[t]: int((nt == t).sum())
                      for t in range(self.schema.num_ntypes)},
            "edges": {self.schema.etypes[r]: int((et == r).sum())
                      for r in range(self.schema.num_etypes)},
        }

    # -- validation ----------------------------------------------------
    def _validate(self) -> None:
        nt = self.ntype_of()
        for et in range(self.schema.num_etypes):
            src, dst, _ = self.relation_coo(et)
            s_t = self.schema.src_ntype_id(et)
            d_t = self.schema.dst_ntype_id(et)
            bad_s = np.nonzero(nt[src] != s_t)[0]
            bad_d = np.nonzero(nt[dst] != d_t)[0]
            if len(bad_s) or len(bad_d):
                c = self.schema.canonical_etypes[et]
                raise ValueError(
                    f"relation {c}: {len(bad_s)} edges with wrong src ntype, "
                    f"{len(bad_d)} with wrong dst ntype")

    @staticmethod
    def wrap(g: CSRGraph, schema: Optional[HeteroSchema] = None,
             validate: bool = True) -> "HeteroCSRGraph":
        """Wrap any CSRGraph; untyped graphs get the degenerate schema."""
        if schema is None:
            if g.num_etypes == 1 and g.num_ntypes == 1:
                schema = HeteroSchema.homogeneous()
            else:
                # unnamed types: synthesize positional names. The canonical
                # src/dst ntypes are unknown for a bare typed array, so every
                # relation is declared n0->n0 and validation is skipped —
                # the positional schema names types, it claims no structure.
                schema = HeteroSchema(
                    ntypes=tuple(f"n{t}" for t in range(g.num_ntypes)),
                    canonical_etypes=tuple(("n0", f"e{r}", "n0")
                                           for r in range(g.num_etypes)))
                validate = False
        return HeteroCSRGraph(g, schema, validate=validate)


def fused_from_typed(node_counts: Mapping[str, int],
                     typed_edges: Sequence[tuple[CanonicalEtype,
                                                 np.ndarray, np.ndarray]],
                     ) -> tuple[CSRGraph, HeteroSchema]:
    """Build a fused CSRGraph + schema from per-type node counts and
    per-relation COO edge lists with *type-local* endpoints.

    Node types are laid out contiguously in declaration order (paper IDs
    first, then authors, ...): fused_id = type_offset[ntype] + local_id.
    This is the constructor the synthetic MAG generator uses.
    """
    from .csr import from_edges
    ntypes = tuple(node_counts.keys())
    offsets = {}
    off = 0
    for nt in ntypes:
        offsets[nt] = off
        off += int(node_counts[nt])
    n = off
    ntype_arr = np.zeros(n, dtype=np.int32)
    for t, nt in enumerate(ntypes):
        lo = offsets[nt]
        ntype_arr[lo:lo + node_counts[nt]] = t

    canon = tuple(c for c, _, _ in typed_edges)
    schema = HeteroSchema(ntypes=ntypes, canonical_etypes=canon)
    srcs, dsts, ets = [], [], []
    for r, ((s_nt, _rel, d_nt), src_local, dst_local) in enumerate(typed_edges):
        srcs.append(np.asarray(src_local, dtype=np.int64) + offsets[s_nt])
        dsts.append(np.asarray(dst_local, dtype=np.int64) + offsets[d_nt])
        ets.append(np.full(len(src_local), r, dtype=np.int32))
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    et = np.concatenate(ets) if ets else np.empty(0, np.int32)
    g = from_edges(src, dst, n, etypes=et, ntypes=ntype_arr,
                   num_etypes=len(canon), num_ntypes=len(ntypes))
    return g, schema
