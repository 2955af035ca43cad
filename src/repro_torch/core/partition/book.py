"""Partition book + physical graph partitions (§5.3).

Implements the paper's partition-data layout:

* vertex/edge **ID relabeling** so every partition's core vertices and edges
  occupy a contiguous range of the new global ID space — global→partition is
  a binary search over a (k+1) offsets array, global→local a subtraction;
* **edge assignment** to the partition of the *destination* vertex
  (owner-compute: the owner of a target vertex can sample its in-neighbors
  locally without talking to other samplers);
* **HALO vertices**: source endpoints of assigned edges that are core in
  another partition are duplicated into the local node space (structure
  only — features are never duplicated, exactly as in the paper).

Each physical partition stores an in-neighbor CSR over its local ID space
(core rows only; sampling dispatches frontier nodes to their owners, so halo
rows are never expanded locally).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ...graph.csr import CSRGraph, to_coo
from ...graph.hetero import HeteroSchema


@dataclasses.dataclass
class GraphPartition:
    """One machine's physical partition (local in-CSR, core rows)."""
    part_id: int
    indptr: np.ndarray        # (n_core + 1,)
    indices: np.ndarray       # (m_local,) LOCAL src ids (core then halo space)
    edge_ids: np.ndarray      # (m_local,) NEW global edge ids
    etypes: Optional[np.ndarray]
    local2global: np.ndarray  # (n_local,) NEW global node ids; [:n_core] core
    n_core: int
    _rel_views: Dict[int, "GraphPartition"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_local(self) -> int:
        return len(self.local2global)

    @property
    def n_halo(self) -> int:
        return self.n_local - self.n_core

    @property
    def num_local_edges(self) -> int:
        return len(self.indices)

    def relation_view(self, etype: int) -> "GraphPartition":
        """This partition restricted to one relation's edges.

        Same core rows and local node space (``local2global`` is shared,
        not copied); only the adjacency is filtered, so per-relation
        sampling reuses ``sample_local`` unchanged. The view is built
        lazily once and cached. An untyped partition *is* its own
        relation-0 view — that identity is what keeps the degenerate
        homogeneous schema byte-identical to the legacy path.
        """
        if self.etypes is None:
            if etype != 0:
                raise KeyError(f"untyped partition has no relation {etype}")
            return self
        if etype not in self._rel_views:
            keep = np.nonzero(self.etypes == etype)[0]
            rows = np.repeat(np.arange(self.n_core, dtype=np.int64),
                             np.diff(self.indptr))[keep]
            indptr = np.zeros(self.n_core + 1, dtype=np.int64)
            np.add.at(indptr, rows + 1, 1)
            np.cumsum(indptr, out=indptr)
            self._rel_views[etype] = GraphPartition(
                part_id=self.part_id, indptr=indptr,
                indices=self.indices[keep], edge_ids=self.edge_ids[keep],
                etypes=None, local2global=self.local2global,
                n_core=self.n_core)
        return self._rel_views[etype]


@dataclasses.dataclass
class PartitionBook:
    """Global metadata shared by every machine (tiny)."""
    num_parts: int
    node_offsets: np.ndarray   # (k+1,) new-global node-ID range per partition
    edge_offsets: np.ndarray   # (k+1,)
    new2old_node: np.ndarray   # (n,) permutation
    old2new_node: np.ndarray
    new2old_edge: np.ndarray
    old2new_edge: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.node_offsets[-1])

    def nid2part(self, nids: np.ndarray) -> np.ndarray:
        """Binary search in the small offsets array (paper's lookup)."""
        return (np.searchsorted(self.node_offsets, nids, side="right") - 1).astype(np.int32)

    def nid2local(self, nids: np.ndarray, parts: Optional[np.ndarray] = None) -> np.ndarray:
        if parts is None:
            parts = self.nid2part(nids)
        return nids - self.node_offsets[parts]

    def eid2part(self, eids: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.edge_offsets, eids, side="right") - 1).astype(np.int32)

    def part_core_range(self, p: int) -> tuple[int, int]:
        return int(self.node_offsets[p]), int(self.node_offsets[p + 1])


def build_partitions(g: CSRGraph, parts: np.ndarray
                     ) -> tuple[PartitionBook, List[GraphPartition]]:
    """Relabel IDs and materialize per-partition physical subgraphs."""
    n = g.num_nodes
    k = int(parts.max()) + 1 if len(parts) else 1
    parts = parts.astype(np.int64)

    # ---- node relabel: order by (partition, old id) ----
    new2old_node = np.argsort(parts, kind="stable").astype(np.int64)
    old2new_node = np.empty(n, dtype=np.int64)
    old2new_node[new2old_node] = np.arange(n, dtype=np.int64)
    counts = np.bincount(parts, minlength=k)
    node_offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=node_offsets[1:])

    # ---- edge assignment to partition(dst), relabel ----
    src_old, dst_old = to_coo(g)
    src = old2new_node[src_old]
    dst = old2new_node[dst_old]
    eparts = parts[dst_old]
    # new edge id order: (partition, dst, original)
    order = np.lexsort((np.arange(len(src)), dst, eparts))
    new2old_edge = order.astype(np.int64)
    old2new_edge = np.empty(len(src), dtype=np.int64)
    old2new_edge[order] = np.arange(len(src), dtype=np.int64)
    ecounts = np.bincount(eparts, minlength=k)
    edge_offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(ecounts, out=edge_offsets[1:])

    book = PartitionBook(num_parts=k, node_offsets=node_offsets,
                         edge_offsets=edge_offsets,
                         new2old_node=new2old_node, old2new_node=old2new_node,
                         new2old_edge=new2old_edge, old2new_edge=old2new_edge)

    src_sorted = src[order]
    dst_sorted = dst[order]
    et_sorted = None if g.etypes is None else g.etypes[new2old_edge]

    partitions = []
    for p in range(k):
        elo, ehi = int(edge_offsets[p]), int(edge_offsets[p + 1])
        nlo, nhi = int(node_offsets[p]), int(node_offsets[p + 1])
        n_core = nhi - nlo
        e_src = src_sorted[elo:ehi]          # global new ids
        e_dst = dst_sorted[elo:ehi]          # all inside [nlo, nhi)
        # halo: srcs outside the core range
        outside = (e_src < nlo) | (e_src >= nhi)
        halo_g = np.unique(e_src[outside])
        local2global = np.concatenate(
            [np.arange(nlo, nhi, dtype=np.int64), halo_g])
        # map global src -> local id
        src_local = np.where(~outside, e_src - nlo, 0)
        if len(halo_g):
            src_local = np.where(
                outside, n_core + np.searchsorted(halo_g, e_src), src_local)
        dst_local = e_dst - nlo
        # in-CSR rows over core nodes (edges already sorted by dst)
        indptr = np.zeros(n_core + 1, dtype=np.int64)
        np.add.at(indptr, dst_local + 1, 1)
        np.cumsum(indptr, out=indptr)
        partitions.append(GraphPartition(
            part_id=p, indptr=indptr, indices=src_local.astype(np.int64),
            edge_ids=np.arange(elo, ehi, dtype=np.int64),
            etypes=None if et_sorted is None else et_sorted[elo:ehi],
            local2global=local2global, n_core=n_core))
    return book, partitions


# ---------------------------------------------------------------------------
# typed (heterograph) partition data: per-ntype node policies and per-etype
# edge policies over TYPE-LOCAL id spaces (§5.4's "separate policies per
# node/edge type", delivered — see DESIGN.md §3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TypedPartitionData:
    """Typed ID spaces layered on a relabeled partition book.

    After ``build_partitions`` the fused node IDs are partition-contiguous.
    For each node type t we define a *type-local* ID space by ranking type-t
    nodes in fused-ID order — which makes every partition's type-t nodes a
    contiguous type-local range, i.e. each per-ntype KVStore policy is again
    binary-search + subtraction (same scheme as the fused policies, one
    offsets array per type). Edge types get the same treatment over the
    fused edge-ID order.

    Maps (all in the NEW/fused id spaces):
      ntype_of_node (n,)  — node type per fused node id
      node_type_local (n,) — type-local id of each fused node
      type2node[t]        — fused ids of type t, in type-local order
      (and the edge-side equivalents)
    """
    schema: HeteroSchema
    ntype_of_node: np.ndarray
    node_type_local: np.ndarray
    type2node: List[np.ndarray]
    etype_of_edge: np.ndarray
    edge_type_local: np.ndarray
    type2edge: List[np.ndarray]
    node_policies: "Dict[str, object]"   # "node:<ntype>" -> PartitionPolicy
    edge_policies: "Dict[str, object]"   # "edge:<rel>"   -> PartitionPolicy

    def node_policy_name(self, ntype: str) -> str:
        return f"node:{ntype}"

    def edge_policy_name(self, rel: str) -> str:
        return f"edge:{rel}"

    def policies(self) -> "Dict[str, object]":
        return {**self.node_policies, **self.edge_policies}

    def nid2typed(self, nids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """fused node ids -> (ntype ids, type-local ids)."""
        nids = np.asarray(nids, dtype=np.int64)
        return self.ntype_of_node[nids], self.node_type_local[nids]

    def typed2nid(self, ntype: int, tids: np.ndarray) -> np.ndarray:
        return self.type2node[ntype][np.asarray(tids, dtype=np.int64)]


def _typed_axis(type_of: np.ndarray, num_types: int, part_of: np.ndarray,
                num_parts: int, names: List[str], prefix: str):
    """Shared node/edge construction for ``build_typed_partition``."""
    from ..kvstore.store import PartitionPolicy
    n = len(type_of)
    type_local = np.zeros(n, dtype=np.int64)
    type2id: List[np.ndarray] = []
    policies = {}
    for t in range(num_types):
        sel = np.nonzero(type_of == t)[0].astype(np.int64)   # fused-id order
        type_local[sel] = np.arange(len(sel), dtype=np.int64)
        type2id.append(sel)
        counts = np.bincount(part_of[sel], minlength=num_parts)
        offs = np.zeros(num_parts + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        policies[f"{prefix}:{names[t]}"] = PartitionPolicy(
            f"{prefix}:{names[t]}", offs)
    return type_local, type2id, policies


def build_typed_partition(book: PartitionBook, schema: HeteroSchema,
                          ntypes_new: Optional[np.ndarray],
                          etypes_new: Optional[np.ndarray]
                          ) -> TypedPartitionData:
    """Construct per-type policies + id maps for a partitioned heterograph.

    ``ntypes_new``/``etypes_new`` are the type arrays in the NEW (relabeled)
    id orders, e.g. ``g.ntypes[book.new2old_node]`` — None means untyped
    (all type 0), which yields policies identical to the fused ones: the
    degenerate schema costs nothing.
    """
    n = book.num_nodes
    m = int(book.edge_offsets[-1])
    nt = (np.zeros(n, dtype=np.int32) if ntypes_new is None
          else np.asarray(ntypes_new, dtype=np.int32))
    et = (np.zeros(m, dtype=np.int32) if etypes_new is None
          else np.asarray(etypes_new, dtype=np.int32))
    assert len(nt) == n and len(et) == m, (len(nt), n, len(et), m)

    node_part = book.nid2part(np.arange(n, dtype=np.int64))
    edge_part = book.eid2part(np.arange(m, dtype=np.int64))
    node_type_local, type2node, node_policies = _typed_axis(
        nt, schema.num_ntypes, node_part, book.num_parts,
        list(schema.ntypes), "node")
    edge_type_local, type2edge, edge_policies = _typed_axis(
        et, schema.num_etypes, edge_part, book.num_parts,
        list(schema.etypes), "edge")
    return TypedPartitionData(
        schema=schema, ntype_of_node=nt, node_type_local=node_type_local,
        type2node=type2node, etype_of_edge=et,
        edge_type_local=edge_type_local, type2edge=type2edge,
        node_policies=node_policies, edge_policies=edge_policies)


def halo_stats(partitions: List[GraphPartition]) -> dict:
    n_core = sum(p.n_core for p in partitions)
    n_halo = sum(p.n_halo for p in partitions)
    return {"core": n_core, "halo": n_halo,
            "halo_ratio": n_halo / max(n_core, 1)}
