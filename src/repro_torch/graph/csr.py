"""Compressed-sparse-row graph container.

This is the substrate DistDGLv2 samples from: the *structure* lives in host
memory as NumPy arrays (the paper keeps it in CPU memory), while mini-batch
tensors are the only thing shipped to the accelerator.

Supports optional edge types (for RGCN-style heterogeneous relations) and
optional node types. The fused single-ID-space layout is deliberate:
full heterographs are a *view* over it (``graph.hetero.HeteroCSRGraph``),
and per-type node/edge ID spaces appear only at the KVStore boundary via
the partition book's per-type policies (see DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Directed graph in CSR form (out-neighbors), host-resident.

    indptr:  (n+1,) int64 — row offsets
    indices: (nnz,) int32/int64 — destination node of each out-edge
    edge_ids:(nnz,) int64 — global edge IDs (identity if None at build)
    etypes:  (nnz,) int32 or None — edge type per edge (RGCN)
    ntypes:  (n,)  int32 or None — node type per node (hetero balancing)
    """

    indptr: np.ndarray
    indices: np.ndarray
    edge_ids: np.ndarray
    etypes: Optional[np.ndarray] = None
    ntypes: Optional[np.ndarray] = None
    num_etypes: int = 1
    num_ntypes: int = 1

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def out_degree(self, u: Optional[np.ndarray] = None) -> np.ndarray:
        deg = np.diff(self.indptr)
        return deg if u is None else deg[u]

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def edge_range(self, u: int) -> tuple[int, int]:
        return int(self.indptr[u]), int(self.indptr[u + 1])

    # ------------------------------------------------------------------
    def reverse(self) -> "CSRGraph":
        """Transpose (in-neighbor CSR), preserving edge ids/types."""
        src = np.repeat(np.arange(self.num_nodes, dtype=self.indices.dtype),
                        np.diff(self.indptr))
        return from_edges(self.indices, src, self.num_nodes,
                          edge_ids=self.edge_ids, etypes=self.etypes,
                          ntypes=self.ntypes, num_etypes=self.num_etypes,
                          num_ntypes=self.num_ntypes)

    def subgraph(self, nodes: np.ndarray) -> tuple["CSRGraph", np.ndarray]:
        """Node-induced subgraph with relabeled IDs.

        Returns (sub, orig_edge_positions). ``nodes`` defines the new ID
        order: new id i == old id nodes[i].
        """
        nodes = np.asarray(nodes)
        n = self.num_nodes
        mapping = np.full(n, -1, dtype=np.int64)
        mapping[nodes] = np.arange(len(nodes), dtype=np.int64)
        # Gather all out edges of `nodes`, keep those landing inside.
        counts = np.diff(self.indptr)[nodes]
        starts = self.indptr[nodes]
        pos = _expand_ranges(starts, counts)
        dst = self.indices[pos]
        keep = mapping[dst] >= 0
        pos = pos[keep]
        dst_new = mapping[dst[keep]]
        src_new = np.repeat(np.arange(len(nodes), dtype=np.int64), counts)[keep]
        sub = from_edges(
            src_new, dst_new, len(nodes),
            edge_ids=self.edge_ids[pos],
            etypes=None if self.etypes is None else self.etypes[pos],
            ntypes=None if self.ntypes is None else self.ntypes[nodes],
            num_etypes=self.num_etypes, num_ntypes=self.num_ntypes,
        )
        return sub, pos


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Vectorized concatenation of [s, s+c) ranges."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(counts)
    return np.repeat(starts, counts) + (np.arange(total) - np.repeat(ends - counts, counts))


def from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int, *,
               edge_ids: Optional[np.ndarray] = None,
               etypes: Optional[np.ndarray] = None,
               ntypes: Optional[np.ndarray] = None,
               num_etypes: int = 1, num_ntypes: int = 1,
               sort: bool = True) -> CSRGraph:
    """Build a CSRGraph from a COO edge list (src -> dst)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = len(src)
    if edge_ids is None:
        edge_ids = np.arange(m, dtype=np.int64)
    else:
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
    if sort:
        order = np.argsort(src, kind="stable")
        src, dst, edge_ids = src[order], dst[order], edge_ids[order]
        if etypes is not None:
            etypes = np.asarray(etypes)[order]
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int64),
                    edge_ids=edge_ids,
                    etypes=None if etypes is None else etypes.astype(np.int32),
                    ntypes=None if ntypes is None else np.asarray(ntypes, dtype=np.int32),
                    num_etypes=num_etypes, num_ntypes=num_ntypes)


def to_coo(g: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    return src, g.indices.astype(np.int64)


def to_undirected(g: CSRGraph) -> CSRGraph:
    """Symmetrize; edge ids are reassigned, types follow the first
    occurrence. Parallel duplicates (when both (u,v) and (v,u) existed)
    are collapsed — samplers assume simple adjacency lists."""
    src, dst = to_coo(g)
    s2 = np.concatenate([src, dst])
    d2 = np.concatenate([dst, src])
    et = None if g.etypes is None else np.concatenate([g.etypes, g.etypes])
    key = s2 * g.num_nodes + d2
    _, first = np.unique(key, return_index=True)
    s2, d2 = s2[first], d2[first]
    et = None if et is None else et[first]
    return from_edges(s2, d2, g.num_nodes, etypes=et, ntypes=g.ntypes,
                      num_etypes=g.num_etypes, num_ntypes=g.num_ntypes)
