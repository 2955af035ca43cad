"""Padded message-flow-graph (MFG) mini-batches.

DGL mini-batches are ragged; XLA/TPU wants one compiled shape. Every layer's
block is padded to *static capacities* derived from (batch_size, fanouts):

    cap_dst[L-1] = batch_size
    cap_edge[l]  = cap_dst[l] * fanout[l]
    cap_src[l]   = cap_dst[l] + cap_edge[l]   (self nodes first, then newly
                                               discovered neighbors)
    cap_dst[l-1] = cap_src[l]

A layer's fanout is either an int (homogeneous) or a per-relation mapping
``{etype: fanout}``; for typed layers ``fanout[l]`` above is the *sum* over
relations, and the edge axis is laid out **relation-major**: relation r owns
the static slot range ``[rel_offsets[r], rel_offsets[r+1])`` with its own
padding, so typed models slice a relation's edges statically instead of
masking the whole axis (see DESIGN.md §2 for the capacity contract and §4
for the per-relation math).

The dst nodes of each block are a prefix of its src nodes (DGL's ``to_block``
invariant), so layer l+1 can slice its inputs from layer l's outputs.
Padding is masked out of aggregation; padded node slots repeat a valid ID so
feature gathers stay in-bounds. The harness reports padding waste — it is
part of the TPU-adaptation story (see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np

Fanout = Union[int, Mapping]    # one layer: int or {etype: fanout}


@dataclasses.dataclass
class MFGBlock:
    """One GNN layer's bipartite block (host arrays, padded).

    For typed blocks (built by ``pad_typed_block``) the edge axis is
    relation-major: ``rel_offsets`` (R+1,) gives each relation's static slot
    range, ``rel_counts`` (R,) its live edge count, and ``edge_types`` is
    filled with the relation ID across the whole segment — padding included —
    so it is a first-class axis (``edge_mask`` alone distinguishes padding).
    Untyped blocks leave ``rel_offsets``/``rel_counts`` as None.
    """
    src_gids: np.ndarray       # (cap_src,) int64 global node ids, dst prefix
    edge_src: np.ndarray       # (cap_edge,) int32 index into src_gids
    edge_dst: np.ndarray       # (cap_edge,) int32 index into dst prefix
    edge_mask: np.ndarray      # (cap_edge,) bool
    edge_types: np.ndarray     # (cap_edge,) int32
    num_src: int
    num_dst: int
    num_edges: int
    rel_offsets: Optional[np.ndarray] = None   # (R+1,) int64, static
    rel_counts: Optional[np.ndarray] = None    # (R,) int64, live edges

    @property
    def cap_src(self) -> int:
        return len(self.src_gids)

    @property
    def cap_edge(self) -> int:
        return len(self.edge_src)

    @property
    def num_rels(self) -> Optional[int]:
        return None if self.rel_offsets is None else len(self.rel_offsets) - 1

    def rel_slice(self, r: int) -> slice:
        """Static slot range of relation ``r`` on the edge axis."""
        assert self.rel_offsets is not None, "untyped block"
        return slice(int(self.rel_offsets[r]), int(self.rel_offsets[r + 1]))


@dataclasses.dataclass
class MiniBatch:
    """Blocks are input-layer first: blocks[0] consumes raw features."""
    blocks: List[MFGBlock]
    seeds: np.ndarray              # (batch,) target node gids (padded)
    seed_mask: np.ndarray          # (batch,) bool
    labels: Optional[np.ndarray]   # (batch,) int64
    input_gids: np.ndarray         # == blocks[0].src_gids
    input_feats: Optional[np.ndarray] = None   # filled by CPU prefetch stage
    input_ntypes: Optional[np.ndarray] = None  # (cap_src_0,) int32, typed runs
    batch_index: int = -1
    epoch: int = -1

    @property
    def num_input_nodes(self) -> int:
        return self.blocks[0].num_src

    def padding_waste(self) -> dict:
        """Fraction of padded slots (reported in benchmarks)."""
        e_cap = sum(b.cap_edge for b in self.blocks)
        e_use = sum(b.num_edges for b in self.blocks)
        s_cap = sum(b.cap_src for b in self.blocks)
        s_use = sum(b.num_src for b in self.blocks)
        return {"edge_fill": e_use / max(e_cap, 1),
                "node_fill": s_use / max(s_cap, 1)}


def _fanout_total(f: Fanout) -> int:
    if isinstance(f, (int, np.integer)):
        return int(f)
    return int(sum(int(v) for v in f.values()))


def capacities(batch_size: int, fanouts: Sequence[Fanout]
               ) -> list[tuple[int, int]]:
    """[(cap_src, cap_edge) per layer], input-layer first.

    Typed layers (dict fanouts) contribute the sum of their per-relation
    fanouts — the relation-major layout partitions exactly that budget.
    """
    caps = []
    cap_dst = batch_size
    for f in reversed(list(fanouts)):       # walk from target layer inward
        cap_edge = cap_dst * _fanout_total(f)
        cap_src = cap_dst + cap_edge
        caps.append((cap_src, cap_edge))
        cap_dst = cap_src
    return caps[::-1]


def relation_capacities(batch_size: int, fanouts: Sequence[Fanout],
                        num_etypes: int, etype_id=None
                        ) -> list[Optional[np.ndarray]]:
    """Per-layer relation slot offsets, input-layer first.

    Each typed layer gets an (R+1,) offsets array with
    ``offsets[r+1]-offsets[r] == cap_dst * fanout_r`` (relation r's static
    edge budget); layers with int fanouts get None (untyped layout).
    ``etype_id`` maps mapping keys to relation IDs (defaults to identity
    for int keys).
    """
    if etype_id is None:
        def etype_id(k):
            if not isinstance(k, (int, np.integer)):
                raise ValueError(
                    f"fanout key {k!r} is not a relation id; name-keyed "
                    f"fanouts need a resolver — pass the schema's etype_id")
            return int(k)
    per_layer: list[Optional[np.ndarray]] = []
    cap_dst = batch_size
    for f in reversed(list(fanouts)):
        if isinstance(f, (int, np.integer)):
            per_layer.append(None)
        else:
            rel_f = np.zeros(num_etypes, dtype=np.int64)
            for k, v in f.items():
                rel_f[etype_id(k)] = int(v)
            offs = np.zeros(num_etypes + 1, dtype=np.int64)
            np.cumsum(cap_dst * rel_f, out=offs[1:])
            per_layer.append(offs)
        cap_dst = cap_dst + cap_dst * _fanout_total(f)
    return per_layer[::-1]


def pad_block(src_gids: np.ndarray, edge_src: np.ndarray, edge_dst: np.ndarray,
              edge_types: Optional[np.ndarray], num_dst: int,
              cap_src: int, cap_edge: int) -> MFGBlock:
    n_src, n_edge = len(src_gids), len(edge_src)
    assert n_src <= cap_src, (n_src, cap_src)
    assert n_edge <= cap_edge, (n_edge, cap_edge)
    pad_gid = src_gids[0] if n_src else 0
    sg = np.full(cap_src, pad_gid, dtype=np.int64)
    sg[:n_src] = src_gids
    es = np.zeros(cap_edge, dtype=np.int32)
    ed = np.zeros(cap_edge, dtype=np.int32)
    em = np.zeros(cap_edge, dtype=bool)
    et = np.zeros(cap_edge, dtype=np.int32)
    es[:n_edge] = edge_src
    ed[:n_edge] = edge_dst
    em[:n_edge] = True
    if edge_types is not None:
        et[:n_edge] = edge_types
    return MFGBlock(src_gids=sg, edge_src=es, edge_dst=ed, edge_mask=em,
                    edge_types=et, num_src=n_src, num_dst=num_dst,
                    num_edges=n_edge)


def pad_typed_block(src_gids: np.ndarray,
                    rel_edge_src: Sequence[np.ndarray],
                    rel_edge_dst: Sequence[np.ndarray],
                    num_dst: int, cap_src: int,
                    rel_offsets: np.ndarray) -> MFGBlock:
    """Relation-major padded block: relation r's live edges go to the head
    of its slot range ``[rel_offsets[r], rel_offsets[r+1])``; the segment
    tail is padding (masked). ``edge_types`` is set to r across the entire
    segment so the type axis is meaningful on every slot."""
    n_src = len(src_gids)
    assert n_src <= cap_src, (n_src, cap_src)
    num_rels = len(rel_offsets) - 1
    assert len(rel_edge_src) == num_rels
    cap_edge = int(rel_offsets[-1])
    pad_gid = src_gids[0] if n_src else 0
    sg = np.full(cap_src, pad_gid, dtype=np.int64)
    sg[:n_src] = src_gids
    es = np.zeros(cap_edge, dtype=np.int32)
    ed = np.zeros(cap_edge, dtype=np.int32)
    em = np.zeros(cap_edge, dtype=bool)
    et = np.zeros(cap_edge, dtype=np.int32)
    counts = np.zeros(num_rels, dtype=np.int64)
    total = 0
    for r in range(num_rels):
        lo, hi = int(rel_offsets[r]), int(rel_offsets[r + 1])
        n_r = len(rel_edge_src[r])
        assert n_r <= hi - lo, (r, n_r, hi - lo)
        es[lo:lo + n_r] = rel_edge_src[r]
        ed[lo:lo + n_r] = rel_edge_dst[r]
        em[lo:lo + n_r] = True
        et[lo:hi] = r
        counts[r] = n_r
        total += n_r
    return MFGBlock(src_gids=sg, edge_src=es, edge_dst=ed, edge_mask=em,
                    edge_types=et, num_src=n_src, num_dst=num_dst,
                    num_edges=total, rel_offsets=np.asarray(rel_offsets,
                                                            dtype=np.int64),
                    rel_counts=counts)
