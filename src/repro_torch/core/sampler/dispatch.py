"""Distributed multi-hop neighbor sampling with owner-compute dispatch
(§5.5.1) producing padded MFG mini-batches.

For every hop, frontier vertices are grouped by owning partition (binary
search in the partition book); each owner samples its vertices' in-neighbors
on its local physical partition (``sample_local``) and the trainer stitches
the per-partition results into one bipartite block. Seeds owned by the
trainer's own machine are sampled through the shared-memory path; seeds
owned elsewhere are counted as remote sampling requests (the transport is
charged for the request + response bytes, and for the request *count* —
the batched-RPC metric of §5.5).

Fanouts are per-layer and either an int (homogeneous) or a mapping
``{etype: fanout}`` (DGL-style per-relation fanouts). Typed layers sample
each relation independently on the owner's per-relation partition view and
lay the block's edge axis out relation-major (``MFGBlock.rel_offsets``);
the frontier stays one fused node set — exactly DistDGL's design, where
heterogeneity lives in the relation schema while storage stays fused. The
typed dispatch is **coalesced per owner**: each remote machine receives ONE
sampling request per layer carrying every relation's fanout (the paper
batches RPCs so the async pipeline's front is never starved by per-relation
round trips) — previously it was one request per relation × per owner.

Randomness is counter-based (DESIGN.md §7): every ``sample()`` call derives
a private generator from ``(seed, epoch, batch_index)``, so the sampler is
safe under the pipeline's multi-worker sampling pools and batches are
byte-identical for any worker count, in sync mode, and on replay. Calls
without batch coordinates (evaluation, ad-hoc tests) draw from a
deterministic sequential side stream.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Mapping, Optional, Sequence

import numpy as np

from ...graph.hetero import HeteroSchema
from ..kvstore.transport import Transport
from ..partition.book import GraphPartition, PartitionBook
from .mfg import (Fanout, MFGBlock, MiniBatch, capacities, pad_block,
                  pad_typed_block, relation_capacities)
from .neighbor import DrawCounts, sample_local
from .prng import STREAM_ADHOC, STREAM_SAMPLE, PerBatchRng


def _unique_first_occurrence(ids: np.ndarray) -> np.ndarray:
    """Unique preserving first-occurrence order."""
    uniq, first = np.unique(ids, return_index=True)
    return ids[np.sort(first)]


@dataclasses.dataclass
class SamplerStats:
    batches: int = 0
    seeds_total: int = 0
    seeds_remote: int = 0
    edges_total: int = 0
    input_nodes_total: int = 0
    # remote sampling request accounting (the coalescing win, §5.5):
    # owner_requests counts requests actually issued (one per remote owner
    # per layer); relation_requests counts what a per-relation dispatch
    # would have issued (one per remote owner per *relation* per layer)
    owner_requests: int = 0
    relation_requests: int = 0
    edges_per_etype: Optional[np.ndarray] = None   # typed runs only
    # the neighbour draw (neighbor._subsample_positions): candidate slots
    # given a key, slots that reached the sort, seeds refilled with all
    # their candidates
    draw_candidates: int = 0
    draw_sorted: int = 0
    draw_refills: int = 0

    @property
    def remote_seed_frac(self) -> float:
        return self.seeds_remote / max(self.seeds_total, 1)

    @property
    def request_coalescing_factor(self) -> float:
        """How many per-relation requests each issued request replaced."""
        return self.relation_requests / max(self.owner_requests, 1)

    def as_dict(self) -> dict:
        """Flat report for loader/benchmark consumers (repro.api's
        ``stats_report`` surfaces this instead of the raw dataclass)."""
        return {"batches": self.batches,
                "seeds_total": self.seeds_total,
                "seeds_remote": self.seeds_remote,
                "remote_seed_frac": self.remote_seed_frac,
                "edges_total": self.edges_total,
                "input_nodes_total": self.input_nodes_total,
                "owner_requests": self.owner_requests,
                "relation_requests": self.relation_requests,
                "coalescing_factor": self.request_coalescing_factor,
                "draw_candidates": self.draw_candidates,
                "draw_sorted": self.draw_sorted,
                "draw_refills": self.draw_refills}


class DistributedSampler:
    """One trainer's sampler (runs in the sampling worker pool, §5.5).

    fanouts are input-layer first (the paper's "15, 10, 5"); each entry is
    an int or a per-relation mapping ``{etype: fanout}`` (keys: relation
    ids, or names when ``schema`` is given). ``machine`` is the trainer's
    home machine: its partition is accessed via shared memory, all other
    partitions through (simulated) RPC. ``ntype_of_node`` (NEW-id space)
    enables typed frontier bookkeeping: each minibatch reports its input
    nodes' types so the CPU-prefetch stage can route per-ntype KVStore
    pulls.

    ``sample`` is thread-safe: randomness is derived per call (see
    ``prng.batch_rng``), stats updates are lock-guarded, and relation
    views are pre-built at construction so the pool workers only read.
    """

    def __init__(self, book: PartitionBook, partitions: List[GraphPartition],
                 fanouts: Sequence[Fanout], batch_size: int, machine: int = 0,
                 transport: Optional[Transport] = None, seed: int = 0,
                 schema: Optional[HeteroSchema] = None,
                 ntype_of_node: Optional[np.ndarray] = None):
        self.book = book
        self.partitions = partitions
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.machine = machine
        self.transport = transport
        self.schema = schema
        self.ntype_of_node = ntype_of_node
        self.typed = any(isinstance(f, Mapping) for f in self.fanouts)
        if self.typed and schema is None:
            raise ValueError("per-relation fanouts require a HeteroSchema")
        self.caps = capacities(batch_size, self.fanouts)
        if self.typed:
            self.rel_caps = relation_capacities(
                batch_size, self.fanouts, schema.num_etypes,
                etype_id=schema.etype_id)
            # relation views are lazily cached on the (shared) partitions;
            # build them now, single-threaded, so pool workers never race
            # the cache fill
            for gp in partitions:
                for r in range(schema.num_etypes):
                    gp.relation_view(r)
        else:
            self.rel_caps = [None] * len(self.fanouts)
        self.seed = seed
        self.stats = SamplerStats()
        self._stats_lock = threading.Lock()
        # the call's private generator policy (DESIGN.md §7)
        self._batch_rng = PerBatchRng(seed, STREAM_SAMPLE, STREAM_ADHOC)
        if self.typed:
            self.stats.edges_per_etype = np.zeros(schema.num_etypes,
                                                  dtype=np.int64)

    # ------------------------------------------------------------------
    def sample(self, seeds: np.ndarray, labels: Optional[np.ndarray] = None,
               batch_index: int = -1, epoch: int = -1) -> MiniBatch:
        """Build the padded multi-layer MFG for ``seeds`` (global IDs)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        n_seed = len(seeds)
        assert n_seed <= self.batch_size
        rng = self._batch_rng(epoch, batch_index)

        cur = seeds
        blocks_rev: List[MFGBlock] = []
        edges_total = 0
        for hop in range(len(self.fanouts)):
            layer = len(self.fanouts) - 1 - hop
            fanout = self.fanouts[layer]
            cap_src, cap_edge = self.caps[layer]
            if isinstance(fanout, Mapping):
                block = self._sample_typed_layer(cur, fanout, cap_src,
                                                 self.rel_caps[layer], rng)
            else:
                block = self._sample_untyped_layer(cur, fanout, cap_src,
                                                   cap_edge, rng)
            blocks_rev.append(block)
            edges_total += block.num_edges
            cur = block.src_gids[:block.num_src]

        with self._stats_lock:
            self.stats.batches += 1
            self.stats.edges_total += edges_total
            self.stats.input_nodes_total += len(cur)

        blocks = blocks_rev[::-1]
        seed_pad = np.full(self.batch_size, seeds[0] if n_seed else 0,
                           dtype=np.int64)
        seed_pad[:n_seed] = seeds
        seed_mask = np.zeros(self.batch_size, dtype=bool)
        seed_mask[:n_seed] = True
        lab = None
        if labels is not None:
            lab = np.zeros(self.batch_size, dtype=np.int64)
            lab[:n_seed] = labels
        input_ntypes = None
        if self.ntype_of_node is not None:
            input_ntypes = self.ntype_of_node[blocks[0].src_gids].astype(
                np.int32)
        return MiniBatch(blocks=blocks, seeds=seed_pad, seed_mask=seed_mask,
                         labels=lab, input_gids=blocks[0].src_gids,
                         input_ntypes=input_ntypes,
                         batch_index=batch_index, epoch=epoch)

    # ------------------------------------------------------------------
    def _group_by_owner(self, cur: np.ndarray
                        ) -> List[tuple[int, np.ndarray, np.ndarray]]:
        """Partition-book lookup for one layer's frontier, computed once
        per layer (every relation reuses it): [(part, sel, local_ids)]."""
        parts = self.book.nid2part(cur)
        with self._stats_lock:
            self.stats.seeds_total += len(parts)
            self.stats.seeds_remote += int((parts != self.machine).sum())
        groups = []
        for p in np.unique(parts):
            sel = np.nonzero(parts == p)[0]
            local = self.book.nid2local(cur[sel], parts[sel])
            groups.append((int(p), sel, local))
        return groups

    def _charge_owner_request(self, num_seeds: int, resp_rows: int,
                              num_relations: int) -> None:
        """Account ONE coalesced sampling request to a remote owner:
        request = the seed list + one fanout word per relation; response =
        the sampled (src_gid, edge_id, etype) triples."""
        if self.transport is not None:
            req = num_seeds * 8 + num_relations * 4
            resp = resp_rows * (8 + 8 + 4)
            self.transport.charge_remote(req + resp)
        with self._stats_lock:
            self.stats.owner_requests += 1
            self.stats.relation_requests += num_relations

    def _count_draw(self, draw: DrawCounts) -> None:
        with self._stats_lock:
            self.stats.draw_candidates += draw.candidates
            self.stats.draw_sorted += draw.sorted
            self.stats.draw_refills += draw.refills

    def _dispatch(self, groups, fanout: int, rng: np.random.Generator,
                  view=None, collect_etypes: bool = False
                  ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Owner-compute one (layer, relation): returns
        (src_gids, dst_idx, etypes) concatenated over partitions in
        partition order. ``view`` selects a per-relation partition view
        (None = the full partition); ``etypes`` is None unless requested
        and the partitions carry edge types."""
        e_src_g: List[np.ndarray] = []
        e_dst_i: List[np.ndarray] = []
        e_type: List[np.ndarray] = []
        typed = False
        draw = DrawCounts()
        for p, sel, local in groups:
            gp = self.partitions[p]
            if view is not None:
                gp = gp.relation_view(view)
            src_g, seed_pos, _eids, etyp = sample_local(gp, local, fanout, rng,
                                                        draw)
            e_src_g.append(src_g)
            e_dst_i.append(sel[seed_pos].astype(np.int32))
            if collect_etypes and etyp is not None:
                typed = True
                e_type.append(etyp)
            if p != self.machine:
                self._charge_owner_request(len(sel), len(src_g), 1)
        self._count_draw(draw)
        src_gids = (np.concatenate(e_src_g) if e_src_g
                    else np.empty(0, dtype=np.int64))
        dst_idx = (np.concatenate(e_dst_i) if e_dst_i
                   else np.empty(0, dtype=np.int32))
        etypes = np.concatenate(e_type) if typed else None
        return src_gids, dst_idx, etypes

    @staticmethod
    def _compact(cur: np.ndarray, src_gids: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
        """Next-layer inputs: current seeds first (to_block prefix rule),
        then newly discovered neighbors; returns (uniq, src_idx) with
        ``src_idx`` the compacted per-edge src index. Host-side version of
        core.sampler.compaction (the GPU pipeline stage)."""
        uniq = _unique_first_occurrence(np.concatenate([cur, src_gids]))
        order = np.argsort(uniq, kind="stable")
        pos_sorted = np.searchsorted(uniq[order], src_gids)
        src_idx = order[pos_sorted].astype(np.int32)
        return uniq, src_idx

    def _sample_untyped_layer(self, cur: np.ndarray, fanout: int,
                              cap_src: int, cap_edge: int,
                              rng: np.random.Generator) -> MFGBlock:
        """Legacy homogeneous layer (one sample_local call per owning
        partition, one flat edge list — guarded by the golden-hash test)."""
        groups = self._group_by_owner(cur)
        src_gids, dst_idx, etypes = self._dispatch(groups, fanout, rng,
                                                   collect_etypes=True)
        uniq, src_idx = self._compact(cur, src_gids)
        return pad_block(uniq, src_idx, dst_idx, etypes, num_dst=len(cur),
                         cap_src=cap_src, cap_edge=cap_edge)

    def _sample_typed_layer(self, cur: np.ndarray, fanout: Mapping,
                            cap_src: int, rel_offsets: np.ndarray,
                            rng: np.random.Generator) -> MFGBlock:
        """Per-relation layer with per-owner request coalescing: the loop
        is owner-major — each owner samples EVERY active relation on its
        relation views and is charged ONE request for the lot — while the
        assembled edge lists stay relation-major (each relation's edges
        concatenated over partitions in partition order), so the block
        layout is identical to the per-relation dispatch. The frontier
        (and to_block compaction) stays one fused node set."""
        schema = self.schema
        rel_fanout = schema.normalize_fanout(dict(fanout))
        groups = self._group_by_owner(cur)
        active = [r for r in range(schema.num_etypes) if rel_fanout[r] != 0]
        # per (relation, partition) results, assembled relation-major below
        parts_src: dict = {r: [] for r in active}
        parts_dst: dict = {r: [] for r in active}
        draw = DrawCounts()
        for p, sel, local in groups:
            gp = self.partitions[p]
            resp_rows = 0
            for r in active:
                src_g, seed_pos, _eids, _ = sample_local(
                    gp.relation_view(r), local, int(rel_fanout[r]), rng, draw)
                parts_src[r].append(src_g)
                parts_dst[r].append(sel[seed_pos].astype(np.int32))
                resp_rows += len(src_g)
            if p != self.machine:
                self._charge_owner_request(len(sel), resp_rows, len(active))
        self._count_draw(draw)
        rel_src_g: List[np.ndarray] = []
        rel_dst_i: List[np.ndarray] = []
        per_etype = np.zeros(schema.num_etypes, dtype=np.int64)
        for r in range(schema.num_etypes):
            if r not in parts_src:
                rel_src_g.append(np.empty(0, dtype=np.int64))
                rel_dst_i.append(np.empty(0, dtype=np.int32))
                continue
            src_g = (np.concatenate(parts_src[r]) if parts_src[r]
                     else np.empty(0, dtype=np.int64))
            dst_i = (np.concatenate(parts_dst[r]) if parts_dst[r]
                     else np.empty(0, dtype=np.int32))
            rel_src_g.append(src_g)
            rel_dst_i.append(dst_i)
            per_etype[r] = len(src_g)
        with self._stats_lock:
            self.stats.edges_per_etype += per_etype
        all_src = (np.concatenate(rel_src_g) if rel_src_g
                   else np.empty(0, dtype=np.int64))
        uniq, src_idx = self._compact(cur, all_src)
        # split the compacted indices back per relation
        rel_src_idx: List[np.ndarray] = []
        off = 0
        for r in range(schema.num_etypes):
            n_r = len(rel_src_g[r])
            rel_src_idx.append(src_idx[off:off + n_r])
            off += n_r
        return pad_typed_block(uniq, rel_src_idx, rel_dst_i,
                               num_dst=len(cur), cap_src=cap_src,
                               rel_offsets=rel_offsets)
