"""Edge mini-batches for link prediction (§6: "for link prediction, we may
use all edges to train a model"), layered on the node sampler.

DistDGL's link-prediction workload trains on *edge* mini-batches: a batch of
positive edges, uniform negative endpoints, and the multi-hop ego-networks of
every endpoint gathered through the same distributed neighbor sampler the
node-classification path uses. This module adds exactly that layer without
duplicating any machinery:

* **positive-edge scheduling over owned edges** — each trainer draws its
  positive batches from the edge-ID range its machine owns (edges live with
  their destination vertex, so the owner can resolve both endpoints from
  host-resident arrays without RPC), mirroring §5.6.1's seed split;
* **per-etype edge batches on the typed path** — a schema'd run schedules
  each batch from a single relation (batch order shuffled across relations),
  so the scoring head can look up one relation embedding per batch and
  negatives can be drawn type-correctly from the relation's dst node type;
* **uniform negative sampling with static padded shapes** — ``num_negs``
  corrupted destinations per positive edge, always shaped ``(B, K)``;
  optionally re-drawn so no negative collides with a positive pair of the
  same batch ("exclusion");
* **:class:`EdgeMiniBatch`** — the endpoint seed set is laid out
  ``[u(B) | v(B) | neg(B*K)]`` and pushed through ``DistributedSampler`` as
  ONE padded node mini-batch, so the ego-networks of positive sources,
  positive destinations and negatives share the §2 MFG capacity formulas
  (DESIGN.md §6 has the slot math).

The class duck-types the ``MiniBatch`` surface the pipeline stages touch
(``input_gids`` / ``input_ntypes`` / ``input_feats``), which is what lets
``EdgeMinibatchPipeline`` reuse the 5-stage async pipeline unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ...graph.csr import CSRGraph, to_coo
from ...graph.hetero import HeteroSchema
from ..partition.book import PartitionBook
from .dispatch import DistributedSampler
from .mfg import MiniBatch
from .prng import STREAM_NEG, STREAM_NEG_ADHOC, PerBatchRng


def edge_endpoints(book: PartitionBook, g: CSRGraph
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) in the NEW node-ID space, indexed by NEW edge ID.

    Host-resident positive-edge lookup table: after relabeling, machine m's
    owned edges are exactly NEW edge IDs ``[edge_offsets[m],
    edge_offsets[m+1])``, so a trainer slices its schedule pool directly.
    """
    src_old, dst_old = to_coo(g)
    return (book.old2new_node[src_old[book.new2old_edge]],
            book.old2new_node[dst_old[book.new2old_edge]])


@dataclasses.dataclass(frozen=True)
class PairGraph:
    """The scoring-head view of one edge mini-batch — what DGL hands a
    link-prediction loop as the (positive+negative) *pair graph*. All
    index arrays point at the seed axis of the underlying node mini-batch
    (= the rows of the encoder's output embeddings); gid arrays carry the
    global ids the scheduler/negative-sampler actually drew."""
    pos_u: np.ndarray          # (B,) int32 seed-axis rows of positive srcs
    pos_v: np.ndarray          # (B,) int32 seed-axis rows of positive dsts
    neg_v: np.ndarray          # (B, K) int32 seed-axis rows of negatives
    pair_mask: np.ndarray      # (B,) bool — live positive edges
    pos_eids: np.ndarray       # (B,) int64 NEW edge ids (padded by repeat)
    pos_src: np.ndarray        # (B,) int64 gids
    pos_dst: np.ndarray        # (B,) int64 gids
    neg_dst: np.ndarray        # (B, K) int64 gids
    edge_etypes: np.ndarray    # (B,) int32 relation id per positive edge
    etype: int = -1            # single-relation batch id (-1 = untyped)

    @property
    def batch_edges(self) -> int:
        return len(self.pos_u)

    @property
    def num_negs(self) -> int:
        return int(self.neg_v.shape[1])


@dataclasses.dataclass
class EdgeMiniBatch:
    """One link-prediction batch: a node ``MiniBatch`` over the endpoint
    seed set plus the index arrays the scoring head consumes.

    ``pos_u``/``pos_v``/``neg_v`` index the *seed axis* of ``mb`` (and so
    the rows of the GNN's output embeddings): positives occupy rows
    ``[0, B)`` and ``[B, 2B)``; uniform negatives rows ``[2B, 2B+B*K)``,
    in-batch negatives point back into the ``v`` section. All shapes are
    static — ``pair_mask`` marks live positive slots.
    """
    mb: MiniBatch
    pos_u: np.ndarray          # (B,) int32 seed-axis rows of positive srcs
    pos_v: np.ndarray          # (B,) int32 seed-axis rows of positive dsts
    neg_v: np.ndarray          # (B, K) int32 seed-axis rows of negatives
    pair_mask: np.ndarray      # (B,) bool — live positive edges
    pos_eids: np.ndarray       # (B,) int64 NEW edge ids (padded by repeat)
    pos_src: np.ndarray        # (B,) int64 gids
    pos_dst: np.ndarray        # (B,) int64 gids
    neg_dst: np.ndarray        # (B, K) int64 gids
    edge_etypes: np.ndarray    # (B,) int32 relation id per positive edge
    etype: int = -1            # single-relation batch id (-1 = untyped)

    # -- MiniBatch duck-typing for the pipeline stages -------------------
    @property
    def blocks(self):
        return self.mb.blocks

    @property
    def seeds(self) -> np.ndarray:
        return self.mb.seeds

    @property
    def seed_mask(self) -> np.ndarray:
        return self.mb.seed_mask

    @property
    def input_gids(self) -> np.ndarray:
        return self.mb.input_gids

    @property
    def input_ntypes(self) -> Optional[np.ndarray]:
        return self.mb.input_ntypes

    @property
    def input_feats(self) -> Optional[np.ndarray]:
        return self.mb.input_feats

    @input_feats.setter
    def input_feats(self, value) -> None:
        self.mb.input_feats = value

    @property
    def batch_index(self) -> int:
        return self.mb.batch_index

    @property
    def epoch(self) -> int:
        return self.mb.epoch

    @property
    def batch_edges(self) -> int:
        return len(self.pos_u)

    @property
    def num_negs(self) -> int:
        return self.neg_v.shape[1]

    @property
    def pair_graph(self) -> PairGraph:
        """The scoring-head slice of this batch (what ``EdgeDataLoader``
        yields as the middle element of its DGL-style triple)."""
        return PairGraph(pos_u=self.pos_u, pos_v=self.pos_v,
                         neg_v=self.neg_v, pair_mask=self.pair_mask,
                         pos_eids=self.pos_eids, pos_src=self.pos_src,
                         pos_dst=self.pos_dst, neg_dst=self.neg_dst,
                         edge_etypes=self.edge_etypes, etype=self.etype)


class NegativeSampler:
    """Uniform corrupted-destination sampling with static ``(B, K)`` shapes.

    ``pools`` (typed path) restricts relation r's candidates to its dst
    node type's fused IDs — negatives are always type-correct, matching the
    schema the scorer assumes. ``exclude_batch_positives`` re-draws any
    negative that would collide with a positive pair *of the same batch*
    (the classic false-negative filter; collisions with graph edges outside
    the batch are allowed, as in DGL's uniform sampler), falling back to a
    deterministic linear probe so the guarantee is absolute, not
    probabilistic.

    Randomness is counter-based (DESIGN.md §7): each ``sample`` call draws
    from a private generator derived from ``(seed, epoch, batch_index)``,
    so negatives are reproducible per batch coordinate regardless of
    which sampling worker builds the batch or in what order.
    """

    def __init__(self, num_nodes: int, num_negs: int, *,
                 mode: str = "uniform", seed: int = 0,
                 pools: Optional[Sequence[np.ndarray]] = None,
                 exclude_batch_positives: bool = False,
                 max_resample: int = 8):
        if mode not in ("uniform", "in-batch"):
            raise ValueError(f"unknown negative mode {mode!r}")
        self.num_nodes = int(num_nodes)
        self.num_negs = int(num_negs)
        self.mode = mode
        self.pools = pools
        self.exclude = exclude_batch_positives
        self.max_resample = max_resample
        self.seed = int(seed)
        # the per-batch generator policy (DESIGN.md §7), shared with the
        # node sampler via prng.PerBatchRng — scheduled draws key on
        # (epoch, batch_index), unscheduled ones on a sequential counter
        self._batch_rng = PerBatchRng(self.seed, STREAM_NEG,
                                      STREAM_NEG_ADHOC)

    # ------------------------------------------------------------------
    def _pool(self, etype: int) -> Optional[np.ndarray]:
        if self.pools is None:
            return None
        return self.pools[etype]

    def _bad(self, pos_keys: np.ndarray, u: np.ndarray,
             neg: np.ndarray) -> np.ndarray:
        """(B, K) mask of proposals that equal a positive pair in-batch."""
        keys = u[:, None].astype(np.int64) * self.num_nodes + neg
        return np.isin(keys, pos_keys)

    def _saturated_rows(self, pos_keys: np.ndarray, pos_src: np.ndarray,
                        candidates: np.ndarray) -> np.ndarray:
        """(B,) mask of rows whose ENTIRE candidate set collides with a
        batch positive — exclusion is impossible there (think a 3-node
        graph whose every edge is in the batch), so those rows keep their
        uniform draw instead of probing forever. ``candidates`` is the
        (finite) candidate dst array: the pool for uniform mode, the
        batch's positive dsts for in-batch mode."""
        mat = np.isin(pos_src[:, None].astype(np.int64) * self.num_nodes
                      + candidates[None, :], pos_keys)
        return mat.all(axis=1)

    def sample(self, pos_src: np.ndarray, pos_dst: np.ndarray, etype: int,
               epoch: int = -1, batch_index: int = -1
               ) -> tuple[np.ndarray, Optional[np.ndarray]]:
        """Draw negatives for one batch of positive pairs.

        Returns ``(neg_dst, in_batch_idx)``: gids always; for in-batch mode
        additionally the (B, K) indices into the positive-dst section that
        produced them (None for uniform mode).
        """
        B, K = len(pos_src), self.num_negs
        rng = self._batch_rng(epoch, batch_index)
        pos_keys = (pos_src.astype(np.int64) * self.num_nodes + pos_dst)
        if self.mode == "in-batch":
            idx = rng.integers(0, B, size=(B, K))
            if self.exclude:
                ok = ~self._saturated_rows(pos_keys, pos_src, pos_dst)
                for _ in range(self.max_resample):
                    bad = self._bad(pos_keys, pos_src, pos_dst[idx]) & ok[:, None]
                    if not bad.any():
                        break
                    idx[bad] = rng.integers(0, B, size=int(bad.sum()))
                bad = self._bad(pos_keys, pos_src, pos_dst[idx]) & ok[:, None]
                while bad.any():        # deterministic probe, bounded by B
                    idx[bad] = (idx[bad] + 1) % B
                    bad = self._bad(pos_keys, pos_src, pos_dst[idx]) & ok[:, None]
            return pos_dst[idx], idx.astype(np.int32)

        pool = self._pool(etype)
        size = len(pool) if pool is not None else self.num_nodes

        def draw(n):
            picks = rng.integers(0, size, size=n)
            return pool[picks] if pool is not None else picks.astype(np.int64)

        neg = draw((B, K))
        if self.exclude:
            # a batch holds <= B distinct positives per src, so a row can
            # only saturate when the candidate pool itself is that small
            if size <= B:
                cand = pool if pool is not None else np.arange(
                    size, dtype=np.int64)
                ok = ~self._saturated_rows(pos_keys, pos_src, cand)
            else:
                ok = np.ones(B, dtype=bool)
            for _ in range(self.max_resample):
                bad = self._bad(pos_keys, pos_src, neg) & ok[:, None]
                if not bad.any():
                    break
                neg[bad] = draw(int(bad.sum()))
            bad = self._bad(pos_keys, pos_src, neg) & ok[:, None]
            if bad.any():               # deterministic probe over the pool
                probe = rng.integers(0, size, size=(B, K))
                while bad.any():
                    probe[bad] = (probe[bad] + 1) % size
                    neg[bad] = (pool[probe[bad]] if pool is not None
                                else probe[bad].astype(np.int64))
                    bad = self._bad(pos_keys, pos_src, neg) & ok[:, None]
        return neg, None


class EdgeBatchSampler:
    """Positive-edge scheduling + negative sampling + endpoint ego-networks.

    Wraps a ``DistributedSampler`` whose ``batch_size`` must equal
    :meth:`required_node_batch` — the static endpoint seed capacity
    (2B for in-batch negatives, 2B + B*K for uniform ones). The node
    sampler builds one padded multi-layer MFG over all endpoints; this
    class only decides *which* seeds go in and how the scorer indexes them.

    ``owned_eids`` is this trainer's slice of the NEW edge-ID space (the
    machine's contiguous range split across its trainers). On the typed
    path (``schema`` + ``etype_of_edge``) the owned pool is pre-grouped per
    relation and every scheduled batch carries a single etype.
    """

    def __init__(self, node_sampler: DistributedSampler,
                 e_src: np.ndarray, e_dst: np.ndarray,
                 owned_eids: np.ndarray, batch_edges: int, num_negs: int, *,
                 neg_mode: str = "uniform",
                 etype_of_edge: Optional[np.ndarray] = None,
                 schema: Optional[HeteroSchema] = None,
                 neg_pools: Optional[Sequence[np.ndarray]] = None,
                 exclude_batch_positives: bool = False,
                 seed: int = 0):
        want = self.required_node_batch(batch_edges, num_negs, neg_mode)
        if node_sampler.batch_size != want:
            raise ValueError(
                f"node sampler batch_size {node_sampler.batch_size} != "
                f"required endpoint capacity {want} "
                f"(= 2*{batch_edges}{'' if neg_mode == 'in-batch' else f' + {batch_edges}*{num_negs}'})")
        self.node_sampler = node_sampler
        self.e_src = np.asarray(e_src, dtype=np.int64)
        self.e_dst = np.asarray(e_dst, dtype=np.int64)
        self.owned_eids = np.asarray(owned_eids, dtype=np.int64)
        self.batch_edges = int(batch_edges)
        self.num_negs = int(num_negs)
        self.neg_mode = neg_mode
        self.schema = schema
        self.etype_of_edge = etype_of_edge
        self.typed = schema is not None and etype_of_edge is not None
        num_nodes = node_sampler.book.num_nodes
        self.negatives = NegativeSampler(
            num_nodes, num_negs, mode=neg_mode, seed=seed + 1,
            pools=neg_pools,
            exclude_batch_positives=exclude_batch_positives)
        if self.typed:
            et = self.etype_of_edge[self.owned_eids]
            self._etype_pools: List[np.ndarray] = [
                self.owned_eids[et == r] for r in range(schema.num_etypes)]
        else:
            self._etype_pools = [self.owned_eids]

    # ------------------------------------------------------------------
    @staticmethod
    def required_node_batch(batch_edges: int, num_negs: int,
                            neg_mode: str = "uniform") -> int:
        """Static endpoint seed capacity for (B, K): the node batch size
        the wrapped sampler (and the model's capacity formulas) must use."""
        if neg_mode == "in-batch":
            return 2 * batch_edges
        return 2 * batch_edges + batch_edges * num_negs

    @property
    def batches_per_epoch(self) -> int:
        return sum(len(p) // self.batch_edges for p in self._etype_pools)

    def schedule(self, rng: np.random.Generator, epoch: int,
                 start_batch: int = 0) -> Iterator[tuple]:
        """Stage 1 for edges: permute each relation's owned positives, cut
        into fixed-size batches, shuffle the batch order across relations.
        Untyped runs have one pool (relation -1). Drop-last per pool, like
        the node schedule.

        ``start_batch`` fast-forwards for recovery replay (DESIGN.md §10):
        every permutation is drawn in full — identical rng consumption —
        and only the first ``start_batch`` emissions are skipped, so the
        surviving batches (including their schedule-position-keyed
        negative sampling) are byte-identical to a live run's."""
        B = self.batch_edges
        batches: List[tuple[int, np.ndarray]] = []
        for r, pool in enumerate(self._etype_pools):
            perm = rng.permutation(len(pool))
            for b in range(len(pool) // B):
                batches.append((r if self.typed else -1,
                                pool[perm[b * B:(b + 1) * B]]))
        order = rng.permutation(len(batches))
        for b in order[start_batch:]:
            et, eids = batches[int(b)]
            yield (epoch, int(b), et, eids)

    # ------------------------------------------------------------------
    def sample_edges(self, eids: np.ndarray, etype: int = -1,
                     batch_index: int = -1, epoch: int = -1
                     ) -> EdgeMiniBatch:
        """Build one padded EdgeMiniBatch for positive edges ``eids``."""
        eids = np.asarray(eids, dtype=np.int64)
        B, K = self.batch_edges, self.num_negs
        n_pos = len(eids)
        assert 0 < n_pos <= B, (n_pos, B)
        # pad positives by repeating the first edge (masked out of the loss)
        full = np.empty(B, dtype=np.int64)
        full[:n_pos] = eids
        full[n_pos:] = eids[0]
        u, v = self.e_src[full], self.e_dst[full]
        pair_mask = np.zeros(B, dtype=bool)
        pair_mask[:n_pos] = True
        if self.typed:
            edge_etypes = self.etype_of_edge[full].astype(np.int32)
        else:
            edge_etypes = np.zeros(B, dtype=np.int32)

        neg_dst, in_batch_idx = self.negatives.sample(
            u, v, etype, epoch=epoch, batch_index=batch_index)
        pos_u = np.arange(B, dtype=np.int32)
        pos_v = B + np.arange(B, dtype=np.int32)
        if self.neg_mode == "in-batch":
            seeds = np.concatenate([u, v])
            neg_v = (B + in_batch_idx).astype(np.int32)
        else:
            seeds = np.concatenate([u, v, neg_dst.ravel()])
            neg_v = (2 * B + np.arange(B * K, dtype=np.int32)).reshape(B, K)
        mb = self.node_sampler.sample(seeds, batch_index=batch_index,
                                      epoch=epoch)
        return EdgeMiniBatch(mb=mb, pos_u=pos_u, pos_v=pos_v, neg_v=neg_v,
                             pair_mask=pair_mask, pos_eids=full,
                             pos_src=u, pos_dst=v, neg_dst=neg_dst,
                             edge_etypes=edge_etypes, etype=int(etype))
