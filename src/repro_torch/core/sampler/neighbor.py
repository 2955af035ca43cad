"""Per-partition vertex-wise neighbor sampling (§5.5.1).

``sample_local`` is what a sampler *server* runs on its own physical
partition: given the seed vertices it owns (local core IDs), draw at most
``fanout`` in-neighbors per seed without replacement, returning global IDs.
The computation is per-vertex independent — the property the paper exploits
to decompose sampling across machines.

The without-replacement subsample is fully vectorized: instead of a Python
loop calling ``rng.choice`` per seed, every candidate edge slot of every
subsampled seed gets one uniform random key, and the ``fanout`` smallest
keys per seed are the draw (a batched random-key selection, equivalent in
distribution to a per-seed partial Fisher–Yates). Only the few candidates
whose key lies below a per-seed threshold are ranked, not every candidate
slot: on a skewed graph a hop's frontier has millions of slots, of which a
few percent are kept. The result is exactly the reference's single
``lexsort`` over all slots, from the same one RNG call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..partition.book import GraphPartition


# The draw's filter keeps candidate ``j`` of a seed of degree ``d`` where
# its key is below ``(fanout + FILTER_SIGMAS * sqrt(fanout) + FILTER_SLACK)
# / d``: about that many candidates a seed, so that fewer than ``fanout``
# of them (a refill) befalls some 2e-5 of the seeds at fanouts 1-25 (the
# Poisson tail).
FILTER_SIGMAS = 4.0
FILTER_SLACK = 6.0


@dataclasses.dataclass
class DrawCounts:
    """What ``_subsample_positions`` did, summed over its calls."""
    candidates: int = 0     # candidate slots given a key
    sorted: int = 0         # slots that reached the sort
    refills: int = 0        # seeds that ranked all their candidates


def _subsample_positions(starts: np.ndarray, degs: np.ndarray, fanout: int,
                         rng: np.random.Generator,
                         draw: Optional[DrawCounts] = None) -> np.ndarray:
    """Vectorized without-replacement draw of ``fanout`` adjacency
    positions for every seed (all must have ``degs > fanout``).

    Returns ``len(starts) * fanout`` absolute positions, grouped by seed.
    Random-key selection: candidate ``j`` of seed ``i`` gets key ``u_ij``;
    the ``fanout`` smallest keys within each seed's segment, in key order,
    are a uniform without-replacement sample of its adjacency list. The
    result equals ``lexsort((keys, seed))`` over every candidate: a seed's
    ``fanout`` smallest keys lie below any threshold that at least
    ``fanout`` of its keys lie below, so only those candidates are ranked,
    and a seed with fewer below its threshold ranks all its candidates.
    ``draw``, if given, is incremented.
    """
    degs = degs.astype(np.int64)
    n = len(degs)
    tot = int(degs.sum())
    ends = np.cumsum(degs)
    grp_start = ends - degs
    keys = rng.random(tot)
    margin = fanout + FILTER_SIGMAS * np.sqrt(fanout) + FILTER_SLACK
    # a seed of degree <= margin keeps every candidate (keys are < 1)
    kept = np.flatnonzero(keys < np.repeat(margin / degs, degs))
    seg = np.searchsorted(ends, kept, side="right")
    cnt = np.bincount(seg, minlength=n)
    short = np.flatnonzero(cnt < fanout)
    if len(short):
        short_degs = degs[short]
        fill = np.arange(int(short_degs.sum()), dtype=np.int64) + np.repeat(
            grp_start[short] - (np.cumsum(short_degs) - short_degs),
            short_degs)
        is_short = np.zeros(n, dtype=bool)
        is_short[short] = True
        live = ~is_short[seg]
        kept = np.concatenate([kept[live], fill])
        seg = np.concatenate([seg[live], np.repeat(short, short_degs)])
        cnt[short] = short_degs
    k = keys[kept]
    # seed + key is monotone in (seed, key), so where its values are
    # distinct their one ascending order is the lexsort's; on any tie, the
    # stable lexsort (each seed's kept slots are in position order)
    comp = seg + k
    order = np.argsort(comp)
    comp = comp[order]
    if (comp[1:] == comp[:-1]).any():
        order = np.lexsort((k, seg))
    first = np.cumsum(cnt) - cnt
    sel = order[(first[:, None] + np.arange(fanout)).ravel()]
    if draw is not None:
        draw.candidates += tot
        draw.sorted += len(kept)
        draw.refills += len(short)
    sel_seg = seg[sel]
    return starts[sel_seg] + (kept[sel] - grp_start[sel_seg])


def _subsample_positions_loop(starts: np.ndarray, degs: np.ndarray,
                              fanout: int, rng: np.random.Generator
                              ) -> np.ndarray:
    """Pre-pool per-seed ``rng.choice`` loop. Kept as the reference for
    ``benchmarks/sampling_micro.py`` (vectorized-vs-loop row) and the
    distribution tests; not used on the hot path."""
    out = np.empty(len(starts) * fanout, dtype=np.int64)
    for i in range(len(starts)):
        picks = rng.choice(int(degs[i]), size=fanout, replace=False)
        out[i * fanout:(i + 1) * fanout] = starts[i] + picks
    return out


def sample_local(gp: GraphPartition, local_seeds: np.ndarray, fanout: int,
                 rng: np.random.Generator,
                 draw: Optional[DrawCounts] = None,
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sample in-neighbors of ``local_seeds`` (core-local IDs) on ``gp``.

    Returns (src_gids, seed_pos, edge_ids, etypes): one row per sampled
    edge; ``seed_pos`` indexes into ``local_seeds`` (the caller knows which
    global seed that is). fanout < 0 means "all neighbors". ``draw``, if
    given, accumulates the draw's counts.
    """
    indptr, indices = gp.indptr, gp.indices
    starts = indptr[local_seeds]
    degs = indptr[local_seeds + 1] - starts

    if fanout < 0:
        take_all = np.ones(len(degs), dtype=bool)
        counts = degs
    else:
        take_all = degs <= fanout
        counts = np.minimum(degs, fanout)
    total = int(counts.sum())
    if total == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.astype(np.int32), z, (None if gp.etypes is None else z.astype(np.int32))

    seed_pos = np.repeat(np.arange(len(local_seeds), dtype=np.int32), counts)
    # positions within each seed's adjacency list
    ends = np.cumsum(counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)

    pos = np.empty(total, dtype=np.int64)
    # full-neighborhood seeds: contiguous ranges (vectorized)
    full_rows = np.repeat(take_all, counts)
    pos[full_rows] = np.repeat(starts, counts)[full_rows] + offs[full_rows]
    # subsampled seeds: batched random-key selection (see module docstring)
    sub = np.nonzero(~take_all)[0]
    if len(sub):
        pos[~full_rows] = _subsample_positions(starts[sub], degs[sub],
                                               fanout, rng, draw)

    src_local = indices[pos]
    src_gids = gp.local2global[src_local]
    edge_ids = gp.edge_ids[pos]
    etypes = None if gp.etypes is None else gp.etypes[pos]
    return src_gids, seed_pos, edge_ids, etypes
