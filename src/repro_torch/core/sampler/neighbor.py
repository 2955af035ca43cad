"""Per-partition vertex-wise neighbor sampling (§5.5.1).

``sample_local`` is what a sampler *server* runs on its own physical
partition: given the seed vertices it owns (local core IDs), draw at most
``fanout`` in-neighbors per seed without replacement, returning global IDs.
The computation is per-vertex independent — the property the paper exploits
to decompose sampling across machines.

The without-replacement subsample is fully vectorized: instead of a Python
loop calling ``rng.choice`` per seed, every candidate edge slot of every
subsampled seed gets one uniform random key and a single ``lexsort`` ranks
the keys within each seed's segment — the ``fanout`` smallest keys per seed
are the draw (a batched random-key selection, equivalent in distribution to
a per-seed partial Fisher–Yates). One RNG call, one sort, no per-seed
Python overhead — this is the kernel the sampler worker pool multiplies.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..partition.book import GraphPartition


def _subsample_positions(starts: np.ndarray, degs: np.ndarray, fanout: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Vectorized without-replacement draw of ``fanout`` adjacency
    positions for every seed (all must have ``degs > fanout``).

    Returns ``len(starts) * fanout`` absolute positions, grouped by seed.
    Random-key selection: candidate ``j`` of seed ``i`` gets key ``u_ij``;
    the ``fanout`` smallest keys within each seed's segment are a uniform
    without-replacement sample of its adjacency list.
    """
    degs = degs.astype(np.int64)
    tot = int(degs.sum())
    ends = np.cumsum(degs)
    grp_start = ends - degs
    # candidate's offset within its seed's adjacency list — also, because
    # segments occupy the same index ranges after a stable per-segment
    # sort, the rank threshold mask for the sorted layout
    within = np.arange(tot, dtype=np.int64) - np.repeat(grp_start, degs)
    seed_rep = np.repeat(np.arange(len(degs), dtype=np.int64), degs)
    keys = rng.random(tot)
    order = np.lexsort((keys, seed_rep))      # segment-major, key-ascending
    sel = order[within < fanout]              # fanout smallest keys per seed
    return starts[seed_rep[sel]] + within[sel]


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
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Sample in-neighbors of ``local_seeds`` (core-local IDs) on ``gp``.

    Returns (src_gids, seed_pos, edge_ids, etypes): one row per sampled
    edge; ``seed_pos`` indexes into ``local_seeds`` (the caller knows which
    global seed that is). fanout < 0 means "all neighbors".
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
                                               fanout, rng)

    src_local = indices[pos]
    src_gids = gp.local2global[src_local]
    edge_ids = gp.edge_ids[pos]
    etypes = None if gp.etypes is None else gp.etypes[pos]
    return src_gids, seed_pos, edge_ids, etypes
