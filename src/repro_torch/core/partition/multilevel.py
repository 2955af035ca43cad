"""Multilevel multi-constraint min-edge-cut graph partitioner (§5.3.1–5.3.2).

A NumPy reimplementation of the METIS recipe the paper uses, including the
paper's power-law extensions:

* **coarsening** by heavy-edge matching (HEM);
* **degree-capped edge retention**: on each coarser graph, every coarse
  vertex keeps only its highest-weight edges so that its degree is (at most)
  the average degree of its constituent vertices — the paper's fix for
  power-law graphs whose coarse graphs otherwise densify ("we extended METIS
  to only retain a subset of the edges in each successive graph");
* a **single initial partitioning** (greedy region growing) and a **single
  refinement pass per level** (the paper reduces METIS' defaults of 5 / 10
  to 1 / 1 for power-law graphs at a 2–10% edge-cut cost);
* **multi-constraint balancing** [Karypis & Kumar 1998]: vertex weights are
  (n, ncon) — e.g. [ones, degree, is_train, is_val, is_test, ntype
  indicators] — and every move/assignment must keep every constraint within
  (1 + eps) of its per-partition average. This is §5.3.2's balancing of
  train/val/test vertices, edges, and per-type counts.

The partitioner is model-agnostic and runs once per graph (preprocessing),
matching the paper's amortization argument.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ...graph.csr import CSRGraph, to_coo


@dataclasses.dataclass
class _Level:
    indptr: np.ndarray
    indices: np.ndarray
    ewgts: np.ndarray
    vwgts: np.ndarray      # (n, ncon)
    cmap: Optional[np.ndarray]  # fine -> coarse map that produced THIS level


def _symmetrize(indptr, indices, ewgts, n):
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    w = np.concatenate([ewgts, ewgts])
    return _build_csr(s, d, w, n, combine=True)


def _build_csr(src, dst, w, n, combine=False):
    if combine and len(src):
        key = src * n + dst
        order = np.argsort(key, kind="stable")
        key, src, dst, w = key[order], src[order], dst[order], w[order]
        uniq_mask = np.empty(len(key), dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        group = np.cumsum(uniq_mask) - 1
        wsum = np.zeros(int(group[-1]) + 1, dtype=w.dtype)
        np.add.at(wsum, group, w)
        src, dst, w = src[uniq_mask], dst[uniq_mask], wsum
    else:
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int64), w


def _heavy_edge_matching(indptr, indices, ewgts, rng):
    """Greedy heavy-edge matching. Returns match[v] = partner (or v)."""
    n = len(indptr) - 1
    match = np.full(n, -1, dtype=np.int64)
    order = rng.permutation(n)
    for v in order:
        if match[v] >= 0:
            continue
        lo, hi = indptr[v], indptr[v + 1]
        nbrs = indices[lo:hi]
        if len(nbrs) == 0:
            match[v] = v
            continue
        w = ewgts[lo:hi]
        free = match[nbrs] < 0
        free &= nbrs != v
        if not free.any():
            match[v] = v
            continue
        cand_w = np.where(free, w, -1)
        u = nbrs[int(np.argmax(cand_w))]
        match[v] = u
        match[u] = v
    return match


def _coarsen(level: _Level, rng, degree_cap: bool) -> Optional[_Level]:
    n = len(level.indptr) - 1
    match = _heavy_edge_matching(level.indptr, level.indices, level.ewgts, rng)
    # assign coarse ids: representative = min(v, match[v])
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    if nc > 0.95 * n:   # matching stalled (e.g. star graphs) — stop coarsening
        return None
    # coarse vertex weights
    ncon = level.vwgts.shape[1]
    cvw = np.zeros((nc, ncon), dtype=level.vwgts.dtype)
    np.add.at(cvw, cmap, level.vwgts)
    # coarse edges
    src, _ = _fine_coo(level)
    csrc = cmap[src]
    cdst = cmap[level.indices]
    keep = csrc != cdst
    ci, cx, cw = _build_csr(csrc[keep], cdst[keep], level.ewgts[keep], nc,
                            combine=True)
    if degree_cap:
        ci, cx, cw = _cap_degrees(ci, cx, cw, level, cmap, nc)
    return _Level(indptr=ci, indices=cx, ewgts=cw, vwgts=cvw, cmap=cmap)


def _fine_coo(level: _Level):
    n = len(level.indptr) - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(level.indptr))
    return src, level.indices


def _cap_degrees(indptr, indices, ewgts, fine: _Level, cmap, nc):
    """Paper's power-law fix: cap each coarse vertex's degree at the average
    degree of its constituents, keeping the highest-weight edges."""
    fine_deg = np.diff(fine.indptr).astype(np.float64)
    csize = np.zeros(nc, dtype=np.int64)
    np.add.at(csize, cmap, 1)
    cdegsum = np.zeros(nc, dtype=np.float64)
    np.add.at(cdegsum, cmap, fine_deg)
    cap = np.maximum(1, np.ceil(cdegsum / np.maximum(csize, 1))).astype(np.int64)

    deg = np.diff(indptr)
    if (deg <= cap).all():
        return indptr, indices, ewgts
    keep = np.ones(len(indices), dtype=bool)
    for v in np.nonzero(deg > cap)[0]:
        lo, hi = indptr[v], indptr[v + 1]
        w = ewgts[lo:hi]
        # keep the cap[v] highest-weight edges
        drop = np.argsort(w, kind="stable")[: (hi - lo) - cap[v]]
        keep[lo + drop] = False
    s = np.repeat(np.arange(nc, dtype=np.int64), deg)[keep]
    return _build_csr(s, indices[keep], ewgts[keep], nc)


def _balance_caps(vwgts, k, eps):
    totals = vwgts.sum(axis=0).astype(np.float64)
    return (1.0 + eps) * totals / k + vwgts.max(axis=0)   # slack for granularity


def _initial_partition(level: _Level, k, eps, rng):
    """Greedy region growing: k BFS fronts grown by connection strength,
    constrained by the primary weight; leftovers go to the lightest part."""
    n = len(level.indptr) - 1
    parts = np.full(n, -1, dtype=np.int32)
    caps = _balance_caps(level.vwgts, k, eps)
    loads = np.zeros((k, level.vwgts.shape[1]), dtype=np.float64)
    seeds = rng.choice(n, size=min(k, n), replace=False)
    from heapq import heappush, heappop
    heaps = [[] for _ in range(k)]
    counter = 0
    for p, s in enumerate(seeds):
        heappush(heaps[p], (0.0, counter, int(s)))
        counter += 1
    active = list(range(min(k, n)))
    while active:
        # grow the currently lightest active part (primary constraint)
        p = min(active, key=lambda q: loads[q, 0])
        placed = False
        while heaps[p]:
            _, _, v = heappop(heaps[p])
            if parts[v] >= 0:
                continue
            if ((loads[p] + level.vwgts[v]) > caps).any():
                continue
            parts[v] = p
            loads[p] += level.vwgts[v]
            lo, hi = level.indptr[v], level.indptr[v + 1]
            for u, w in zip(level.indices[lo:hi], level.ewgts[lo:hi]):
                if parts[u] < 0:
                    heappush(heaps[p], (-float(w), counter, int(u)))
                    counter += 1
            placed = True
            break
        if not placed:
            active.remove(p)
    # assign untouched vertices (disconnected or capacity-skipped):
    # lightest part that still fits every constraint, falling back to the
    # overall-lightest only when nothing fits (rebalance repairs later)
    for v in np.nonzero(parts < 0)[0]:
        score = loads[:, 0] + loads.sum(axis=1)
        fits = ((loads + level.vwgts[v]) <= caps).all(axis=1)
        if fits.any():
            score = np.where(fits, score, np.inf)
        p = int(np.argmin(score))
        parts[v] = p
        loads[p] += level.vwgts[v]
    return parts


def _rebalance(level: _Level, parts, k, eps, max_passes=4):
    """Drain overloaded partitions until every constraint is within the
    ``_balance_caps`` envelope ``(1+eps)·total/k + max_vwgt``.

    Refinement alone never repairs imbalance (it only refuses to worsen
    it), and both the coarse-level granularity and the initial
    partition's forced placements can overflow the caps. Each level runs
    this after refinement, so successively finer granularity shaves the
    overflow down to the finest level's vertex weights. Vertices leave an
    overloaded part least-attached-first (minimum same-part edge weight),
    landing on the feasible part they connect to most — the smallest cut
    damage that restores balance.
    """
    caps = _balance_caps(level.vwgts, k, eps)
    loads = np.zeros((k, level.vwgts.shape[1]), dtype=np.float64)
    np.add.at(loads, parts, level.vwgts)
    src, _ = _fine_coo(level)
    for _ in range(max_passes):
        over = np.nonzero((loads > caps + 1e-9).any(axis=1))[0]
        if not len(over):
            break
        moved = 0
        # same-part connectivity: how embedded each vertex is where it sits
        own_w = np.zeros(len(parts), dtype=np.float64)
        same = parts[src] == parts[level.indices]
        np.add.at(own_w, src[same], level.ewgts[same])
        for p in over:
            verts = np.nonzero(parts == p)[0]
            for v in verts[np.argsort(own_w[verts], kind="stable")]:
                if (loads[p] <= caps + 1e-9).all():
                    break
                lo, hi = level.indptr[v], level.indptr[v + 1]
                conn = np.zeros(k, dtype=np.float64)
                np.add.at(conn, parts[level.indices[lo:hi]],
                          level.ewgts[lo:hi])
                feasible = ((loads + level.vwgts[v]) <= caps).all(axis=1)
                feasible[p] = False
                if not feasible.any():
                    continue
                conn = np.where(feasible, conn, -np.inf)
                best = int(np.argmax(conn))
                parts[v] = best
                loads[p] -= level.vwgts[v]
                loads[best] += level.vwgts[v]
                moved += 1
        if moved == 0:
            break
    # best-effort phase: strict feasibility can dead-end — e.g. two parts
    # over the COUNT cap while two others are over the DEGREE cap, so no
    # single receiver is feasible and the tied maximum never strictly
    # drops. Descend a potential Φ = Σ_{p,c} excess(p,c)² instead (excess
    # in units of the cap): any move that strictly shrinks TOTAL excess is
    # taken, which walks through tied-maximum plateaus and trades hub
    # vertices one way for light vertices the other.
    def _phi_part(load):
        ex = np.maximum(load / caps - 1.0, 0.0)
        return float((ex * ex).sum())

    # bounded move count: each iteration re-derives candidates with
    # per-part argsorts, so an O(n) bound would be O(n² log n) at the
    # finest level; the residual past a few hundred single-row moves is
    # within the property-tested 2·vmax slack anyway
    for _ in range(min(4 * len(parts), 512)):
        over = np.nonzero((loads > caps + 1e-9).any(axis=1))[0]
        if not len(over):
            break
        best_move, best_dphi = None, -1e-12
        for p in over:
            verts = np.nonzero(parts == p)[0]
            # candidates: the heaviest vertices on each violated
            # constraint (hubs shift load fastest) + a light-vertex tail
            # (fine-grained count adjustment)
            cand: list = []
            for c in np.nonzero(loads[p] > caps + 1e-9)[0]:
                w = level.vwgts[verts, c]
                cand.extend(verts[np.argsort(-w, kind="stable")[:8]])
            cand.extend(verts[np.argsort(
                level.vwgts[verts].sum(axis=1), kind="stable")[:32]])
            phi_p = _phi_part(loads[p])
            for v in dict.fromkeys(int(x) for x in cand):
                d_p = _phi_part(loads[p] - level.vwgts[v]) - phi_p
                for q in range(k):
                    if q == p:
                        continue
                    d_q = (_phi_part(loads[q] + level.vwgts[v])
                           - _phi_part(loads[q]))
                    if d_p + d_q < best_dphi:
                        best_move, best_dphi = (v, p, q), d_p + d_q
        if best_move is None:
            break
        v, p, q = best_move
        parts[v] = q
        loads[p] -= level.vwgts[v]
        loads[q] += level.vwgts[v]
    return parts


def _refine(level: _Level, parts, k, eps, passes=1):
    """Greedy boundary (KL/FM-style) refinement, multi-constraint safe.

    The paper runs a single refinement iteration per level for power-law
    graphs; ``passes=1`` mirrors that.
    """
    n = len(level.indptr) - 1
    caps = _balance_caps(level.vwgts, k, eps)
    loads = np.zeros((k, level.vwgts.shape[1]), dtype=np.float64)
    np.add.at(loads, parts, level.vwgts)
    src, dst = _fine_coo(level)
    for _ in range(passes):
        # boundary vertices: any edge crossing partitions
        cross = parts[src] != parts[dst]
        boundary = np.unique(src[cross])
        moved = 0
        for v in boundary:
            lo, hi = level.indptr[v], level.indptr[v + 1]
            nbr_p = parts[level.indices[lo:hi]]
            w = level.ewgts[lo:hi]
            own = parts[v]
            conn = np.zeros(k, dtype=np.float64)
            np.add.at(conn, nbr_p, w)
            gain = conn - conn[own]
            gain[own] = -np.inf
            # forbid moves that break any balance constraint
            feasible = ((loads + level.vwgts[v]) <= caps).all(axis=1)
            gain[~feasible] = -np.inf
            best = int(np.argmax(gain))
            if gain[best] > 0:
                parts[v] = best
                loads[own] -= level.vwgts[v]
                loads[best] += level.vwgts[v]
                moved += 1
        if moved == 0:
            break
    return parts


def partition_graph(g: CSRGraph, k: int, *,
                    vwgts: Optional[np.ndarray] = None,
                    eps: float = 0.08, seed: int = 0,
                    coarsen_to: Optional[int] = None,
                    degree_cap: bool = True,
                    refine_passes: int = 1) -> np.ndarray:
    """k-way multi-constraint partition. Returns parts: (n,) int32.

    ``vwgts`` (n, ncon) are the balance constraints; defaults to
    [ones, out_degree] (vertex + edge balance).
    """
    n = g.num_nodes
    if k <= 1 or n <= k:
        return (np.arange(n) % max(k, 1)).astype(np.int32)
    if vwgts is None:
        vwgts = np.stack([np.ones(n), np.diff(g.indptr)], axis=1).astype(np.float64)
    vwgts = np.asarray(vwgts, dtype=np.float64)
    if vwgts.ndim == 1:
        vwgts = vwgts[:, None]
    rng = np.random.default_rng(seed)
    if coarsen_to is None:
        coarsen_to = max(32 * k, 256)

    src, dst = to_coo(g)
    keep = src != dst
    indptr, indices, ewgts = _symmetrize(
        *_build_csr(src[keep], dst[keep], np.ones(keep.sum(), dtype=np.float64),
                    n, combine=True), n)
    levels = [_Level(indptr, indices, ewgts, vwgts, cmap=None)]
    while len(levels[-1].indptr) - 1 > coarsen_to:
        nxt = _coarsen(levels[-1], rng, degree_cap)
        if nxt is None:
            break
        levels.append(nxt)

    parts = _initial_partition(levels[-1], k, eps, rng)
    parts = _refine(levels[-1], parts, k, eps, passes=max(refine_passes, 2))
    parts = _rebalance(levels[-1], parts, k, eps)
    for fine, coarse in zip(levels[-2::-1], levels[:0:-1]):
        parts = parts[coarse.cmap]
        parts = _refine(fine, parts, k, eps, passes=refine_passes)
        parts = _rebalance(fine, parts, k, eps)
    return parts.astype(np.int32)


def random_partition(g: CSRGraph, k: int, seed: int = 0) -> np.ndarray:
    """Euler-style random partitioning (the paper's baseline contrast)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=g.num_nodes).astype(np.int32)


def edge_cut(g: CSRGraph, parts: np.ndarray) -> float:
    """Fraction of (directed) edges crossing partitions."""
    src, dst = to_coo(g)
    if len(src) == 0:
        return 0.0
    return float((parts[src] != parts[dst]).mean())


def balance_report(g: CSRGraph, parts: np.ndarray, vwgts: np.ndarray) -> np.ndarray:
    """Max-over-partitions imbalance factor per constraint:
    max_p load[p, c] / (total[c] / k). 1.0 == perfectly balanced."""
    k = int(parts.max()) + 1
    vwgts = np.asarray(vwgts, dtype=np.float64)
    if vwgts.ndim == 1:
        vwgts = vwgts[:, None]
    loads = np.zeros((k, vwgts.shape[1]))
    np.add.at(loads, parts, vwgts)
    ideal = vwgts.sum(axis=0) / k
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ideal > 0, loads.max(axis=0) / ideal, 1.0)


def make_constraints(g: CSRGraph, split_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """§5.3.2's constraint matrix: vertices, edges, train/val/test counts,
    and per-ntype vertex counts for heterographs."""
    n = g.num_nodes
    cols = [np.ones(n), np.diff(g.indptr).astype(np.float64)]
    if split_mask is not None:
        for s in (1, 2, 3):
            cols.append((split_mask == s).astype(np.float64))
    if g.ntypes is not None and g.num_ntypes > 1:
        for t in range(g.num_ntypes):
            cols.append((g.ntypes == t).astype(np.float64))
    return np.stack(cols, axis=1)
