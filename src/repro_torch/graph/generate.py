"""Synthetic graph generators.

The paper evaluates on power-law natural graphs (ogbn-products, Amazon,
ogbn-papers100M, MAG-LSC). Those datasets are not available offline, so the
benchmark harness uses two families of synthetic graphs whose properties
drive the same system behaviours:

* ``rmat`` — recursive-matrix power-law graphs (degree skew => imbalanced
  mini-batches, hub HALO explosion), the stress case for multi-constraint
  balancing and the async pipeline.
* ``planted`` — planted-partition (stochastic block) graphs with strong
  community structure, the best case for min-edge-cut partitioning (METIS
  locality wins show up clearly, mirroring Fig. 14's partition bars).
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges, to_undirected
from .hetero import HeteroSchema, fused_from_typed


def rmat_graph(scale: int, edge_factor: int = 16, *,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               seed: int = 0, undirected: bool = True,
               num_etypes: int = 1, num_ntypes: int = 1) -> CSRGraph:
    """R-MAT generator: 2**scale nodes, edge_factor * n edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for level in range(scale):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_right = r >= a + b          # dst high bit
        go_down = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # src high bit
        src |= go_down.astype(np.int64) << level
        dst |= go_right.astype(np.int64) << level
    # permute node ids so degree isn't correlated with id
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    # drop self loops, dedup
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]
    etypes = None
    if num_etypes > 1:
        etypes = rng.integers(0, num_etypes, size=len(src)).astype(np.int32)
    ntypes = None
    if num_ntypes > 1:
        ntypes = rng.integers(0, num_ntypes, size=n).astype(np.int32)
    g = from_edges(src, dst, n, etypes=etypes, ntypes=ntypes,
                   num_etypes=num_etypes, num_ntypes=num_ntypes)
    return to_undirected(g) if undirected else g


def planted_partition_graph(num_nodes: int, num_blocks: int, *,
                            p_in: float = 12.0, p_out: float = 1.0,
                            seed: int = 0,
                            num_etypes: int = 1) -> CSRGraph:
    """Stochastic block model, expected degree p_in within / p_out across.

    p_in / p_out are *expected per-node edge counts* to make scaling
    intuitive (not probabilities).
    """
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, num_blocks, size=num_nodes).astype(np.int64)
    # within-block edges
    m_in = int(num_nodes * p_in / 2)
    m_out = int(num_nodes * p_out / 2)
    # sample pairs within the same block: pick a node, pick another from its block
    order = np.argsort(blocks, kind="stable")
    sorted_nodes = order
    block_start = np.searchsorted(blocks[order], np.arange(num_blocks))
    block_end = np.searchsorted(blocks[order], np.arange(num_blocks), side="right")
    u = rng.integers(0, num_nodes, size=m_in)
    bu = blocks[u]
    lo, hi = block_start[bu], block_end[bu]
    v = sorted_nodes[lo + (rng.random(m_in) * (hi - lo)).astype(np.int64)]
    src_in, dst_in = u, v
    src_out = rng.integers(0, num_nodes, size=m_out)
    dst_out = rng.integers(0, num_nodes, size=m_out)
    src = np.concatenate([src_in, src_out])
    dst = np.concatenate([dst_in, dst_out])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    etypes = None
    if num_etypes > 1:
        etypes = rng.integers(0, num_etypes, size=len(src)).astype(np.int32)
    g = from_edges(src, dst, num_nodes, etypes=etypes, num_etypes=num_etypes)
    return to_undirected(g)


def _powerlaw_targets(rng: np.random.Generator, num_edges: int,
                      num_targets: int, alpha: float = 0.8) -> np.ndarray:
    """Draw ``num_edges`` endpoints over [0, num_targets) with a Zipf-ish
    skew (hub targets), the degree profile of citation/authorship graphs."""
    u = rng.random(num_edges)
    ranks = (num_targets * u ** (1.0 / (1.0 - alpha))).astype(np.int64)
    ranks = np.minimum(ranks, num_targets - 1)
    # permute so hub ids aren't correlated with id order
    perm = rng.permutation(num_targets)
    return perm[ranks]


def mag_graph(scale: int = 12, *, authors_per_paper: float = 3.0,
              cites_per_paper: float = 8.0, inst_frac: float = 0.02,
              author_frac: float = 1.5, seed: int = 0
              ) -> tuple[CSRGraph, HeteroSchema]:
    """Synthetic OGBN-MAG-like heterograph: 3 node types, 4 relations.

        paper       --cites-->      paper    (power-law in-degree)
        author      --writes-->     paper
        paper       --rev_writes--> author   (reverse of writes: lets the
                                             sampler expand author frontiers)
        institution --employs-->    author   (institution features reach
                                             papers via author hops)

    2**scale papers; authors ~ ``author_frac``×papers, institutions
    ~ ``inst_frac``×papers. Edges point *toward* the prediction targets
    (message-passing direction): the trainer samples in-neighbors of paper
    seeds, so every relation's src type can enter a paper-rooted MFG,
    mirroring the paper's MAG-LSC workload where labels live on papers only.
    """
    rng = np.random.default_rng(seed)
    n_paper = 1 << scale
    n_author = int(n_paper * author_frac)
    n_inst = max(int(n_paper * inst_frac), 4)

    # cites: paper -> paper, power-law cited-degree, no self-cites
    m_cite = int(n_paper * cites_per_paper)
    cite_src = rng.integers(0, n_paper, size=m_cite)
    cite_dst = _powerlaw_targets(rng, m_cite, n_paper)
    keep = cite_src != cite_dst
    cite_src, cite_dst = cite_src[keep], cite_dst[keep]

    # writes: author -> paper (each paper gets ~authors_per_paper authors,
    # authors have power-law productivity)
    m_wr = int(n_paper * authors_per_paper)
    wr_author = _powerlaw_targets(rng, m_wr, n_author)
    wr_paper = rng.integers(0, n_paper, size=m_wr)

    # employs: institution -> author (hub institutions, one each per author)
    emp_author = np.arange(n_author, dtype=np.int64)
    emp_inst = _powerlaw_targets(rng, n_author, n_inst)

    g, schema = fused_from_typed(
        {"paper": n_paper, "author": n_author, "institution": n_inst},
        [(("paper", "cites", "paper"), cite_src, cite_dst),
         (("author", "writes", "paper"), wr_author, wr_paper),
         (("paper", "rev_writes", "author"), wr_paper, wr_author),
         (("institution", "employs", "author"), emp_inst, emp_author)],
    )
    return g, schema


def random_features(num_nodes: int, dim: int, seed: int = 0,
                    dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((num_nodes, dim)).astype(dtype)


def community_labels_and_features(g: CSRGraph, num_classes: int, dim: int, *,
                                  seed: int = 0, noise: float = 1.0):
    """Learnable synthetic node-classification task.

    Labels come from spectral-ish communities (here: label propagation from
    random seeds over the real graph structure), features are a noisy
    class-conditioned Gaussian mixture *plus* neighbor mixing, so that a GNN
    that actually aggregates neighbors beats an MLP — which makes the
    convergence benchmarks (Fig. 2/13 analogues) meaningful.
    """
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    labels = rng.integers(0, num_classes, size=n).astype(np.int64)
    # few rounds of majority propagation to create clustered labels
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    dst = g.indices
    for _ in range(3):
        onehot = np.zeros((n, num_classes), dtype=np.float32)
        onehot[np.arange(n), labels] = 1.0
        agg = np.zeros((n, num_classes), dtype=np.float32)
        np.add.at(agg, dst, onehot[src])
        agg += onehot * 0.5 + rng.random((n, num_classes)) * 0.1
        labels = agg.argmax(axis=1).astype(np.int64)
    centers = rng.standard_normal((num_classes, dim)).astype(np.float32)
    feats = centers[labels] + noise * rng.standard_normal((n, dim)).astype(np.float32)
    # one hop of smoothing: makes the signal partially *structural*
    deg = np.maximum(np.diff(g.indptr), 1).astype(np.float32)
    smooth = np.zeros_like(feats)
    np.add.at(smooth, dst, feats[src])
    feats = 0.5 * feats + 0.5 * smooth / deg[:, None]
    return labels, feats


def train_val_test_split(num_nodes: int, *, train_frac: float = 0.1,
                         val_frac: float = 0.05, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    n_tr = int(num_nodes * train_frac)
    n_va = int(num_nodes * val_frac)
    mask = np.zeros(num_nodes, dtype=np.int8)  # 0 none, 1 train, 2 val, 3 test
    mask[perm[:n_tr]] = 1
    mask[perm[n_tr:n_tr + n_va]] = 2
    mask[perm[n_tr + n_va:n_tr + n_va + n_tr]] = 3
    return mask
