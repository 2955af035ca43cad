"""Device-side subgraph compaction, the paper's ``to_block`` on the GPU
(§5.5.1: "after sampling a subgraph, we move the subgraph to GPU and
perform to_block on GPUs"); the port of ``repro/core/sampler/compaction.py``.

Given padded seed gids and padded edge src gids, produce:
  * ``uniq``      (cap_src,) unique gids in first-occurrence order (seeds
                  first -- the to_block dst-prefix invariant), padded;
  * ``n_uniq``    scalar count;
  * ``edge_src``  (cap_edge,) compacted src index per edge.

Every shape is static and the ids are int32, as in the reference with x64
off. Algorithm: stable-sort by gid; flag group heads; each group's head
priority (its first occurrence position, padding pushed to ``_BIG``) is
ranked to recover first-occurrence order; ranks are scattered back
through the sort permutation. Plain PyTorch on the tensors' device: the
reference's function is ``jnp`` outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

_ID_DTYPE = torch.int32
_BIG = int(torch.iinfo(_ID_DTYPE).max)


def _propagate_group_head(values: torch.Tensor,
                          is_head: torch.Tensor) -> torch.Tensor:
    """For each position, the ``values`` entry at its group head (groups
    are contiguous runs; position 0 is a head): the last head at or before
    a position is a running max of the heads' positions."""
    pos = torch.arange(values.shape[0], device=values.device)
    last_head = torch.cummax(torch.where(is_head, pos, 0), 0).values
    return values[last_head]


def to_block_device(seed_gids: torch.Tensor, seed_mask: torch.Tensor,
                    edge_gids: torch.Tensor, edge_mask: torch.Tensor,
                    cap_src: int):
    """Static-shape first-occurrence compaction of tensors on one device.
    See module docstring."""
    dev = seed_gids.device
    seed_gids = seed_gids.to(_ID_DTYPE)
    edge_gids = edge_gids.to(_ID_DTYPE)
    n_seed = seed_gids.shape[0]
    ids = torch.cat([torch.where(seed_mask, seed_gids, _BIG),
                     torch.where(edge_mask, edge_gids, _BIG)])
    n = ids.shape[0]
    arange = torch.arange(n, dtype=_ID_DTYPE, device=dev)
    prio = torch.where(ids == _BIG, _BIG, arange)

    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    sprio = prio[order]
    is_head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sid[1:] != sid[:-1]])
    group = torch.cumsum(is_head, 0) - 1                 # (n,) contiguous
    head_prio = _propagate_group_head(sprio, is_head)    # min prio per group

    # rank groups by head priority (== first occurrence order)
    gfp = torch.full((n,), _BIG, dtype=_ID_DTYPE, device=dev)
    gfp.scatter_reduce_(0, torch.where(is_head, group, n - 1),
                        torch.where(is_head, head_prio, _BIG), "amin")
    ord2 = torch.argsort(gfp, stable=True)
    grank = torch.empty(n, dtype=_ID_DTYPE, device=dev)
    grank[ord2] = arange

    new_idx = torch.empty(n, dtype=_ID_DTYPE, device=dev)
    new_idx[order] = grank[group]
    edge_src = new_idx[n_seed:]

    # unique ids in rank order; a rank past cap_src is dropped into the
    # extra last slot (only dropped writes meet there)
    head_rank = torch.where(is_head & (sprio != _BIG), grank[group], cap_src)
    head_rank = torch.clamp(head_rank, max=cap_src).long()
    uniq = torch.zeros(cap_src + 1, dtype=_ID_DTYPE, device=dev)
    uniq[head_rank] = sid
    uniq = uniq[:cap_src]
    n_uniq = torch.sum(is_head & (head_prio != _BIG)).to(torch.int32)
    # padded uniq slots repeat slot 0 (valid gid) so feature gathers stay real
    uniq = torch.where(torch.arange(cap_src, device=dev) < n_uniq, uniq,
                       uniq[0])
    return uniq, n_uniq, edge_src


def to_block_reference(seed_gids: np.ndarray, seed_mask: np.ndarray,
                       edge_gids: np.ndarray, edge_mask: np.ndarray,
                       cap_src: int):
    """NumPy oracle (the host compaction the sampler uses)."""
    seeds = np.asarray(seed_gids)[np.asarray(seed_mask)]
    egs = np.asarray(edge_gids)[np.asarray(edge_mask)]
    allids = np.concatenate([seeds, egs])
    _, first = np.unique(allids, return_index=True)
    uniq = allids[np.sort(first)]
    n_uniq = len(uniq)
    lookup = {g: i for i, g in enumerate(uniq.tolist())}
    edge_src = np.zeros(len(edge_gids), dtype=np.int32)
    em = np.asarray(edge_mask)
    for i, (g, m) in enumerate(zip(np.asarray(edge_gids).tolist(), em.tolist())):
        if m:
            edge_src[i] = lookup[g]
    out = np.full(cap_src, uniq[0] if n_uniq else 0, dtype=np.int64)
    out[:n_uniq] = uniq[:cap_src]
    return out, n_uniq, edge_src
