"""Ad-hoc ego-network sampling — the shared eval/serving protocol.

``NodeDataLoader(mode="eval")`` and :class:`repro.api.InferenceServer`
serve the SAME deterministic ego networks: sequential (unshuffled) chunks
of the requested node ids, each sampled at the ad-hoc epoch coordinate
``(epoch=-1, batch_index=chunk_position)`` (DESIGN.md §7) with features
pulled through the caller's KVStore client. Factoring the loop here is
what makes the serving-oracle contract (DESIGN.md §11) structural: the
server cannot drift from the eval loader because both run this function.

Determinism properties the serving tests pin:

* a chunk's bytes are a pure function of ``(sampler seed, chunk position,
  chunk contents, partitions)`` — not of call history (the coordinates are
  counter-keyed, not drawn from a shared mutable RNG);
* feature bytes are cache-invariant (a cache hit returns exactly the rows
  the owning server would have sent — DESIGN.md §5).

``full_neighbor_fanouts`` resolves DGL's ``fanout=-1`` ("all in-neighbors")
into a static per-layer bound so full-neighborhood sampling fits the §2
static-capacity contract: with ``fanout >= max in-degree`` every seed takes
the whole adjacency list deterministically (no subsampling draw) and the
padded capacities stay compile-time constants. This is what the offline
layer-wise inference pass (DESIGN.md §11) samples with.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from .dispatch import DistributedSampler
from .mfg import MiniBatch


def pull_batch_feats(client, feat_name: str, mb: MiniBatch,
                     typed=None) -> np.ndarray:
    """The eval/serving feature pull: one batched ``pull`` over the
    batch's input nodes (``pull_typed`` on the heterogeneous path, routed
    by the sampler's frontier type bookkeeping)."""
    if typed is not None:
        return client.pull_typed(feat_name, mb.input_gids, typed,
                                 ntypes=mb.input_ntypes)
    return client.pull(feat_name, mb.input_gids)


def sample_ego_networks(sampler: DistributedSampler, client, feat_name: str,
                        nids: np.ndarray, *,
                        labels: Optional[np.ndarray] = None,
                        typed=None, drop_last: bool = True,
                        start_batch_index: int = 0,
                        pull_feats: bool = True) -> Iterator[MiniBatch]:
    """Yield one featurized :class:`MiniBatch` per sequential chunk of
    ``nids`` — the deterministic ad-hoc protocol shared by
    ``NodeDataLoader(mode="eval")`` and the inference server.

    Chunk ``b`` (size ``sampler.batch_size``) is sampled at coordinate
    ``batch_index=start_batch_index + b`` on the ad-hoc epoch (-1), so a
    request covering the same ids produces byte-identical blocks whether
    it is served by a loader, a server tick, or a direct call here.
    ``drop_last=False`` additionally serves the ragged tail chunk (padded
    to capacity like any short batch) — the serving path, where every
    requested node must get a prediction; the eval loader keeps the
    historical ``drop_last=True`` full-chunks-only protocol.
    """
    nids = np.asarray(nids, dtype=np.int64)
    bs = sampler.batch_size
    n_full = len(nids) // bs
    n_chunks = n_full if drop_last else -(-len(nids) // bs)
    for b in range(n_chunks):
        chunk = nids[b * bs:(b + 1) * bs]
        lab = None if labels is None else labels[b * bs:(b + 1) * bs]
        mb = sampler.sample(chunk, labels=lab,
                            batch_index=start_batch_index + b)
        if pull_feats:
            mb.input_feats = pull_batch_feats(client, feat_name, mb,
                                              typed=typed)
        yield mb


def full_neighbor_fanouts(partitions, num_layers: int,
                          schema=None) -> list:
    """Static per-layer fanouts equivalent to DGL's ``fanout=-1``.

    Returns ``[D] * num_layers`` with ``D`` the max in-degree over every
    partition (per relation on the typed path: ``[{etype: D_r}] * L``).
    ``sample_local`` takes a seed's entire adjacency list whenever
    ``degree <= fanout``, so sampling with these fanouts is full-neighbor
    aggregation — deterministic, no RNG consumption — while the padded
    capacities derived from them stay static (§2).
    """
    def max_deg(gps) -> int:
        d = 0
        for gp in gps:
            if len(gp.indptr) > 1:
                d = max(d, int(np.max(np.diff(gp.indptr))))
        return max(d, 1)

    if schema is None:
        return [max_deg(partitions)] * num_layers
    per_rel = {schema.etypes[r]: max_deg([gp.relation_view(r)
                                          for gp in partitions])
               for r in range(schema.num_etypes)}
    return [dict(per_rel)] * num_layers
