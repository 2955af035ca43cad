"""Positive-edge endpoint lookup, the one function of ``repro``'s
``core/sampler/edge_batch.py`` that the serving slice needs
(``api/dist_graph.py`` imports it). Edge mini-batches for link prediction
are not ported yet (ROADMAP queue A)."""
from __future__ import annotations

import numpy as np

from ...graph.csr import CSRGraph, to_coo
from ..partition.book import PartitionBook


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
