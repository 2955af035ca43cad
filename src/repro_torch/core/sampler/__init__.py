from .mfg import (MFGBlock, MiniBatch, capacities, pad_block,
                  pad_typed_block, relation_capacities)
from .neighbor import sample_local
from .dispatch import DistributedSampler, SamplerStats
from .ego import (full_neighbor_fanouts, pull_batch_feats,
                  sample_ego_networks)
from .compaction import to_block_device, to_block_reference
from .edge_batch import (EdgeBatchSampler, EdgeMiniBatch, NegativeSampler,
                         PairGraph, edge_endpoints)
from .prng import batch_rng, batch_seed_sequence

__all__ = [
    "MFGBlock", "MiniBatch", "capacities", "pad_block", "pad_typed_block",
    "relation_capacities", "sample_local", "DistributedSampler",
    "SamplerStats", "to_block_device", "to_block_reference",
    "EdgeBatchSampler", "EdgeMiniBatch", "NegativeSampler",
    "PairGraph", "edge_endpoints",
    "batch_rng", "batch_seed_sequence",
    "sample_ego_networks", "pull_batch_feats", "full_neighbor_fanouts",
]
