from .transport import NetworkModel, PeerHealth, Transport
from .store import DistKVStore, KVClient, KVServer, PartitionPolicy
from .embedding import DistEmbedding, SparseAdamConfig
from .cache import CacheConfig, FeatureCache, halo_access_counts
from .faults import (FaultInjector, OwnerDownError, OwnerDownWindow,
                     OwnerUnavailable, RPCRetriesExhausted, TrainerDeath,
                     TransientRPCError)

__all__ = [
    "NetworkModel", "PeerHealth", "Transport", "DistKVStore", "KVClient",
    "KVServer", "PartitionPolicy", "DistEmbedding", "SparseAdamConfig",
    "CacheConfig", "FeatureCache", "halo_access_counts",
    "FaultInjector", "TransientRPCError", "RPCRetriesExhausted",
    "TrainerDeath", "OwnerDownError", "OwnerDownWindow", "OwnerUnavailable",
]
