"""``repro_torch.api`` -- the ported public surface: the DGL-style
:class:`DistGraph`, :class:`NodeDataLoader`, :class:`EdgeDataLoader`
and :class:`DistEmbedding`
(learnable rows in the KVStore, row-sparse Adam at the owners), the
synchronous :class:`DistGNNTrainer` (with checkpoints and recovery), the
online :class:`InferenceServer` and the layer-wise
:func:`offline_embeddings`.

    from repro_torch.api import (DistGraph, InferenceServer,
                                 offline_embeddings)

    g = DistGraph(ds, num_machines=2, trainers_per_machine=1)
    with InferenceServer(g, cfg, params, device="cuda") as srv:
        logits = srv.predict([0, 1, 2])

    embs = offline_embeddings(g, cfg, params, chunk_size=64)  # on the card
"""
from ..core.kvstore.embedding import DistEmbedding, SparseAdamConfig
from ..core.kvstore.faults import (FaultInjector, OwnerDownWindow,
                                   OwnerUnavailable, RPCRetriesExhausted,
                                   TrainerDeath, TransientRPCError)
from .dataloader import EdgeBatch, EdgeDataLoader, NodeBatch, NodeDataLoader
from .dist_graph import DistGraph, DistTensor
from .inference import (DeadlineExceeded, InferenceServer, PredictionHandle,
                        ServerOverloaded, offline_embeddings)

__all__ = [
    "DistGraph", "DistTensor", "DistEmbedding", "SparseAdamConfig",
    "NodeBatch", "NodeDataLoader", "EdgeBatch", "EdgeDataLoader",
    "DistGNNTrainer", "TrainJobConfig",
    "InferenceServer", "PredictionHandle", "offline_embeddings",
    "ServerOverloaded", "DeadlineExceeded",
    "FaultInjector", "TransientRPCError", "RPCRetriesExhausted",
    "TrainerDeath", "OwnerDownWindow", "OwnerUnavailable",
]


def __getattr__(name: str):
    # the trainer imports this package's loaders, so it is imported on
    # first use rather than here
    if name in ("DistGNNTrainer", "TrainJobConfig"):
        from ..training import trainer
        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
