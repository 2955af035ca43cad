"""``repro_torch.api`` -- the ported public surface: the DGL-style
:class:`DistGraph` and the online :class:`InferenceServer`.

    from repro_torch.api import DistGraph, InferenceServer

    g = DistGraph(ds, num_machines=2, trainers_per_machine=1)
    with InferenceServer(g, cfg, params, device="cuda") as srv:
        logits = srv.predict([0, 1, 2])

The data loaders, the trainer, ``DistEmbedding`` and
``offline_embeddings`` are not ported yet (ROADMAP queue A).
"""
from ..core.kvstore.faults import (FaultInjector, OwnerDownWindow,
                                   OwnerUnavailable, RPCRetriesExhausted,
                                   TrainerDeath, TransientRPCError)
from .dist_graph import DistGraph, DistTensor
from .inference import (DeadlineExceeded, InferenceServer, PredictionHandle,
                        ServerOverloaded)

__all__ = [
    "DistGraph", "DistTensor",
    "InferenceServer", "PredictionHandle",
    "ServerOverloaded", "DeadlineExceeded",
    "FaultInjector", "TransientRPCError", "RPCRetriesExhausted",
    "TrainerDeath", "OwnerDownWindow", "OwnerUnavailable",
]
