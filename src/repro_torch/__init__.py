"""PyTorch/CUDA port of ``repro`` (DistDGLv2), slice by slice.

This package mirrors ``repro``'s subpaths. It imports ``torch`` and numpy,
never JAX and nothing of ``repro``. The host plane (graph, partition,
KVStore, sampler) is a verbatim NumPy copy of the reference; the device
plane (kernels, models, serving) is rewritten in PyTorch, and every TPU
kernel on a ported path is a hand-written CUDA kernel for Hopper
(``repro_torch/csrc``). Entry points run on the card unless the caller
asks for ``device="cpu"``.

The public surface is ``repro_torch.api`` (``DistGraph``,
``NodeDataLoader``, ``EdgeDataLoader``, ``DistEmbedding``,
``DistGNNTrainer``, ``InferenceServer``); its names are re-exported here
lazily.
"""
__all__ = ["DistGraph", "DistTensor", "DistEmbedding", "SparseAdamConfig",
           "NodeDataLoader", "EdgeDataLoader", "DistGNNTrainer",
           "TrainJobConfig", "InferenceServer", "PredictionHandle",
           "ServerOverloaded", "DeadlineExceeded"]


def __getattr__(name: str):
    if name in __all__:
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
