"""DistDGLv2's core host plane, copied from ``repro.core``: hierarchical
multi-constraint partitioning, the distributed KVStore, distributed
owner-compute neighbor sampling and the asynchronous node mini-batch
pipeline (its device stage on the port's packed staging)."""
from . import kvstore, partition, pipeline, sampler  # noqa: F401
