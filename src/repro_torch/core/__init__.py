"""DistDGLv2's core host plane, copied from ``repro.core``: hierarchical
multi-constraint partitioning, the distributed KVStore and distributed
owner-compute neighbor sampling. The asynchronous mini-batch pipeline is
not ported yet (ROADMAP queue A)."""
from . import kvstore, partition, sampler  # noqa: F401
