"""Hand-written Hopper kernels for the GNN hot spots, each beside its plain
PyTorch version.

Each kernel package has ``ref.py`` (the plain version, mirroring the
reference's ``ref.py``), ``kernel.py`` (the ctypes wrapper of the CUDA
source in ``repro_torch/csrc``, with its launch counter) and ``ops.py``
(the ``impl=`` switch of :mod:`.impl`). ``pack`` is the packed one-arena
device staging. Importing this package builds nothing: a kernel is
compiled with ``nvcc`` at its first launch (:mod:`._cuda`).

Ported so far: K1 ``fused_gather_aggregate`` and K2 ``segment_sum``.
"""
from .dst_groups import DstGroups, dst_groups
from .fused_gather_aggregate import (fused_gather_aggregate,
                                     fused_gather_aggregate_cuda,
                                     fused_gather_aggregate_ref)
from .pack import PackSpec, PackedBatch, device_stage, pack, unpack
from .segment_sum import segment_sum, segment_sum_cuda, segment_sum_ref

__all__ = ["DstGroups", "dst_groups",
           "fused_gather_aggregate", "fused_gather_aggregate_cuda",
           "fused_gather_aggregate_ref",
           "segment_sum", "segment_sum_cuda", "segment_sum_ref",
           "PackSpec", "PackedBatch", "device_stage", "pack", "unpack"]
