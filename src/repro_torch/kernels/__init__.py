"""Hand-written Hopper kernels for the GNN hot spots, each beside its plain
PyTorch version.

Each kernel package has ``ref.py`` (the plain version, mirroring the
reference's ``ref.py``), ``kernel.py`` (the ctypes wrappers of the CUDA
source in ``repro_torch/csrc``, each with its launch counter) and
``ops.py`` (the ``impl=`` switch of :mod:`.impl`, and on the card the
``torch.autograd.Function`` whose backward is a kernel too). ``pack`` is
the packed one-arena device staging. Importing this package builds
nothing: a kernel is compiled with ``nvcc`` at its first launch
(:mod:`._cuda`).

Ported: K1 ``fused_gather_aggregate`` (with its backward), K2
``segment_sum``, K3 ``fused_edge_softmax_aggregate`` (with its backward),
K4 ``edge_softmax``, ``src_scatter``, the source-keyed reduction both
backward passes share, K5 ``sparse_adam`` (the owners' row-sparse Adam of
``DistEmbedding``) and K6 ``gather_rows``.
"""
from .dst_groups import EdgeGroups, dst_groups, edge_groups, src_groups
from .edge_softmax import (edge_softmax, edge_softmax_norm_cuda,
                           edge_softmax_ref, edge_softmax_stats_cuda)
from .fused_edge_softmax_aggregate import (
    FusedEdgeSoftmaxAggregate, fused_edge_softmax_aggregate,
    fused_edge_softmax_aggregate_bwd_cuda, fused_edge_softmax_aggregate_cuda,
    fused_edge_softmax_aggregate_ref)
from .fused_gather_aggregate import (FusedGatherAggregate,
                                     fused_gather_aggregate,
                                     fused_gather_aggregate_cuda,
                                     fused_gather_aggregate_ref)
from .gather import gather_rows, gather_rows_cuda, gather_rows_ref
from .pack import PackSpec, PackedBatch, device_stage, pack, unpack
from .segment_sum import (gather_edges, keyed_rows, segment_sum,
                          segment_sum_cuda, segment_sum_ref)
from .sparse_adam import (StagingArena, sparse_adam_apply, sparse_adam_cuda,
                          sparse_adam_ref, sparse_adam_staged)
from .src_scatter import src_scatter_cuda, src_scatter_ref

__all__ = ["EdgeGroups", "dst_groups", "edge_groups", "src_groups",
           "edge_softmax", "edge_softmax_norm_cuda", "edge_softmax_ref",
           "edge_softmax_stats_cuda",
           "FusedEdgeSoftmaxAggregate", "fused_edge_softmax_aggregate",
           "fused_edge_softmax_aggregate_bwd_cuda",
           "fused_edge_softmax_aggregate_cuda",
           "fused_edge_softmax_aggregate_ref",
           "FusedGatherAggregate", "fused_gather_aggregate",
           "fused_gather_aggregate_cuda",
           "fused_gather_aggregate_ref",
           "gather_rows", "gather_rows_cuda", "gather_rows_ref",
           "StagingArena", "sparse_adam_apply", "sparse_adam_cuda",
           "sparse_adam_ref", "sparse_adam_staged",
           "gather_edges", "keyed_rows", "segment_sum", "segment_sum_cuda",
           "segment_sum_ref", "src_scatter_cuda", "src_scatter_ref",
           "PackSpec", "PackedBatch", "device_stage", "pack", "unpack",
           "CUDA_WRAPPERS"]

# every kernel wrapper, by the name chip_smoke.py reports it under; each
# counts its own launches in ``.launches``
CUDA_WRAPPERS = {
    "fused_gather_aggregate": fused_gather_aggregate_cuda,
    "segment_sum": segment_sum_cuda,
    "src_scatter": src_scatter_cuda,
    "edge_softmax_stats": edge_softmax_stats_cuda,
    "edge_softmax_norm": edge_softmax_norm_cuda,
    "fused_edge_softmax_aggregate": fused_edge_softmax_aggregate_cuda,
    "fused_edge_softmax_aggregate_bwd": fused_edge_softmax_aggregate_bwd_cuda,
    "sparse_adam": sparse_adam_cuda,
    "gather_rows": gather_rows_cuda,
}
