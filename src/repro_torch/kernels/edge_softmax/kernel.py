"""Wrappers of K4's two CUDA kernels (``repro_torch/csrc/edge_softmax.cu``).

They replace ``edge_softmax_pallas``
(``repro/kernels/edge_softmax/kernel.py``): :func:`edge_softmax_stats_cuda`
its ``_stats_kernel`` (also K3's phase 1) and :func:`edge_softmax_norm_cuda`
its ``_norm_kernel`` (which K3's backward runs on the saved statistics).
Each wrapper checks device, type, shape and contiguity, allocates its
outputs, launches on PyTorch's current stream without synchronising,
counts the launch in its own ``launches`` and raises on a non-zero
``cudaError_t``. The library is built at the first call.

The statistics take a thread a destination (and two heads, or one where
H is odd): up to ``STATS_EDGES`` order entries, then their scores, are
loaded before the online chain runs over them; a group of more than
``WARP_FROM`` live edges is taken by the whole warp, 32 edges a batch,
the running max from a scan over the lanes and the denominator's chain
over the lanes' exponentials in the stable order. The normalize takes a
thread a run of ``NORM_SLOTS`` consecutive slots, with vector loads and
stores where the pointers allow, and gathers the statistics of live
slots only. Every route gives the bits of one thread walking a
(destination, head)'s edges in the stable order. The constants are the
library's compile-time ones; the wrappers check that they agree.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

# csrc/edge_softmax.cu's design constants, in edge_softmax_design's order:
# live edges a statistics thread loads before its chain (U); the group
# length above which the whole warp takes a group; the warp route's
# batches of 32 edges in flight; consecutive slots a normalize thread takes
STATS_EDGES = 8
WARP_FROM = 64
RING = 4
NORM_SLOTS = 4
DESIGN = (STATS_EDGES, WARP_FROM, RING, NORM_SLOTS)

_STATS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
_NORM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library_design() -> tuple:
    fn = _cuda.symbol("edge_softmax", "edge_softmax_design", [ctypes.c_int])
    return tuple(fn(i) for i in range(len(DESIGN)))


def _check_design() -> None:
    if _library_design() != DESIGN:
        raise RuntimeError(f"edge_softmax.cu's design constants are "
                           f"{_library_design()}, the wrapper's {DESIGN}")


def _check_scores(what: str, scores: torch.Tensor) -> None:
    _cuda.check_cuda_f32(what, scores=scores)
    if scores.dim() != 2:
        raise ValueError(f"{what}: scores must be (E, H), got "
                         f"{tuple(scores.shape)}")


def edge_softmax_stats_cuda(scores: torch.Tensor, groups: EdgeGroups):
    """scores: (E, H) f32 on the card; groups: the destination groups ->
    (m, z), each (num_dst, H) f32: the max and the denominator of each
    destination's softmax over its live edges (m = 0, z = 0 where a
    destination has none)."""
    what = "edge_softmax_stats_cuda"
    _check_scores(what, scores)
    _cuda.check_index(what, scores.device, order=groups.order)
    if groups.order.numel() != scores.shape[0]:
        raise ValueError(f"{what}: groups must be built from the scores' "
                         f"E edges")
    _check_design()
    h = scores.shape[1]
    m = torch.empty((groups.num_groups, h), dtype=torch.float32,
                    device=scores.device)
    z = torch.empty_like(m)
    fn = _cuda.symbol("edge_softmax", "edge_softmax_stats_f32",
                      _STATS_ARGTYPES)
    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(), groups.order.data_ptr(),
                 groups.offsets.data_ptr(), m.data_ptr(), z.data_ptr(),
                 groups.num_groups, h, _cuda.stream_ptr(scores.device))
    edge_softmax_stats_cuda.launches += 1
    _cuda.check(err, "edge_softmax_stats")
    return m, z


def edge_softmax_norm_cuda(scores: torch.Tensor, edge_dst: torch.Tensor,
                           edge_mask: torch.Tensor, m: torch.Tensor,
                           z: torch.Tensor) -> torch.Tensor:
    """scores: (E, H) f32; edge_dst: (E,) int32; edge_mask: (E,) bool;
    (m, z) from :func:`edge_softmax_stats_cuda` -> alpha (E, H) f32,
    ``exp(s - m[dst]) / max(z[dst], 1e-30)`` on live edges, 0 on padded
    ones."""
    what = "edge_softmax_norm_cuda"
    _check_scores(what, scores)
    _cuda.check_cuda_f32(what, m=m, z=z)
    _cuda.check_index(what, scores.device, edge_dst=edge_dst)
    e, h = scores.shape
    if (edge_mask.dtype != torch.bool or edge_mask.shape != (e,)
            or not edge_mask.is_contiguous()
            or edge_mask.device != scores.device):
        raise ValueError(f"{what}: edge_mask must be a contiguous (E,) bool "
                         f"tensor on {scores.device}")
    if edge_dst.numel() != e or m.shape != z.shape or m.dim() != 2 \
            or m.shape[1] != h:
        raise ValueError(f"{what}: edge_dst must be (E,) and m, z "
                         f"(num_dst, H) for scores of shape {(e, h)}")
    _check_design()
    alpha = torch.empty_like(scores)
    fn = _cuda.symbol("edge_softmax", "edge_softmax_norm_f32",
                      _NORM_ARGTYPES)
    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(), edge_dst.data_ptr(),
                 edge_mask.data_ptr(), m.data_ptr(), z.data_ptr(),
                 alpha.data_ptr(), e, h, _cuda.stream_ptr(scores.device))
    edge_softmax_norm_cuda.launches += 1
    _cuda.check(err, "edge_softmax_norm")
    return alpha


edge_softmax_stats_cuda.launches = 0
edge_softmax_norm_cuda.launches = 0
