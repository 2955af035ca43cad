"""Wrapper of K1's CUDA kernel (``repro_torch/csrc/fused_gather_aggregate.cu``).

It replaces ``fused_gather_aggregate_pallas``
(``repro/kernels/fused_gather_aggregate/kernel.py``). The wrapper checks
device, type, shape and contiguity, picks float4 columns where F and the
alignment allow, allocates the output, launches on PyTorch's current
stream without synchronising, counts the launch in
``fused_gather_aggregate_cuda.launches`` and raises on a non-zero
``cudaError_t``. The library is built at the first call.

A warp sums one destination with the whole row in its lanes (column
vectors and slabs as :func:`~..segment_sum.kernel.row_tiling` gives them
for :func:`gather_floats` of the launch), loads a batch's ``order`` and
``edge_src`` once, and gathers U rows before it adds them in the stable
order: the output is bitwise the plain version's under deterministic
algorithms.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

# csrc/fused_gather_aggregate.cu's design constants, in
# fused_gather_aggregate_design's order: floats of gathered rows a lane
# holds before the adds in a launch of at most FEW_DST destinations, at
# most MANY_DST, and more; and column vectors a lane holds at most
GATHER_FLOATS_FEW = 128
GATHER_FLOATS_MID = 32
GATHER_FLOATS_MANY = 16
FEW_DST = 1024
MANY_DST = 8192
MAX_VECS_PER_LANE = 8
DESIGN = (GATHER_FLOATS_FEW, GATHER_FLOATS_MID, GATHER_FLOATS_MANY, FEW_DST,
          MANY_DST, MAX_VECS_PER_LANE)


def gather_floats(num_dst: int) -> int:
    """Floats of gathered rows a lane holds in a launch of ``num_dst``
    destinations: more rows in flight for few, more resident warps for
    many. No bit of the result depends on it."""
    if num_dst > MANY_DST:
        return GATHER_FLOATS_MANY
    return GATHER_FLOATS_MID if num_dst > FEW_DST else GATHER_FLOATS_FEW


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library_design() -> tuple:
    fn = _cuda.symbol("fused_gather_aggregate",
                      "fused_gather_aggregate_design", [ctypes.c_int])
    return tuple(fn(i) for i in range(len(DESIGN)))


def fused_gather_aggregate_cuda(h_src: torch.Tensor, edge_src: torch.Tensor,
                                groups: EdgeGroups) -> torch.Tensor:
    """h_src: (V, F) f32 on the card; edge_src: (E,) int32 -> (num_dst, F)
    f32, each destination's live source rows summed in ``groups``' order.
    ``edge_src`` must index rows of ``h_src`` (the sampler guarantees it)."""
    if not h_src.is_cuda:
        raise ValueError(f"fused_gather_aggregate_cuda needs a CUDA tensor, "
                         f"got {h_src.device}")
    if h_src.dtype != torch.float32:
        raise TypeError(f"fused_gather_aggregate_cuda takes float32, got "
                        f"{h_src.dtype}")
    if h_src.dim() != 2 or not h_src.is_contiguous():
        raise ValueError(f"h_src must be a contiguous (V, F) tensor, got "
                         f"shape {tuple(h_src.shape)}")
    if (edge_src.dtype != torch.int32 or edge_src.dim() != 1
            or not edge_src.is_contiguous()
            or edge_src.device != h_src.device):
        raise ValueError("edge_src must be a contiguous (E,) int32 tensor "
                         "on h_src's device")
    if (groups.order.device != h_src.device
            or groups.order.numel() != edge_src.numel()):
        raise ValueError("groups must be built on h_src's device from the "
                         "same E edges")
    if _library_design() != DESIGN:
        raise RuntimeError(f"fused_gather_aggregate.cu's design constants "
                           f"are {_library_design()}, the wrapper's "
                           f"{DESIGN}")
    f = h_src.shape[1]
    out = torch.empty((groups.num_groups, f), dtype=torch.float32,
                      device=h_src.device)
    vec4 = int(f % 4 == 0 and h_src.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    fn = _cuda.symbol("fused_gather_aggregate", "fused_gather_aggregate_f32",
                      _ARGTYPES)
    with torch.cuda.device(h_src.device):
        err = fn(h_src.data_ptr(), edge_src.data_ptr(),
                 groups.order.data_ptr(), groups.offsets.data_ptr(),
                 out.data_ptr(), groups.num_groups, f, vec4,
                 _cuda.stream_ptr(h_src.device))
    fused_gather_aggregate_cuda.launches += 1
    _cuda.check(err, "fused_gather_aggregate")
    return out


fused_gather_aggregate_cuda.launches = 0
