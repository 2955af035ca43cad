"""Wrapper of K1's CUDA kernel (``repro_torch/csrc/fused_gather_aggregate.cu``).

It replaces ``fused_gather_aggregate_pallas``
(``repro/kernels/fused_gather_aggregate/kernel.py``). The wrapper checks
device, type, shape and contiguity, picks float4 columns where F and the
alignment allow, allocates the output, launches on PyTorch's current
stream without synchronising, counts the launch in
``fused_gather_aggregate_cuda.launches`` and raises on a non-zero
``cudaError_t``. The library is built at the first call.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from ..dst_groups import DstGroups

_fns: dict = {}


def _fn():
    fn = _fns.get("f32")
    if fn is None:
        fn = _cuda.load("fused_gather_aggregate").fused_gather_aggregate_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["f32"] = fn
    return fn


def fused_gather_aggregate_cuda(h_src: torch.Tensor, edge_src: torch.Tensor,
                                groups: DstGroups) -> torch.Tensor:
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
    f = h_src.shape[1]
    out = torch.empty((groups.num_dst, f), dtype=torch.float32,
                      device=h_src.device)
    vec4 = int(f % 4 == 0 and h_src.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    with torch.cuda.device(h_src.device):
        err = _fn()(h_src.data_ptr(), edge_src.data_ptr(),
                    groups.order.data_ptr(), groups.offsets.data_ptr(),
                    out.data_ptr(), groups.num_dst, f, vec4,
                    torch.cuda.current_stream().cuda_stream)
    fused_gather_aggregate_cuda.launches += 1
    _cuda.check(err, "fused_gather_aggregate")
    return out


fused_gather_aggregate_cuda.launches = 0
