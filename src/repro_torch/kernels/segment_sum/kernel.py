"""Wrapper of K2's CUDA kernel (``repro_torch/csrc/segment_sum.cu``).

It replaces ``segment_sum_pallas`` (``repro/kernels/segment_sum/kernel.py``).
The wrapper checks device, type, shape and contiguity, allocates the
output, launches on PyTorch's current stream without synchronising, counts
the launch in ``segment_sum_cuda.launches`` and raises on a non-zero
``cudaError_t``. The library is built at the first call.

The kernel has no backward: on the training path K2 runs as ``_degrees``
(its input is built from the mask) and inside backward passes, where
nothing requires a gradient. Given a tensor that requires one, the wrapper
raises rather than return an output that would silently cut the graph.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

_SYMBOLS = {torch.float32: "segment_sum_f32",
            torch.bfloat16: "segment_sum_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]


def segment_sum_cuda(msg: torch.Tensor, groups: EdgeGroups) -> torch.Tensor:
    """msg: (E, F) f32 or bf16 on the card -> (num_groups, F) in msg's
    type, summed in fp32 over each group's live edges in ``groups``'
    order (groups keyed by destination in the forward, by source or
    destination inside backward passes)."""
    if not msg.is_cuda:
        raise ValueError(f"segment_sum_cuda needs a CUDA tensor, got "
                         f"{msg.device}")
    if msg.requires_grad:
        raise NotImplementedError(
            "segment_sum_cuda has no backward kernel: the backward of K2's "
            "general form is still to port (ROADMAP queue B)")
    if msg.dtype not in _SYMBOLS:
        raise TypeError(f"segment_sum_cuda takes float32 or bfloat16, got "
                        f"{msg.dtype}")
    if msg.dim() != 2 or not msg.is_contiguous():
        raise ValueError(f"msg must be a contiguous (E, F) tensor, got "
                         f"shape {tuple(msg.shape)}")
    if (groups.order.device != msg.device
            or groups.order.numel() != msg.shape[0]):
        raise ValueError("groups must be built on msg's device from its "
                         "E edges")
    e, f = msg.shape
    out = torch.empty((groups.num_groups, f), dtype=msg.dtype,
                      device=msg.device)
    fn = _cuda.symbol("segment_sum", _SYMBOLS[msg.dtype], _ARGTYPES)
    with torch.cuda.device(msg.device):
        err = fn(msg.data_ptr(), groups.order.data_ptr(),
                 groups.offsets.data_ptr(), out.data_ptr(),
                 groups.num_groups, f, _cuda.stream_ptr(msg.device))
    segment_sum_cuda.launches += 1
    _cuda.check(err, "segment_sum")
    return out


segment_sum_cuda.launches = 0
