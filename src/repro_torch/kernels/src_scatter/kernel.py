"""Wrapper of the source-keyed weighted gather-sum
(``repro_torch/csrc/src_scatter.cu``), the backward kernel of K1 and of
K3's projected-feature input.

The wrapper checks device, type, shape and contiguity, picks float4
columns where the widths and the alignment allow, allocates the output,
launches on PyTorch's current stream without synchronising, counts the
launch in ``src_scatter_cuda.launches`` and raises on a non-zero
``cudaError_t``. The library is built at the first call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p])


def src_scatter_cuda(grad: torch.Tensor, edge_dst: torch.Tensor,
                     groups: EdgeGroups,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """grad: (num_dst, F) f32 on the card; edge_dst: (E,) int32; groups:
    the edges grouped by source row (:func:`~..dst_groups.src_groups`);
    weights: (E, H) f32 with F = H * Dh, or None -> (num_groups, F):
    ``out[v] = sum over v's live edges, in order, of w[e] * grad[dst_e]``.
    ``edge_dst`` must index rows of ``grad`` (the sampler guarantees it)."""
    what = "src_scatter_cuda"
    tensors = {"grad": grad} if weights is None else {"grad": grad,
                                                      "weights": weights}
    _cuda.check_cuda_f32(what, **tensors)
    _cuda.check_index(what, grad.device, edge_dst=edge_dst,
                      order=groups.order)
    if grad.dim() != 2 or groups.order.numel() != edge_dst.numel():
        raise ValueError(f"{what}: grad must be (num_dst, F) and groups "
                         f"built from edge_dst's E edges")
    f = grad.shape[1]
    h, dh = 1, f
    if weights is not None:
        if weights.dim() != 2 or weights.shape[0] != edge_dst.numel():
            raise ValueError(f"{what}: weights must be (E, H)")
        h = weights.shape[1]
        if h == 0 or f % h:
            raise ValueError(f"{what}: F={f} is not a multiple of H={h}")
        dh = f // h
    out = torch.empty((groups.num_groups, f), dtype=torch.float32,
                      device=grad.device)
    vec4 = int(f % 4 == 0 and dh % 4 == 0 and _cuda.aligned16(grad, out))
    fn = _cuda.symbol("src_scatter", "src_scatter_f32", _ARGTYPES)
    with torch.cuda.device(grad.device):
        err = fn(grad.data_ptr(), edge_dst.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 groups.order.data_ptr(), groups.offsets.data_ptr(),
                 out.data_ptr(), groups.num_groups, f, h, dh, vec4,
                 _cuda.stream_ptr(grad.device))
    src_scatter_cuda.launches += 1
    _cuda.check(err, "src_scatter")
    return out


src_scatter_cuda.launches = 0
