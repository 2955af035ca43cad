"""Wrapper of K2's CUDA kernel (``repro_torch/csrc/segment_sum.cu``).

It replaces ``segment_sum_pallas`` (``repro/kernels/segment_sum/kernel.py``).
The wrapper checks device, type, shape and contiguity, allocates the
output, launches on PyTorch's current stream without synchronising, counts
the launch in ``segment_sum_cuda.launches`` and raises on a non-zero
``cudaError_t``. The library is built at the first call.

The kernel's schedule is keyed on F alone (:func:`schedule`): up to
:data:`SMALL_F_MAX` features, lanes across edges (sub-warps of
:data:`SUB_WARP` lanes, each loading :data:`EDGE_LOADS` edges a batch);
wider rows, lanes across features with :func:`row_tiling`'s rows gathered
before the adds. Every group is still summed from 0, one edge at a time in
its stable order, so the output is bitwise the plain version's under
deterministic algorithms. The constants are the library's compile-time
ones; the wrapper checks that they agree.

The kernel has no backward: on the training path K2 runs as ``_degrees``
(its input is built from the mask) and inside backward passes, where
nothing requires a gradient. Given a tensor that requires one, the wrapper
raises rather than return an output that would silently cut the graph.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

# csrc/segment_sum.cu's design constants, in segment_sum_design's order:
# F at most SMALL_F_MAX takes lanes across edges; there a group has
# SUB_WARP lanes, each loading EDGE_LOADS edges a batch. Wider rows take
# lanes across features, each lane holding at most MAX_VECS_PER_LANE column
# vectors and GATHER_FLOATS floats of gathered rows before the adds.
SMALL_F_MAX = 8
SUB_WARP = 8
EDGE_LOADS = 4
GATHER_FLOATS = 64
MAX_VECS_PER_LANE = 8
DESIGN = (SMALL_F_MAX, SUB_WARP, EDGE_LOADS, GATHER_FLOATS,
          MAX_VECS_PER_LANE)

_SYMBOLS = {torch.float32: "segment_sum_f32",
            torch.bfloat16: "segment_sum_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]


def schedule(f: int) -> str:
    """The kernel's schedule for F features: ``"edges"`` (lanes across
    edges) or ``"rows"`` (lanes across features)."""
    return "edges" if f <= SMALL_F_MAX else "rows"


def row_tiling(cols: int, vec: int, gather_floats: int = GATHER_FLOATS,
               max_vecs: int = MAX_VECS_PER_LANE) -> tuple:
    """Lanes across features, for a row of ``cols`` column vectors of
    ``vec`` floats: (NV column vectors a lane, slabs of 32 * NV vectors,
    each a warp, U rows gathered before the adds). K1's forward tiles its
    rows the same way, with its own constants."""
    need = -(-cols // 32)
    nv = next(n for n in (1, 2, 4, 8) if need <= n or max_vecs <= n)
    return nv, -(-cols // (32 * nv)), min(32, max(1, gather_floats
                                                 // (nv * vec)))


@functools.lru_cache(maxsize=None)
def _library_design() -> tuple:
    fn = _cuda.symbol("segment_sum", "segment_sum_design", [ctypes.c_int])
    return tuple(fn(i) for i in range(len(DESIGN)))


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
    if _library_design() != DESIGN:
        raise RuntimeError(f"segment_sum.cu's design constants are "
                           f"{_library_design()}, the wrapper's {DESIGN}")
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
