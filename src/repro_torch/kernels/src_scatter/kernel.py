"""Wrapper of the source-keyed weighted gather-sum
(``repro_torch/csrc/src_scatter.cu``), the backward kernel of K1 and of
K3's projected-feature input.

The kernel splits the live edges of the source-grouped order into chunks
of :data:`CHUNK` positions, one warp a chunk, so a source row with
hundreds of edges no longer sets the pace of one warp's gathers. A row
that crosses chunk boundaries is carried from chunk to chunk in chunk
order, so every row is summed in the plain version's order and rounding:
the result is bitwise that of :func:`~.ref.src_scatter_ref` computed with
deterministic algorithms. Warps of the same launch write the zeros of
rows with no live edge. A call counts as one launch.

The wrapper checks device, type, shape and contiguity, picks float4
columns where the widths and the alignment allow, allocates the output,
launches on PyTorch's current stream without synchronising, counts the
call in ``src_scatter_cuda.launches`` and raises on a non-zero
``cudaError_t``. The kernel's scratch (a carry row a chunk, every float
the unset mark, and a ticket counter a column slab) is kept per device
and stream and grown when a call needs more: every launch leaves it as
it found it, so no call allocates or clears scratch. The library is built
at the first call.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

# live positions per chunk: the kernel's compile-time kChunk, checked
# against the library
CHUNK = 32

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 3
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _library_chunk() -> int:
    return _cuda.symbol("src_scatter", "src_scatter_chunk", [])()


# (device index, stream) -> (carry, tickets), a cache like the caching
# allocator's: one stream at a time uses a scratch, and the launches of one
# stream run one after another
_scratch: Dict[tuple, tuple] = {}
_scratch_lock = threading.Lock()


def _scratch_for(device: torch.device, stream: int, floats: int,
                 slabs: int) -> tuple:
    """The stream's scratch, grown to ``floats`` carry floats (set to the
    unset mark, the NaN 0xffffffff) and ``slabs`` zeroed ticket counters."""
    key = (device.index, stream)
    with _scratch_lock:
        carry, tickets = _scratch.get(key, (None, None))
        if carry is None or carry.numel() < floats:
            n = max(floats, 2 * (0 if carry is None else carry.numel()),
                    1024)
            carry = torch.full((n,), -1, dtype=torch.int32,
                               device=device).view(torch.float32)
        if tickets is None or tickets.numel() < slabs:
            tickets = torch.zeros(max(slabs, 64), dtype=torch.int32,
                                  device=device)
        _scratch[key] = carry, tickets
    return carry, tickets


def src_scatter_cuda(grad: torch.Tensor, edge_dst: torch.Tensor,
                     groups: EdgeGroups,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """grad: (num_dst, F) f32 on the card; edge_dst: (E,) int32; groups:
    the edges grouped by source row (:func:`~..dst_groups.src_groups`);
    weights: (E, H) f32 with F = H * Dh, or None -> (num_groups, F):
    ``out[v] = sum over v's live edges, in order, of w[e] * grad[dst_e]``,
    each product rounded before it is added. ``edge_dst`` must index rows
    of ``grad`` (the sampler guarantees it)."""
    what = "src_scatter_cuda"
    tensors = {"grad": grad} if weights is None else {"grad": grad,
                                                      "weights": weights}
    _cuda.check_cuda_f32(what, **tensors)
    _cuda.check_index(what, grad.device, edge_dst=edge_dst,
                      order=groups.order, keys=groups.keys,
                      offsets=groups.offsets)
    e = edge_dst.numel()
    if (grad.dim() != 2 or groups.order.numel() != e
            or groups.keys.numel() != e):
        raise ValueError(f"{what}: grad must be (num_dst, F) and groups "
                         f"built from edge_dst's E edges")
    f = grad.shape[1]
    h, dh = 1, f
    if weights is not None:
        if weights.dim() != 2 or weights.shape[0] != e:
            raise ValueError(f"{what}: weights must be (E, H)")
        h = weights.shape[1]
        if h == 0 or f % h:
            raise ValueError(f"{what}: F={f} is not a multiple of H={h}")
        dh = f // h
    out = torch.empty((groups.num_groups, f), dtype=torch.float32,
                      device=grad.device)
    if _library_chunk() != CHUNK:
        raise RuntimeError(f"src_scatter.cu's kChunk is {_library_chunk()},"
                           f" the wrapper's CHUNK {CHUNK}")
    vec4 = int(f % 4 == 0 and dh % 4 == 0 and _cuda.aligned16(grad, out))
    stream = _cuda.stream_ptr(grad.device)
    # a carry row a chunk, a ticket counter a slab of 32 column vectors
    carry, tickets = _scratch_for(grad.device, stream, -(-e // CHUNK) * f,
                                  -(-(f // 4 if vec4 else f) // 32))
    fn = _cuda.symbol("src_scatter", "src_scatter_f32", _ARGTYPES)
    with torch.cuda.device(grad.device):
        err = fn(grad.data_ptr(), edge_dst.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 groups.order.data_ptr(), groups.keys.data_ptr(),
                 groups.offsets.data_ptr(), out.data_ptr(), carry.data_ptr(),
                 tickets.data_ptr(), groups.num_groups, e, f, h, dh, vec4,
                 stream)
    src_scatter_cuda.launches += 1
    _cuda.check(err, "src_scatter")
    return out


src_scatter_cuda.launches = 0
