"""Wrappers of K3's CUDA kernels
(``repro_torch/csrc/fused_edge_softmax_aggregate.cu``): the forward's
phase 2 (:func:`fused_edge_softmax_aggregate_cuda`, after K4's statistics)
and the backward into the scores
(:func:`fused_edge_softmax_aggregate_bwd_cuda`).

They replace ``fused_edge_softmax_aggregate_pallas``
(``repro/kernels/fused_edge_softmax_aggregate/kernel.py``). Each wrapper
checks device, type, shape and contiguity, picks float4 columns where the
head width and the alignment allow, allocates its output, launches on
PyTorch's current stream without synchronising, counts the launch in its
own ``launches`` and raises on a non-zero ``cudaError_t``. The library is
built at the first call.

The forward walks each destination's live edges once with the whole row
in a warp's lanes: lane k computes the alpha of edge k of a batch, U rows
are gathered before the adds, and every column is summed in the stable
order. The backward takes a warp a destination, or sub-warps of W lanes
an edge where the heads are narrow; each (edge, head) dot product is
reduced by the same butterfly either way. The library chooses each
launch's layout and :func:`launch_plan` reads its choice. The constants
are the library's compile-time ones; the wrappers check that they agree.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _cuda
from ..dst_groups import EdgeGroups

# csrc/fused_edge_softmax_aggregate.cu's design constants, in
# fused_edge_softmax_aggregate_design's order: floats of gathered rows a
# lane holds before the arithmetic; column vectors a lane holds of a row at
# most; the heads whose alphas a forward lane holds at once where H > 2,
# the most heads a backward slab holds and the most heads the backward
# takes; heads of at most SMALL_HEAD_VECS column vectors take sub-warps in
# the backward; resident blocks an SM the backward's warp kernel asks of
# the compiler (a register cap)
GATHER_FLOATS = 8
MAX_VECS_PER_LANE = 8
MAX_HEADS = 8
SMALL_HEAD_VECS = 8
BWD_MIN_BLOCKS = 8
DESIGN = (GATHER_FLOATS, MAX_VECS_PER_LANE, MAX_HEADS, SMALL_HEAD_VECS,
          BWD_MIN_BLOCKS)
# fused_edge_softmax_aggregate_plan's fields: the backward's sub-warp route
# (0 or 1); column vectors a lane of the row (forward) or of each head
# (backward); the heads whose alphas a forward lane holds at once, the
# heads of a backward slab, or H on the sub-warp route; blocks along y; U,
# the rows in flight a warp or sub-warp; a head's lanes on the sub-warp
# route, else 32
PLAN_FIELDS = ("subwarp", "vecs", "heads", "slabs", "rows", "lanes")


def launch_plan(backward: bool, h: int, dh: int, vec4: bool) -> dict:
    """The layout the library launches the forward or the backward with,
    for H heads of ``dh`` floats on float4 or scalar columns (the
    wrappers take float4 where ``dh % 4 == 0`` and the tensors are 16-byte
    aligned): {field: value} over :data:`PLAN_FIELDS`. Builds the library
    at the first call."""
    fn = _cuda.symbol("fused_edge_softmax_aggregate",
                      "fused_edge_softmax_aggregate_plan",
                      [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    plan = (ctypes.c_int * len(PLAN_FIELDS))()
    err = fn(int(backward), h, dh, int(vec4), plan)
    if err:
        raise ValueError(f"fused_edge_softmax_aggregate_plan refuses "
                         f"H={h}, Dh={dh} (backward={backward})")
    return dict(zip(PLAN_FIELDS, plan))


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p])


def _check_common(what: str, h_proj, scores, edge_src, groups) -> tuple:
    if h_proj.dim() != 3 or scores.dim() != 2:
        raise ValueError(f"{what}: h_proj must be (V, H, Dh) and scores "
                         f"(E, H)")
    _, h, dh = h_proj.shape
    e = scores.shape[0]
    if scores.shape[1] != h or edge_src.numel() != e \
            or groups.order.numel() != e:
        raise ValueError(f"{what}: scores {tuple(scores.shape)}, edge_src "
                         f"and groups must share E and h_proj's H={h}")
    _cuda.check_index(what, h_proj.device, edge_src=edge_src,
                      order=groups.order)
    return h, dh


@functools.lru_cache(maxsize=None)
def _library_design() -> tuple:
    fn = _cuda.symbol("fused_edge_softmax_aggregate",
                      "fused_edge_softmax_aggregate_design", [ctypes.c_int])
    return tuple(fn(i) for i in range(len(DESIGN)))


def _check_design() -> None:
    if _library_design() != DESIGN:
        raise RuntimeError(f"fused_edge_softmax_aggregate.cu's design "
                           f"constants are {_library_design()}, the "
                           f"wrapper's {DESIGN}")


def fused_edge_softmax_aggregate_cuda(h_proj: torch.Tensor,
                                      scores: torch.Tensor,
                                      edge_src: torch.Tensor,
                                      groups: EdgeGroups, m: torch.Tensor,
                                      z: torch.Tensor) -> torch.Tensor:
    """h_proj: (V, H, Dh); scores: (E, H); edge_src: (E,) int32; groups:
    the destination groups; (m, z): K4's statistics of ``scores`` over
    ``groups`` -> (num_dst, H*Dh) f32, every destination's live source rows
    weighted by their softmax attention and summed in ``groups``' order."""
    what = "fused_edge_softmax_aggregate_cuda"
    _cuda.check_cuda_f32(what, h_proj=h_proj, scores=scores, m=m, z=z)
    h, dh = _check_common(what, h_proj, scores, edge_src, groups)
    if m.shape != (groups.num_groups, h) or z.shape != m.shape:
        raise ValueError(f"{what}: m and z must be (num_dst, H)")
    _check_design()
    out = torch.empty((groups.num_groups, h * dh), dtype=torch.float32,
                      device=h_proj.device)
    vec4 = int(dh % 4 == 0 and _cuda.aligned16(h_proj, out))
    fn = _cuda.symbol("fused_edge_softmax_aggregate",
                      "fused_edge_softmax_aggregate_f32", _ARGTYPES)
    with torch.cuda.device(h_proj.device):
        err = fn(h_proj.data_ptr(), scores.data_ptr(), edge_src.data_ptr(),
                 groups.order.data_ptr(), groups.offsets.data_ptr(),
                 m.data_ptr(), z.data_ptr(), out.data_ptr(),
                 groups.num_groups, h, dh, vec4,
                 _cuda.stream_ptr(h_proj.device))
    fused_edge_softmax_aggregate_cuda.launches += 1
    _cuda.check(err, "fused_edge_softmax_aggregate")
    return out


def fused_edge_softmax_aggregate_bwd_cuda(grad: torch.Tensor,
                                          h_proj: torch.Tensor,
                                          out: torch.Tensor,
                                          alpha: torch.Tensor,
                                          edge_src: torch.Tensor,
                                          groups: EdgeGroups) -> torch.Tensor:
    """The gradient into the scores. grad, out: (num_dst, H*Dh) (the
    output's gradient and the forward's output); h_proj: (V, H, Dh);
    alpha: (E, H) from K4's normalize kernel -> (E, H) f32,
    ``alpha * (<grad[dst], h_proj[src]> - <grad[dst], out[dst]>)`` per
    head on live edges and 0 on padded ones."""
    what = "fused_edge_softmax_aggregate_bwd_cuda"
    _cuda.check_cuda_f32(what, grad=grad, h_proj=h_proj, out=out,
                         alpha=alpha)
    h, dh = _check_common(what, h_proj, alpha, edge_src, groups)
    if h > MAX_HEADS:
        raise ValueError(f"{what} takes at most {MAX_HEADS} heads, got {h}")
    if grad.shape != (groups.num_groups, h * dh) or out.shape != grad.shape:
        raise ValueError(f"{what}: grad and out must be (num_dst, H*Dh)")
    _check_design()
    dscores = torch.zeros_like(alpha)
    vec4 = int(dh % 4 == 0 and _cuda.aligned16(grad, h_proj, out))
    fn = _cuda.symbol("fused_edge_softmax_aggregate",
                      "fused_edge_softmax_aggregate_bwd_f32", _ARGTYPES)
    with torch.cuda.device(h_proj.device):
        err = fn(grad.data_ptr(), h_proj.data_ptr(), out.data_ptr(),
                 alpha.data_ptr(), edge_src.data_ptr(),
                 groups.order.data_ptr(), groups.offsets.data_ptr(),
                 dscores.data_ptr(), groups.num_groups, h, dh, vec4,
                 _cuda.stream_ptr(h_proj.device))
    fused_edge_softmax_aggregate_bwd_cuda.launches += 1
    _cuda.check(err, "fused_edge_softmax_aggregate_bwd")
    return dscores


fused_edge_softmax_aggregate_cuda.launches = 0
fused_edge_softmax_aggregate_bwd_cuda.launches = 0
