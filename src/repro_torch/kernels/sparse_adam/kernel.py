"""Wrapper of K5's CUDA kernel (``repro_torch/csrc/sparse_adam.cu``).

It replaces ``sparse_adam_pallas`` (``repro/kernels/sparse_adam/kernel.py``)
with one kernel: the TPU's two programs existed only to keep XLA from
contracting a multiply and an add, and the CUDA source says so itself with
correctly rounded intrinsics. The wrapper checks device, type, shape and
contiguity, launches on PyTorch's current stream without synchronising,
counts the launch in ``sparse_adam_cuda.launches`` and raises on a
non-zero ``cudaError_t``. The library is built at the first call.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 + [
    ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p]


def sparse_adam_cuda(w: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     rows: torch.Tensor, cm: torch.Tensor, cv: torch.Tensor,
                     bc1: torch.Tensor, bc2: torch.Tensor, *, beta1: float,
                     beta2: float, lr: float, eps: float) -> None:
    """In-place row-sparse Adam on full tables; only ``rows`` change.

    w/m/v: (N, D) f32 on the card (updated in place); rows: (R,) int32
    row ids, which must be UNIQUE (the caller coalesces duplicates, as
    ``DistEmbedding.push_grad`` does; a repeated row would be updated by
    two warps at once) and in range; cm/cv: (R, D) f32, the host's
    ``(1 - beta1) * g`` and ``(1 - beta2) * g * g``; bc1/bc2: (R,) f32,
    each row's bias corrections ``1 - beta ** t``. The result is bitwise
    equal to the float32 NumPy update. ``beta1``, ``beta2``, ``lr`` and
    ``eps`` are rounded to float32, as NumPy rounds them against float32
    arrays."""
    _cuda.check_cuda_f32("sparse_adam_cuda", w=w, m=m, v=v, cm=cm, cv=cv,
                         bc1=bc1, bc2=bc2)
    if w.dim() != 2 or m.shape != w.shape or v.shape != w.shape:
        raise ValueError(f"w, m, v must be (N, D) tensors of one shape, got "
                         f"{tuple(w.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    _cuda.check_index("sparse_adam_cuda", w.device, rows=rows)
    r, d = rows.numel(), w.shape[1]
    if cm.shape != (r, d) or cv.shape != (r, d):
        raise ValueError(f"cm and cv must be (R, D) = ({r}, {d}), got "
                         f"{tuple(cm.shape)}, {tuple(cv.shape)}")
    if bc1.shape != (r,) or bc2.shape != (r,):
        raise ValueError(f"bc1 and bc2 must be (R,) = ({r},), got "
                         f"{tuple(bc1.shape)}, {tuple(bc2.shape)}")
    vec4 = int(d % 4 == 0 and _cuda.aligned16(w, m, v, cm, cv))
    fn = _cuda.symbol("sparse_adam", "sparse_adam_f32", _ARGTYPES)
    hyper = [float(np.float32(x)) for x in (beta1, beta2, lr, eps)]
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), m.data_ptr(), v.data_ptr(), rows.data_ptr(),
                 cm.data_ptr(), cv.data_ptr(), bc1.data_ptr(),
                 bc2.data_ptr(), r, d, *hyper, vec4,
                 _cuda.stream_ptr(w.device))
    sparse_adam_cuda.launches += 1
    _cuda.check(err, "sparse_adam")


sparse_adam_cuda.launches = 0
