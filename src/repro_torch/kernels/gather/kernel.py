"""Wrapper of K6's CUDA kernel (``repro_torch/csrc/gather_rows.cu``).

It replaces ``gather_rows_pallas`` (``repro/kernels/gather/kernel.py``).
The wrapper checks device, type, shape and contiguity, picks the widest
word (16, 8, 4 or 2 bytes) that divides a row and the alignment of both
tensors, allocates the output, launches on PyTorch's current stream
without synchronising, counts the launch in ``gather_rows_cuda.launches``
and raises on a non-zero ``cudaError_t``. The library is built at the
first call.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda

_DTYPES = (torch.float32, torch.bfloat16)
_SYMBOLS = {torch.int32: "gather_rows_i32", torch.int64: "gather_rows_i64"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
    ctypes.c_int, ctypes.c_void_p]


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (V, F) f32 or bf16 on the card; idx: (N,) int32 or int64 on
    the same card -> (N, F), ``out[i] = table[idx[i]]``. Every index must
    lie in ``[0, V)``: the kernel does not check them (out-of-range rows
    would be read from outside the table)."""
    if not table.is_cuda:
        raise ValueError(f"gather_rows_cuda needs a CUDA tensor, got "
                         f"{table.device}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"gather_rows_cuda takes float32 or bfloat16, got "
                        f"{table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (V, F) tensor, got "
                         f"shape {tuple(table.shape)}")
    if (idx.dtype not in _SYMBOLS or idx.dim() != 1
            or not idx.is_contiguous() or idx.device != table.device):
        raise ValueError("idx must be a contiguous (N,) int32 or int64 "
                         "tensor on table's device")
    n, f = idx.numel(), table.shape[1]
    out = torch.empty((n, f), dtype=table.dtype, device=table.device)
    row_bytes = f * table.element_size()
    vec = next(w for w in (16, 8, 4, 2)
               if row_bytes % w == 0 and table.data_ptr() % w == 0
               and out.data_ptr() % w == 0)
    fn = _cuda.symbol("gather_rows", _SYMBOLS[idx.dtype], _ARGTYPES)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                 row_bytes, vec, _cuda.stream_ptr(table.device))
    gather_rows_cuda.launches += 1
    _cuda.check(err, "gather_rows")
    return out


gather_rows_cuda.launches = 0
