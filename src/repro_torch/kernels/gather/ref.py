"""Plain PyTorch version of K6, the row gather. It mirrors
``repro/kernels/gather/ref.py``: the CPU path of the port and the oracle
the CUDA kernel is held against."""
from __future__ import annotations

import torch


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table: (V, F); idx: (N,) int -> (N, F)."""
    return table[idx.long()]
