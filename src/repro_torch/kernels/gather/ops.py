"""Public op: row gather (K6) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`: the CUDA kernel on a CUDA table, the
plain version on a CPU table."""
from __future__ import annotations

import torch

from ..impl import resolve_impl
from .kernel import gather_rows_cuda
from .ref import gather_rows_ref


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """table: (V, F); idx: (N,) int32 or int64 in ``[0, V)`` -> (N, F)."""
    if resolve_impl(impl, table) == "ref":
        return gather_rows_ref(table, idx)
    return gather_rows_cuda(table, idx)
