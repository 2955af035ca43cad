"""Plain PyTorch version of K5, row-sparse Adam. It mirrors
``repro/kernels/sparse_adam/ref.py`` expression for expression and works
in place: the CPU path of the port (on tables that are
``torch.from_numpy`` views of the KVStore's arrays, so it writes straight
into them) and the oracle the CUDA kernel is held against.

Every operation is one float32 operation rounded once, as NumPy's are, so
the result is bitwise equal to the reference's. Two of ATen's float32
operations are not correctly rounded, and the plain version avoids them:
it divides by tensors only (on the card ATen divides by a CPU scalar by
multiplying with its reciprocal), and it takes the square root in float64
and rounds that to float32 (ATen's vectorised float32 ``sqrt`` on the CPU
misses the correctly rounded result by one ulp for about 0.7% of inputs;
the square root of a float32 taken in float64 and rounded once is the
correctly rounded float32 one).
"""
from __future__ import annotations

import torch


def sparse_adam_ref(w: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    rows: torch.Tensor, grad: torch.Tensor,
                    bc1: torch.Tensor, bc2: torch.Tensor, *, beta1: float,
                    beta2: float, lr: float, eps: float) -> None:
    """In-place row-sparse Adam on full tables.

    w/m/v: (N, D) tables (mutated; m and v float32, w any float type);
    rows: (R,) unique row ids; grad: (R, D) f32 coalesced gradients;
    bc1/bc2: (R, 1) f32 bias corrections ``1 - beta**t`` for the rows'
    post-increment counts. All on one device.
    """
    rows = rows.long()
    g = grad
    m[rows] = beta1 * m[rows] + (1 - beta1) * g
    v[rows] = beta2 * v[rows] + (1 - beta2) * g * g
    mhat = m[rows] / bc1
    vhat = v[rows] / bc2
    w[rows] -= (lr * mhat / (torch.sqrt(vhat.double()).float() + eps)
                ).to(w.dtype)
