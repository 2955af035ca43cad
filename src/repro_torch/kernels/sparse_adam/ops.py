"""Public op: row-sparse Adam (K5) with the ``impl=`` switch of
:mod:`repro_torch.kernels.impl`, the port of
``repro/kernels/sparse_adam/ops.py``.

The caller (``DistEmbedding.push_grad``) owns everything stateful: the
int64 step counters ``t`` (incremented here on the host; they never pass
through a device copy), the duplicate-id coalescing and the transport
accounting. These functions apply one already-coalesced update to one
shard's tables.

Bitwise contract (every route): the bytes of the NumPy expressions of
``repro/kernels/sparse_adam/ref.py``. The bias corrections ``1 - beta**t``
(``powf``) and the kernel's ``(1 - beta) * g`` terms are computed here in
NumPy for every route, never on the card.

:func:`sparse_adam_apply` updates tables that are tensors, on any device.
:func:`sparse_adam_staged` is the card's route for tables that live in
host memory, as the KVStore's do: it gathers the touched rows into one
pinned arena, copies it to the card once, runs K5 in place on the staged
rows (so the kernel sees rows ``0..R-1``), copies the updated rows back
once and scatters them into the host tables after the stream has
finished.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..impl import resolve_impl
from .kernel import sparse_adam_cuda
from .ref import sparse_adam_ref


def _step_counts(t: np.ndarray, rows: np.ndarray, beta1: float,
                 beta2: float):
    """Increment the rows' int64 counters in place (BEFORE the bias
    correction, as the oracle does) -> (bc1, bc2), each (R, 1) f32."""
    t[rows] += 1
    tr = t[rows].astype(np.float32)[:, None]
    return 1 - beta1 ** tr, 1 - beta2 ** tr


def _adam_terms(grad: np.ndarray, beta1: float, beta2: float,
                cm: np.ndarray, cv: np.ndarray) -> None:
    """The kernel's host terms into ``cm`` and ``cv``: the oracle's exact
    products ``(1 - beta1) * g`` and ``(1 - beta2) * g * g`` (the double
    ``1 - beta`` rounded to float32 against float32 ``g``, multiplied left
    to right)."""
    g = grad.astype(np.float32, copy=False)
    np.multiply(1 - beta1, g, out=cm)
    np.multiply(1 - beta2, g, out=cv)
    np.multiply(cv, g, out=cv)


def sparse_adam_apply(w: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                      rows: np.ndarray, grad: np.ndarray, t: np.ndarray, *,
                      beta1: float, beta2: float, lr: float, eps: float,
                      impl: str = "auto") -> None:
    """One shard's row-sparse Adam step, in place.

    w/m/v: (N, D) tensors on one device (mutated in place); rows: (R,)
    unique local row ids; grad: (R, D) f32 coalesced gradients; t: (N,)
    int64 host step counters (mutated in place). ``impl`` follows
    :func:`~repro_torch.kernels.impl.resolve_impl` on ``w``: K5 on a
    CUDA table (float32 only: another type raises), the plain version on
    a CPU table (any float type)."""
    rows = np.asarray(rows)
    bc1, bc2 = _step_counts(t, rows, beta1, beta2)
    dev = w.device
    if resolve_impl(impl, w) == "ref":
        sparse_adam_ref(w, m, v, torch.from_numpy(rows).to(dev),
                        torch.from_numpy(grad.astype(np.float32)).to(dev),
                        torch.from_numpy(bc1).to(dev),
                        torch.from_numpy(bc2).to(dev), beta1=beta1,
                        beta2=beta2, lr=lr, eps=eps)
        return
    if w.dtype != torch.float32:
        raise TypeError(f"sparse Adam on the card takes float32 tables, got "
                        f"{w.dtype}; the bitwise contract is defined for "
                        f"float32 only")
    cm = np.empty(grad.shape, np.float32)
    cv = np.empty(grad.shape, np.float32)
    _adam_terms(grad, beta1, beta2, cm, cv)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sparse_adam_cuda(w, m, v, put(rows.astype(np.int32)), put(cm), put(cv),
                     put(bc1[:, 0]), put(bc2[:, 0]), beta1=beta1,
                     beta2=beta2, lr=lr, eps=eps)


class StagingArena:
    """One reusable host buffer for :func:`sparse_adam_staged` (pinned
    where the update runs on the card). Pinning hundreds of MB takes
    longer than the copy it speeds up, so the buffer grows to 1.25x the
    largest update seen, and updates of about one size share it."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None

    def get(self, nwords: int, device: torch.device) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < nwords:
            self.buf = torch.empty(nwords + nwords // 4, dtype=torch.float32,
                                   pin_memory=device.type == "cuda")
        return self.buf[:nwords]


def sparse_adam_staged(w: np.ndarray, m: np.ndarray, v: np.ndarray,
                       rows: np.ndarray, grad: np.ndarray, t: np.ndarray, *,
                       device: torch.device, beta1: float, beta2: float,
                       lr: float, eps: float, arena: StagingArena,
                       impl: str = "auto",
                       spans: Optional[Dict[str, float]] = None) -> None:
    """One shard's row-sparse Adam step on host tables, run on
    ``device`` over staged copies of the touched rows.

    w/m/v: (N, D) float32 host arrays (the KVStore's local views, updated
    in place); rows, grad, t as in :func:`sparse_adam_apply`. The arena
    holds, as float32 words, the rows of w, m and v, cm, cv, bc1, bc2 and
    the staged row ids ``0..R-1`` (int32 bits): one copy to the device,
    K5 in place there, one copy of the updated (3, R, D) rows back into
    the arena, and a synchronisation of the stream before the NumPy
    scatter (a copy that has not finished would scatter stale bytes).
    ``spans`` (if given) accumulates seconds under ``stage``, ``apply``
    and ``unstage``, and on the card the device's ``device_h2d``,
    ``device_kernel`` and ``device_d2h`` from CUDA events."""
    if w.dtype != np.float32:
        raise TypeError(f"sparse Adam on the card takes float32 tables, got "
                        f"{w.dtype}")
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    rows = np.asarray(rows)
    r, d = len(rows), w.shape[1]
    bc1, bc2 = _step_counts(t, rows, beta1, beta2)
    rd = r * d
    host = arena.get(5 * rd + 3 * r, device)
    a = host.numpy()
    tabs = a[:3 * rd].reshape(3, r, d)
    np.take(w, rows, axis=0, out=tabs[0])
    np.take(m, rows, axis=0, out=tabs[1])
    np.take(v, rows, axis=0, out=tabs[2])
    _adam_terms(grad, beta1, beta2, a[3 * rd:4 * rd].reshape(r, d),
                a[4 * rd:5 * rd].reshape(r, d))
    a[5 * rd:5 * rd + r] = bc1[:, 0]
    a[5 * rd + r:5 * rd + 2 * r] = bc2[:, 0]
    a[5 * rd + 2 * r:].view(np.int32)[:] = np.arange(r, dtype=np.int32)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
        if on_card else None
    if on_card:
        events[0].record()
    dev = host.to(device, non_blocking=True)
    if on_card:
        events[1].record()
    t1 = time.perf_counter()
    dt = dev[:3 * rd].view(3, r, d)
    cm_d = dev[3 * rd:4 * rd].view(r, d)
    cv_d = dev[4 * rd:5 * rd].view(r, d)
    bc1_d = dev[5 * rd:5 * rd + r]
    bc2_d = dev[5 * rd + r:5 * rd + 2 * r]
    rows_d = dev[5 * rd + 2 * r:].view(torch.int32)
    if resolve_impl(impl, dev) == "ref":
        g_d = torch.from_numpy(grad.astype(np.float32)).to(device)
        sparse_adam_ref(dt[0], dt[1], dt[2], rows_d, g_d, bc1_d[:, None],
                        bc2_d[:, None], beta1=beta1, beta2=beta2, lr=lr,
                        eps=eps)
    else:
        sparse_adam_cuda(dt[0], dt[1], dt[2], rows_d, cm_d, cv_d, bc1_d,
                         bc2_d, beta1=beta1, beta2=beta2, lr=lr, eps=eps)
    if on_card:
        events[2].record()
    t2 = time.perf_counter()
    if dev.data_ptr() != host.data_ptr():
        host[:3 * rd].copy_(dev[:3 * rd], non_blocking=True)
    if on_card:
        events[3].record()
        events[3].synchronize()
    w[rows] = tabs[0]
    m[rows] = tabs[1]
    v[rows] = tabs[2]
    t3 = time.perf_counter()
    if spans is not None:
        spans["stage"] += t1 - t0
        spans["apply"] += t2 - t1
        spans["unstage"] += t3 - t2
        if on_card:
            for name, (e0, e1) in (("device_h2d", events[0:2]),
                                   ("device_kernel", events[1:3]),
                                   ("device_d2h", events[2:4])):
                spans[name] += e0.elapsed_time(e1) / 1e3
