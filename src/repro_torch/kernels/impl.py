"""The ``impl=`` switch every kernel op takes.

==========  ===========  ================
``impl``    CUDA tensor  CPU tensor
==========  ===========  ================
``"auto"``  the kernel   the plain version
``"ref"``   plain        plain
``"cuda"``  the kernel   raises
==========  ===========  ================

There is no fallback: on a CUDA tensor ``"auto"`` launches the kernel, and
a kernel that fails to build or launch raises. The one exception is set
by name: inside :func:`plain_kernels` (the dry-run's trace, whose fake
``cuda`` tensors no kernel can take) ``"auto"`` means ``"ref"``.
"""
from __future__ import annotations

import contextlib

import torch

IMPLS = ("auto", "ref", "cuda")
_AUTO = "auto"


@contextlib.contextmanager
def plain_kernels():
    """Inside the block, ``impl="auto"`` resolves to ``"ref"`` on every
    device: the plain versions, for a trace on fake tensors."""
    global _AUTO
    prev, _AUTO = _AUTO, "ref"
    try:
        yield
    finally:
        _AUTO = prev


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``"cuda"`` or ``"ref"`` for an op whose main input is ``x``."""
    if impl == "auto":
        impl = _AUTO
    if impl == "ref":
        return "ref"
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    if impl == "cuda":
        if not x.is_cuda:
            raise ValueError(f"impl='cuda' needs CUDA tensors, got a tensor "
                             f"on {x.device}")
        return "cuda"
    raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
