"""The ``impl=`` switch every kernel op takes.

==========  ===========  ================
``impl``    CUDA tensor  CPU tensor
==========  ===========  ================
``"auto"``  the kernel   the plain version
``"ref"``   plain        plain
``"cuda"``  the kernel   raises
==========  ===========  ================

There is no fallback: on a CUDA tensor ``"auto"`` launches the kernel, and
a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "ref", "cuda")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``"cuda"`` or ``"ref"`` for an op whose main input is ``x``."""
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
