"""Collectives over named mesh axes for code that runs on local shards
(:func:`~repro_torch.sharding.rules.local_call`, the port's
``shard_map``): the counterparts of ``jax.lax.psum``, ``pmax``,
``all_gather``, ``psum_scatter``, ``all_to_all`` and ``axis_index``.
The sum, gather, scatter and all-to-all carry gradients; ``pmax`` takes
none (its callers detach)."""
from __future__ import annotations

import torch
from torch.distributed import _functional_collectives as funcol


def _done(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _dims(mesh, axes) -> list:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [mesh.mesh_dim_names.index(a) for a in axes
            if mesh.size(mesh.mesh_dim_names.index(a)) > 1]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh[axis].get_local_rank()


def axis_size(mesh, axes) -> int:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = 1
    for a in axes:
        n *= mesh[a].size()
    return n


def _all_reduce(x, mesh, dims, op="sum"):
    for d in dims:
        x = _done(funcol.all_reduce(x, op, (mesh, d)))
    return x


class _PSum(torch.autograd.Function):
    """Sum over the ranks of ``dims``; its transpose is the same sum, as
    ``jax.lax.psum``'s (see ``rules.local_call``)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _all_reduce(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.dims), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    dims = _dims(mesh, axes)
    return _PSum.apply(x, mesh, dims) if dims else x


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _all_reduce(x, mesh, _dims(mesh, axes), "max")


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    if mesh[axis].size() == 1:
        return x
    out = funcol.all_gather_tensor_autograd(
        x, gather_dim=dim, group=(mesh, mesh.mesh_dim_names.index(axis)))
    return _done(out)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``."""
    if mesh[axis].size() == 1:
        return x
    out = funcol.reduce_scatter_tensor_autograd(
        x, "sum", scatter_dim=dim,
        group=(mesh, mesh.mesh_dim_names.index(axis)))
    return _done(out)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)`` for ``x`` of leading dim the axis' size: block ``j``
    goes to rank ``j``, and block ``i`` of the result came from rank
    ``i``."""
    if mesh[axis].size() == 1:
        return x
    out = funcol.all_to_all_single_autograd(
        x.contiguous(), None, None,
        group=(mesh, mesh.mesh_dim_names.index(axis)))
    return _done(out)
