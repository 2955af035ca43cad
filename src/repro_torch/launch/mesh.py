"""Production mesh construction; the port of ``repro.launch.mesh``.

Single pod: (16, 16) = ("data", "model") — 256 ranks.
Multi-pod:  (2, 16, 16) = ("pod", "data", "model") — 512 ranks.

FUNCTIONS, not module-level constants: importing this module touches no
process-group state. A mesh needs a default process group of its size:
a real one (NCCL on the cards, gloo on the CPU), or :func:`fake_world`'s,
which allocates and communicates nothing (the dry-run's).
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# use_mesh(mesh): a context manager in which ``mesh`` is the active one
# for ``maybe_constrain`` and ``moe_block``
from ..sharding.rules import active_mesh as use_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type="cuda"):
    """(world, 1) ("data", "model") over the process group that exists."""
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n, 1),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0,
    for the block: collectives return at once and move nothing. Use it
    under ``FakeTensorMode`` (the shapes of a real mesh, no memory)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


__all__ = ["fake_world", "make_host_mesh", "make_production_mesh",
           "use_mesh"]
