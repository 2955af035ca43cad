"""Dry-run of the paper's own GNN train step on the production mesh
(beyond the 40 LM pairs: it shows why DistDGLv2's contribution is on the
host); the port of ``repro.launch.gnn_dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.gnn_dryrun [--arch graphsage]

Each of the 256 ranks (512 with ``--multi-pod``) of a fake process group
holds one trainer's padded mini-batch (``capacities(batch_size,
fanouts)``) and the replicated parameters; the step takes the gradients
of its trainer's loss, all-reduces them (their mean, DistDGL's
synchronous SGD: explicit functional all-reduces of local tensors) and
applies AdamW. It runs under ``FakeTensorMode`` on rank 0 with
:class:`~repro_torch.launch.dryrun.StepTrace`; nothing runs, and no
ctypes kernel takes a fake tensor, so ``apply_gnn`` is traced with
``impl="ref"`` (the plain versions of K1-K4), passed in its config.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from ..configs import get_config
from ..core.sampler.mfg import capacities
from .dryrun import StepTrace, collective_bytes


def run(arch: str = "graphsage", trainers: int = 256,
        multi_pod: bool = False, device: str = "cuda",
        mesh_shape=None) -> dict:
    """Trace one synchronous step -> {"params", "collectives", "memory",
    "mesh"}; prints the reference's three lines."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from .mesh import fake_world

    cfg = dataclasses.replace(get_config(arch), impl="ref")
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    if math.prod(mesh_shape) != trainers:
        raise ValueError(f"{trainers} trainers on a {mesh_shape} mesh")
    names = ("pod", "data", "model")[-len(mesh_shape):]
    trace = StepTrace()
    with fake_world(trainers):
        mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=names)
        with FakeTensorMode():
            n_params = _trace(cfg, mesh, trace, device)
    coll = collective_bytes(trace)
    mem = trace.memory()
    tag = "x".join(str(n) for n in mesh_shape)
    print(f"{arch}: {n_params / 1e6:.2f}M params, {trainers} trainers on "
          f"{tag} (apply_gnn traced with impl='ref')")
    args = sum(v for k, v in mem.items()
               if k.endswith("_bytes") and k not in ("step_peak_bytes",
                                                      "peak_bytes"))
    print(f"  temp={mem['step_peak_bytes'] / 1e9:.2f}GB "
          f"args={args / 1e9:.2f}GB")
    print(f"  collectives={coll['total'] / 1e6:.2f}MB/step/device "
          f"(all-reduce={coll['all-reduce'] / 1e6:.2f}MB)")
    return {"params": n_params, "collectives": coll, "memory": mem,
            "mesh": tag}


def _trace(cfg, mesh, trace, device) -> int:
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from ..models.gnn import apply_gnn, init_gnn, nc_loss
    from ..optim import adamw_init, adamw_update
    from ..optim.optimizers import tree_leaves, tree_map

    caps = capacities(cfg.batch_size, cfg.fanouts)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    batch = dict(
        input_feats=empty((caps[0][0], cfg.in_dim), torch.float32),
        labels=empty((cfg.batch_size,), torch.int64),
        seed_mask=empty((cfg.batch_size,), torch.bool),
        blocks=[dict(edge_src=empty((ce,), torch.int32),
                     edge_dst=empty((ce,), torch.int32),
                     edge_mask=empty((ce,), torch.bool),
                     edge_types=empty((ce,), torch.int32))
                for _, ce in caps])
    trace.track(params, "params")
    trace.track((opt.mu, opt.nu), "opt_state")
    trace.track(batch, "inputs")
    world = mesh.size()
    with trace:
        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = nc_loss(apply_gnn(cfg, alias, batch), batch["labels"],
                       batch["seed_mask"])
        leaves = tree_leaves(alias)
        grads = torch.autograd.grad(loss, leaves)
        # the trainers' mean gradient: one all-reduce a leaf
        reduced = [funcol.all_reduce(g, "sum", dist.group.WORLD) / world
                   for g in grads]
        it = iter(reduced)
        adamw_update(params, tree_map(lambda _: next(it), params), opt,
                     lr=1e-3)
    return n_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="graphsage",
                    choices=["graphsage", "gat", "rgcn"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device")
    args = ap.parse_args(argv)
    run(args.arch, trainers=512 if args.multi_pod else 256,
        multi_pod=args.multi_pod, device=args.device)


if __name__ == "__main__":
    main()
