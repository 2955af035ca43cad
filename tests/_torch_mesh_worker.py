"""Multi-rank and fake-world cases of the port's sharding, run as

    python tests/_torch_mesh_worker.py CASE DIR [WORLD]

by ``tests/test_torch_sharded_step.py`` and ``tests/test_torch_sharding.py``
in a subprocess of their own (the default process group is global to a
process). ``CASE`` names a function below; its inputs are ``DIR/in.npz``
and ``DIR/in.json``, and rank 0 writes ``DIR/out.npz``. A gloo world of
``WORLD`` CPU processes rendezvouses through a ``FileStore`` in ``DIR``;
every rank runs one intra-op thread. This module imports no JAX.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def _unflatten(flat: dict) -> dict:
    """{"a/b": array} -> nested dicts of tensors."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def _flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _mesh(shape=(2, 4)):
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.sharding.rules as R
    R.AXIS_SIZES.update({"data": shape[0], "model": shape[1]})
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _full(x) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def sharded_step(rank, world, d, meta, arrays):
    """One train step of ``meta["arch"]``'s smoke config on a (2, 4)
    mesh under ``meta["rules"]`` (tp or fsdp); rank 0 writes the loss,
    every gradient of ``loss_and_grads`` (taken first, on the same
    parameters), the step's gradient norm and every updated parameter,
    whole."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.lm import make_train_step
    from repro_torch.models.lm.steps import loss_and_grads
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import (distribute, param_pspecs,
                                            placements, set_rules, spec)

    mesh = _mesh()
    rules = rules_for(meta["rules"], False)
    set_rules(rules)
    cfg = dataclasses.replace(smoke_variant(get_config(meta["arch"])),
                              **meta["cfg"])
    params = _unflatten({k[2:]: v for k, v in arrays.items()
                         if k.startswith("p/")})
    tokens = torch.from_numpy(arrays["tokens"])
    params = distribute(params, param_pspecs(params, fsdp=cfg.fsdp,
                                             rules=rules), mesh)
    opt = adamw_init(params)
    batch = {"tokens": distribute_tensor(
        tokens, mesh, placements(spec(rules.batch_axes, None), mesh))}
    step = make_train_step(cfg, lr=meta["lr"])
    with use_mesh(mesh), implicit_replication():
        _, grads = loss_and_grads(cfg, params, batch)
        out = {f"g/{k}": _full(v).numpy()
               for k, v in _flatten(grads).items()}
        del grads
        params, opt, metrics = step(params, opt, batch)
    out.update({f"p/{k}": _full(v).numpy()
                for k, v in _flatten(params).items()})
    out["loss"] = _full(metrics["loss"]).numpy()
    out["grad_norm"] = _full(metrics["grad_norm"]).numpy()
    return out


def moe(rank, world, d, meta, arrays):
    """``moe_block`` on a (2, 4) mesh (tp rules, batch over data) for
    each case in ``meta["cases"]``; rank 0 writes each output, aux loss
    and gradient of (out^2).sum() + aux (x's and each weight's)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.lm.config import LMConfig
    from repro_torch.models.lm.moe import moe_block
    from repro_torch.sharding.rules import AxisRules, set_rules

    mesh = _mesh()
    set_rules(AxisRules(batch_axes=("data",), model_axis_size=4))
    out = {}
    for i, case in enumerate(meta["cases"]):
        cfg = LMConfig(name="t", arch_type="moe", num_layers=1, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=64,
                       num_experts=case["ne"], experts_per_tok=2,
                       moe_d_ff=16, dtype="float32",
                       moe_dispatch=case["dispatch"],
                       moe_capacity_factor=case["cf"])
        p = {k: arrays[f"{i}/{k}"] for k in ("router", "experts_gate",
                                               "experts_up", "experts_down")}
        p = {k: torch.from_numpy(v) for k, v in p.items()}
        rep = (Replicate(), Replicate())
        pd = {k: distribute_tensor(v, mesh, rep).requires_grad_()
              for k, v in p.items()}
        x = distribute_tensor(torch.from_numpy(arrays[f"{i}/x"]), mesh,
                              rep).requires_grad_()
        with use_mesh(mesh), implicit_replication():
            o, aux = moe_block(pd, x, cfg)
            ((o ** 2).sum() + aux).backward()
        out[f"{i}/out"] = _full(o).detach().numpy()
        out[f"{i}/aux"] = _full(aux).detach().numpy()
        out[f"{i}/g/x"] = _full(x.grad).numpy()
        out.update({f"{i}/g/{k}": _full(v.grad).numpy()
                    for k, v in pd.items()})
    return out


def sharded_serve(rank, world, d, meta, arrays):
    """For each case of ``meta["cases"]``, ``prefill`` of a one-row
    prompt and ``steps`` ``decode_step``s on a (2, 4) mesh under the tp
    rules, the parameters placed by ``param_pspecs`` and the cache by
    ``cache_pspecs`` (one row: the ring over "data"; KV heads that do not
    divide over "model": head_dim over it); rank 0 writes every step's
    logits and the last cache, whole."""
    import dataclasses

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models.lm import decode_step, prefill
    from repro_torch.sharding.rules import (distribute, param_pspecs,
                                            placements, set_rules,
                                            spec, spec_of)

    mesh = _mesh()
    rules = rules_for("tp", False)
    set_rules(rules)
    rep = placements(spec(None, None), mesh)
    out = {}
    for i, case in enumerate(meta["cases"]):
        cfg = dataclasses.replace(smoke_variant(get_config(case["arch"])),
                                  sliding_window=case["window"])
        params = _unflatten({k[len(f"{i}/p/"):]: v
                             for k, v in arrays.items()
                             if k.startswith(f"{i}/p/")})
        params = distribute(params, param_pspecs(params, rules=rules),
                            mesh)
        prompt = distribute_tensor(torch.from_numpy(arrays[f"{i}/prompt"]),
                                   mesh, rep)
        nxt = torch.from_numpy(arrays[f"{i}/next"])
        with use_mesh(mesh), implicit_replication():
            logits, cache = prefill(cfg, params, prompt, case["cache_len"])
            out[f"{i}/logits/0"] = _full(logits).numpy()
            out[f"{i}/specs"] = np.array(json.dumps(
                {k: spec_of(v) for k, v in cache.items() if k != "pos"}))
            for t in range(nxt.shape[1]):
                tok = distribute_tensor(nxt[:, t:t + 1].contiguous(), mesh,
                                        rep)
                logits, cache = decode_step(cfg, params, cache, tok)
                out[f"{i}/logits/{t + 1}"] = _full(logits).numpy()
        out.update({f"{i}/cache/{k}": _full(v).numpy()
                    for k, v in cache.items() if k != "pos"})
        out[f"{i}/pos"] = np.array(cache["pos"])
    return out


def placement(rank, world, d, meta, arrays):
    """Each rank's local shard of ``x`` placed by each spec of
    ``meta["specs"]`` on a (2, 4) mesh; rank 0 writes every rank's."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import placements, spec

    mesh = _mesh()
    out = {}
    for i, entries in enumerate(meta["specs"]):
        sp = spec(*[tuple(e) if isinstance(e, list) else e
                    for e in entries])
        x = distribute_tensor(torch.from_numpy(arrays["x"]), mesh,
                              placements(sp, mesh))
        gathered = [None] * world
        dist.all_gather_object(gathered, x.to_local().numpy())
        out.update({f"{i}/r{r}": a for r, a in enumerate(gathered)})
    return out


def fake_collectives(d):
    """On a fake world of 8 ranks under ``FakeTensorMode``, a program of
    known collectives traced by ``StepTrace``; writes its records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.launch.dryrun import StepTrace, collective_bytes
    from repro_torch.launch.mesh import fake_world

    with fake_world(8):
        group = dist.group.WORLD
        with FakeTensorMode():
            x = torch.empty((4, 8), dtype=torch.float32)
            y = torch.empty((8, 6), dtype=torch.bfloat16)
            trace = StepTrace()
            with trace:
                funcol.all_gather_tensor(x, 0, group)
                funcol.all_reduce(x, "sum", group)
                funcol.all_reduce(y, "max", group)
                funcol.reduce_scatter_tensor(
                    torch.empty((32, 8)), "sum", 0, group)
                funcol.all_to_all_single(y, None, None, group)
                z = x @ torch.empty((8, 3))
    with open(os.path.join(d, "out.json"), "w") as f:
        json.dump({"collectives": collective_bytes(trace),
                   "records": trace.records, "flops": trace.flops,
                   "z": list(z.shape)}, f)


def mini_dryrun(d):
    """``run_one`` for ``meta``'s cases on a fake (2, 4) world; writes
    each result."""
    import dataclasses

    import repro_torch.sharding.rules as R
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.gnn_dryrun import run

    with open(os.path.join(d, "in.json")) as f:
        meta = json.load(f)
    R.AXIS_SIZES.update({"data": 2, "model": 4})
    out = {}
    for case in meta["lm"]:
        cfg = dataclasses.replace(smoke_variant(get_config(case["arch"])),
                                  **case["cfg"])
        res = run_one(case["arch"], case["shape"], cfg=cfg,
                      mesh_shape=(2, 4), device="cpu",
                      parallel=case["parallel"])
        out[f"{case['arch']}|{case['shape']}|{case['parallel']}"] = \
            res.to_json()
    for arch in meta["gnn"]:
        out[f"gnn|{arch}"] = run(arch, trainers=8, device="cpu",
                                 mesh_shape=(2, 4))
    with open(os.path.join(d, "out.json"), "w") as f:
        json.dump(out, f)


def _worker(rank, world, d, case):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(d, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        with open(os.path.join(d, "in.json")) as f:
            meta = json.load(f)
        arrays = dict(np.load(os.path.join(d, "in.npz")))
        out = globals()[case](rank, world, d, meta, arrays)
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), **out)
    finally:
        dist.destroy_process_group()


def main():
    import logging
    import warnings
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    case, d = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    if case in ("fake_collectives", "mini_dryrun"):     # one process
        return globals()[case](d)
    world = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    torch.multiprocessing.spawn(_worker, args=(world, d, case),
                                nprocs=world, join=True)


if __name__ == "__main__":
    main()
