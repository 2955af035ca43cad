"""Multi-pod dry-run: trace every (architecture × input shape × mesh)
step on the production mesh with no card and no memory, prove memory fit
and count the roofline terms; the port of ``repro.launch.dryrun``.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 pairs, 1-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b  # its 4 shapes

How: a fake process group of 256 (or 512) ranks, this process rank 0, and
``FakeTensorMode``: the parameters and AdamW moments are DTensors placed
by ``param_pspecs``, the batch and cache by ``batch_pspecs`` and
``cache_pspecs``, and the step is ``make_train_step`` /
``make_prefill_step`` / ``make_decode_step`` run once on them, every
kernel call on its plain version (``kernels.impl.plain_kernels``: no
kernel takes a fake tensor). Nothing is allocated and nothing is
computed. In place of the reference's HLO, :class:`StepTrace` (a
``TorchDispatchMode`` under DTensor, so it sees rank 0's local ops and
the collectives DTensor and the shard bodies call) counts:

* ``collectives``: the bytes of each collective's result, by kind, as the
  reference counts them (an all-gather the gathered size); Python loops
  are unrolled in the trace, so every layer counts;
* ``flops_per_device``: ``torch.utils.flop_counter``'s formulas (the
  matrix products, 2 a multiply-add) on the local shards, every layer,
  the remat forward as torch's checkpoint runs it (it stops before a
  block's last product, which nothing of the backward reads); an
  embedding lookup counts none. ``--save-trace`` writes them by op,
  beside the collectives;
* ``bytes_per_device``: the input plus output bytes of every ATen op
  (views excluded) on the local shards: an unfused upper bound;
* ``memory``: the live storages of rank 0 (parameters, optimizer state,
  inputs, and the peak of everything the step adds), held against the
  H100's 80 GB.

These are counts from a trace, not measurements. Results go to
``build/dryrun/dryrun_torch.json`` (resumable by key).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ARCH_IDS, get_config
from ..models.lm.config import LMConfig
from ..sharding.rules import (AXIS_SIZES, AxisRules, batch_pspecs,
                              cache_pspecs, distribute, param_pspecs, spec,
                              set_rules)
from .input_specs import SHAPES, effective_window, input_specs

RESULTS_PATH = os.path.join(os.path.dirname(__file__),
                            "../../../build/dryrun/dryrun_torch.json")
HBM_BYTES = 80e9             # one H100 SXM 80 GB

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# (namespace, op) -> kind: the functional collectives DTensor and
# repro_torch.sharding.collectives call, and the c10d ones
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


@contextlib.contextmanager
def _propagation_flag(trace):
    """Raise ``trace._propagating`` while DTensor runs an op on global-shape
    stand-ins to learn its output's metadata (``ShardingPropagator``'s
    ``_propagate_tensor_meta_non_cached``): no rank runs that op, so the
    trace does not count it. A torch without that method raises here,
    not silently counts every op twice."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(ShardingPropagator, name, None)
    if inner is None:
        raise RuntimeError(f"ShardingPropagator has no {name}: StepTrace "
                           f"cannot tell DTensor's metadata runs from "
                           f"rank 0's ops on this torch")

    @functools.wraps(inner)
    def flagged(self, *args, **kwargs):
        trace._propagating += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            trace._propagating -= 1
    setattr(ShardingPropagator, name, flagged)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Counts what rank 0 runs under it: collectives (kind and result
    bytes), FLOPs, op bytes, and the live bytes of its storages. It
    returns ``NotImplemented`` on a DTensor op, so it sees the local ops
    and collectives that DTensor dispatches to, not the global op."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.flops = 0
        self.flops_by_op: collections.Counter = collections.Counter()
        self._propagating = 0
        self._flag = None
        self.op_bytes = 0
        self.live = 0
        self.peak = 0
        self.by_category: dict = {}
        self._seen = WeakIdKeyDictionary()

    def _hold(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)
        return n

    def _free(self, n: int):
        self.live -= n

    def track(self, tree, category: str):
        """Count the storages of ``tree``'s tensors (their local shards)
        as live, under ``category``."""
        from torch.distributed.tensor import DTensor
        total = 0
        for t in _tensors(tree):
            total += self._hold(t.to_local() if isinstance(t, DTensor)
                                else t)
        self.by_category[category] = (self.by_category.get(category, 0)
                                      + total)

    def __enter__(self):
        self._flag = _propagation_flag(self)
        self._flag.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._flag.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (isinstance(func, torch._ops.HigherOrderOperator)
                or self._propagating):
            return out
        ns = func.namespace
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        if ns in _COLLECTIVE_NS and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            res = outs if ns != "c10d" else _tensors(args)[:1]
            self.records.append({"kind": kind, "op": f"{ns}.{name}",
                                 "bytes": sum(_nbytes(t) for t in res),
                                 "shapes": [list(t.shape) for t in res],
                                 "dtype": str(res[0].dtype) if res
                                 else ""})
        else:
            from torch.utils.flop_counter import flop_registry
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                n = fn(*args, **kwargs, out_val=out)
                self.flops += n
                self.flops_by_op[name] += n
            if not func.is_view:
                self.op_bytes += sum(_nbytes(t) for t in
                                     _tensors((args, kwargs)) + outs)
        for t in outs:
            self._hold(t)
        return out

    def memory(self) -> dict:
        base = sum(self.by_category.values())
        d = {f"{k}_bytes": int(v) for k, v in self.by_category.items()}
        d["step_peak_bytes"] = int(self.peak - base)
        d["peak_bytes"] = int(self.peak)
        d["fits_80gb"] = bool(self.peak <= HBM_BYTES)
        return d


def collective_bytes(trace) -> dict:
    """Per-device result bytes of every collective in ``trace`` (a
    :class:`StepTrace` or its ``records``), by kind, with ``count`` and
    ``total``: the reference's keys."""
    records = getattr(trace, "records", trace)
    out = {k: 0 for k in KINDS}
    out["count"] = 0
    for r in records:
        out[r["kind"]] += r["bytes"]
        out["count"] += 1
    out["total"] = sum(out[k] for k in KINDS)
    return out


@dataclasses.dataclass
class DryRunResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=dict)
    error: str = ""

    def to_json(self):
        return dataclasses.asdict(self)


def rules_for(parallel: str, multi_pod: bool) -> AxisRules:
    """The reference's rules: ``tp`` (batch over data, heads/FFN over
    model, ``fsdp`` configs' other weight dim over data) or ``fsdp``
    (pure ZeRO-3: batch over every axis but pod's model, weights on one
    dim)."""
    msize = AXIS_SIZES["model"]
    if parallel == "fsdp":
        if multi_pod:
            return AxisRules(batch_axes=("pod", "data"), fsdp_axis=None,
                             seq_shard_activations=True, pure_fsdp=True,
                             fsdp_param_axes=("pod", "data", "model"),
                             model_axis_size=msize)
        return AxisRules(batch_axes=("data", "model"), fsdp_axis=None,
                         seq_shard_activations=False, pure_fsdp=True,
                         model_axis_size=msize)
    return AxisRules(batch_axes=("pod", "data") if multi_pod else ("data",),
                     fsdp_axis=("pod", "data") if multi_pod else "data",
                     model_axis_size=msize)


def trace_step(cfg: LMConfig, shape_name: str, rules: AxisRules,
               mesh_shape: tuple, *, device="cuda", microbatches: int = 1
               ) -> StepTrace:
    """Run ``shape_name``'s step of ``cfg`` once on a fake world of
    ``prod(mesh_shape)`` ranks under ``FakeTensorMode``, every kernel on
    its plain version, and return rank 0's :class:`StepTrace`."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..kernels.impl import plain_kernels
    from .mesh import fake_world

    names = ("pod", "data", "model")[-len(mesh_shape):]
    set_rules(rules)
    trace = StepTrace()
    with fake_world(math.prod(mesh_shape)), plain_kernels():
        mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=names)
        trace = _trace(cfg, shape_name, rules, mesh, trace, device,
                       microbatches)
    return trace


def _trace(cfg, shape_name, rules, mesh, trace, device, microbatches):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models.lm import (abstract_params, make_decode_step,
                             make_prefill_step, make_train_step)
    from ..optim import adamw_init
    from .mesh import use_mesh

    with FakeTensorMode():
        inputs = input_specs(cfg, shape_name, device)
        params = abstract_params(cfg, device)
        params = distribute(params, param_pspecs(params, fsdp=cfg.fsdp,
                                                 rules=rules), mesh)
        trace.track(params, "params")
        with use_mesh(mesh), implicit_replication():
            if inputs["kind"] == "train":
                # optimizer moments are placed like their parameters
                opt = adamw_init(params)
                trace.track((opt.mu, opt.nu), "opt_state")
                batch = distribute(inputs["batch"],
                                   batch_pspecs(inputs["batch"], rules),
                                   mesh)
                trace.track(batch, "inputs")
                step = make_train_step(cfg, microbatches=microbatches)
                with trace:
                    step(params, opt, batch)
            elif inputs["kind"] == "prefill":
                batch = distribute(inputs["batch"],
                                   batch_pspecs(inputs["batch"], rules),
                                   mesh)
                trace.track(batch, "inputs")
                step = make_prefill_step(cfg, inputs["cache_len"])
                with trace:
                    step(params, batch)
            else:
                b = SHAPES[shape_name]["batch"]
                cache = inputs["cache"]
                cspecs = cache_pspecs(cfg, cache, b, rules)
                cache = dict(distribute(
                    {k: v for k, v in cache.items() if k != "pos"},
                    {k: v for k, v in cspecs.items() if k != "pos"}, mesh),
                    pos=cache["pos"])
                tokens = distribute(
                    inputs["tokens"],
                    spec(rules.batch_axes if b > 1 else None, None), mesh)
                trace.track((cache, tokens), "inputs")
                step = make_decode_step(cfg)
                with trace:
                    step(params, cache, tokens)
    return trace


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            save_trace: str = "", window_override=None,
            parallel: str = "tp", microbatches: int = 1,
            extra_tag: str = "", device: str = "cuda",
            cfg: Optional[LMConfig] = None,
            mesh_shape: Optional[tuple] = None) -> DryRunResult:
    """One dry-run; ``cfg`` and ``mesh_shape`` replace the id's config and
    the production mesh (for tests: set ``AXIS_SIZES`` to match)."""
    t0 = time.time()
    rules = rules_for(parallel, multi_pod)
    if parallel == "fsdp":
        extra_tag = extra_tag or "+fsdp"
    cfg = cfg or get_config(arch)
    w = window_override if window_override is not None else \
        effective_window(cfg, shape_name)
    if w is not None:
        cfg = dataclasses.replace(cfg, sliding_window=w)
    mesh_shape = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    mesh_tag = "x".join(str(n) for n in mesh_shape) + extra_tag
    try:
        trace = trace_step(cfg, shape_name, rules, tuple(mesh_shape),
                           device=device, microbatches=microbatches)
        if save_trace:
            with open(save_trace, "w") as f:
                json.dump({"collectives": trace.records,
                           "flops_by_op": dict(trace.flops_by_op)}, f,
                          indent=0)
        res = DryRunResult(
            arch=arch, shape=shape_name, mesh=mesh_tag, ok=True,
            seconds=round(time.time() - t0, 1),
            flops_per_device=float(trace.flops),
            bytes_per_device=float(trace.op_bytes),
            collectives=collective_bytes(trace), memory=trace.memory())
    except Exception as e:   # noqa: BLE001 — report, don't crash the sweep
        res = DryRunResult(arch=arch, shape=shape_name, mesh=mesh_tag,
                           ok=False, seconds=round(time.time() - t0, 1),
                           error=f"{type(e).__name__}: {e}\n"
                                 f"{traceback.format_exc()[-1500:]}")
    return res


def load_results(path=RESULTS_PATH) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_result(res: DryRunResult, path=RESULTS_PATH):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    all_res = load_results(path)
    all_res[f"{res.arch}|{res.shape}|{res.mesh}"] = res.to_json()
    with open(path, "w") as f:
        json.dump(all_res, f, indent=1)


def summary(res: DryRunResult) -> str:
    """One line: ok, collective bytes by kind, FLOPs a device, peak GiB a
    rank against 80 GB, seconds."""
    if not res.ok:
        return (f"FAIL {res.arch}|{res.shape}|{res.mesh} in {res.seconds}s: "
                f"{res.error.splitlines()[0]}")
    c = res.collectives
    kinds = " ".join(f"{k}={c[k]:.4e}" for k in KINDS if c.get(k))
    peak = res.memory["peak_bytes"]
    return (f"ok {res.arch}|{res.shape}|{res.mesh} coll[{kinds}] "
            f"total={c['total']:.4e}B count={c['count']} "
            f"flops/dev={res.flops_per_device:.4e} "
            f"peak={peak / 2**30:.2f}GiB/rank "
            f"({'fits' if res.memory['fits_80gb'] else 'exceeds'} 80 GB) "
            f"in {res.seconds}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES),
                    help="default with --arch: all four")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-trace", default="",
                    help="write the step's collectives and its FLOPs by "
                         "op here (JSON)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device")
    ap.add_argument("--results", default=RESULTS_PATH)
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch (and --shape), or --all")

    pairs = [(a, s) for a in (ARCH_IDS if args.all else [args.arch])
             for s in (SHAPES if args.all or not args.shape
                       else [args.shape])]
    existing = load_results(args.results)
    todo = []
    for arch, shape in pairs:
        key = f"{arch}|{shape}|{'2x16x16' if args.multi_pod else '16x16'}"
        if not args.force and existing.get(key, {}).get("ok"):
            print(f"[skip cached] {key}")
            continue
        todo.append((arch, shape))
    if len(todo) > 1:
        results = _run_parallel(todo, args)
    else:
        results = []
        for arch, shape in todo:
            print(f"[dryrun] {arch}|{shape} ...", flush=True)
            res = run_one(arch, shape, multi_pod=args.multi_pod,
                          save_trace=args.save_trace, device=args.device)
            save_result(res, args.results)
            print("  " + summary(res), flush=True)
            results.append(res)
    return 1 if any(not r.ok for r in results) else 0


def _run_parallel(pairs: list, args) -> list:
    """Each pair in a process of its own (a fake world is global to its
    process), one fewer at once than the host has cores, each into a
    results file of its own, merged into ``args.results``."""
    import subprocess
    import tempfile

    jobs = max(1, (os.cpu_count() or 2) - 1)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        procs, pending = {}, list(pairs)
        while pending or procs:
            while pending and len(procs) < jobs:
                arch, shape = pending.pop(0)
                path = os.path.join(tmp, f"{arch}_{shape}.json")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--force",
                       "--device", args.device, "--results", path]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                with open(path + ".err", "w") as err:
                    procs[path] = subprocess.Popen(
                        cmd, stdout=subprocess.DEVNULL, stderr=err)
            time.sleep(0.5)
            for path, proc in list(procs.items()):
                if proc.poll() is None:
                    continue
                del procs[path]
                got = list(load_results(path).values())
                if not got:
                    with open(path + ".err") as err:
                        raise RuntimeError(f"{path}: no result\n"
                                           f"{err.read()[-2000:]}")
                res = DryRunResult(**got[0])
                save_result(res, args.results)
                print("  " + summary(res), flush=True)
                results.append(res)
    return results


if __name__ == "__main__":
    raise SystemExit(main())
