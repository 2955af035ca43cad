"""One run of one benchmark cell, driven by the files the manifest names.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration's file lies under ``gnnbench/configs/``, the traffic's under
``gnnbench/traffic/<traffic>.json``, each cell's correctness limits under
``gnnbench/limits/<cell>.json``, each metric's reader under
``gnnbench/metrics/<metric>.py``, the configuration's architecture under
``gnnbench/archs/<model.arch>.py`` and its graph under
``gnnbench/graphs/<data.generator>.py``. A later cell, traffic mix,
metric, architecture or kind of graph is new files and a manifest entry;
nothing here names one.

A run: make the inputs from the seed (the graph's plug-in draws the
graph, ``inputs`` the weights); build the program's trainer
(``repro_torch.api.DistGNNTrainer`` with ``TrainJobConfig``) on them with
the benchmark's weights; drive its ``train_epoch`` from epoch 0 until its
first ``CHECKED_STEPS`` steps are observed (every shape of the cell's
traffic, and the kernels' first build and load), then restart its
loaders' pipelines and run one more epoch; then, timed, drive ``train_epoch`` epoch after epoch until
``seconds`` have passed, ending at the end of that epoch; then read the
metrics, free the program's state and check its first steps against the
reference (``gnnbench/reference``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import counts, inputs, trace
from .reference import check

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "gnnbench"
MANIFEST = ROOT / "BENCHMARK.json"
# the steps the reference follows
CHECKED_STEPS = 3
# names whose presence in the measuring process is refused (compared as
# whole top-level module names)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file
    traffic: dict          # the traffic file
    limits: dict           # {number: limit}
    end_to_end: list       # manifest entries that this cell reports
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def batch_size(self) -> int:
        return int(self.traffic["seeds_per_trainer"])

    @property
    def arch(self):
        """The architecture's plug-in, ``archs/<model.arch>.py``."""
        return plugin("archs", self.model["arch"])

    @property
    def graph(self):
        """The graph's plug-in, ``graphs/<data.generator>.py``."""
        return plugin("graphs", self.config["data"]["generator"])

    @property
    def trainers(self) -> int:
        j = self.config["job"]
        return int(j["num_machines"]) * int(j["trainers_per_machine"])


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    m = manifest if manifest is not None else _read_json(MANIFEST)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in m["configs"]}[w["config"]]
    reported = [e for e in m["end_to_end"]
                if name in e.get("workloads", cells)]
    moves = {e["name"] for e in reported}
    layered = [p for p in m["per_layer"]
               if (name in p["workloads"] if "workloads" in p
                   else p["moves"] in moves)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_read_json(ROOT / cfg["file"]),
                traffic=_read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(BENCH / "limits" / f"{name}.json")["limits"],
                end_to_end=reported, per_layer=layered)


def plugin(kind: str, name: str):
    """The module ``gnnbench/<kind>/<name>.py``, loaded once a file (its
    relative imports reach the rest of ``gnnbench``)."""
    path = BENCH / kind / f"{name}.py"
    key = f"gnnbench.{kind}.{name.replace('.', '_')}"
    mod = sys.modules.get(key)
    if mod is not None and Path(mod.__file__) == path:
        return mod
    if not path.is_file():
        raise SystemExit(f"no {kind} plug-in {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod      # a dataclass in it looks its module up
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(window)`` function of ``gnnbench/metrics/<metric>.py``."""
    return plugin("metrics", metric).read


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

def build_trainer(cell: Cell, data, seed: int, params, device):
    """The program's trainer on the benchmark's data and weights."""
    import repro_torch.graph as port_graph
    from repro_torch.api import DistGNNTrainer, TrainJobConfig
    from repro_torch.models.gnn import GNNConfig

    ds = cell.graph.dataset(data, cell.config["name"], port_graph)
    model_cfg = GNNConfig(**cell.arch.port_config(cell.model,
                                                  cell.batch_size))
    j = cell.config["job"]
    job = TrainJobConfig(
        num_machines=int(j["num_machines"]),
        trainers_per_machine=int(j["trainers_per_machine"]),
        partition_method=j["partition_method"],
        use_level2=bool(j["use_level2"]), sync=bool(j["sync"]),
        non_stop=bool(j["non_stop"]), lr=float(cell.config["optimizer"]["lr"]),
        sample_workers=int(j["sample_workers"]),
        packed_staging=bool(j["packed_staging"]),
        seed=inputs.seed31(seed, inputs.JOB))
    return DistGNNTrainer(ds, model_cfg, job, device=device, params=params)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def _numpy(t):
    return t.detach().to("cpu", copy=True).numpy()


class FirstSteps:
    """Observes the trainer's first ``n`` steps through its own
    ``train_epoch``: after each, the stacked batch as staged (every block
    array, and the feature rows up to the last one a live edge or seed
    uses); after step 1, AdamW's first moment and the parameters; after
    step ``n``, the parameters. It stands in for ``train_step`` on the instance, calls the
    class's, and is removed before the window."""

    def __init__(self, tr, n: int):
        self.tr, self.n = tr, n
        self.epoch = 0
        self.steps, self.moment1, self.params_end = [], None, None
        self.params1 = None
        tr.train_step = self

    def __call__(self, stacked):
        out = type(self.tr).train_step(self.tr, stacked)
        k = self.tr.global_step
        if k <= self.n:
            self.steps.append(self._capture(stacked))
        if k == 1:
            self.moment1 = _host(self.tr.opt.mu)
            self.params1 = _host(self.tr.params)
        if k == self.n:
            self.params_end = _host(self.tr.params)
        return out

    def _capture(self, stacked) -> dict:
        blocks = [{k: _numpy(v) for k, v in b.items() if torch.is_tensor(v)}
                  for b in stacked["blocks"]]
        seed_mask = _numpy(stacked["seed_mask"])
        feats = []
        for s in range(seed_mask.shape[0]):
            top = int(seed_mask[s].sum())
            for b in blocks:
                m = b["edge_mask"][s].astype(bool)
                if m.any():
                    top = max(top, int(b["edge_src"][s][m].max()) + 1,
                              int(b["edge_dst"][s][m].max()) + 1)
            feats.append(_numpy(stacked["input_feats"][s, :top]))
        return {"epoch": self.epoch, "seed_mask": seed_mask,
                "labels": _numpy(stacked["labels"]),
                "blocks": blocks, "feats": feats,
                "shapes": {"input_feats": tuple(stacked["input_feats"].shape),
                           "edges": [tuple(b["edge_mask"].shape)
                                     for b in blocks]}}

    def close(self) -> None:
        del self.tr.train_step


@dataclasses.dataclass
class Setup:
    tr: object
    data: object            # what the graph's plug-in made
    params0: dict           # the initial weights, on the host
    first: FirstSteps
    losses: list            # the program's loss of every warm-up step
    next_epoch: int


def setup(cell: Cell, seed: int, device, log=print,
          steady: bool = True) -> Setup:
    """Inputs, trainer and warm-up: epochs from 0 until the first
    ``CHECKED_STEPS`` steps have been observed; then, with ``steady``, the
    loaders' pipelines stopped and one more epoch run from fresh ones.
    While the first, slower epochs run (the first batches, the kernels'
    load), the loaders fill their queues several batches deep, and a
    window that started on those queues would measure them; after the
    restart the queues hold what the steady state leaves in them."""
    t = time.perf_counter()
    data = cell.graph.make(cell.config["data"], seed)
    log("[setup] data: " + ", ".join(
        f"{k} {v.shape}" for k, v in vars(data).items()
        if isinstance(v, np.ndarray))
        + f" ({time.perf_counter() - t:.2f} s)")
    params = inputs.make_weights(cell.arch, cell.model, seed, device)
    params0 = _host(params)
    t = time.perf_counter()
    tr = build_trainer(cell, data, seed, params, device)
    log(f"[setup] trainer: {tr.num_trainers} trainers, "
        f"{tr.batches_per_epoch} steps an epoch, partitioned in "
        f"{tr.partition_time_s:.2f} s ({time.perf_counter() - t:.2f} s)")
    first = FirstSteps(tr, CHECKED_STEPS)
    losses, epoch = [], 0

    def one_epoch(what):
        nonlocal epoch
        t = time.perf_counter()
        m = tr.train_epoch(epoch)
        log(f"[setup] {what} epoch {epoch}: {m['batches']} steps in "
            f"{time.perf_counter() - t:.2f} s")
        epoch += 1
        return m["losses"]
    try:
        while tr.global_step < CHECKED_STEPS:
            first.epoch = epoch
            losses += one_epoch("checked")
    finally:
        first.close()
    if steady:
        t = time.perf_counter()
        tr.stop()
        log(f"[setup] loaders stopped ({time.perf_counter() - t:.2f} s)")
        one_epoch("steady")
    return Setup(tr, data, params0, first, losses, epoch)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What the metric readers read (``gnnbench/metrics``)."""
    steps: int
    seconds: float
    seeds: int
    setup_s: float
    spans: dict             # the trainer's span totals over the window, s
    sample_busy_s: float    # the loaders' sample stage, summed
    flops_per_step: int
    peak: Optional[dict]    # the device's peaks (counts/peaks.json)
    trace: Optional[trace.Summary] = None
    kernel_least_s: Optional[dict] = None   # per step, from the check


def _sample_busy(tr) -> float:
    return sum(p.stats_report().get("sample", {}).get("busy_s", 0.0)
               for p in tr.pipelines)


def window(cell: Cell, st: Setup, seconds: float, traced: bool, t_start,
           device_kind: str, log=print) -> Window:
    tr = st.tr
    spans0 = dict(tr.spans.totals)
    busy0 = _sample_busy(tr)
    steps, epoch, times = 0, st.next_epoch, []
    marks = trace.StepMarks(tr.spans) if traced else None
    prof = trace.start(device_kind != "cpu") if traced else None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        m = tr.train_epoch(epoch)
        steps += m["batches"]
        times.append(m["time_s"])
        epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    summary = trace.stop(prof, t1 - t0) if traced else None
    if marks is not None:
        marks.close()
    spans = {k: v - spans0.get(k, 0.0) for k, v in tr.spans.totals.items()}
    log(f"[window] epochs of {tr.batches_per_epoch} steps, seconds: "
        + " ".join(f"{t:.3f}" for t in times))
    return Window(
        steps=steps, seconds=t1 - t0,
        seeds=steps * tr.num_trainers * cell.batch_size, setup_s=setup_s,
        spans=spans, sample_busy_s=_sample_busy(tr) - busy0,
        flops_per_step=cell.arch.flops_per_step(
            cell.model, cell.batch_size, tr.num_trainers),
        peak=counts.peaks(device_kind), trace=summary)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def check_first_steps(cell: Cell, st: Setup, device, log=print) -> tuple:
    """(the compared numbers, the decoded steps): the staged batches
    judged, the reference followed and compared. Call once the program's
    trainer is stopped and freed."""
    t = time.perf_counter()
    decoded = cell.graph.decode(st.data, st.first.steps, cell.model,
                                cell.batch_size)
    log(f"[check] decoded {len(decoded.samples)} steps "
        f"({time.perf_counter() - t:.2f} s): faults {decoded.faults}")
    t = time.perf_counter()
    opt = cell.config["optimizer"]
    ref = check.follow(cell.arch.forward, st.params0, decoded, opt, device)
    got = check.program_side(st.losses[:CHECKED_STEPS], st.first.moment1,
                             st.first.params_end, st.params0,
                             float(opt["betas"][0]))
    values = check.readings(got, ref)
    values.update({f"{k}_faults": v for k, v in decoded.faults.items()})
    values["shape_faults"] = _shape_faults(cell, st)
    log(f"[check] reference followed ({time.perf_counter() - t:.2f} s): "
        f"losses program {got.losses} reference {ref.losses}")
    return values, decoded


def control_readings(cell: Cell, st: Setup, decoded, device) -> dict:
    """The compared numbers of the program and of what stands in its
    place, each against the float32 reference: ``tf32``, the reference
    with every matrix product's operands in TF32 (the control); and
    ``half_batch``, the reference with half of the trainers' batches left
    out of the step's mean (a fault)."""
    opt = cell.config["optimizer"]
    forward = cell.arch.forward
    ref = check.follow(forward, st.params0, decoded, opt, device)
    got = check.program_side(st.losses[:CHECKED_STEPS], st.first.moment1,
                             st.first.params_end, st.params0,
                             float(opt["betas"][0]))
    slots = len(decoded.samples[0])
    tf32 = check.follow(forward, st.params0, decoded, opt, device,
                        precision="tf32")
    half = check.follow(forward, st.params0, decoded, opt, device,
                        slots=range(slots // 2))
    return {"program": check.readings(got, ref),
            "tf32": check.readings(tf32, ref),
            "half_batch": check.readings(half, ref)}


def _shape_faults(cell: Cell, st: Setup) -> int:
    """Steps whose staged arrays are not at the cell's padded sizes."""
    want = cell.arch.staged_shapes(cell.model, cell.batch_size,
                                   cell.trainers)
    return sum(s["shapes"] != want for s in st.first.steps)


def free(st: Setup) -> None:
    """Stop the program's loaders and drop its state from the card."""
    st.tr.stop()
    st.tr = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def live_per_step(decoded) -> list:
    """Per layer: the mean over the checked steps of (live edges,
    distinct live sources, distinct live destinations), summed over the
    trainers' slots."""
    layers = len(decoded.live[0])
    return [tuple(statistics.mean(step[l][i] for step in decoded.live)
                  for i in range(3)) for l in range(layers)]


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", log=print) -> dict:
    """One run -> the result line's object."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    st = setup(cell, seed, device, log)
    w = window(cell, st, seconds, traced, t_start, kind, log)
    log(f"[window] {w.steps} steps, {w.seeds} seeds in {w.seconds:.3f} s "
        f"after {w.setup_s:.3f} s of set-up")
    peak_bytes = (int(torch.cuda.max_memory_allocated(device)) if on_card
                  else 0)
    free(st)
    values, decoded = check_first_steps(cell, st, device, log)
    if w.peak is not None:
        w.kernel_least_s = cell.arch.kernel_least_per_step(
            cell.model, cell.batch_size, cell.trainers,
            live_per_step(decoded), w.peak)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for entry in wanted:
        value = reader(entry["name"])(w)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak_bytes}
    out = {"correct": check.judge(values, cell.limits),
           "attempted": w.steps, "failed": 0, "metrics": metrics,
           "device": dev}
    if traced:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
        out["breakdown"] = {"device_ops": w.trace.device_ops,
                            "idle_gaps": w.trace.idle_gaps}
    out["checks"] = check.order_checks(values, cell.limits)
    log("[check] not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in values.items() if k not in cell.limits))
    return out
