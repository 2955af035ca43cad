"""The training path's tracer (``training/trainer.py::_Spans``, reached as
``DistGNNTrainer.spans``): child spans nested in a step span, additions
from many threads, copies of its totals taken while threads add, the
harness's stand-ins for ``start`` / ``mark`` on the instance, its
profiler ranges, and its totals over a trainer epoch against the
quantities they measure (the arena's bytes, the pipelines' own stage
stats, wall time against CPU time).

The epoch runs with ``sync=True`` loaders: the tests snapshot counters,
so no thread may decide the order of what they count.
"""
import sys
import threading
import time

import pytest
import torch

from repro_torch.api import DistGNNTrainer, TrainJobConfig
from repro_torch.graph import get_dataset
from repro_torch.kernels.pack import pack, stack_trees
from repro_torch.models.gnn import GNNConfig
from repro_torch.training.trainer import (COUNTERS, HOST_SPANS, LOADER_SPANS,
                                          RANGE_PREFIX, STAGE_SPANS, _Spans)

SCALE = 11
MODEL = dict(arch="graphsage", in_dim=100, hidden_dim=16, num_classes=16,
             fanouts=[5, 5], batch_size=16)
JOB = dict(num_machines=2, trainers_per_machine=2, sync=True)
STEP = ["start", "wait_loaders", "stack_stage", "forward", "backward",
        "optimizer", "read_loss"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the tracer alone
# ---------------------------------------------------------------------------

def test_child_span_counts_toward_its_parent_and_itself():
    sp = _Spans(on_card=False)
    sp.start()
    with sp.span("stack_stage", cpu=True):
        boundary = sp._t
        with sp.child("stack_host"):
            time.sleep(0.02)
        # a child moves no boundary
        assert sp._t == boundary
        time.sleep(0.01)
    assert sp.totals["stack_host"] >= 0.02
    assert sp.totals["stack_stage"] >= sp.totals["stack_host"] + 0.01
    assert 0 <= sp.totals["stack_stage_cpu"] <= sp.totals["stack_stage"]


def test_additions_from_many_threads_give_the_exact_sum():
    sp = _Spans(on_card=False)
    threads, n = 8, 10_000

    def work():
        for _ in range(n):
            sp.add("sample", 1.0, cpu=0.5)
            sp.add("staged_bytes", 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert sp.totals["sample"] == threads * n
    assert sp.totals["sample_cpu"] == threads * n * 0.5
    assert sp.totals["staged_bytes"] == threads * n * 3


def test_a_copy_of_the_totals_taken_while_threads_add_never_raises():
    sp = _Spans(on_card=False)
    keys = set(sp.totals)
    assert keys >= set(HOST_SPANS + STAGE_SPANS + LOADER_SPANS + COUNTERS)
    stop = threading.Event()

    def work():
        while not stop.is_set():
            sp.add("pull", 1e-3, cpu=1e-4)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    try:
        for _ in range(2_000):
            assert set(dict(sp.totals)) == keys
    finally:
        stop.set()
        for t in ts:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    # every key exists from the start: an unknown name is refused, never
    # inserted while another thread copies the dict
    with pytest.raises(KeyError):
        sp.add("not_a_span", 1.0)
    assert set(sp.totals) == keys


# ---------------------------------------------------------------------------
# a trainer epoch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced():
    """One epoch with the harness's stand-ins on the instance (``start``,
    ``mark`` and ``train_step``), then one more under a CPU
    ``torch.profiler`` session."""
    tr = DistGNNTrainer(get_dataset("product-sim", scale=SCALE),
                        GNNConfig(**MODEL), TrainJobConfig(**JOB),
                        device="cpu")
    try:
        sp = tr.spans
        seen, stepped = [], []
        start, mark = sp.start, sp.mark

        def marked_start():
            start()
            seen.append("start")

        def marked_mark(name, device=False):
            mark(name, device)
            seen.append(name)

        def train_step(stacked):
            stepped.append(tr.global_step)
            return type(tr).train_step(tr, stacked)

        sp.start, sp.mark, tr.train_step = marked_start, marked_mark, \
            train_step
        try:
            m0 = tr.train_epoch(0)
        finally:
            del sp.start, sp.mark, tr.train_step
        totals = dict(sp.totals)
        stats = [ld.pipeline.stats_report() for ld in tr.loaders]
        batches = [next(ld.epoch(1)).model_input() for ld in tr.loaders]
        arena_bytes = len(pack(stack_trees(batches))[1])
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            m1 = tr.train_epoch(1)
        events = [(e.name()[len(RANGE_PREFIX):], e.start_ns(),
                   e.start_ns() + e.duration_ns(), e.kwinputs())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(RANGE_PREFIX)]
    finally:
        tr.stop()
    return dict(tr=tr, steps=m0["batches"], steps1=m1["batches"],
                seen=seen, stepped=stepped, totals=totals, stats=stats,
                arena_bytes=arena_bytes, events=events)


def test_stand_ins_on_the_instance_see_every_boundary(traced):
    steps = traced["steps"]
    assert steps >= 2
    assert traced["seen"] == STEP * steps
    assert traced["stepped"] == list(range(steps))


def test_stack_stage_holds_its_children(traced):
    t = traced["totals"]
    assert t["stack_host"] > 0 and t["stage_pack"] > 0
    assert t["stack_host"] + t["stage_pack"] <= t["stack_stage"]


def test_staged_bytes_count_the_arena_of_every_step(traced):
    assert traced["totals"]["staged_bytes"] == \
        traced["steps"] * traced["arena_bytes"]
    assert traced["tr"].counters() == {
        "staged_bytes": (traced["steps"] + traced["steps1"])
        * traced["arena_bytes"]}


@pytest.mark.parametrize("name, calls", [("stack_stage", 1),
                                         ("sample", 4), ("pull", 4)])
def test_cpu_time_is_at_most_wall_time(traced, name, calls):
    """Each call's CPU time lies inside its wall interval, so each total
    is at most its wall total plus a tick of both clocks a call."""
    t = traced["totals"]
    tick = (time.get_clock_info("thread_time").resolution
            + time.get_clock_info("perf_counter").resolution)
    assert t[f"{name}_cpu"] > 0
    assert t[f"{name}_cpu"] <= t[name] + calls * traced["steps"] * tick


@pytest.mark.parametrize("span, stage", [("sample", "sample"),
                                         ("pull", "cpu_prefetch")])
def test_loader_totals_are_the_pipelines_stage_stats(traced, span, stage):
    t, stats = traced["totals"], traced["stats"]
    assert sum(s[stage]["items"] for s in stats) == 4 * traced["steps"]
    assert t[span] == pytest.approx(
        sum(s[stage]["busy_s"] for s in stats), rel=1e-12, abs=0)
    assert t[f"{span}_cpu"] == pytest.approx(
        sum(s[stage]["cpu_s"] for s in stats), rel=1e-12, abs=0)


def test_profiler_ranges_nest_with_their_steps_args(traced):
    ranges = traced["events"]
    steps = traced["steps1"]
    names = [n for n, *_ in ranges]
    for name in HOST_SPANS + ("stack_host", "stage_pack"):
        assert names.count(name) == steps, name
    by_step = {}
    for name, a, b, args in ranges:
        by_step.setdefault((args["epoch"], args["step"]), {})[name] = (a, b)
    assert sorted(by_step) == [(1, k) for k in range(steps)]
    for spans in by_step.values():
        lo, hi = spans["stack_stage"]
        for child in ("stack_host", "stage_pack"):
            a, b = spans[child]
            assert lo <= a <= b <= hi
        order = [spans[n][0] for n in HOST_SPANS]
        assert order == sorted(order)


def test_no_range_without_a_profiler():
    """Outside a profiler session a span opens no range: one check."""
    assert _Spans(on_card=False)._open("stack_stage") is None
