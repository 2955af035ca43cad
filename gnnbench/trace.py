"""``torch.profiler`` over the measured window, reduced to what the metric
readers and the result's breakdown take: the card's busy time (the union
of every kernel's and copy's interval), the device time of each operation
by name, and the card's idle time attributed to the trainer's span that
the host was in.

The spans are the trainer's own marks (``_Spans.start`` and ``.mark``,
one at each boundary of a step: ``wait_loaders``, ``stack_stage``,
``forward``, ``backward``, ``optimizer``, ``read_loss``). In a traced run
:class:`StepMarks` stands in for the two methods on the trainer's span
object, calls them, and leaves an empty ``record_function`` range named
``gnnbench.<span>`` in the trace at each boundary.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Optional

import torch

MARK = "gnnbench."
TOP = 10          # entries of each list of the breakdown


class StepMarks:
    def __init__(self, spans):
        self.spans = spans
        start, mark = spans.start, spans.mark

        def marked_start():
            start()
            _marker("start")

        def marked_mark(name, device=False):
            mark(name, device)
            _marker(name)
        spans.start = marked_start
        spans.mark = marked_mark

    def close(self) -> None:
        del self.spans.start
        del self.spans.mark


def _marker(name: str) -> None:
    with torch.profiler.record_function(MARK + name):
        pass


@dataclasses.dataclass
class Summary:
    busy_s: float               # the card busy (union of intervals)
    window_s: float             # the traced window, on the host clock
    by_name: dict               # device seconds by operation name
    device_ops: list            # [[name, seconds]], most first
    idle_gaps: list             # [[host span, idle seconds]], most first


def start(on_card: bool = True):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if on_card else []))
    prof.__enter__()
    return prof


def _events(prof) -> tuple:
    """([(start_ns, end_ns, name)] on the card, [(ns, span)] markers)."""
    from torch.autograd import DeviceType

    device, marks = [], []
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            device.append((t0, t1, e.name()))
        elif e.name().startswith(MARK):
            marks.append((t0, e.name()[len(MARK):]))
    device.sort()
    marks.sort()
    return device, marks


def _union(intervals: list) -> list:
    out = []
    for a, b, _ in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _span_of(marks: list, t: int) -> str:
    """The span the host was in at ``t``: the one the next mark ends."""
    i = bisect.bisect_left(marks, (t, ""))
    if i == len(marks):
        return "after the last step"
    name = marks[i][1]
    return "between steps" if name == "start" else name


def stop(prof, window_s: float) -> Optional[Summary]:
    prof.__exit__(None, None, None)
    return summarize(*_events(prof), window_s)


def summarize(device: list, marks: list, window_s: float
              ) -> Optional[Summary]:
    """``device``: sorted (start_ns, end_ns, name) of every kernel and
    copy; ``marks``: sorted (ns, span) of the host's step boundaries."""
    if not marks:
        return None
    lo = marks[0][0]
    hi = max([marks[-1][0]] + [b for _, b, _ in device])
    busy = _union([(max(a, lo), min(b, hi), n) for a, b, n in device
                   if b > lo and a < hi])
    busy_ns = sum(b - a for a, b in busy)
    by_name = defaultdict(float)
    for a, b, n in device:
        by_name[n] += (b - a) / 1e9
    # idle intervals between busy ones, cut at the host's marks
    idle = defaultdict(float)
    cuts = [t for t, _ in marks]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        at = a
        for c in cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(
                cuts, b)] + [b]:
            idle[_span_of(marks, c)] += (c - at) / 1e9
            at = c
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(busy_s=busy_ns / 1e9, window_s=window_s,
                   by_name=dict(by_name),
                   device_ops=[[n[:120], s] for n, s in top],
                   idle_gaps=[[n, s] for n, s in gaps])
