"""Generic multi-stage asynchronous pipeline with per-stage bounded queues
and per-stage worker pools (§5.5, Fig. 7).

Every stage runs in one or more threads and communicates through a bounded
queue whose depth encodes the paper's "different degrees of aggressiveness
in different stages": deep queues at the cheap front of the pipeline (batch
scheduling, sampling), shallow ones near the device (depth 1 for device
prefetch, because accelerator memory is scarce). A stage that is slower than
its consumers simply keeps its queue drained; a stage slower than its
*producers* exerts backpressure through the bounded queue — no global
barrier anywhere, which is how the pipeline hides both I/O latency and the
per-batch imbalance of GNN sampling.

``Stage(workers=N)`` runs N threads pulling from the stage's shared input
queue — the paper's *multiple sampling workers per trainer* (§5.5), which
keeps the pipeline fed when one stage's per-item latency (RPC round trips,
per-batch sampling skew) exceeds the consumer's step time. Items are tagged
with sequence numbers by the feeder and a reassembly buffer at the pooled
stage's output restores arrival order, so downstream consumers — and the
byte-identity guarantees of DESIGN.md §7 — are unaffected by pool size or
completion order. The reorder buffer is bounded by ``workers + depth``
in-flight items, so pooling never breaks backpressure.

``sync=True`` collapses the whole thing into an inline loop — the
no-pipelining baseline used for the Fig. 14 ablation.

Per-stage wall-time and occupancy counters feed the Table-2-style breakdown
benchmark; under pools the counters aggregate over all of a stage's
workers (guarded by a per-stage lock).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

_SENTINEL = object()
_WORKER_DONE = object()   # one pool worker exited normally
_WORKER_ERR = object()    # a pool worker errored: end the stream now


@dataclasses.dataclass
class Stage:
    name: str
    fn: Callable[[Any], Any]
    depth: int = 2          # output queue bound (ahead-of-time aggressiveness)
    workers: int = 1        # >1: thread pool + in-order reassembly


@dataclasses.dataclass
class StageStats:
    items: int = 0
    busy_s: float = 0.0
    wait_in_s: float = 0.0     # starved (waiting for producer)
    wait_out_s: float = 0.0    # backpressured (waiting for consumer)

    def as_dict(self):
        return dataclasses.asdict(self)


class AsyncPipeline:
    """Drive ``source`` through ``stages``; iterate results.

    The source iterable runs in its own feeder thread so that *scheduling*
    (the first pipeline stage in Fig. 7) is also asynchronous. The feeder
    tags every item with a sequence number; pooled stages may complete
    items out of order but re-emit them in sequence order.
    """

    def __init__(self, source: Iterable[Any], stages: List[Stage], *,
                 sync: bool = False, name: str = "pipeline"):
        self.source = source
        self.stages = stages
        self.sync = sync
        self.name = name
        self.stats = {s.name: StageStats() for s in stages}
        self._stat_locks = {s.name: threading.Lock() for s in stages}
        self._threads: List[threading.Thread] = []
        self._queues: List[queue.Queue] = []
        self._aux_queues: List[queue.Queue] = []   # pool intermediate queues
        self._stop = threading.Event()
        self._started = False
        self._error: Optional[BaseException] = None
        # pooled-stage ordering state: the emitted frontier per stage (the
        # next seq its reassembler will release) and a condition workers
        # wait on so no worker runs fn() more than workers+depth items
        # ahead of the frontier — this is what bounds the reorder buffer
        self._order_cv = threading.Condition()
        self._emitted = {i: 0 for i, s in enumerate(stages) if s.workers > 1}
        # stages whose pool hit an error: siblings stop running fn()
        self._failed_stages: set = set()

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        if self.sync:
            yield from self._run_sync()
            return
        self.start()
        out_q = self._queues[-1]
        while True:
            item = out_q.get()
            if item is _SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item[1]          # strip the sequence tag

    def _run_sync(self) -> Iterator[Any]:
        for item in self.source:
            for s in self.stages:
                st = self.stats[s.name]
                t0 = time.perf_counter()
                item = s.fn(item)
                st.busy_s += time.perf_counter() - t0
                st.items += 1
            yield item

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        # queue[0] feeds stage 0; queue[i+1] is stage i's output
        self._queues = [queue.Queue(maxsize=max(self.stages[0].depth, 1))]
        for s in self.stages:
            self._queues.append(queue.Queue(maxsize=max(s.depth, 1)))

        def feeder():
            try:
                for seq, item in enumerate(self.source):
                    if self._stop.is_set():
                        break
                    if not self._put(self._queues[0], (seq, item)):
                        return   # stopped while backpressured
            except BaseException as e:   # propagate into the consumer
                self._error = e
            finally:
                self._put(self._queues[0], _SENTINEL)

        t = threading.Thread(target=feeder, name=f"{self.name}-feed", daemon=True)
        t.start()
        self._threads.append(t)

        for i, s in enumerate(self.stages):
            if s.workers <= 1:
                t = threading.Thread(target=self._stage_loop, args=(i, s),
                                     name=f"{self.name}-{s.name}", daemon=True)
                t.start()
                self._threads.append(t)
                continue
            # worker pool: N workers share the input queue and deposit
            # (seq, out) into an intermediate queue; one reassembler
            # restores sequence order on the stage's output queue. The
            # mid queue leaves headroom for every worker to park one
            # finished item without deadlocking the reorder flush.
            mid_q = queue.Queue(maxsize=max(s.depth, 1) + s.workers)
            self._aux_queues.append(mid_q)
            for w in range(s.workers):
                t = threading.Thread(
                    target=self._pool_worker, args=(i, s, mid_q),
                    name=f"{self.name}-{s.name}-w{w}", daemon=True)
                t.start()
                self._threads.append(t)
            t = threading.Thread(
                target=self._reassembler, args=(i, s, mid_q),
                name=f"{self.name}-{s.name}-order", daemon=True)
            t.start()
            self._threads.append(t)

    def _put(self, q: queue.Queue, item: Any) -> bool:
        """put() that cannot deadlock a shutdown: while running it blocks
        (bounded-queue backpressure), but it re-checks the stop flag so a
        producer stuck on a full queue wakes up once ``stop()`` is called.
        Returns False if the item was dropped because the pipeline stopped."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        try:                       # stopping: best-effort, never block
            q.put_nowait(item)
            return True
        except queue.Full:
            return False

    def _get(self, q: queue.Queue) -> Any:
        """get() that re-checks the stop flag: a worker that was mid-``fn``
        when ``stop()``'s pill/join window expired must not block forever on
        the abandoned (empty) input queue afterwards."""
        while True:
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return _SENTINEL

    def _stage_loop(self, i: int, s: Stage) -> None:
        # single-worker stage: sole writer of its stats, no lock needed
        in_q, out_q = self._queues[i], self._queues[i + 1]
        st = self.stats[s.name]
        while True:
            t0 = time.perf_counter()
            item = self._get(in_q)
            t1 = time.perf_counter()
            st.wait_in_s += t1 - t0
            if item is _SENTINEL or self._stop.is_set():
                self._put(out_q, _SENTINEL)
                return
            seq, payload = item
            try:
                out = s.fn(payload)
            except BaseException as e:
                self._error = e
                self._put(out_q, _SENTINEL)
                return
            t2 = time.perf_counter()
            st.busy_s += t2 - t1
            if not self._put(out_q, (seq, out)):
                return
            st.wait_out_s += time.perf_counter() - t2
            st.items += 1

    # ---- worker pools -------------------------------------------------
    def _pool_worker(self, i: int, s: Stage, mid_q: queue.Queue) -> None:
        """One of a pooled stage's N workers: pull from the shared input
        queue, run ``fn``, deposit the tagged result for reassembly. On
        the end-of-stream sentinel it re-posts the sentinel so sibling
        workers see it too (the sentinel is always the queue's last real
        item, so the re-post cannot block behind payload)."""
        in_q = self._queues[i]
        st, lock = self.stats[s.name], self._stat_locks[s.name]
        window = s.workers + max(s.depth, 1)
        while True:
            t0 = time.perf_counter()
            item = self._get(in_q)
            t1 = time.perf_counter()
            with lock:
                st.wait_in_s += t1 - t0
            if i in self._failed_stages:
                return   # a sibling errored: stop running fn (side effects)
            if item is _SENTINEL or self._stop.is_set():
                self._put(in_q, _SENTINEL)
                self._put(mid_q, _WORKER_DONE)
                return
            seq, payload = item
            # ordering window: never run fn more than workers+depth items
            # ahead of the emitted frontier, so one slow batch cannot let
            # the siblings cycle and grow the reorder buffer without
            # bound. The frontier item itself (seq == emitted) never
            # waits, so the window cannot deadlock.
            with self._order_cv:
                while (seq >= self._emitted[i] + window
                       and not self._stop.is_set()
                       and i not in self._failed_stages):
                    self._order_cv.wait(0.1)
            if self._stop.is_set() or i in self._failed_stages:
                return   # woken by shutdown/error, not by the frontier
            tw = time.perf_counter()
            with lock:
                st.wait_out_s += tw - t1     # window wait = backpressure
            t1 = tw
            try:
                out = s.fn(payload)
            except BaseException as e:
                self._error = e
                with self._order_cv:
                    self._failed_stages.add(i)
                    self._order_cv.notify_all()
                self._put(mid_q, _WORKER_ERR)
                return
            t2 = time.perf_counter()
            with lock:
                st.busy_s += t2 - t1
            if not self._put(mid_q, (seq, out)):
                return
            with lock:
                st.wait_out_s += time.perf_counter() - t2
                st.items += 1

    def _reassembler(self, i: int, s: Stage, mid_q: queue.Queue) -> None:
        """In-order reassembly for a pooled stage: buffer out-of-order
        completions, emit runs of consecutive sequence numbers, and
        advance the emitted frontier the workers' ordering window keys
        on. Every stage's input is a contiguous in-order sequence (the
        feeder numbers from 0 and upstream pools reorder before
        emitting), and the window keeps workers within ``workers +
        depth`` of the frontier, so the buffer is bounded by that too."""
        out_q = self._queues[i + 1]
        buf: dict = {}
        expected = 0
        done = 0

        def advance(to_seq):
            with self._order_cv:
                self._emitted[i] = to_seq
                self._order_cv.notify_all()

        while True:
            item = self._get(mid_q)
            if item is _WORKER_ERR or item is _SENTINEL or self._stop.is_set():
                self._put(out_q, _SENTINEL)
                return
            if item is _WORKER_DONE:
                done += 1
                if done == s.workers:
                    for seq in sorted(buf):     # gapless unless stopping
                        if not self._put(out_q, (seq, buf[seq])):
                            return
                    self._put(out_q, _SENTINEL)
                    return
                continue
            seq, out = item
            buf[seq] = out
            while expected in buf:
                if not self._put(out_q, (expected, buf.pop(expected))):
                    return
                expected += 1
                advance(expected)

    # ------------------------------------------------------------------
    def stop(self, timeout: float = 5.0) -> None:
        """Tear the pipeline down without leaking blocked threads.

        A single drain races the workers: a stage blocked on ``put()`` into
        a full queue can refill it right after the drain and then block
        again forever. Instead we repeatedly (a) drain every queue so
        blocked producers wake, (b) poison-pill every queue so blocked
        consumers wake, and (c) join the workers with a bounded timeout,
        until every thread has exited or ``timeout`` elapses."""
        self._stop.set()
        deadline = time.perf_counter() + timeout
        alive = [t for t in self._threads if t.is_alive()]
        while alive:
            for q in self._queues + self._aux_queues:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    q.put_nowait(_SENTINEL)
                except queue.Full:
                    pass
            for t in alive:
                t.join(timeout=0.05)
            alive = [t for t in alive if t.is_alive()]
            if time.perf_counter() >= deadline:
                break   # daemon threads; don't hang the caller
        # leave queues drained (sentinels only) so a consumer mid-iteration
        # terminates instead of blocking on an abandoned queue
        self._threads = [t for t in self._threads if t.is_alive()]

    def stats_report(self) -> dict:
        out = {}
        for s in self.stages:
            d = self.stats[s.name].as_dict()
            d["workers"] = s.workers
            out[s.name] = d
        return out
