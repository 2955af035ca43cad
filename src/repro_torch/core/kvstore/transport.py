"""Transport layer between KVStore clients and servers.

On a real cluster the local partition is reached through shared memory
(zero-copy — §5.4 "uses shared memory to access data in the local KVStore
server to minimize data copy") and remote partitions over TCP. This
container is one host, so *correctness* is exact (separate per-partition
arrays, all remote accesses go through ``remote_fetch``/``remote_apply``)
while the *network cost* is modeled: every remote byte is charged to a
latency+bandwidth accountant that benchmarks read out, and can optionally
really sleep to make pipeline-overlap benchmarks honest in wall-clock.

Availability plumbing (DESIGN.md §12): charges may carry a destination
server id (``dst``), and the transport keeps a :class:`PeerHealth`
circuit breaker per destination — consecutive failures open the breaker,
an open breaker half-opens after a cooldown on the *simulated* clock, and
a successful probe closes it. The breaker never blocks a charge by
itself (replication r=1 must behave exactly as before); it informs the
client's *routing*: the replicated read path orders candidates
available-first and skips open destinations instead of burning the whole
retry budget on a dead server.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

from .faults import OwnerDownError, TransientRPCError


@dataclasses.dataclass
class NetworkModel:
    """Cost model: t = latency + bytes / bandwidth (per request)."""
    latency_s: float = 100e-6           # ~100us RPC latency
    bandwidth_Bps: float = 12.5e9       # 100 Gbps, the paper's cluster
    sleep: bool = False                 # really sleep (for wall-clock benches)

    def cost(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps


class PeerHealth:
    """Per-destination circuit breaker (DESIGN.md §12).

    States per peer: **closed** (healthy — all traffic allowed), **open**
    (``failure_threshold`` consecutive failures — presumed dead), and
    **half-open** (``open_window_s`` of simulated time elapsed since the
    breaker opened — one probe is allowed; success closes it, failure
    reopens it and restarts the cooldown). Time comes from a caller-
    supplied clock so the state machine is driven by the *simulated*
    clock, keeping chaos tests deterministic.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, clock, *, failure_threshold: int = 3,
                 open_window_s: float = 0.1):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._clock = clock
        self.failure_threshold = int(failure_threshold)
        self.open_window_s = float(open_window_s)
        self._lock = threading.Lock()
        self._consecutive: Dict[int, int] = {}
        self._opened_at: Dict[int, float] = {}
        self.breaker_opens = 0

    def state(self, dst: int) -> str:
        dst = int(dst)
        with self._lock:
            if dst not in self._opened_at:
                return self.CLOSED
            if self._clock() - self._opened_at[dst] >= self.open_window_s:
                return self.HALF_OPEN
            return self.OPEN

    def available(self, dst: int) -> bool:
        """True when traffic to ``dst`` is worth attempting (closed or
        half-open — a half-open peer gets its probe)."""
        return self.state(dst) != self.OPEN

    def record_success(self, dst: int) -> None:
        dst = int(dst)
        with self._lock:
            self._consecutive[dst] = 0
            self._opened_at.pop(dst, None)

    def record_failure(self, dst: int) -> None:
        dst = int(dst)
        with self._lock:
            was_open = dst in self._opened_at
            if was_open:
                # a failed half-open probe reopens and restarts the cooldown
                self._opened_at[dst] = self._clock()
                return
            n = self._consecutive.get(dst, 0) + 1
            self._consecutive[dst] = n
            if n >= self.failure_threshold:
                self._opened_at[dst] = self._clock()
                self.breaker_opens += 1

    def stats(self) -> dict:
        with self._lock:
            return {"breaker_opens": self.breaker_opens,
                    "open_peers": sorted(self._opened_at)}


class Transport:
    def __init__(self, model: NetworkModel | None = None,
                 fault_injector=None):
        self.model = model or NetworkModel()
        # optional FaultInjector (kvstore.faults): charge_remote raises
        # TransientRPCError on its deterministic schedule. None (default)
        # keeps the fault check off the hot path entirely.
        self.fault_injector = fault_injector
        self._lock = threading.Lock()
        self.remote_bytes = 0
        self.remote_requests = 0
        self.local_bytes = 0
        self.simulated_time_s = 0.0
        # transient-fault accounting (kvstore.faults): injected failures
        # and the retries/backoffs clients paid recovering from them
        self.rpc_failures = 0
        self.rpc_retries = 0
        # hot-vertex cache accounting (kvstore.cache): bytes a remote fetch
        # WOULD have moved but a trainer-side cache hit absorbed — the
        # paper-style traffic-reduction numerator for benchmarks
        self.cache_hits = 0
        self.cache_misses = 0
        self.saved_remote_bytes = 0
        # availability accounting (DESIGN.md §12)
        self.owner_down_failures = 0    # charges refused by a down window
        self.failovers = 0              # reads served by a non-primary copy
        self.hedged_reads = 0           # hedge timers that fired
        self.hedge_wins = 0             # hedged replica attempt succeeded
        self.deferred_replica_writes = 0  # write charges skipped: dst down
        self.degraded_pulls = 0         # rows served stale/zero-filled
        self.health = PeerHealth(lambda: self.simulated_time_s)

    def charge_cache_hit(self, nbytes: int, rows: int = 1) -> None:
        with self._lock:
            self.cache_hits += rows
            self.saved_remote_bytes += nbytes

    def charge_cache_miss(self, rows: int = 1) -> None:
        with self._lock:
            self.cache_misses += rows

    def charge_remote(self, nbytes: int, op: str = "data",
                      dst: Optional[int] = None) -> None:
        inj = self.fault_injector
        if (inj is not None and dst is not None
                and inj.owner_is_down(dst, op)):
            # the destination server is inside a sustained down window:
            # the request times out after one round trip, no bytes move
            with self._lock:
                self.rpc_failures += 1
                self.owner_down_failures += 1
                self.simulated_time_s += self.model.latency_s
            if dst is not None:
                self.health.record_failure(dst)
            if self.model.sleep:
                time.sleep(self.model.latency_s)
            raise OwnerDownError(
                f"server {dst} is down (injected outage) on {op!r} RPC "
                f"({nbytes}B)")
        if inj is not None and inj.rpc_should_fail(op):
            # a failed RPC still burned a round trip before the error came
            # back; the payload bytes never moved
            with self._lock:
                self.rpc_failures += 1
                self.simulated_time_s += self.model.latency_s
            if dst is not None:
                self.health.record_failure(dst)
            if self.model.sleep:
                time.sleep(self.model.latency_s)
            raise TransientRPCError(
                f"injected transient failure on {op!r} RPC ({nbytes}B)")
        t = self.model.cost(nbytes)
        with self._lock:
            self.remote_bytes += nbytes
            self.remote_requests += 1
            self.simulated_time_s += t
        if dst is not None:
            self.health.record_success(dst)
        if self.model.sleep:
            time.sleep(t)

    def charge_retry_backoff(self, delay_s: float) -> None:
        """One retry's backoff wait, charged to the simulated clock (and
        really slept when the model sleeps — wall-clock benches stay
        honest about recovery cost)."""
        with self._lock:
            self.rpc_retries += 1
            self.simulated_time_s += delay_s
        if self.model.sleep:
            time.sleep(delay_s)

    def charge_hedge_delay(self, delay_s: float) -> None:
        """The hedge timer firing: the primary read is ``delay_s`` late,
        so a replica attempt is launched (DESIGN.md §12)."""
        with self._lock:
            self.hedged_reads += 1
            self.simulated_time_s += delay_s
        if self.model.sleep:
            time.sleep(delay_s)

    def charge_local(self, nbytes: int) -> None:
        with self._lock:
            self.local_bytes += nbytes

    # -- availability accounting hooks (DESIGN.md §12) --------------------
    def note_failover(self) -> None:
        with self._lock:
            self.failovers += 1

    def note_hedge_win(self) -> None:
        with self._lock:
            self.hedge_wins += 1

    def note_deferred_replica_write(self) -> None:
        with self._lock:
            self.deferred_replica_writes += 1

    def note_degraded(self, rows: int = 1) -> None:
        with self._lock:
            self.degraded_pulls += rows

    def stats(self) -> dict:
        with self._lock:
            looked_up = self.cache_hits + self.cache_misses
            return {
                "remote_bytes": self.remote_bytes,
                "remote_requests": self.remote_requests,
                "local_bytes": self.local_bytes,
                "simulated_network_s": self.simulated_time_s,
                "rpc_failures": self.rpc_failures,
                "rpc_retries": self.rpc_retries,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_hit_rate": self.cache_hits / max(looked_up, 1),
                "saved_remote_bytes": self.saved_remote_bytes,
                # conservative in-run estimate (DESIGN.md §5): the
                # denominator is ALL remote traffic — sampling RPCs and
                # pushes included — so this understates the pull-only
                # reduction; the table2 ablation's on/off comparison is
                # the controlled number
                "remote_traffic_reduction": self.saved_remote_bytes / max(
                    self.saved_remote_bytes + self.remote_bytes, 1),
                # availability accounting (DESIGN.md §12)
                "owner_down_failures": self.owner_down_failures,
                "failovers": self.failovers,
                "hedged_reads": self.hedged_reads,
                "hedge_wins": self.hedge_wins,
                "deferred_replica_writes": self.deferred_replica_writes,
                "degraded_pulls": self.degraded_pulls,
                "breaker_opens": self.health.breaker_opens,
            }

    def reset(self) -> None:
        with self._lock:
            self.remote_bytes = 0
            self.remote_requests = 0
            self.local_bytes = 0
            self.simulated_time_s = 0.0
            self.rpc_failures = 0
            self.rpc_retries = 0
            self.cache_hits = 0
            self.cache_misses = 0
            self.saved_remote_bytes = 0
            self.owner_down_failures = 0
            self.failovers = 0
            self.hedged_reads = 0
            self.hedge_wins = 0
            self.deferred_replica_writes = 0
            self.degraded_pulls = 0
        self.health = PeerHealth(lambda: self.simulated_time_s)
