"""Failure injection for elastic-recovery testing (DESIGN.md §10).

Production traffic implies machines dying mid-epoch; this repo's unfair
advantage is that every sampling-front draw is counter-keyed on
``(seed, epoch, batch_index, stream)`` (DESIGN.md §7), so a replacement
trainer can re-derive *exactly* the batches a dead one would have produced.
:class:`FaultInjector` is the other half of that story: a **seeded,
deterministic failure schedule** that the chaos suite and the launcher's
``--inject-fault`` flag use to make "a machine died" a reproducible event.

Two failure families:

* **trainer death** — ``kill_at=(epoch, batch_index)`` raises
  :class:`TrainerDeath` from the trainer loop the moment it is about to
  consume that batch (i.e. the batch is never trained). One-shot: after
  firing, the injector disarms itself so a recovered run that replays
  through the same coordinate does not die again.
* **transient RPC errors** — ``rpc_failure_rate`` makes
  ``Transport.charge_remote`` raise :class:`TransientRPCError` on a
  deterministic counter-keyed schedule (per-call draw from
  ``SeedSequence((seed, call_counter))``, same construction as the
  sampler's per-batch RNG). ``KVClient`` retries these with exponential
  backoff charged to the simulated clock, so injected transients change
  accounting but **never bytes** — golden hashes are pinned by tests.

``ops`` scopes injection to transport operation tags: feature/embedding
traffic is ``"pull"``/``"push"`` (the retried paths); sampler dispatch
charges under the default ``"data"`` tag and is only faulted when a test
asks for it explicitly (the mid-stream pipeline-failure tests do).

A third family (DESIGN.md §12) models a **server dying**, not a blip:

* **sustained owner-down windows** — :class:`OwnerDownWindow` marks one
  KVStore owner unreachable for a contiguous window, in *call-index*
  coordinates (the n-th..m-th RPC addressed to that owner) or
  *epoch:batch* coordinates (the trainer's batch clock, updated through
  :meth:`FaultInjector.check_death`). Every charge addressed to a down
  owner raises :class:`OwnerDownError`; the replicated read path fails
  over to a live replica (byte-identical rows), and when EVERY copy of
  an owner is unreachable the client surfaces
  :class:`OwnerUnavailable` — which degraded-mode serving converts into
  a flagged stale-cache/zero-fill response instead of a failure.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

_MASK32 = 0xFFFFFFFF


class TransientRPCError(RuntimeError):
    """A remote call failed but may succeed on retry (network blip)."""


class OwnerDownError(TransientRPCError):
    """A remote call failed because its destination server is inside a
    sustained down window (DESIGN.md §12). Subclasses
    :class:`TransientRPCError` so unreplicated retry loops treat it like
    any failure; the health-routed read path recognizes it and fails
    over instead of burning the retry budget."""


class RPCRetriesExhausted(RuntimeError):
    """A remote call kept failing past the retry budget — fatal."""


class OwnerUnavailable(RuntimeError):
    """EVERY replica of an owner is unreachable (DESIGN.md §12).

    Raised by the replicated read path after failover exhausted all copy
    holders, or by an unreplicated read whose owner is inside a sustained
    down window. Training treats it as fatal (no copy of the bytes
    exists); degraded-mode serving catches it and falls back to stale
    cached rows / zero-fill with the response flagged ``degraded``.
    """


Coordinate = Union[int, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class OwnerDownWindow:
    """A sustained outage of one KVStore owner (DESIGN.md §12).

    ``owner`` is the partition/machine id whose server is unreachable for
    ``start <= x < end``, where ``x`` is either

    * ``unit="calls"`` — the per-owner RPC call index (the n-th charge
      addressed to that owner), so the window is a pure function of call
      order and needs no trainer wiring; or
    * ``unit="batch"`` — the trainer's ``(epoch, batch_index)`` clock,
      compared lexicographically and advanced as a side effect of
      :meth:`FaultInjector.check_death` (which every injected trainer
      already calls once per batch).
    """

    owner: int
    start: Coordinate
    end: Coordinate
    unit: str = "calls"

    def __post_init__(self):
        if self.unit not in ("calls", "batch"):
            raise ValueError(f"unit must be 'calls' or 'batch', "
                             f"got {self.unit!r}")
        if self.unit == "batch":
            for name in ("start", "end"):
                v = getattr(self, name)
                if not (isinstance(v, tuple) and len(v) == 2):
                    raise ValueError(f"batch-unit window needs "
                                     f"(epoch, batch) {name}, got {v!r}")
        if not (self.start < self.end):  # lexicographic for tuples
            raise ValueError(f"empty window: start {self.start!r} "
                             f">= end {self.end!r}")

    def contains(self, x: Coordinate) -> bool:
        return self.start <= x < self.end


class TrainerDeath(RuntimeError):
    """An injected trainer loss at coordinate ``(epoch, batch_index)``.

    The batch at the death coordinate was NOT trained; recovery restores
    the latest checkpoint and replays forward through it.
    """

    def __init__(self, epoch: int, batch_index: int):
        super().__init__(f"trainer killed at epoch {epoch}, "
                         f"batch {batch_index} (injected fault)")
        self.epoch = int(epoch)
        self.batch_index = int(batch_index)


class FaultInjector:
    """Seeded deterministic failure schedule.

    Thread-safe: the RPC draw counter is shared by every thread that
    charges the transport (CPU-prefetch stages, embedding pushes). The
    schedule is a pure function of ``(seed, call order)`` — two runs that
    issue the same calls in the same order see identical faults, which is
    what lets CI pin a fault schedule.
    """

    def __init__(self, seed: int = 0, *,
                 kill_at: Optional[Tuple[int, int]] = None,
                 rpc_failure_rate: float = 0.0,
                 ops: Sequence[str] = ("pull", "push"),
                 max_rpc_failures: Optional[int] = None,
                 owner_down: Sequence[OwnerDownWindow] = ()):
        if not (0.0 <= rpc_failure_rate <= 1.0):
            raise ValueError(f"rpc_failure_rate must be in [0, 1], "
                             f"got {rpc_failure_rate}")
        self.seed = int(seed)
        self.kill_at = None if kill_at is None else (int(kill_at[0]),
                                                     int(kill_at[1]))
        self.rpc_failure_rate = float(rpc_failure_rate)
        self.ops = tuple(ops)
        # cap on TOTAL injected RPC faults (None = unlimited): lets a test
        # inject "the first k calls fail" without rate-1.0 starving retries
        self.max_rpc_failures = max_rpc_failures
        self.owner_down = tuple(owner_down)
        self._lock = threading.Lock()
        self._rpc_calls = 0
        self.rpc_faults_injected = 0
        self.death_fired = False
        # per-owner RPC call counters for unit="calls" windows
        self._owner_calls: Dict[int, int] = {}
        # trainer batch clock for unit="batch" windows, advanced by
        # check_death; (-1, -1) = before the first batch
        self._coord: Tuple[int, int] = (-1, -1)
        self.owner_down_hits = 0

    # -- transient RPC faults -------------------------------------------
    def rpc_should_fail(self, op: str = "data") -> bool:
        """Deterministic per-call draw; counts every matching call."""
        if self.rpc_failure_rate <= 0.0 or op not in self.ops:
            return False
        with self._lock:
            n = self._rpc_calls
            self._rpc_calls += 1
            if (self.max_rpc_failures is not None
                    and self.rpc_faults_injected >= self.max_rpc_failures):
                return False
            # counter-keyed, like prng.batch_rng: reproducible per call index
            rng = np.random.default_rng(np.random.SeedSequence(
                (self.seed & _MASK32, n & _MASK32)))
            fail = bool(rng.random() < self.rpc_failure_rate)
            if fail:
                self.rpc_faults_injected += 1
            return fail

    # -- sustained owner-down windows -------------------------------------
    def owner_is_down(self, owner: int, op: str = "data") -> bool:
        """True if ``owner`` is inside a down window for this call.

        Counts one per-owner call per invocation (unit="calls" windows are
        a pure function of per-owner call order); batch-unit windows
        compare against the clock advanced by :meth:`check_death`.
        Scoped to ``ops`` like the transient schedule, so sampler dispatch
        (op="data") is untouched unless a test opts in.
        """
        if not self.owner_down or op not in self.ops:
            return False
        owner = int(owner)
        with self._lock:
            n = self._owner_calls.get(owner, 0)
            self._owner_calls[owner] = n + 1
            coord = self._coord
            down = any(
                w.owner == owner and w.contains(n if w.unit == "calls"
                                                else coord)
                for w in self.owner_down)
            if down:
                self.owner_down_hits += 1
            return down

    # -- trainer death ---------------------------------------------------
    def check_death(self, epoch: int, batch_index: int) -> None:
        """Raise :class:`TrainerDeath` at the scheduled coordinate (once).

        Also advances the batch clock used by batch-unit owner-down
        windows — the trainer calls this once per batch whenever an
        injector is attached, so the clock needs no extra wiring.
        """
        with self._lock:
            self._coord = (int(epoch), int(batch_index))
        if self.kill_at is None or self.death_fired:
            return
        if (int(epoch), int(batch_index)) == self.kill_at:
            self.death_fired = True
            raise TrainerDeath(epoch, batch_index)

    def stats(self) -> dict:
        with self._lock:
            return {"rpc_calls_seen": self._rpc_calls,
                    "rpc_faults_injected": self.rpc_faults_injected,
                    "death_fired": self.death_fired,
                    "kill_at": self.kill_at,
                    "owner_down_windows": len(self.owner_down),
                    "owner_down_hits": self.owner_down_hits}
