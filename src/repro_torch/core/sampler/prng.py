"""Counter-based per-batch RNG derivation (the sampling determinism
contract, DESIGN.md §7).

Every random draw on the sampling front — neighbor subsampling, negative
sampling, the epoch batch schedule — is made from a short-lived generator
derived from ``(root_seed, epoch, batch_index, stream)`` instead of a
shared mutated ``np.random.Generator``.  Two consequences:

* **worker-count invariance** — a batch's bytes depend only on its
  coordinates, never on which pool thread produced it or how many
  siblings ran before it, so ``--sample-workers {1, 2, 4}``, ``sync=True``
  and replay all yield byte-identical streams;
* **thread safety for free** — pool workers never contend on generator
  state; each ``sample()`` call owns its private generator.

The ``stream`` axis keeps co-seeded consumers (node sampler vs negative
sampler vs schedule) on provably disjoint key material even when callers
reuse a root seed.
"""
from __future__ import annotations

import threading

import numpy as np

_MASK32 = (1 << 32) - 1

# stream ids: one per independent consumer of a (seed, epoch, batch) cell
STREAM_SAMPLE = 0     # DistributedSampler neighbor draws
STREAM_NEG = 1        # NegativeSampler corrupted-destination draws
STREAM_SCHEDULE = 2   # per-epoch batch schedule permutations
STREAM_ADHOC = 3      # sequential sampler calls without batch coordinates
STREAM_NEG_ADHOC = 4  # sequential negative-sampler calls without coordinates


def batch_seed_sequence(root_seed: int, epoch: int, batch_index: int,
                        stream: int = STREAM_SAMPLE) -> np.random.SeedSequence:
    """The key cell for one (batch, consumer).  Negative coordinates (the
    ``-1`` "unscheduled" defaults) are folded into uint32 words, so every
    integer input is legal and the map stays injective per word."""
    return np.random.SeedSequence(
        (root_seed & _MASK32, epoch & _MASK32, batch_index & _MASK32,
         stream & _MASK32))


def batch_rng(root_seed: int, epoch: int, batch_index: int,
              stream: int = STREAM_SAMPLE) -> np.random.Generator:
    """A fresh private generator for one batch's draws."""
    return np.random.default_rng(
        batch_seed_sequence(root_seed, epoch, batch_index, stream))


class PerBatchRng:
    """The per-batch generator policy, shared by every sampling-front
    consumer: scheduled calls (``batch_index >= 0``) key on their batch
    coordinates in ``stream``; unscheduled calls (evaluation, direct test
    calls passing the ``-1`` default) key on a lock-guarded sequential
    counter in ``adhoc_stream`` — deterministic for a sequential caller,
    a fresh stream per call. Keeping the policy here (one place) is what
    keeps neighbor and negative draws on the same DESIGN.md §7 contract."""

    def __init__(self, root_seed: int, stream: int, adhoc_stream: int):
        self.root_seed = int(root_seed)
        self.stream = stream
        self.adhoc_stream = adhoc_stream
        self._lock = threading.Lock()
        self._adhoc_calls = 0

    def __call__(self, epoch: int, batch_index: int) -> np.random.Generator:
        if batch_index < 0:
            with self._lock:
                n = self._adhoc_calls
                self._adhoc_calls += 1
            return batch_rng(self.root_seed, epoch, n, self.adhoc_stream)
        return batch_rng(self.root_seed, epoch, batch_index, self.stream)
