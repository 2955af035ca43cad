"""Distributed sparse (learnable) embeddings (§3.1 "sparse parameters",
§5.4, Fig. 4's "sparse emb update" arrow), the port of
``repro/core/kvstore/embedding.py``.

Embedding rows live in the KVStore next to the features; a mini-batch pulls
only the rows it touches, and the trainer pushes *row-sparse gradients*
back, where the owning server applies a row-wise Adam update. Dense model
parameters never flow through here — they take the all-reduce path.

The owners' update runs where ``device`` says, the card by default. On the
card it works as DGL's sparse optimizer does, with no device mirror of the
table that could go stale: each owner's touched rows are staged, updated
by K5 and copied back (:func:`~repro_torch.kernels.sparse_adam.
sparse_adam_staged`). On the CPU the plain version updates the KVStore's
arrays in place. Both give the bytes of the reference's NumPy update.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ...kernels.sparse_adam import (StagingArena, sparse_adam_apply,
                                    sparse_adam_staged)
from .store import DistKVStore, KVClient

# seconds a push spends in each part, summed over pushes; the device_*
# ones are the card's time (CUDA events) and stay 0 on the CPU
SPANS = ("coalesce", "charge", "stage", "apply", "unstage", "replicate",
         "notify", "device_h2d", "device_kernel", "device_d2h")


@dataclasses.dataclass
class SparseAdamConfig:
    lr: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


def _stages_rows(device: torch.device) -> bool:
    """Whether the owners update staged copies of the touched rows on the
    device (the card), rather than the host tables in place."""
    return device.type == "cuda"


class DistEmbedding:
    """num x dim learnable table, sharded by a node partition policy.

    Part of the public ``repro_torch.api`` surface (the
    ``dgl.distributed.DistEmbedding`` analogue): the table registers
    *mutable* (version-tracked), so it is also reachable as a writable
    ``DistTensor`` through ``DistGraph.ndata`` — row writes bump versions
    and invalidate trainer caches, exactly like ``push_grad``'s updates.

    ``device`` is where the owners' Adam update runs: ``"cuda"`` (the
    default; raises when there is no card, and takes float32 tables only)
    or ``"cpu"``. ``impl`` is the kernel switch of
    :mod:`repro_torch.kernels.impl` on that device.
    """

    def __init__(self, store: DistKVStore, name: str, num: int, dim: int,
                 policy_name: str, *, seed: int = 0,
                 optim: Optional[SparseAdamConfig] = None,
                 dtype=np.float32, impl: str = "auto", device="cuda"):
        pol = store.policies[policy_name]
        assert pol.total == num, (pol.total, num)
        # imported here: the api package imports this one
        from ...api.inference import resolve_device
        self.device = resolve_device(device)
        if _stages_rows(self.device) and np.dtype(dtype) != np.float32:
            raise TypeError(f"DistEmbedding on the card takes float32 "
                            f"tables, got {np.dtype(dtype)}")
        self.store = store
        self.name = name
        self.num = num
        self.dim = dim
        self.policy_name = policy_name
        self.optim = optim or SparseAdamConfig()
        self.impl = impl
        self.spans = dict.fromkeys(SPANS, 0.0)
        self._arena = StagingArena()
        rng = np.random.default_rng(seed)
        scale = 1.0 / np.sqrt(dim)
        # mutable=True: rows change under sparse-Adam pushes, so trainer
        # caches must version-check them (immutable features skip this)
        store.init_data(name, (dim,), dtype, policy_name,
                        init=lambda s: rng.standard_normal(s) * scale,
                        mutable=True)
        store.init_data(name + "__m", (dim,), np.float32, policy_name)
        store.init_data(name + "__v", (dim,), np.float32, policy_name)
        store.init_data(name + "__t", (), np.int64, policy_name)

    def __len__(self) -> int:
        return self.num

    @property
    def shape(self) -> tuple:
        return (self.num, self.dim)

    def pull(self, client: KVClient, ids: np.ndarray) -> np.ndarray:
        return client.pull(self.name, ids)

    def _apply(self, w, mm, vv, rows, gm, t) -> None:
        cfg = self.optim
        hyper = dict(beta1=cfg.beta1, beta2=cfg.beta2, lr=cfg.lr,
                     eps=cfg.eps, impl=self.impl)
        if _stages_rows(self.device):
            sparse_adam_staged(w, mm, vv, rows, gm, t, device=self.device,
                               arena=self._arena, spans=self.spans, **hyper)
            return
        t0 = time.perf_counter()
        # views of the server's arrays: the plain version writes into them
        sparse_adam_apply(torch.from_numpy(w), torch.from_numpy(mm),
                          torch.from_numpy(vv), rows, gm, t, **hyper)
        self.spans["apply"] += time.perf_counter() - t0

    def push_grad(self, client: KVClient, ids: np.ndarray, grad: np.ndarray) -> None:
        """Row-sparse Adam applied at the owners.

        Duplicate IDs within a batch are first coalesced (summed) so each
        row gets a single update — matching how DGL's sparse optimizer
        behaves under synchronous training.
        """
        spans = self.spans
        t0 = time.perf_counter()
        # the optimizer-state writes below bypass KVClient.push, so run
        # its pre-write guard for every tensor this method mutates
        for suffix in ("", "__m", "__v", "__t"):
            self.store.check_writable(self.name + suffix)
        ids = np.asarray(ids, dtype=np.int64)
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((len(uniq), grad.shape[1]), dtype=np.float32)
        np.add.at(g, inv, grad.astype(np.float32))

        store = self.store
        pol = store.policy_for(self.name)
        parts = pol.part_of(uniq)
        local = pol.local_of(uniq, parts)
        t1 = time.perf_counter()
        spans["coalesce"] += t1 - t0
        for p in range(store.num_parts):
            m = parts == p
            if not m.any():
                continue
            t1 = time.perf_counter()
            srv = store.servers[p]
            rows = local[m]
            gm = g[m]
            # charge the gradient shipment to EVERY copy holder BEFORE the
            # owner applies it — same ordering as KVClient.push: a
            # transient-fault retry (client._charge_remote) must never
            # re-run an Adam step. A holder inside a down window gets its
            # charge skipped (deferred replica write, DESIGN.md §12); the
            # update only fails when no copy holder accepted it.
            nbytes = gm.nbytes
            holders = (store.replicas_of(p) if hasattr(store, "replicas_of")
                       else (p,))
            machine = getattr(client, "machine", p)
            delivered = 0
            last = None
            for h in holders:
                if h == machine:
                    store.transport.charge_local(nbytes)
                    delivered += 1
                elif hasattr(client, "_charge_remote"):
                    try:
                        client._charge_remote(nbytes, op="push", dst=h)
                        delivered += 1
                    except Exception as e:
                        if len(holders) == 1:
                            raise
                        last = e
                        store.transport.note_deferred_replica_write()
                else:
                    store.transport.charge_remote(nbytes, op="push")
                    delivered += 1
            if delivered == 0:
                raise last
            t2 = time.perf_counter()
            spans["charge"] += t2 - t1
            t = srv.local_view(self.name + "__t")
            mm = srv.local_view(self.name + "__m")
            vv = srv.local_view(self.name + "__v")
            w = srv.local_view(self.name)
            # gather -> Adam (K5 on the card) -> scatter on the owner's
            # local views, bitwise equal to the reference's NumPy update
            self._apply(w, mm, vv, rows, gm, t)
            t3 = time.perf_counter()
            # synchronous replication: copy the post-Adam rows (weights AND
            # optimizer state) to every replica, so a failover read of any
            # tensor in the family is byte-identical to the primary
            store.copy_rows_to_replicas(self.name, p, rows)
            store.copy_rows_to_replicas(self.name + "__m", p, rows)
            store.copy_rows_to_replicas(self.name + "__v", p, rows)
            # __t is a per-row step counter with scalar rows
            store.copy_rows_to_replicas(self.name + "__t", p, rows)
            spans["replicate"] += time.perf_counter() - t3
        t4 = time.perf_counter()
        # AFTER the owners applied the update: bump versions + drop own
        # cached copies (the shared writer protocol)
        client.notify_write(self.name, uniq)
        spans["notify"] += time.perf_counter() - t4
