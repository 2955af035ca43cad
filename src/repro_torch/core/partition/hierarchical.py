"""Hierarchical (2-level) partitioning (§5.3, Fig. 6) and the training-set
split algorithm (§5.6.1, Fig. 9).

Level 1: machines (physical subgraphs with HALO, via ``build_partitions``).
Level 2: trainers within a machine. The paper does NOT build physical
subgraphs at this level — trainers share the machine's partition and use a
*node split* so each trainer's seeds are topologically clustered (better
intra-batch locality => fewer unique input nodes per mini-batch, Fig. 14's
"2-level partition" bar). We realize level 2 by running the same multilevel
partitioner on the machine-local core subgraph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ...graph.csr import CSRGraph
from .book import GraphPartition, PartitionBook, build_partitions
from .multilevel import make_constraints, partition_graph, random_partition


@dataclasses.dataclass
class HierarchicalPartition:
    book: PartitionBook
    partitions: List[GraphPartition]
    machine_of_node: np.ndarray       # (n,) in NEW global id space
    trainer_of_node: np.ndarray       # (n,) trainer index WITHIN its machine
    trainers_per_machine: int

    @property
    def num_machines(self) -> int:
        return self.book.num_parts

    @property
    def num_trainers(self) -> int:
        return self.num_machines * self.trainers_per_machine

    def global_trainer(self, machine: int, local_trainer: int) -> int:
        return machine * self.trainers_per_machine + local_trainer


def hierarchical_partition(g: CSRGraph, num_machines: int,
                           trainers_per_machine: int, *,
                           split_mask: Optional[np.ndarray] = None,
                           method: str = "metis", seed: int = 0,
                           eps: float = 0.08) -> HierarchicalPartition:
    """Partition ``g`` for ``num_machines`` × ``trainers_per_machine``.

    method: "metis" (multilevel multi-constraint, the paper) or "random"
    (the Euler baseline).
    """
    vw = make_constraints(g, split_mask)
    if method == "metis":
        parts = partition_graph(g, num_machines, vwgts=vw, seed=seed, eps=eps)
    elif method == "random":
        parts = random_partition(g, num_machines, seed=seed)
    else:
        raise ValueError(f"unknown partition method {method!r}")

    book, partitions = build_partitions(g, parts)

    n = g.num_nodes
    machine_of_node = book.nid2part(np.arange(n, dtype=np.int64))
    trainer_of_node = np.zeros(n, dtype=np.int32)
    if trainers_per_machine > 1:
        split_new = None if split_mask is None else split_mask[book.new2old_node]
        for p, gp in enumerate(partitions):
            lo, hi = book.part_core_range(p)
            core_old = book.new2old_node[lo:hi]
            sub, _ = g.subgraph(core_old)
            sub_mask = None if split_new is None else split_new[lo:hi]
            sub_vw = make_constraints(sub, sub_mask)
            if method == "metis":
                sub_parts = partition_graph(sub, trainers_per_machine,
                                            vwgts=sub_vw, seed=seed + 1 + p,
                                            eps=eps)
            else:
                sub_parts = random_partition(sub, trainers_per_machine,
                                             seed=seed + 1 + p)
            trainer_of_node[lo:hi] = sub_parts
    return HierarchicalPartition(book=book, partitions=partitions,
                                 machine_of_node=machine_of_node,
                                 trainer_of_node=trainer_of_node,
                                 trainers_per_machine=trainers_per_machine)


def split_training_set(hp: HierarchicalPartition, train_nids_new: np.ndarray,
                       *, use_level2: bool = True,
                       seed: int = 0) -> List[np.ndarray]:
    """§5.6.1's split algorithm, returning one seed array per trainer.

    The paper splits the training IDs into equal contiguous ranges and
    assigns each range to the machine whose partition overlaps it most
    (possible because relabeling made partitions contiguous). Every trainer
    then gets exactly the same number of seeds — the synchronous-SGD
    requirement — while nearly all seeds stay machine-local.
    """
    t = hp.num_trainers
    train_sorted = np.sort(np.asarray(train_nids_new, dtype=np.int64))
    total = len(train_sorted)
    per = total // t
    if per == 0:
        raise ValueError(f"fewer training points ({total}) than trainers ({t})")
    train_sorted = train_sorted[: per * t]          # equal counts (drop tail)
    ranges = train_sorted.reshape(t, per)

    # assign each contiguous range to the machine with the largest overlap
    machine_budget = {m: hp.trainers_per_machine for m in range(hp.num_machines)}
    assignment: List[Optional[np.ndarray]] = [None] * t
    order = []
    for r in range(t):
        mids = hp.machine_of_node[ranges[r]]
        best = np.bincount(mids, minlength=hp.num_machines)
        order.append((r, best))
    # greedy: process ranges by how peaked their overlap is
    order.sort(key=lambda x: -x[1].max())
    slots: List[List[np.ndarray]] = [[] for _ in range(hp.num_machines)]
    unplaced = []
    for r, counts in order:
        placed = False
        for m in np.argsort(-counts):
            if machine_budget[int(m)] > 0:
                slots[int(m)].append(ranges[r])
                machine_budget[int(m)] -= 1
                placed = True
                break
        if not placed:
            unplaced.append(ranges[r])
    assert not unplaced

    out: List[np.ndarray] = []
    rng = np.random.default_rng(seed)
    for m in range(hp.num_machines):
        chunks = slots[m]
        if use_level2 and hp.trainers_per_machine > 1:
            # distribute this machine's seeds across its trainers by the
            # level-2 (intra-machine) partition for intra-batch locality,
            # re-balancing to equal counts.
            allseeds = np.concatenate(chunks)
            t2 = hp.trainer_of_node[allseeds]
            buckets = [allseeds[t2 == j] for j in range(hp.trainers_per_machine)]
            # equalize: move overflow to underfull buckets
            target = len(allseeds) // hp.trainers_per_machine
            overflow = []
            for j in range(hp.trainers_per_machine):
                if len(buckets[j]) > target:
                    overflow.append(buckets[j][target:])
                    buckets[j] = buckets[j][:target]
            extra = (np.concatenate(overflow) if overflow
                     else np.empty(0, dtype=np.int64))
            ptr = 0
            for j in range(hp.trainers_per_machine):
                need = target - len(buckets[j])
                if need > 0:
                    buckets[j] = np.concatenate([buckets[j], extra[ptr:ptr + need]])
                    ptr += need
            out.extend(buckets)
        else:
            for c in chunks:
                out.append(c.copy())
    # every trainer: identical count (sync SGD), shuffled order
    counts = {len(s) for s in out}
    m = min(counts)
    out = [rng.permutation(s[:m]) for s in out]
    return out


def locality_report(hp: HierarchicalPartition,
                    trainer_seeds: List[np.ndarray]) -> dict:
    """Fraction of each trainer's seeds that are machine-local."""
    fracs = []
    for ti, seeds in enumerate(trainer_seeds):
        m = ti // hp.trainers_per_machine
        fracs.append(float((hp.machine_of_node[seeds] == m).mean()))
    return {"per_trainer_local_frac": fracs,
            "mean_local_frac": float(np.mean(fracs))}
