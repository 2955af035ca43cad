"""The check of a run's first steps against the plain reference.

The run hands over, for its first steps, the stacked batch exactly as the
program staged it on the card (copied back to the host: every block array
of every trainer slot, and the live prefix of the feature rows), the
program's loss of each step, its AdamW first moment after step 1 and its
parameters after the last step checked. This module judges them:

1. ``decode`` works each slot's batch out again from the benchmark's own
   graph data: it identifies every feature row by its bytes among the
   generated features, and checks that each live edge of layer l is an
   edge of the graph, that each destination has min(degree, fanout_l)
   distinct sampled sources, that the seeds are training nodes with their
   own labels, never repeated within an epoch across trainers and steps,
   and that every row is the generated row. Faults are counted, and the
   limit on each count is 0.
2. ``follow`` runs the reference from the benchmark's initial weights
   through the same steps, and ``readings`` compares: each step's loss,
   the first gradient (the program's, from its first moment after step 1)
   and the parameters' change after the last step, each by the worst
   leaf, as the gap between the two norms over the reference's norm of
   that leaf or of the median leaf, whichever is larger. Leaves whose
   step-1 reference gradient is under a thousandth of the median leaf's
   are left out of the change.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List

import numpy as np
import torch

from . import model

# a leaf whose step-1 gradient norm is under this share of the median
# leaf's moves under Adam by rounding alone
ROUNDING_LEAF = 1e-3


@dataclasses.dataclass
class Decoded:
    samples: list               # per step: list of per-slot samples (numpy)
    faults: dict                # {"sample": n, "row": n, "seed": n}
    # per step and layer, summed over slots: live edges, distinct live
    # sources, distinct live destinations
    live: list


def _row_keys(rows: np.ndarray) -> np.ndarray:
    """A 64-bit key of each float32 row: its first two words."""
    w = np.ascontiguousarray(rows[:, :2]).view(np.uint32).astype(np.uint64)
    return (w[:, 0] << np.uint64(32)) | w[:, 1]


class GraphIndex:
    """Lookups into the benchmark's graph data for the check."""

    def __init__(self, data):
        self.data = data
        n = data.num_nodes
        keys = _row_keys(data.feats)
        self.key_order = np.argsort(keys, kind="stable")
        self.sorted_keys = keys[self.key_order]
        if np.any(self.sorted_keys[1:] == self.sorted_keys[:-1]):
            raise ValueError("two feature rows share a key: draw again")
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
        self.edge_keys = src * n + data.indices       # sorted ascending
        self.degree = np.diff(data.indptr)

    def identify(self, rows: np.ndarray) -> tuple:
        """(node id of each row or -1, number of rows that are not a
        generated row byte for byte)."""
        keys = _row_keys(rows)
        at = np.searchsorted(self.sorted_keys, keys)
        at = np.minimum(at, len(self.sorted_keys) - 1)
        found = self.sorted_keys[at] == keys
        ids = np.where(found, self.key_order[at], -1)
        same = found & np.all(
            rows == self.data.feats[np.maximum(ids, 0)], axis=1)
        return np.where(same, ids, -1), int((~same).sum())

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        keys = u * self.data.num_nodes + v
        at = np.minimum(np.searchsorted(self.edge_keys, keys),
                        len(self.edge_keys) - 1)
        return self.edge_keys[at] == keys


def decode(index: GraphIndex, steps: list, fanouts: list,
           batch_size: int) -> Decoded:
    """Judge the captured steps. ``steps[k]`` = {"epoch", "seed_mask" (S,
    B), "labels" (S, B), "blocks": [{"edge_src", "edge_dst",
    "edge_mask"} (S, E_l)], "feats": [(rows, F) per slot]}."""
    faults = {"sample": 0, "row": 0, "seed": 0}
    out, live = [], []
    seen = {}                    # epoch -> seed ids taken in that epoch
    data = index.data
    for st in steps:
        slots = []
        num_layers = len(st["blocks"])
        step_live = [[0, 0, 0] for _ in range(num_layers)]
        for s in range(st["seed_mask"].shape[0]):
            mask = st["seed_mask"][s]
            n_seeds = int(mask.sum())
            if n_seeds != batch_size or not mask[:n_seeds].all():
                faults["seed"] += 1
            # live counts, from the top layer down
            layers = [None] * num_layers
            n_dst = n_seeds
            for l in range(num_layers - 1, -1, -1):
                b = st["blocks"][l]
                m = b["edge_mask"][s].astype(bool)
                es = b["edge_src"][s][m].astype(np.int64)
                ed = b["edge_dst"][s][m].astype(np.int64)
                if len(ed) and (ed.min() < 0 or ed.max() >= n_dst
                                or es.min() < 0):
                    faults["sample"] += 1
                    es, ed = es[:0], ed[:0]
                n_src = max(n_dst, int(es.max()) + 1 if len(es) else 0)
                layers[l] = {"src": es, "dst": ed, "n_dst": n_dst,
                             "n_src": n_src}
                n_dst = n_src
            rows = st["feats"][s]
            if rows.shape[0] < n_dst:
                faults["row"] += n_dst - rows.shape[0]
            ids, bad = index.identify(rows[:n_dst])
            faults["row"] += bad
            ids = np.concatenate([ids, np.full(n_dst - len(ids), -1)])
            if len(np.unique(ids[ids >= 0])) != int((ids >= 0).sum()):
                faults["sample"] += 1     # a node twice among the sources
            for l, blk in enumerate(layers):
                es, ed = blk["src"], blk["dst"]
                u, v = ids[es], ids[ed]
                ok = (u >= 0) & (v >= 0)
                ok[ok] = index.has_edges(v[ok], u[ok])
                faults["sample"] += int((~ok).sum())
                pair = ed * blk["n_src"] + es
                faults["sample"] += len(pair) - len(np.unique(pair))
                want = np.minimum(
                    index.degree[np.maximum(ids[:blk["n_dst"]], 0)],
                    int(fanouts[l]))
                got = np.bincount(ed, minlength=blk["n_dst"])
                faults["sample"] += int((got != want).sum())
                step_live[l][0] += len(es)
                step_live[l][1] += len(np.unique(es))
                step_live[l][2] += len(np.unique(ed))
            seeds = ids[:n_seeds]
            labels = st["labels"][s][:n_seeds].astype(np.int64)
            good = seeds >= 0
            faults["seed"] += int((~good).sum())
            faults["seed"] += int((data.split_mask[seeds[good]] != 1).sum())
            faults["seed"] += int((data.labels[seeds[good]]
                                    != labels[good]).sum())
            seen.setdefault(st["epoch"], []).append(seeds[good])
            slots.append({"feats": data.feats[np.maximum(ids, 0)],
                          "layers": [{"src": b["src"], "dst": b["dst"],
                                      "n_dst": b["n_dst"]} for b in layers],
                          "labels": data.labels[np.maximum(seeds, 0)]})
        out.append(slots)
        live.append(step_live)
    for taken in seen.values():
        allseeds = np.concatenate(taken)
        faults["seed"] += len(allseeds) - len(np.unique(allseeds))
    return Decoded(out, faults, live)


def to_device(samples: list, device) -> list:
    return [{"feats": torch.as_tensor(s["feats"], device=device),
             "layers": [{"src": torch.as_tensor(b["src"], device=device),
                         "dst": torch.as_tensor(b["dst"], device=device),
                         "n_dst": b["n_dst"]} for b in s["layers"]],
             "labels": torch.as_tensor(s["labels"], device=device)}
            for s in samples]


@dataclasses.dataclass
class Followed:
    losses: List[float]
    grad1: dict                 # path -> step-1 gradient norm per leaf
    change: dict                # path -> norm of the change after the steps


def _norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(t.double()))
            for p, t in model.leaves(tree)}


def follow(arch: str, params0, decoded: Decoded, opt_cfg: dict, device,
           precision: str = "float32", slots=None) -> Followed:
    """The reference from ``params0`` through every decoded step, its
    sums in a fixed order (PyTorch's deterministic algorithms)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = model.tree_map(lambda p: torch.as_tensor(p, device=device)
                            .float().clone(), params0)
    start = model.tree_map(torch.clone, params)
    opt = model.AdamW(params, float(opt_cfg["lr"]),
                      tuple(opt_cfg["betas"]), float(opt_cfg["eps"]),
                      float(opt_cfg["weight_decay"]))
    losses, grad1 = [], None
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for step in decoded.samples:
            samples = to_device(step, device)
            loss, grads = model.loss_and_grads(arch, params, samples,
                                               precision, slots)
            losses.append(float(loss))
            if grad1 is None:
                grad1 = _norms(grads)
            params = opt.step(params, grads)
            del samples, grads
    finally:
        torch.use_deterministic_algorithms(was)
    change = _norms(model.tree_map(lambda a, b: a - b, params, start))
    return Followed(losses, grad1, change)


def program_side(losses, moment1, params_end, params0, beta1) -> Followed:
    """The program's readings: its step losses, its first gradient worked
    out from AdamW's first moment after step 1 (m_1 = (1 - beta1) g_1),
    and its parameters' change."""
    grad1 = {p: float(torch.linalg.vector_norm(t.double())) / (1 - beta1)
             for p, t in model.leaves(moment1)}
    start = dict(model.leaves(params0))
    change = {p: float(torch.linalg.vector_norm(
        t.double() - torch.as_tensor(start[p]).to(t.device).double()))
        for p, t in model.leaves(params_end)}
    return Followed(list(losses), grad1, change)


def _leaf_gaps(got: dict, want: dict, keep=None) -> list:
    """Each leaf's gap between the two norms, over the reference's norm of
    the leaf or of the median leaf, whichever is larger."""
    keys = [k for k in want if keep is None or k in keep]
    if set(got) != set(want):
        return [float("inf")]
    if not keys:
        return [0.0]
    floor = statistics.median(want[k] for k in keys)
    return [abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in keys]


def readings(got: Followed, ref: Followed) -> dict:
    """The numbers a run can compare (the limits file of a cell says
    which it does, and section 4 of PERF.md why): ``loss1_gap``, the
    first step's loss; ``loss_gap``, the worst step's; ``grad_gap``, the
    first gradient by the worst leaf; ``change_gap`` and
    ``change_med_gap``, the change after the steps by the worst and by
    the median leaf. Leaves whose step-1 reference gradient is under
    ``ROUNDING_LEAF`` of the median leaf's are left out of the change."""
    steps = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    if len(got.losses) != len(ref.losses) or not steps:
        steps = [float("inf")]
    floor = statistics.median(ref.grad1.values())
    moved = {k for k, v in ref.grad1.items() if v >= ROUNDING_LEAF * floor}
    change = _leaf_gaps(got.change, ref.change, moved)
    return {"loss1_gap": steps[0], "loss_gap": max(steps),
            "grad_gap": max(_leaf_gaps(got.grad1, ref.grad1)),
            "change_gap": max(change),
            "change_med_gap": statistics.median(change)}


def judge(values: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN never is)."""
    return all(values[k] <= limits[k] for k in limits)


def order_checks(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the limits' order."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}
