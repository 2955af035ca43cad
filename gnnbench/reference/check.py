"""The check of a run's first steps against the plain reference.

The run hands over, for its first steps, the stacked batch exactly as the
program staged it on the card (copied back to the host: every block array
of every trainer slot, and the live prefix of the feature rows), the
program's loss of each step, its AdamW first moment after step 1 and its
parameters after the last step checked. This module judges them:

1. The graph's plug-in's ``decode`` (``gnnbench/graphs/``) works each
   slot's batch out again from the benchmark's own graph data and counts
   the faults it finds (sampling, rows, seeds; the limit on each count is
   0) into a :class:`Decoded`.
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


def to_device(samples: list, device) -> list:
    """Decoded samples as tensors on ``device``: the features, the labels
    and every array of every layer (its count ``n_dst`` kept as is)."""
    def tensor(v):
        return torch.as_tensor(v, device=device) \
            if isinstance(v, np.ndarray) else v
    return [{"feats": tensor(s["feats"]),
             "layers": [{k: tensor(v) for k, v in b.items()}
                        for b in s["layers"]],
             "labels": tensor(s["labels"])}
            for s in samples]


@dataclasses.dataclass
class Followed:
    losses: List[float]
    grad1: dict                 # path -> step-1 gradient norm per leaf
    change: dict                # path -> norm of the change after the steps


def _norms(tree) -> dict:
    return {p: float(torch.linalg.vector_norm(t.double()))
            for p, t in model.leaves(tree)}


def follow(forward, params0, decoded: Decoded, opt_cfg: dict, device,
           precision: str = "float32", slots=None) -> Followed:
    """The reference (``forward``, an architecture plug-in's) from
    ``params0`` through every decoded step, its sums in a fixed order
    (PyTorch's deterministic algorithms)."""
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
            loss, grads = model.loss_and_grads(forward, params, samples,
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
