"""The benchmark's own seed streams, and the model's initial weights drawn
from ``--seed``. The graph's plug-in (``gnnbench/graphs/``) draws the
graph, its features, labels and training split from the streams here.
"""
from __future__ import annotations

import math

import numpy as np

# sub-streams of one run's seed
GRAPH, FEATS, LABELS, SPLIT, JOB, WEIGHTS = range(6)


def substream(seed: int, which: int) -> np.random.SeedSequence:
    """The independent key of one consumer of a run's seed (any whole
    number, negative or past 64 bits included)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             int(seed < 0)]
    return np.random.SeedSequence(words).spawn(6)[which]


def seed31(seed: int, which: int) -> int:
    """A non-negative seed under 2**31 for a consumer that takes an int."""
    return int(substream(seed, which).generate_state(1)[0] >> 1)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make_weights(arch, model_cfg: dict, seed: int, device) -> dict:
    """Glorot-uniform weights (limits sqrt(6 / (fan_in + fan_out)) from
    the first and last axes) and zero biases, drawn on ``device`` from the
    seed in one call, in float32, in the shapes and leaf order of the
    architecture's plug-in ``arch`` (``arch.weight_shapes``)."""
    import torch

    shapes = arch.weight_shapes(model_cfg)
    leaves = [(p, s) for p, s in _leaves(shapes) if len(s) > 1]
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed31(seed, WEIGHTS))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32)
    tree = _structure(shapes)
    at = 0
    for path, shape in leaves:
        k = math.prod(shape)
        lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
        _set(tree, path, (flat[at:at + k].view(shape) * 2 - 1) * lim)
        at += k
    for path, shape in _leaves(shapes):
        if len(shape) == 1:
            _set(tree, path, torch.zeros(shape, device=device))
    return tree


def _structure(shapes):
    if isinstance(shapes, dict):
        return {k: _structure(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_structure(v) for v in shapes]
    return None
