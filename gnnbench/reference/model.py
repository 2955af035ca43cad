"""The shared pieces of the plain float32 reference: the sample format,
the TF32 control, the aggregations the architectures' plug-ins
(``gnnbench/archs/``) build their ``forward`` from, the
node-classification loss, and AdamW.

A sample is one trainer's batch of one step, compacted to its live nodes
and edges:

    {"feats": (n_src[0], F) float32,
     "layers": [{"src": (E,) int64, "dst": (E,) int64, "n_dst": int,
                 ...}, ...],
     "labels": (n_seeds,) int64}

with the input layer first, the destinations of every layer a prefix of
its sources, and layer l's sources layer l-1's destinations. A layer may
carry more arrays of its edges (a typed graph's relation of each edge),
as the graph's plug-in decodes them. The loss is each trainer's mean
cross-entropy over its seeds, averaged over the trainers (synchronous
data parallelism).

``precision="tf32"`` rounds both operands of every matrix product,
forward and backward, to TF32 (10 mantissa bits, to nearest even) and
accumulates in float32, which is what a TF32 tensor-core product does:
the control of the correctness check.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).t(), tf32_round(a).t() @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    return a @ b


def mean_aggregate(h, src, dst, n_dst):
    """The mean of each destination's source rows (0 with no edge)."""
    deg = torch.zeros(n_dst, dtype=h.dtype, device=h.device).index_add_(
        0, dst, torch.ones_like(dst, dtype=h.dtype))
    agg = torch.zeros((n_dst, h.shape[1]), dtype=h.dtype,
                      device=h.device).index_add_(0, dst, h[src])
    return agg / deg.clamp_min(1.0)[:, None]


def edge_softmax(scores, dst, n_dst):
    """(E, H) scores -> their softmax over each destination's in-edges."""
    heads = scores.shape[1]
    m = torch.full((n_dst, heads), -math.inf, dtype=scores.dtype,
                   device=scores.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, heads), scores, "amax",
                         include_self=True)
    ex = torch.exp(scores - m[dst])
    z = torch.zeros((n_dst, heads), dtype=scores.dtype,
                    device=scores.device).index_add_(0, dst, ex)
    return ex / z[dst]


def step_loss(forward, params, samples, precision="float32",
              slots=None) -> torch.Tensor:
    """The mean over trainers (``slots``: the ones taken; all by default)
    of each trainer's mean cross-entropy over its seeds, ``forward``
    giving each sample's logits (an architecture's plug-in's)."""
    slots = range(len(samples)) if slots is None else slots
    losses = [F.cross_entropy(forward(params, samples[s], precision),
                              samples[s]["labels"]) for s in slots]
    return torch.stack(losses).mean()


def leaves(tree, path=()):
    """(path, tensor) pairs of a tree of dicts and lists, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def loss_and_grads(forward, params, samples, precision="float32",
                   slots=None):
    """(loss, gradient tree) at ``params``."""
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss = step_loss(forward, live, samples, precision, slots)
    paths = [p for p, _ in leaves(live)]
    grads = torch.autograd.grad(loss, [t for _, t in leaves(live)])
    by_path = dict(zip(paths, grads))
    out = tree_map(lambda p: None, params)

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree[k]
        tree[path[-1]] = value
    for path, g in by_path.items():
        put(out, path, g)
    return loss.detach(), out


class AdamW:
    """AdamW with bias correction: m = b1 m + (1 - b1) g,
    v = b2 v + (1 - b2) g^2, p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""

    def __init__(self, params, lr, betas, eps, weight_decay):
        self.lr, self.eps, self.wd = lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.t = 0
        self.m = tree_map(torch.zeros_like, params)
        self.v = tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        self.m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g,
                          self.m, grads)
        self.v = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g,
                          self.v, grads)
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        return tree_map(
            lambda p, m, v: p - self.lr * ((m / c1) / (torch.sqrt(v / c2)
                                                      + self.eps)
                                           + self.wd * p),
            params, self.m, self.v)
