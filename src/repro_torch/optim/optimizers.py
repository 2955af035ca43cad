"""Dense optimizers, the port of ``repro/optim/optimizers.py``: AdamW,
global-norm clipping and SGD as plain functions on trees (dicts and lists)
of tensors.

Dense parameters take the synchronous all-reduce + optimizer path (§5.6).
The update is the reference's formula, not ``torch.optim.AdamW``'s: an
int32 ``step``, ``t`` and the bias corrections in float32,
``mhat / (sqrt(vhat) + eps)``, weight decay inside the ``lr`` product, and
float32 moments whatever the parameters' type.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any
    nu: Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of identically structured trees of dicts and
    lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    # moments in f32 regardless of (possibly bf16) param dtype
    def f32_zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(tree_leaves(params))).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(f32_zeros, params),
                      nu=tree_map(f32_zeros, params))


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """One AdamW step -> (new params, new state); nothing is updated in
    place."""
    step = state.step + 1
    t = step.to(torch.float32)
    mu = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g.to(torch.float32),
                  state.mu, grads)
    nu = tree_map(lambda v, g: beta2 * v + (1 - beta2) *
                  g.to(torch.float32) * g.to(torch.float32),
                  state.nu, grads)
    bc1 = 1 - torch.pow(beta1, t)
    bc2 = 1 - torch.pow(beta2, t)

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = lr * (mhat / (torch.sqrt(vhat) + eps) +
                      weight_decay * p.to(torch.float32))
        return (p.to(torch.float32) - delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu)


def _sorted_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree.leaves``' order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def global_norm(grads) -> torch.Tensor:
    """The float32 L2 norm of every leaf, the leaves' squared sums added
    in the reference's leaf order."""
    total = 0
    for g in _sorted_leaves(grads):
        total = total + torch.sum(g.to(torch.float32) ** 2)
    return torch.sqrt(total)


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The float32 factor that takes a global norm ``gn`` to at most
    ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, the norm
    before). The scaled leaves are float32 whatever the gradients' type:
    the reference multiplies by a float32 array, and JAX promotes a
    bfloat16 gradient to float32 there (torch would keep bfloat16)."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


@torch.no_grad()
def sgd_update(params, grads, *, lr: float, momentum_state=None,
               momentum: float = 0.0):
    """-> (new params, new momentum state); heavy-ball momentum when
    ``momentum`` and a state are given."""
    if momentum and momentum_state is not None:
        momentum_state = tree_map(lambda b, g: momentum * b + g,
                                  momentum_state, grads)
        grads = momentum_state
    return tree_map(lambda p, g: p - lr * g, params, grads), momentum_state
