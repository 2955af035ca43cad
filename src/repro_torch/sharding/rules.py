"""Sharding rules: logical-axis -> mesh-axis mapping and parameter specs;
the port of ``repro.sharding.rules``.

The production mesh is ("data", "model") per pod, with an optional leading
"pod" axis (see ``launch/mesh.py``). The batch dimension shards over
("pod","data"); Megatron-style tensor parallelism shards attention heads /
FFN columns over "model"; configs with ``fsdp=True`` additionally shard the
other weight dim over "data" (ZeRO-3 / weight-gathered FSDP).

A spec is a plain tuple with one entry a dimension, each ``None``, a mesh
axis name or a tuple of names: the contents of the reference's
``PartitionSpec``, normalised as it is (a one-name tuple is the name).
:func:`placements` turns it into DTensor placements on a mesh. Parameter
specs are derived *by path name* from the parameter tree, so model code
stays free of sharding concerns; activation constraint points call
:func:`maybe_constrain`, the identity unless a mesh is active (made so by
``launch.mesh.use_mesh``) and the tensor is a DTensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


@dataclasses.dataclass
class AxisRules:
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    model_axis: str = "model"
    fsdp_axis: Optional[str] = "data"
    model_axis_size: int = 16                 # for divisibility checks
    seq_shard_activations: bool = True        # Megatron sequence parallelism
    # pure_fsdp: ZeRO-3 data parallelism — batch over ALL mesh axes, weights
    # sharded on one dim and gathered per layer, no tensor parallelism.
    pure_fsdp: bool = False
    # axes params shard over in pure_fsdp mode (defaults to batch_axes);
    # multi-pod uses all three axes for params while batch spans (pod,data)
    fsdp_param_axes: Optional[Tuple[str, ...]] = None


_RULES = AxisRules()
_MESH = None


def set_rules(rules: AxisRules) -> None:
    global _RULES
    _RULES = rules


def current_rules() -> AxisRules:
    return _RULES


def spec(*entries) -> tuple:
    """A spec from ``PartitionSpec``'s arguments, normalised as it
    normalises them: a one-name tuple becomes the name."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else (tuple(e) if isinstance(e, list) else e)
                 for e in entries)


def batch_spec(*trailing) -> tuple:
    """The spec with the batch dim sharded over the batch axes."""
    return spec(_RULES.batch_axes, *trailing)


def _active_mesh():
    """The mesh that ``launch.mesh.use_mesh`` made active, or ``None``."""
    return _MESH


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` the one :func:`maybe_constrain` and ``moe_block``
    see, for the duration of the block. The parameter, cache and
    activation specs divide by ``AXIS_SIZES``, so it must give the mesh's
    sizes: a mesh of other sizes raises."""
    global _MESH
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names)
        have = {a: mesh.size(i) for i, a in enumerate(names)}
        want = {a: AXIS_SIZES.get(a, 1) for a in names}
        if have != want:
            raise ValueError(f"the mesh's axes {have} disagree with "
                             f"AXIS_SIZES {want}: set AXIS_SIZES to the "
                             f"mesh's sizes")
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec_: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` for ``spec_``: mesh dimension ``i``
    is ``Shard(d)`` when the spec's entry for tensor dim ``d`` names it,
    else ``Replicate()``. A dim sharded over several axes, such as
    ("pod", "data"), is ``Shard(d)`` on each, and DTensor splits it
    major-to-minor in mesh order, as JAX splits it in the entry's order:
    so the entry must list the axes in mesh order."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec_):
        axes = _names(entry)
        pos = [names.index(a) if a in names else -1 for a in axes]
        if -1 in pos:
            raise ValueError(f"spec {spec_} names an axis not in the mesh "
                             f"{names}")
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in pos:
            out[i] = Shard(d)
    return tuple(out)


def is_split(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor whose dim ``dim`` is split over a mesh
    dimension of more than one rank."""
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim
        and x.device_mesh.size(i) > 1 for i, p in enumerate(x.placements))


def fit(spec_: tuple, shape) -> tuple:
    """``spec_`` with every entry whose axes do not divide its dim
    dropped (per ``AXIS_SIZES``): a shard body's shards must be even."""
    return spec(*(e if e is None or shape[d] % _axis_size(e) == 0 else None
                  for d, e in enumerate(spec_)))


def maybe_constrain(x, spec: tuple):
    """``x`` redistributed to ``spec`` if a mesh is active and ``x`` is a
    DTensor, else ``x``: the reference's ``with_sharding_constraint``
    points. (The parameter keeps the reference's name and shadows the
    module's :func:`spec` here, which the body never calls.)"""
    mesh = _active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# parameter specs by path
# ---------------------------------------------------------------------------

AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _axis_size(ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= AXIS_SIZES.get(a, 1)
        return n
    return AXIS_SIZES.get(ax, 1)


def _spec_for(path: str, shape: tuple, fsdp: bool, rules: AxisRules
              ) -> tuple:
    if rules.pure_fsdp:
        return _spec_pure_fsdp(shape, rules)
    m = rules.model_axis
    f = rules.fsdp_axis if fsdp else None
    ndim = len(shape)

    def pad(spec_tail):
        """Left-pad with None for stacked leading dims, then drop any mesh
        axis that doesn't divide its dimension."""
        tail = list(spec_tail)
        if len(tail) > ndim:
            tail = tail[-ndim:]
        full = [None] * (ndim - len(tail)) + tail
        out = []
        for dim, ax in zip(shape, full):
            if ax is None:
                out.append(None)
            else:
                out.append(ax if dim % _axis_size(ax) == 0 else None)
        return spec(*out)

    if re.search(r"experts_gate|experts_up|experts_down", path):
        # (L, E, a, b): experts over model when divisible, else the
        # per-expert ff dim; the other big dim gets fsdp
        e = shape[-3]
        ff_axis = -1 if "down" not in path else -2
        s = [None] * ndim
        if e % AXIS_SIZES[m] == 0:
            s[-3] = m
            if f and shape[ff_axis] % _axis_size(f) == 0:
                s[ff_axis] = f
        elif shape[ff_axis] % AXIS_SIZES[m] == 0:
            s[ff_axis] = m
        return spec(*s)

    # order matters: first match wins
    table = [
        (r"embed",               (m, None)),          # (vocab, d)
        (r"lm_head",             (None, m)),          # (d, vocab)
        (r"router",              (None, None)),
        (r"\bwq\b|\bwk\b|\bwv\b|wqkv", (f, m)),
        (r"\bwo\b",              (m, f)),
        (r"w_gateup",            (f, None, m)),
        (r"w_gate|w_up",         (f, m)),
        (r"w_down",              (m, f)),
        (r"in_proj",             (f, m)),
        (r"out_proj",            (m, f)),
        (r"bc_proj",             (f, None)),
        (r"conv_bc",             None),
        (r"conv_w",              (None, m)),
        (r"conv_b$",             (m,)),
        (r"(\b|_)b(q|k|v|o)?\b|bias|norm|scale|a_log|\bD\b|dt_bias", None),
    ]
    for pat, tail in table:
        if re.search(pat, path):
            return () if tail is None else pad(tail)
    return ()   # default: replicated


def _spec_pure_fsdp(shape: tuple, rules: AxisRules) -> tuple:
    """ZeRO-3: shard the first dividing dim (skipping the stack dim for
    ndim>=3) over the fsdp param axes; everything else replicated."""
    axes = rules.fsdp_param_axes or rules.batch_axes
    total = _axis_size(axes)
    ndim = len(shape)
    if ndim < 2:
        return ()
    start = 1 if ndim >= 3 else 0
    s = [None] * ndim
    for i in range(start, ndim):
        if shape[i] % total == 0:
            s[i] = axes
            break
    return spec(*s)


def _paths(tree, prefix=()):
    """(path, leaf) pairs, the path in ``jax.tree_util``'s key strings:
    ``['name']`` for a dict key, ``[i]`` for a list index."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (f"['{k}']",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (f"[{i}]",))
    else:
        yield "/".join(prefix), tree


def param_pspecs(params, fsdp: bool = False,
                 rules: Optional[AxisRules] = None):
    """Mirror ``params`` (a tree of dicts of tensors, or of anything with
    a ``shape``) with a spec a leaf, derived from its path."""
    rules = rules or _RULES
    specs = {p: _spec_for(p.lower(), tuple(getattr(leaf, "shape", ())),
                          fsdp, rules)
             for p, leaf in _paths(params)}
    it = iter(specs.values())

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [rebuild(v) for v in tree]
        return next(it)
    return rebuild(params)


def distribute(tree, specs, mesh):
    """Every leaf of ``tree`` as a DTensor on ``mesh``, placed by its spec
    in ``specs`` (same structure; a leaf that already is a DTensor is
    redistributed)."""
    def one(t, s):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements(s, mesh))
        return distribute_tensor(t, mesh, placements(s, mesh))

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, s[i]) for i, v in enumerate(t)]
        return one(t, s)
    return walk(tree, specs)


def _shard_counts(x) -> dict:
    """tensor dim -> the product of the mesh sizes that shard it."""
    out = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            out[p.dim] = out.get(p.dim, 1) * x.device_mesh.size(i)
    return out


def reshape(x, *shape):
    """``x.reshape(*shape)``. On a DTensor, first replicate every mesh dim
    that shards a dim the reshape rewrites, unless it shards the first dim
    of that group and the group's first new dim still divides evenly:
    DTensor can carry a shard through such a split or merge and no
    other (the reference's GSPMD reshards the same places)."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    old = tuple(x.shape)
    known = math.prod(n for n in shape if n != -1)
    new = tuple(math.prod(old) // known if n == -1 else n for n in shape)
    k = 0
    while k < min(len(old), len(new)) and old[k] == new[k]:
        k += 1
    counts = _shard_counts(x)
    pl = list(x.placements)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim >= k:
            if not (p.dim == k and k < len(new) and new[k] % counts[k] == 0
                    and old[k] % counts[k] == 0):
                pl[i] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    y = x.reshape(*new)
    # the gradient comes back placed as y is (replicated where y is a
    # partial sum), so that the reshape's backward (the inverse reshape)
    # sees a layout it can take
    return _PlaceGrad.apply(y, tuple(
        Replicate() if p.is_partial() else p for p in y.placements))


class _PlaceGrad(torch.autograd.Function):
    """The identity on a DTensor, whose backward redistributes the
    gradient to the placements given."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.mesh, ctx.pl = x.device_mesh, pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(ctx.mesh, ctx.pl)
        return g, None


def local_call(fn, in_specs: tuple, out_specs, *args):
    """``fn(*args)`` on each rank's local shards, as under ``shard_map``:
    where a mesh is active and an argument is a DTensor, every tensor
    argument is constrained to its entry of ``in_specs`` (``None``: not a
    tensor, passed as it is) and ``fn`` runs under DTensor's
    ``local_map``, its outputs placed by ``out_specs`` (a spec, or a list
    of specs for a tuple of outputs). Otherwise ``fn(*args)``.

    Gradients follow ``shard_map``'s transpose: an output's cotangent is
    divided by the size of the axes it is replicated over, and an input's
    gradient is summed over the axes it is replicated over (``Partial``),
    so that a body written with :mod:`.collectives` (whose ``psum``
    transposes to ``psum``) differentiates as the reference's does."""
    mesh = _active_mesh()
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    args = list(args)
    in_pl, grad_pl = [], []
    for i, (a, s) in enumerate(zip(args, in_specs)):
        if s is None:
            in_pl.append(None)
            grad_pl.append(None)
            continue
        pl = placements(s, mesh)
        for d, e in enumerate(s):
            n = 1
            for ax in _names(e):
                n *= mesh[ax].size()
            if a.shape[d] % n:
                raise ValueError(f"local_call: dim {d} of {tuple(a.shape)} "
                                 f"does not divide over {e}")
        if not isinstance(a, DTensor):
            a = distribute_tensor(a, mesh, pl)
        args[i] = maybe_constrain(a, s)
        in_pl.append(list(pl))
        grad_pl.append([Partial() if isinstance(q, Replicate) else q
                        for q in pl])
    many = isinstance(out_specs, list)
    out_pl = [list(placements(s, mesh))
              for s in (out_specs if many else [out_specs])]
    shrink = []
    for pl in out_pl:
        n = 1
        for i, q in enumerate(pl):
            if isinstance(q, Replicate):
                n *= mesh.size(i)
        shrink.append(n)

    def body(*local):
        outs = fn(*local)
        outs = list(outs) if many else [outs]
        outs = [_ScaleGrad.apply(o, 1.0 / n)
                if n > 1 and isinstance(o, torch.Tensor) and o.requires_grad
                else o for o, n in zip(outs, shrink)]
        return tuple(outs) if many else outs[0]
    return local_map(body, out_placements=tuple(out_pl) if many
                     else out_pl[0], in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*args)


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def mm(x, w):
    """``x @ w``. A DTensor activation (B, S, ..., K) first has its
    sequence gathered (the batch stays over the batch axes, K as it is
    placed), as GSPMD gathers a sequence-parallel activation before a
    block's product: DTensor cannot fold a batch and a sequence that are
    both sharded into the product's rows. A K sharded over "model" (the
    heads into ``wo``, the FFN columns into ``w_down``) stays so: each
    rank multiplies its columns by its rows of ``w`` into a partial sum,
    and its share of ``w``'s gradient is its own columns' product. The
    product's gradient comes back placed as the product is (replicated
    where it is a partial sum), as GSPMD places a cotangent like its
    primal."""
    if not isinstance(x, DTensor):
        return x @ w
    if x.ndim >= 3:
        k = spec_of(x)[-1]
        if set(_names(k)) & set(_names(_RULES.batch_axes)):
            k = None
        x = maybe_constrain(x, fit(batch_spec(*([None] * (x.ndim - 2)),
                                           k), x.shape))
    y = x @ w
    return _PlaceGrad.apply(y, tuple(
        Replicate() if p.is_partial() else p for p in y.placements))


# ---------------------------------------------------------------------------
# serve-cache and batch specs
# ---------------------------------------------------------------------------

def cache_pspecs(cfg, cache, batch: int, rules: AxisRules):
    """Specs for the serve cache (a dict of tensors and ``pos``).

    Input shardings must divide evenly, so axes are chosen greedily:
    batch over the batch axes when divisible (else the ring/seq dim over
    "data"); "model" goes to the kv-head dim when divisible, else to
    head_dim, else nowhere."""
    ba = rules.batch_axes
    m = rules.model_axis
    dsize = 32 if len(ba) == 2 else 16     # ("pod","data") = 2*16
    msize = 16

    def div(x, n):
        return x % n == 0

    def spec_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if name in ("k", "v", "xk", "xv"):
            # (L|ns, B, W, KV, hd)
            bspec = ba if div(shape[1], dsize) else None
            wspec = "data" if bspec is None and div(shape[2], 16) else None
            kvspec = m if div(shape[3], msize) else None
            hdspec = m if kvspec is None and div(shape[4], msize) else None
            return spec(None, bspec, wspec, kvspec, hdspec)
        if name in ("ssm", "tail_ssm"):
            # (..., B, H, P, N)
            lead = [None] * (nd - 4)
            bspec = ba if div(shape[nd - 4], dsize) else None
            hspec = m if div(shape[nd - 3], msize) else None
            return spec(*lead, bspec, hspec, None, None)
        if name in ("conv", "tail_conv"):
            lead = [None] * (nd - 3)
            bspec = ba if div(shape[nd - 3], dsize) else None
            return spec(*lead, bspec, None, None)
        return ()

    return {k: spec_for(k, v) for k, v in cache.items()}


def batch_pspecs(batch: dict, rules: AxisRules) -> dict:
    """The batch dim of every entry over the batch axes."""
    ba = rules.batch_axes
    return {k: spec(ba, *([None] * (len(v.shape) - 1)))
            for k, v in batch.items()}


def spec_of(x) -> tuple:
    """The spec of a DTensor's placements (the inverse of
    :func:`placements`; ``Partial`` dims read as unsharded)."""
    names = x.device_mesh.mesh_dim_names
    entries = [[] for _ in range(x.ndim)]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(names[i])
    return spec(*(None if not e else tuple(e) for e in entries))
