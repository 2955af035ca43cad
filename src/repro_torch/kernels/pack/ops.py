"""Packed one-shot device staging (the port of ``repro/kernels/pack/ops.py``).

A mini-batch tree of host arrays is packed into **one contiguous uint8
arena**, one segment per dtype, in exactly the reference's
:class:`PackSpec` layout: leaves keyed by their "/"-joined tree path,
sorted by key within each dtype segment, segments in descending-itemsize
order so every segment's byte offset is a multiple of its itemsize. The
host-side canonicalisation casts are the reference's (int64 -> int32,
uint64 -> uint32, float64 -> float32: the JAX package stages with x64
off), so :func:`pack` gives an arena byte-equal to ``repro``'s ``pack()``
for the same tree.

:func:`device_stage` fills the arena in pinned host memory, makes ONE
``non_blocking`` host-to-device copy, and unpacks on the device with
``view(dtype)`` slices at the static offsets. No arithmetic touches the
payload; the bool segment is a ``view(torch.bool)`` of its 0/1 bytes.
``device_stage(..., packed=False)`` is the reference's per-array
ablation baseline: one copy per leaf from pageable host memory, with the
same casts, so both give the same bytes on the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

SEP = "/"

# the reference's staging casts (x64 off), applied on the host while
# filling the arena so the bytes match the reference's arena
_CANON = {np.dtype(np.int64): np.dtype(np.int32),
          np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.float64): np.dtype(np.float32)}


def _canon_dtype(dt: np.dtype) -> np.dtype:
    return _CANON.get(dt, dt)


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of one packed batch: per-field (path, shape,
    dtype) plus the paths of ``None`` leaves."""

    fields: Tuple[Tuple[str, Tuple[int, ...], str], ...]
    none_paths: Tuple[str, ...] = ()

    @functools.cached_property
    def layout(self) -> Tuple[Tuple[str, Tuple[int, ...], str, int, int], ...]:
        """(path, shape, dtype, offset, size) per field; offsets count
        elements within that dtype's 1-D buffer, in sorted-path order."""
        cursor: Dict[str, int] = {}
        out = []
        for path, shape, dt in sorted(self.fields):
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            off = cursor.get(dt, 0)
            out.append((path, shape, dt, off, size))
            cursor[dt] = off + size
        return tuple(out)

    @functools.cached_property
    def buffer_sizes(self) -> Dict[str, int]:
        sizes: Dict[str, int] = {}
        for _, _, dt, off, size in self.layout:
            sizes[dt] = off + size
        return sizes

    @property
    def num_buffers(self) -> int:
        return len(self.buffer_sizes)

    @functools.cached_property
    def arena_layout(self) -> Tuple[Tuple[str, int, int], ...]:
        """(dtype, byte_offset, num_elements) per dtype segment of the
        arena, in descending-itemsize order."""
        segs = sorted(self.buffer_sizes.items(),
                      key=lambda kv: (-np.dtype(kv[0]).itemsize, kv[0]))
        out, off = [], 0
        for dt, n in segs:
            out.append((dt, off, n))
            off += n * np.dtype(dt).itemsize
        return tuple(out)

    def total_bytes(self) -> int:
        return sum(n * np.dtype(dt).itemsize
                   for dt, n in self.buffer_sizes.items())


def flatten_tree(tree: Any) -> Tuple[Dict[str, np.ndarray], Tuple[str, ...]]:
    """Nested dict/list/tuple batch -> ({path: array}, none_paths)."""
    flat: Dict[str, np.ndarray] = {}
    nones = []

    def walk(prefix: str, node: Any) -> None:
        if node is None:
            nones.append(prefix)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{SEP}{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{SEP}{i}" if prefix else str(i), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    return flat, tuple(sorted(nones))


def unflatten_tree(flat: Dict[str, Any], none_paths: Tuple[str, ...] = ()
                   ) -> Any:
    """Inverse of :func:`flatten_tree`: "/"-paths back to nested
    dicts/lists (a node whose keys are all decimal becomes a list)."""
    root: Dict[str, Any] = {}
    for path in list(flat) + list(none_paths):
        parts = path.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if path in none_paths else flat[path]

    def rebuild(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [rebuild(node[str(i)]) for i in range(len(node))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def stack_trees(trees: list, stack=np.stack) -> Any:
    """Leaf-wise ``stack`` of identically structured trees (``None`` leaves
    stay ``None``): with ``np.stack``, the host side of staging several
    batches on one leading axis; with ``torch.stack``, per-array staging's
    stack on the device."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees], stack) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_trees([t[i] for t in trees], stack)
                for i in range(len(first))]
    return stack(trees)


@functools.lru_cache(maxsize=256)
def _spec_cache(fields, none_paths) -> PackSpec:
    # padded-MFG shapes are static across a run, so every batch of a run
    # hits the same spec and its layout is computed once
    return PackSpec(fields, none_paths)


def _spec_of(flat: Dict[str, np.ndarray], none_paths) -> PackSpec:
    fields = [(path, tuple(arr.shape), _canon_dtype(arr.dtype).str)
              for path, arr in flat.items()]
    return _spec_cache(tuple(sorted(fields)), none_paths)


def _fill(spec: PackSpec, flat: Dict[str, np.ndarray],
          arena: np.ndarray) -> None:
    views = {dt: arena[boff:boff + n * np.dtype(dt).itemsize].view(dt)
             for dt, boff, n in spec.arena_layout}
    for path, shape, dt, off, size in spec.layout:
        # ravel + canonicalisation cast in one copy into the arena
        np.copyto(views[dt][off:off + size].reshape(shape), flat[path],
                  casting="unsafe")


def pack(tree: Any) -> Tuple[PackSpec, np.ndarray]:
    """Flatten a host batch into ONE contiguous uint8 arena (one segment
    per dtype, fields at static offsets within their segment)."""
    flat, none_paths = flatten_tree(tree)
    spec = _spec_of(flat, none_paths)
    arena = np.empty(spec.total_bytes(), dtype=np.uint8)
    _fill(spec, flat, arena)
    return spec, arena


def _torch_dtype(dt: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dt))).dtype


def unpack_flat(spec: PackSpec, arena: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """uint8 arena tensor -> {path: tensor}, every tensor a view into the
    arena (static byte slices, ``view(dtype)``, ``view(shape)``)."""
    bufs = {}
    for dt, boff, n in spec.arena_layout:
        nbytes = n * np.dtype(dt).itemsize
        bufs[dt] = arena[boff:boff + nbytes].view(_torch_dtype(dt))
    return {path: bufs[dt][off:off + size].view(shape)
            for path, shape, dt, off, size in spec.layout}


def unpack(spec: PackSpec, arena: torch.Tensor) -> Any:
    """uint8 arena tensor -> the original nested tree (``None`` leaves
    restored), every leaf a view into the arena."""
    return unflatten_tree(unpack_flat(spec, arena), spec.none_paths)


class PackedBatch:
    """One staged mini-batch: the spec, its uint8 arena on the device and
    the pinned host arena it was copied from (held so the asynchronous
    copy's source outlives the copy)."""

    __slots__ = ("spec", "arena", "host", "_tree")

    def __init__(self, spec: PackSpec, arena: torch.Tensor,
                 host: torch.Tensor):
        self.spec = spec
        self.arena = arena
        self.host = host
        self._tree = None

    def unpack(self) -> Any:
        if self._tree is None:
            self._tree = unpack(self.spec, self.arena)
        return self._tree

    def __getitem__(self, key: str) -> Any:
        return self.unpack()[key]

    def total_bytes(self) -> int:
        return self.spec.total_bytes()

    def to(self, device) -> "PackedBatch":
        """The batch staged on ``device`` with ONE ``non_blocking`` copy of
        the host arena; on the CPU the host arena is the staged arena."""
        device = torch.device(device)
        if device.type != "cuda":
            return PackedBatch(self.spec, self.host, self.host)
        return PackedBatch(self.spec,
                           self.host.to(device, non_blocking=True),
                           self.host)


def host_stage(tree: Any, pin: bool) -> PackedBatch:
    """Pack ``tree`` into a host arena, in pinned memory when ``pin``; the
    batch's arena is that host arena until :meth:`PackedBatch.to`."""
    flat, none_paths = flatten_tree(tree)
    spec = _spec_of(flat, none_paths)
    host = torch.empty(spec.total_bytes(), dtype=torch.uint8,
                       pin_memory=pin)
    _fill(spec, flat, host.numpy())
    return PackedBatch(spec, host, host)


def _stage_leaf(x, device: torch.device) -> torch.Tensor:
    # the staging cast makes the host copy; the card's copy is a second,
    # from pageable memory, as the reference's per-leaf device_put
    arr = np.asarray(x)
    host = torch.from_numpy(np.array(arr, dtype=_canon_dtype(arr.dtype)))
    return host.to(device)


def _map_leaves(fn, tree: Any) -> Any:
    """``fn`` over every array leaf of a nested dict/list/tuple tree,
    ``None`` leaves passed through."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def device_stage(tree: Any, device, packed: bool = True):
    """Stage ``tree`` on ``device``. ``packed=True``: pack it into a host
    arena (pinned when ``device`` is a card) and stage it with ONE
    ``non_blocking`` copy -> :class:`PackedBatch`; on the CPU the host
    arena is the staged arena. ``packed=False``: the per-array ablation
    baseline -> the same tree with one tensor per leaf, each cast as the
    arena casts it and copied on its own (``None`` leaves passed
    through)."""
    device = torch.device(device)
    if not packed:
        return _map_leaves(lambda x: _stage_leaf(x, device), tree)
    return host_stage(tree, pin=device.type == "cuda").to(device)
