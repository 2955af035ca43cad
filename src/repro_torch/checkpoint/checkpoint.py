"""Checkpointing, the port of ``repro/checkpoint/checkpoint.py``: trees
of tensors (dense model/optimizer state), KVStore shards (features +
sparse embeddings + their optimizer rows + row versions) and trainer-side
feature-cache snapshots.

Each leaf goes to an .npy file, the tree structure and leaf paths to a
JSON manifest, with the reference's path strings (``['key']`` for a dict
entry, ``[i]`` for a list item, ``.name`` for a named-tuple field). A
tensor on the card is saved from a host copy and restored onto the
template's device. KVStore checkpoints are per-server (per machine) — on a
real cluster each host writes only its own shard, which is what makes
checkpointing billion-node embedding tables feasible. The KVStore and
cache parts are NumPy and write the same files as the reference.

Restores are strict (DESIGN.md §10): a checkpoint that does not match its
template — missing leaves, extra leaves, shape or dtype drift — raises
instead of silently coercing. ``load_pytree(cast=True)`` is the explicit
escape hatch for intentional dtype migration; it is the ONLY path that
loses bits.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, List

import numpy as np
import torch

from ..optim.optimizers import tree_leaves


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree: Any, prefix: str = "") -> List[str]:
    """The path of every leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, f"{prefix}/[{k!r}]")]
    if _is_namedtuple(tree):
        return [p for k, v in zip(tree._fields, tree)
                for p in _paths(v, f"{prefix}/.{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/[{i}]")]
    return [prefix[1:]]


def _rebuild(template: Any, leaves: Iterator) -> Any:
    """``template``'s structure (dicts, lists, tuples, named tuples) with
    its leaves taken in order from ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves) for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_rebuild(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def _flatten_with_paths(tree: Any):
    leaves = tree_leaves(tree)
    paths = _paths(tree)
    assert len(paths) == len(leaves), (len(paths), len(leaves))
    return paths, leaves


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree: Any, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    manifest = []
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(directory, fname), _host(leaf))
        manifest.append({"path": p, "file": fname})
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_pytree(template: Any, directory: str, *, cast: bool = False) -> Any:
    """Load a :func:`save_pytree` checkpoint into ``template``'s structure.

    Every template leaf must have a checkpointed counterpart (same path)
    with the same shape AND dtype. ``cast=True`` opts into coercion for
    dtype mismatches (shape mismatches always raise). Leaves in the
    checkpoint but not the template raise too: a byte-exact recovery
    cannot ignore state it does not know how to restore. A tensor leaf is
    restored as a tensor on the template leaf's device, any other leaf as
    a NumPy array.
    """
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    paths, leaves = _flatten_with_paths(template)
    by_path = {m["path"]: m["file"] for m in manifest}
    extra = sorted(set(by_path) - set(paths))
    if extra:
        raise KeyError(f"checkpoint has {len(extra)} leaves the template "
                       f"does not: {extra[:5]}")
    new_leaves = []
    for p, leaf in zip(paths, leaves):
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p!r}")
        arr = np.load(os.path.join(directory, by_path[p]))
        is_tensor = isinstance(leaf, torch.Tensor)
        shape = tuple(leaf.shape) if is_tensor else np.asarray(leaf).shape
        if arr.shape != shape:
            raise ValueError(f"leaf {p!r}: checkpoint shape {arr.shape} != "
                             f"template shape {shape}")
        if is_tensor:
            out = torch.from_numpy(arr)
            if out.dtype != leaf.dtype:
                if not cast:
                    raise ValueError(
                        f"leaf {p!r}: checkpoint dtype {out.dtype} != "
                        f"template dtype {leaf.dtype} — pass cast=True to "
                        f"coerce (lossy for narrowing casts)")
                out = out.to(leaf.dtype)
            new_leaves.append(out.to(leaf.device))
            continue
        want = np.asarray(leaf)
        if arr.dtype != want.dtype:
            if not cast:
                raise ValueError(
                    f"leaf {p!r}: checkpoint dtype {arr.dtype} != template "
                    f"dtype {want.dtype} — pass cast=True to coerce "
                    f"(lossy for narrowing casts)")
            arr = arr.astype(want.dtype)
        new_leaves.append(arr)
    return _rebuild(template, iter(new_leaves))


def _kv_fname(part: int, name: str) -> str:
    # typed tensors are named "feat:<ntype>"; ':' is not portable in paths
    return f"part{part}_{name.replace(':', '__')}.npy"


def _versions_fname(name: str) -> str:
    return f"versions_{name.replace(':', '__')}.npy"


def save_kvstore(store, directory: str) -> None:
    """Per-server shards plus, for mutable tensors, the exact per-row
    version tables — the half of the cache-consistency pair that lets a
    restored :class:`~repro_torch.core.kvstore.FeatureCache` snapshot validate
    again (DESIGN.md §10)."""
    os.makedirs(directory, exist_ok=True)
    meta = {"num_parts": store.num_parts, "names": sorted(store._meta),
            "versions": sorted(store.mutable_names())}
    for p, server in enumerate(store.servers):
        for name in store._meta:
            np.save(os.path.join(directory, _kv_fname(p, name)),
                    server.local_view(name))
    for name in meta["versions"]:
        np.save(os.path.join(directory, _versions_fname(name)),
                store.version_table(name))
    with open(os.path.join(directory, "kv_manifest.json"), "w") as f:
        json.dump(meta, f)


def load_kvstore(store, directory: str) -> None:
    with open(os.path.join(directory, "kv_manifest.json")) as f:
        meta = json.load(f)
    assert meta["num_parts"] == store.num_parts
    for p, server in enumerate(store.servers):
        for name in meta["names"]:
            arr = np.load(os.path.join(directory, _kv_fname(p, name)))
            dst = server.local_view(name)
            assert dst.shape == arr.shape, (name, dst.shape, arr.shape)
            dst[...] = arr
    # a restore is a write like any other (DESIGN.md §5): flush every live
    # cache's entries — unlike pushes, a restore may rewrite even immutable
    # tensors' bytes, so version refusal alone cannot cover it. Mutable
    # tensors restore their EXACT checkpointed version tables (so a cache
    # snapshot from the same checkpoint validates, DESIGN.md §10); legacy
    # checkpoints without saved versions fall back to the blanket bump.
    saved_versions = set(meta.get("versions", []))
    for name in meta["names"]:
        if store.is_mutable(name):
            if name in saved_versions:
                store.set_versions(
                    name,
                    np.load(os.path.join(directory, _versions_fname(name))))
            else:
                pol = store.policy_for(name)
                store.bump_versions(name,
                                    np.arange(pol.total, dtype=np.int64))
        store.invalidate_caches(name)
    # the loop above rewrote the PRIMARY shards in place; bring every
    # replica copy back to byte-identity so a post-restore failover read
    # still returns exactly the restored bytes (no-op at replication=1)
    if hasattr(store, "sync_replicas"):
        store.sync_replicas()


def save_cache(cache, directory: str) -> None:
    """Snapshot a trainer's :class:`FeatureCache` (gids + rows + version
    stamps per tensor). Pairs with the ``save_kvstore`` of the same
    checkpoint: the stamps only validate against those version tables."""
    os.makedirs(directory, exist_ok=True)
    state = cache.state_dict()
    manifest = {}
    for name, s in state.items():
        key = name.replace(":", "__")
        files = {"gids": f"cache_{key}_gids.npy",
                 "rows": f"cache_{key}_rows.npy"}
        np.save(os.path.join(directory, files["gids"]), s["gids"])
        np.save(os.path.join(directory, files["rows"]), s["rows"])
        if s["versions"] is not None:
            files["versions"] = f"cache_{key}_versions.npy"
            np.save(os.path.join(directory, files["versions"]), s["versions"])
        manifest[name] = files
    with open(os.path.join(directory, "cache_manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_cache(cache, directory: str) -> int:
    """Restore a :func:`save_cache` snapshot; returns rows admitted.
    Must run AFTER ``load_kvstore`` of the same checkpoint — that call
    both restores the version tables the snapshot's stamps are checked
    against and flushes whatever the cache held before."""
    with open(os.path.join(directory, "cache_manifest.json")) as f:
        manifest = json.load(f)
    state = {}
    for name, files in manifest.items():
        state[name] = {
            "gids": np.load(os.path.join(directory, files["gids"])),
            "rows": np.load(os.path.join(directory, files["rows"])),
            "versions": (np.load(os.path.join(directory, files["versions"]))
                         if "versions" in files else None),
        }
    return cache.load_state_dict(state)
