"""CPU stand-ins for the port's CUDA kernel wrappers, for tests that drive
the card's code path (the ``torch.autograd.Function``s, the grouped
orders, the layers' flattening) where there is no card.

Each stand-in computes what its kernel computes, over the same grouped
edge order and in the same per-group edge order (``index_add_`` on the CPU
adds sequentially), and counts its launches like the wrapper it replaces.
:func:`emulate_cuda` patches them in, together with an ``impl`` switch
that takes the card's path for CPU tensors. The kernels themselves are
held against the plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import torch

from repro_torch.core.kvstore import embedding
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.fused_edge_softmax_aggregate import ops as k3_ops
from repro_torch.kernels.fused_gather_aggregate import ops as k1_ops
from repro_torch.kernels.segment_sum import ops as k2_ops
from repro_torch.kernels.sparse_adam import ops as k5_ops
from repro_torch.kernels.src_scatter.kernel import CHUNK
from repro_torch.models.gnn import layers


def _live(groups):
    """(edge ids, their group keys) of the live edges in grouped order."""
    n_live = int(groups.offsets[-1])
    edges = groups.order[:n_live].long()
    keys = torch.repeat_interleave(
        torch.arange(groups.num_groups),
        (groups.offsets[1:] - groups.offsets[:-1]).long())
    return edges, keys


def _grouped_sum(rows, keys, num_groups):
    out = torch.zeros((num_groups,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype)
    return out.index_add_(0, keys, rows)


def fused_gather_aggregate(h_src, edge_src, groups):
    fused_gather_aggregate.launches += 1
    edges, keys = _live(groups)
    return _grouped_sum(h_src[edge_src[edges].long()], keys,
                        groups.num_groups)


def segment_sum(msg, groups):
    if msg.requires_grad:
        raise NotImplementedError("segment_sum_cuda has no backward kernel")
    segment_sum.launches += 1
    edges, keys = _live(groups)
    return _grouped_sum(msg[edges], keys, groups.num_groups)


def chunk_plan(keys, offsets, chunk=CHUNK):
    """The bookkeeping of ``csrc/src_scatter.cu``'s chunk warps, chunk by
    chunk in ticket order (chunk k waits only on chunk k - 1): the live
    positions ``[0, offsets[-1])`` cut into chunks of ``chunk``, and per
    chunk its row segments in the order the warp sums them, as (row,
    begin, end, start, finish). ``start`` is "zero", or "carry" where the
    segment goes on from the running sum the previous chunk published;
    ``finish`` is "out" (the row's sum is stored), or "carry" where the
    row goes on past the chunk and its running sum is published. A warp
    sums the segments after its first, publishing, before its first,
    which may wait for a carry."""
    keys = np.asarray(keys)
    n_live = int(offsets[-1])
    plan = []
    for p0 in range(0, n_live, chunk):
        n = min(chunk, n_live - p0)
        ks = keys[p0:p0 + n]
        cont_before = p0 > 0 and keys[p0 - 1] == ks[0]
        cont_after = p0 + n < n_live and keys[p0 + n] == ks[-1]
        starts = (np.flatnonzero(ks[1:] != ks[:-1]) + 1).tolist()
        b1 = starts[0] if starts else n
        segs = []
        for beg, end, carried in ((b1, n, False), (0, b1, cont_before)):
            if beg == end:
                continue
            bounds = [beg] + [b for b in starts if beg < b < end] + [end]
            for i, (b, e) in enumerate(zip(bounds[:-1], bounds[1:])):
                segs.append((int(ks[b]), p0 + b, p0 + e,
                             "carry" if carried and i == 0 else "zero",
                             "carry" if e == n and cont_after else "out"))
        plan.append(segs)
    return plan


def src_scatter_chunked(grad, edge_dst, groups, weights=None, chunk=CHUNK):
    """What the kernel computes, as it computes it: each row's terms (the
    products rounded first) added one at a time in position order, from 0
    or from the previous chunk's carry; rows with no live edge zero."""
    n_live = int(groups.offsets[-1])
    edges = groups.order[:n_live].long()
    terms = grad[edge_dst[edges].long()]
    if weights is not None:
        h = weights.shape[1]
        terms = (terms.view(n_live, h, terms.shape[1] // h)
                 * weights[edges][:, :, None]).reshape(terms.shape)
    out = torch.zeros((groups.num_groups, grad.shape[1]), dtype=grad.dtype)
    carry = None
    for segs in chunk_plan(groups.keys.numpy(), groups.offsets.numpy(),
                           chunk):
        published = None
        for row, b, e, start, finish in segs:
            acc = (carry.clone() if start == "carry"
                   else torch.zeros_like(out[row]))[None]
            acc.index_add_(0, torch.zeros(e - b, dtype=torch.long),
                           terms[b:e])
            acc = acc[0]
            if finish == "carry":
                published = acc
            else:
                out[row] = acc
        carry = published
    return out


def src_scatter(grad, edge_dst, groups, weights=None):
    src_scatter.launches += 1
    return src_scatter_chunked(grad, edge_dst, groups, weights)


def edge_softmax_stats(scores, groups):
    edge_softmax_stats.launches += 1
    edges, keys = _live(groups)
    h = scores.shape[1]
    m = torch.full((groups.num_groups, h), -1e30).scatter_reduce(
        0, keys[:, None].expand(-1, h), scores[edges], "amax")
    m = torch.where(m <= -5e29, 0.0, m)
    z = _grouped_sum(torch.exp(scores[edges] - m[keys]), keys,
                     groups.num_groups)
    return m, z


def edge_softmax_norm(scores, edge_dst, edge_mask, m, z):
    edge_softmax_norm.launches += 1
    d = edge_dst.long()
    alpha = torch.exp(scores - m[d]) / torch.clamp_min(z[d], 1e-30)
    return torch.where(edge_mask[:, None], alpha, 0.0)


def fused_edge_softmax_aggregate(h_proj, scores, edge_src, groups, m, z):
    fused_edge_softmax_aggregate.launches += 1
    edges, keys = _live(groups)
    alpha = (torch.exp(scores[edges] - m[keys])
             / torch.clamp_min(z[keys], 1e-30))
    rows = h_proj[edge_src[edges].long()] * alpha[:, :, None]
    return _grouped_sum(rows.flatten(1), keys, groups.num_groups)


def fused_edge_softmax_aggregate_bwd(grad, h_proj, out, alpha, edge_src,
                                     groups):
    fused_edge_softmax_aggregate_bwd.launches += 1
    edges, keys = _live(groups)
    v, h, dh = h_proj.shape
    g = grad.view(-1, h, dh)
    dot = (g[keys] * h_proj[edge_src[edges].long()]).sum(-1)
    dot_out = (g * out.view(-1, h, dh)).sum(-1)[keys]
    ds = torch.zeros_like(alpha)
    ds[edges] = alpha[edges] * (dot - dot_out)
    return ds


def sparse_adam(w, m, v, rows, cm, cv, bc1, bc2, *, beta1, beta2, lr,
                eps):
    """K5's update, one float32 operation at a time in the kernel's
    order, in place on the rows."""
    sparse_adam.launches += 1
    r = rows.long()
    mm = beta1 * m[r] + cm
    vv = beta2 * v[r] + cv
    mhat = mm / bc1[:, None]
    vhat = vv / bc2[:, None]
    # the kernel's __fsqrt_rn is correctly rounded; so is this
    w[r] = w[r] - (lr * mhat) / (torch.sqrt(vhat.double()).float() + eps)
    m[r] = mm
    v[r] = vv


STAND_INS = {
    "fused_gather_aggregate": fused_gather_aggregate,
    "segment_sum": segment_sum,
    "src_scatter": src_scatter,
    "edge_softmax_stats": edge_softmax_stats,
    "edge_softmax_norm": edge_softmax_norm,
    "fused_edge_softmax_aggregate": fused_edge_softmax_aggregate,
    "fused_edge_softmax_aggregate_bwd": fused_edge_softmax_aggregate_bwd,
    "sparse_adam": sparse_adam,
}


def _card_path(impl, x):
    return "ref" if impl == "ref" else "cuda"


def emulate_cuda(monkeypatch) -> dict:
    """Route every op's card path to the stand-ins, for CPU tensors; the
    launch counts start at 0. ``DistEmbedding`` takes the card's route
    (staged rows, K5) on the CPU too. Returns the stand-ins by kernel
    name."""
    for fn in STAND_INS.values():
        fn.launches = 0
    for mod in (layers, k1_ops, k2_ops, k3_ops, es_ops, k5_ops):
        monkeypatch.setattr(mod, "resolve_impl", _card_path)
    monkeypatch.setattr(embedding, "_stages_rows", lambda device: True)
    patches = [
        (k1_ops, "fused_gather_aggregate_cuda", fused_gather_aggregate),
        (k1_ops, "src_scatter_cuda", src_scatter),
        (k2_ops, "segment_sum_cuda", segment_sum),
        (k3_ops, "edge_softmax_stats_cuda", edge_softmax_stats),
        (k3_ops, "edge_softmax_norm_cuda", edge_softmax_norm),
        (k3_ops, "fused_edge_softmax_aggregate_cuda",
         fused_edge_softmax_aggregate),
        (k3_ops, "fused_edge_softmax_aggregate_bwd_cuda",
         fused_edge_softmax_aggregate_bwd),
        (k3_ops, "src_scatter_cuda", src_scatter),
        (es_ops, "edge_softmax_stats_cuda", edge_softmax_stats),
        (es_ops, "edge_softmax_norm_cuda", edge_softmax_norm),
        (k5_ops, "sparse_adam_cuda", sparse_adam),
    ]
    for mod, name, fn in patches:
        monkeypatch.setattr(mod, name, fn)
    return STAND_INS


# ---------------------------------------------------------------------------
# Mirrors of K2's schedules (csrc/segment_sum.cu) and K1's forward schedule
# (csrc/fused_gather_aggregate.cu), built from their kernel.py constants
# ---------------------------------------------------------------------------

from repro_torch.kernels.segment_sum.kernel import (  # noqa: E402
    EDGE_LOADS as K2_EDGE_LOADS, SUB_WARP as K2_SUB_WARP, row_tiling)

def edge_schedule(offsets, sub_warp=K2_SUB_WARP, loads=K2_EDGE_LOADS):
    """K2's lanes-across-edges schedule (F <= SMALL_F_MAX) over a grouped
    order's ``offsets``. Group g belongs to sub-warp g % (32 // sub_warp)
    of warp g // (32 // sub_warp); a warp runs as many batches as its
    longest group needs. Returns, per warp, its batches; per batch, for each
    of the warp's groups: (the order entries its lanes load in this batch,
    the next batch's, as (lane, position); the message rows they load, as
    (lane, position); the positions added, in the order they are added).
    The first batch's order entries are loaded before the loop and listed
    with the first batch."""
    offsets = np.asarray(offsets)
    per_warp, b = 32 // sub_warp, sub_warp * loads

    def lanes(beg, end, base):
        return [(s, base + r * sub_warp + s) for r in range(loads)
                for s in range(sub_warp) if base + r * sub_warp + s < end]

    warps = []
    for w0 in range(0, len(offsets) - 1, per_warp):
        groups = range(w0, min(w0 + per_warp, len(offsets) - 1))
        n_batches = max(-(-int(offsets[g + 1] - offsets[g]) // b)
                        for g in groups)
        batches = []
        for k in range(n_batches):
            batch = {}
            for g in groups:
                beg, end = int(offsets[g]), int(offsets[g + 1])
                base = beg + k * b
                rows = lanes(beg, end, base)
                index = lanes(beg, end, base + b)
                if k == 0:
                    index = rows + index
                batch[g] = (index, rows, [p for _s, p in rows])
            batches.append(batch)
        warps.append(batches)
    return warps


def row_schedule(length, f, vec, gather_floats, max_vecs):
    """The lanes-across-features schedule of one group of ``length`` live
    positions (K2 for F > SMALL_F_MAX, and K1's forward, each with its own
    constants): (NV, slabs, U) from ``row_tiling``, and per batch of 32
    positions (the order entries lane i loads, and in K1 their source
    indices, as (lane, position); the gather rounds, each the positions
    whose rows are gathered before the first of them is added). The adds
    run round by round, in order."""
    nv, slabs, u = row_tiling(f // vec, vec, gather_floats, max_vecs)
    batches = []
    for base in range(0, length, 32):
        n = min(32, length - base)
        batches.append(([(i, base + i) for i in range(n)],
                        [list(range(base + k0, base + min(k0 + u, n)))
                         for k0 in range(0, n, u)]))
    return (nv, slabs, u), batches


def row_columns(cols, nv, slabs):
    """The column vectors (slab, lane, j) of a row of ``cols`` vectors
    hold: vector (slab * nv + j) * 32 + lane, where it is below cols."""
    return [((s * nv + j) * 32 + lane, (s, lane, j)) for s in range(slabs)
            for lane in range(32) for j in range(nv)
            if (s * nv + j) * 32 + lane < cols]


def replay(rows, adds):
    """The kernel's arithmetic on the positions it adds, in order: a float32
    sum from 0, one add at a time."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32)
    for p in adds:
        acc = acc + rows[p].float()
    return acc
