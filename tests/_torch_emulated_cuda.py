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


# ---------------------------------------------------------------------------
# Mirrors of K3's forward and its backward into the scores
# (csrc/fused_edge_softmax_aggregate.cu), built from its kernel.py constants
# and run in numpy float32
# ---------------------------------------------------------------------------

from repro_torch.kernels.fused_edge_softmax_aggregate import \
    kernel as k3  # noqa: E402


def vec_dot(a, b):
    """A column vector's dot product over the last axis in float32, term by
    term in order (on the card the backward fuses a float4's products as
    fma(w, fma(z, fma(x, y * y'))), and a scalar column's into the sum)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def butterfly(x, lanes):
    """``warp_sum``'s xor butterfly over the last axis (a power of two of
    lanes), restricted to the offsets below ``lanes``: the sub-warp sum of
    the backward's small heads; ``lanes`` = 32 is ``warp_sum`` itself.
    Each lane adds the value of lane ``i ^ o`` to its own, in float32."""
    x = np.asarray(x, np.float32)
    idx = np.arange(x.shape[-1])
    for o in (16, 8, 4, 2, 1):
        if o < lanes:
            x = x + x[..., idx ^ o]
    return x


def _pow2_at_least(x):
    return 1 << max(0, x - 1).bit_length()


def k3_plan(backward, h, hcols, vec, gf=None, min_lanes=1):
    """A model of the layout ``fused_edge_softmax_aggregate_plan`` exports
    for H heads of ``hcols`` column vectors of ``vec`` floats, built from
    ``kernel.py``'s constants (``gf`` gathered floats a lane, by default
    the library's): {field: value} over ``k3.PLAN_FIELDS``. ``min_lanes``
    is the least lanes a head on the sub-warp route (1 in the library, more
    in the sweep's ``L<n>`` variants). The ``cuda``-marked test holds the
    model to the library's plan."""
    gf = k3.GATHER_FLOATS if gf is None else gf

    def rows(floats):
        return min(32, max(1, gf // floats))

    def fields(*values):
        return dict(zip(k3.PLAN_FIELDS, values))

    if not backward:
        nv = min(_pow2_at_least(-(-h * hcols // 32)), k3.MAX_VECS_PER_LANE)
        return fields(0, nv, 2 if h <= 2 else k3.MAX_HEADS,
                      -(-h * hcols // (32 * nv)), rows(nv * vec), 32)
    lanes = _pow2_at_least(max(hcols, min_lanes))
    if hcols <= k3.SMALL_HEAD_VECS and h * lanes <= 32:
        s = 32 // (h * lanes)
        return fields(1, 1, h, 1, min(_pow2_at_least(rows(vec)),
                                      _pow2_at_least(-(-32 // s))), lanes)
    nvh = min(_pow2_at_least(-(-hcols // 32)), k3.MAX_VECS_PER_LANE)
    wide = min(k3.MAX_VECS_PER_LANE // nvh, k3.MAX_HEADS)
    hs = h if h <= 2 and wide >= 2 else wide
    return fields(0, nvh, hs, -(-h // hs), rows(nvh * hs * vec), 32)


def k3_forward_mirror(h_proj, scores, edge_src, order, offsets, m, z, vec,
                      plan=None):
    """K3's forward as the kernel schedules it, a warp (a destination and a
    slab of its row) at a time, in float32, on ``plan`` (by default
    :func:`k3_plan`'s). Returns (out (num_dst, H*Dh), log):
    ``index_loads[p]`` counts the loads of live position p's order entry
    and source index, ``alpha[p, h]`` the alphas lane k computes,
    ``row_loads[p, c]`` the loads of its column vector c; ``adds[d]``
    lists, per (slab, head chunk), its column vectors and the positions
    added into them, in the order added; ``rounds`` the positions gathered
    together before the first of them is added."""
    v, h, dh = h_proj.shape
    hcols = dh // vec
    cols = h * hcols
    num_dst = len(offsets) - 1
    plan = k3_plan(False, h, hcols, vec) if plan is None else plan
    nv, slabs, u = plan["vecs"], plan["slabs"], plan["rows"]
    rows = np.asarray(h_proj, np.float32).reshape(v, cols, vec)
    n_live = int(offsets[-1])
    log = {"plan": plan,
           "index_loads": np.zeros(n_live, int),
           "alpha": np.zeros((n_live, h), int),
           "row_loads": np.zeros((n_live, cols), int),
           "adds": [[] for _ in range(num_dst)], "rounds": []}
    out = np.zeros((num_dst, cols, vec), np.float32)
    for d in range(num_dst):
        beg, end = int(offsets[d]), int(offsets[d + 1])
        for slab in range(slabs):
            first = slab * nv * 32
            mine = np.arange(first, min(first + nv * 32, cols))
            heads = mine // hcols
            h_lo, h_hi = heads[0], heads[-1]
            hcs = plan["heads"]
            chunks = [(hc, min(hcs, h_hi + 1 - hc))
                      for hc in range(h_lo, h_hi + 1, hcs)]
            added = {hc: [] for hc, _ in chunks}
            for base in range(beg, end, 32):
                pos = np.arange(base, min(base + 32, end))
                log["index_loads"][pos] += 1
                e = order[pos]
                s = edge_src[e]
                for hc, nh in chunks:
                    hh = np.arange(hc, hc + nh)
                    alpha = (np.exp(scores[e][:, hh] - m[d, hh])
                             / np.maximum(z[d, hh], np.float32(1e-30)))
                    log["alpha"][pos[:, None], hh] += 1
                    cc = mine[(heads >= hc) & (heads < hc + nh)]
                    w_head = cc // hcols - hc
                    for k0 in range(0, pos.size, u):
                        ks = range(k0, min(k0 + u, pos.size))
                        log["rounds"].append([int(pos[k]) for k in ks])
                        for k in ks:
                            log["row_loads"][pos[k], cc] += 1
                        for k in ks:
                            out[d, cc] = (out[d, cc] + alpha[k, w_head][:, None]
                                          * rows[s[k], cc])
                            added[hc].append(int(pos[k]))
            for hc, nh in chunks:
                cc = mine[(heads >= hc) & (heads < hc + nh)]
                log["adds"][d].append((cc.tolist(), added[hc]))
    return out.reshape(num_dst, cols * vec), log


def _head_dots(plan, a, b, hcols):
    """Per head, the (edge, head) dot product <a[h], b[h]> over (H, hcols,
    vec) as the plan's lanes take it: each lane's partial sum from 0 over
    its columns in order, then the butterfly over the head's lanes."""
    h = a.shape[0]
    if plan["subwarp"]:
        parts = np.zeros((h, plan["lanes"]), np.float32)
        parts[:, :hcols] = np.float32(0) + vec_dot(a, b)
        return butterfly(parts, plan["lanes"])[:, 0]
    parts = np.zeros((h, 32), np.float32)
    for i in range(-(-hcols // 32)):
        c = np.arange(32 * i, min(32 * i + 32, hcols))
        parts[:, c - 32 * i] = parts[:, c - 32 * i] + vec_dot(a[:, c],
                                                              b[:, c])
    return butterfly(parts, 32)[:, 0]


def k3_backward_mirror(grad, h_proj, out, alpha, edge_src, order, offsets,
                       vec, plan=None, parent=False):
    """K3's backward into the scores as the kernel schedules it on
    ``plan`` (by default :func:`k3_plan`'s), in float32: ds starts at 0 as
    the wrapper fills it, and each live edge's ds[e, h] = alpha[e, h] *
    (dot - <G[d, h], out[d, h]>). With ``parent``, the schedule it
    replaced: one edge at a time, every head's dot over all 32 lanes of a
    warp. Returns (ds, log): ``plan``, ``writes[e, h]`` the stores of
    ds[e, h], ``rounds`` per (destination, slab, batch) the positions whose
    rows are gathered together before any of their dot products."""
    v, h, dh = h_proj.shape
    hcols = dh // vec
    num_dst = len(offsets) - 1
    if parent:
        plan = dict(zip(k3.PLAN_FIELDS, (0, -(-hcols // 32), h, 1, 1, 32)))
    elif plan is None:
        plan = k3_plan(True, h, hcols, vec)
    g = np.asarray(grad, np.float32).reshape(num_dst, h, hcols, vec)
    o = np.asarray(out, np.float32).reshape(num_dst, h, hcols, vec)
    rows = np.asarray(h_proj, np.float32).reshape(v, h, hcols, vec)
    ds = np.zeros(alpha.shape, np.float32)
    log = {"plan": plan, "writes": np.zeros(alpha.shape, int),
           "rounds": []}
    slabs = [np.arange(s * plan["heads"], min(h, (s + 1) * plan["heads"]))
             for s in range(plan["slabs"])]
    for d in range(num_dst):
        beg, end = int(offsets[d]), int(offsets[d + 1])
        if beg == end:
            continue
        for hh in slabs:
            gdo = _head_dots(plan, g[d, hh], o[d, hh], hcols)
            for base in range(beg, end, 32):
                pos = np.arange(base, min(base + 32, end))
                u = plan["rows"]
                if plan["subwarp"]:
                    s = 32 // (h * plan["lanes"])
                    per = -(-pos.size // s)
                    rounds = [[int(pos[q + s * i]) for i in range(i0, i0 + u)
                               for q in range(s) if q + s * i < pos.size]
                              for i0 in range(0, per, u)]
                else:
                    rounds = [pos[k0:k0 + u].tolist()
                              for k0 in range(0, pos.size, u)]
                log["rounds"].append(rounds)
                for p in (p for r in rounds for p in r):
                    e = order[p]
                    dot = _head_dots(plan, g[d, hh], rows[edge_src[e], hh],
                                     hcols)
                    ds[e, hh] = alpha[e, hh] * (dot - gdo)
                    log["writes"][e, hh] += 1
    return ds, log


# ---------------------------------------------------------------------------
# Mirrors of K4's schedules (csrc/edge_softmax.cu), built from its kernel.py
# constants
# ---------------------------------------------------------------------------

from repro_torch.kernels.edge_softmax import kernel as k4  # noqa: E402

_F1 = np.float32(1)


def k4_stats_heads(h):
    """The heads a statistics thread takes: 2 where H is even, else 1."""
    return 2 if h % 2 == 0 else 1


def k4_norm_heads(h):
    """The heads a normalize thread takes: 4 where H % 4 == 0, 2 where H
    is even, else 1."""
    return 4 if h % 4 == 0 else 2 if h % 2 == 0 else 1


def _online_step(s, m, z):
    """One step of the statistics' chain on float32 scalars."""
    up = s > m
    e = np.exp(m - s if up else s - m)
    return (s, z * e + _F1) if up else (m, z + e)


def first_max(a, b):
    """The chain's max rule as an operator on (earlier a, later b): b
    replaces a when strictly greater, or when a is a NaN (no edge)."""
    return np.where((b > a) | np.isnan(a), b, a)


def _warp_group(s, m, z, log):
    """The warp route over one group's scores ``s`` (its live edges in the
    stable order, one head), 32 edges a batch, in float32: where some
    lane's score exceeds the running max, the max before each edge from a
    Hillis-Steele scan of ``first_max`` over the lanes (NaN past the
    group's end; ``log["scans"]`` counts these batches), else the running
    max; each lane's exponential, then the denominator's chain over the
    lanes in order (a lane past the end adds +0)."""
    lane = np.arange(32)
    for base in range(0, s.size, 32):
        cnt = min(32, s.size - base)
        x = np.full(32, np.nan, np.float32)
        x[:cnt] = s[base:base + cnt]
        own = x.copy()
        before = np.full(32, m, np.float32)
        if (own > m).any():
            log["scans"] += 1
            for off in (1, 2, 4, 8, 16):
                y = np.r_[x[:off], x[:-off]]
                x = np.where(lane >= off, first_max(y, x), x)
            before = np.r_[m, first_max(before[1:], x[:-1])]
            m = np.float32(first_max(m, x[31]))
        up = own > before
        e = np.exp(np.where(up, before - own, own - before))
        e[cnt:] = 0
        for k in range(32):
            z = z * e[k] + _F1 if up[k] else z + e[k]
    return m, z


def k4_stats_mirror(scores, order, offsets, u=None, warp_from=None):
    """K4's statistics as ``csrc/edge_softmax.cu`` schedules them, in
    float32 (``u`` order entries a thread loads before its chain and the
    warp route's threshold ``warp_from``, by default kernel.py's): a thread
    a destination and ``k4_stats_heads(H)`` heads loads a batch of up to U
    order entries, then their scores, then runs the chain; a group of more
    than ``warp_from`` live edges goes to the warp route. Returns (m, z,
    log): ``order_loads[p]`` and ``score_loads[p, h]`` count the loads of
    live position p's order entry and score of head h, ``writes[d, h]``
    the stores of m[d, h] (and z), ``warp[d]`` whether d took the warp
    route, ``batches`` the positions each thread batch loaded together,
    ``scans`` the warp route's batches that took the scan."""
    u = k4.STATS_EDGES if u is None else u
    warp_from = k4.WARP_FROM if warp_from is None else warp_from
    scores = np.asarray(scores, np.float32)
    h = scores.shape[1]
    ht = k4_stats_heads(h)
    num_dst = len(offsets) - 1
    n_live = int(offsets[-1])
    m = np.zeros((num_dst, h), np.float32)
    z = np.zeros((num_dst, h), np.float32)
    log = {"order_loads": np.zeros(n_live, int),
           "score_loads": np.zeros((n_live, h), int),
           "writes": np.zeros((num_dst, h), int),
           "warp": np.zeros(num_dst, bool), "batches": [], "scans": 0}
    with np.errstate(over="ignore", invalid="ignore"):
        for d in range(num_dst):
            beg, end = int(offsets[d]), int(offsets[d + 1])
            log["warp"][d] = end - beg > warp_from
            for h0 in range(0, h, ht):
                heads = range(h0, h0 + ht)
                mm = [np.float32(-1e30)] * ht
                zz = [np.float32(0)] * ht
                if log["warp"][d]:
                    log["order_loads"][beg:end] += 1
                    log["score_loads"][beg:end, h0:h0 + ht] += 1
                    s = scores[order[beg:end]]
                    for j, hh in enumerate(heads):
                        mm[j], zz[j] = _warp_group(s[:, hh], mm[j], zz[j],
                                                   log)
                for base in range(beg, end if not log["warp"][d] else beg,
                                  u):
                    pos = np.arange(base, min(base + u, end))
                    log["batches"].append(pos.tolist())
                    log["order_loads"][pos] += 1
                    s = scores[order[pos]][:, h0:h0 + ht]
                    log["score_loads"][pos, h0:h0 + ht] += 1
                    for row in s:
                        for j in range(ht):
                            mm[j], zz[j] = _online_step(row[j], mm[j], zz[j])
                for j, hh in enumerate(heads):
                    if mm[j] <= np.float32(-1e30) / 2:
                        mm[j], zz[j] = np.float32(0), np.float32(0)
                    m[d, hh], z[d, hh] = mm[j], zz[j]
                    log["writes"][d, hh] += 1
    return m, z, log


def k4_norm_mirror(scores, edge_dst, edge_mask, m, z):
    """K4's normalize as ``csrc/edge_softmax.cu`` schedules it, in float32:
    a thread a run of ``NORM_SLOTS`` consecutive slots and
    ``k4_norm_heads(H)`` heads loads the run's mask and destinations,
    gathers m and z of its live slots only, loads the scores of runs that
    hold a live slot, and writes every slot of the run, 0 where padded.
    Returns (alpha, log): ``writes[e, h]``, ``score_loads[e, h]``,
    ``stat_loads[e]`` the gathers of m and z by slot e's destination."""
    scores = np.asarray(scores, np.float32)
    e_n, h = scores.shape
    ht = k4_norm_heads(h)
    alpha = np.zeros((e_n, h), np.float32)
    log = {"writes": np.zeros((e_n, h), int),
           "score_loads": np.zeros((e_n, h), int),
           "stat_loads": np.zeros(e_n, int)}
    for e0 in range(0, e_n, k4.NORM_SLOTS):
        run = np.arange(e0, min(e0 + k4.NORM_SLOTS, e_n))
        live = np.asarray(edge_mask)[run]
        for h0 in range(0, h, ht):
            cols = slice(h0, h0 + ht)
            if live.any():
                log["score_loads"][run, cols] += 1
            for r in run[live]:
                d = int(edge_dst[r])
                log["stat_loads"][r] += 1
                with np.errstate(over="ignore"):
                    alpha[r, cols] = (np.exp(scores[r, cols] - m[d, cols])
                                      / np.maximum(z[d, cols],
                                                   np.float32(1e-30)))
            log["writes"][run, cols] += 1
    return alpha, log
