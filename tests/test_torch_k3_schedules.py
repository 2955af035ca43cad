"""K3's forward and its backward into the scores
(``csrc/fused_edge_softmax_aggregate.cu``): their schedules, through the
Python mirrors in ``_torch_emulated_cuda`` built from the constants in
``kernel.py``, run in float32.

The forward takes a warp a destination with the row in its lanes: a batch
of 32 live edges loads its order entries and source indices once, lane k
computes the alpha of edge k for up to ``MAX_HEADS`` heads at a time, U
rows are gathered before the adds, and every column is summed in the
group's stable order. The backward takes a warp a destination, or
sub-warps of W lanes an edge where a head has at most ``SMALL_HEAD_VECS``
column vectors; each (edge, head) dot product is a lane's partial sums
reduced by ``warp_sum``'s butterfly, restricted on a sub-warp to the
offsets below the head's lanes. On blocks whose groups hold every length
from 0 to 100 live edges, the mirrors load and add each live edge once
per slab in the stable order and write each live edge's ds once per head;
the backward's ds is bitwise the schedule it replaced (one edge a warp);
and both are held against the JAX package (its oracle, its Pallas kernel
in interpret mode, ``jax.vjp`` of its oracle) within its kernel
tolerance rtol = atol = 1e-5. The mirrors run on a model of the layout
the library chooses (``k3_plan``). The kernels themselves run on the
card: the ``cuda``-marked tests hold them there, and the model to the
plan the library exports; ``chip_smoke.py`` holds the kernels at the
schedules' edges and at the main path's shapes.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.kernels.fused_edge_softmax_aggregate.kernel import \
    fused_edge_softmax_aggregate_pallas
from repro.kernels.fused_edge_softmax_aggregate.ref import \
    fused_edge_softmax_aggregate_ref as jax_k3_ref
from repro_torch.kernels import (dst_groups,
                                 fused_edge_softmax_aggregate_bwd_cuda,
                                 fused_edge_softmax_aggregate_cuda,
                                 fused_edge_softmax_aggregate_ref)
from repro_torch.kernels.fused_edge_softmax_aggregate import kernel as k3

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = list(range(101))          # every group length 0-100
V = 300                             # source rows

# (H, Dh, column vector width): the step's layers 0-1 (2 x 128) on both
# column routes and its last layer (2 x 8), the scalar route (1 x 3) and
# eight heads; the forward also takes more than MAX_HEADS heads
BWD_SHAPES = [(2, 128, 4), (2, 128, 1), (2, 8, 4), (2, 8, 1), (1, 3, 1),
              (8, 8, 4), (8, 8, 1), (8, 128, 4)]
FWD_SHAPES = BWD_SHAPES + [(12, 8, 4), (12, 8, 1)]
# the Pallas kernel in interpret mode compiles per shape (seconds each)
PALLAS_SHAPES = {(2, 128, 4), (2, 8, 4), (1, 3, 1), (12, 8, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(shapes):
    return [f"H{h}-Dh{dh}-vec{v}" for h, dh, v in shapes]


def _block(seed, lengths, pad):
    """Destination-keyed edges: group d holds ``lengths[d]`` live edges,
    each from a seeded source row; ``pad`` masked slots (src 0, dst 0, as
    ``pad_block`` pads) mixed in; the slots shuffled, so the grouped order
    is not the slot order."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    src = rng.integers(0, V, dst.size).astype(np.int32)
    mask = np.r_[np.ones(dst.size, bool), np.zeros(pad, bool)]
    src = np.r_[src, np.zeros(pad, np.int32)]
    dst = np.r_[dst, np.zeros(pad, np.int32)]
    perm = rng.permutation(dst.size)
    return src[perm], dst[perm], mask[perm]


def _stats(scores, dst, mask, n):
    """K4's statistics in float32: each destination's max over its live
    edges (0 where it has none) and the denominator."""
    h = scores.shape[1]
    m = np.full((n, h), -np.inf, np.float32)
    np.maximum.at(m, dst[mask], scores[mask])
    m[np.isinf(m)] = 0
    z = np.zeros((n, h), np.float32)
    np.add.at(z, dst[mask], np.exp(scores[mask] - m[dst[mask]]))
    return m, z


def _alpha(scores, dst, mask, m, z):
    """K4's normalize: the alpha both kernels' callers hand them."""
    x = np.where(mask[:, None], scores - m[dst], np.float32(-np.inf))
    return (np.exp(x) / np.maximum(z[dst], np.float32(1e-30))).astype(
        np.float32)


def _case(h, dh, seed, spread=3.0, lengths=LENGTHS):
    src, dst, mask = _block(seed, lengths, 300)
    n = len(lengths)
    rng = np.random.default_rng(seed + 1)
    hp = rng.standard_normal((V, h, dh)).astype(np.float32)
    scores = (rng.standard_normal((src.size, h)) * spread).astype(np.float32)
    cot = rng.standard_normal((n, h * dh)).astype(np.float32)
    g = dst_groups(torch.from_numpy(dst), torch.from_numpy(mask), n)
    return (src, dst, mask, hp, scores, cot, g.order.numpy(),
            g.offsets.numpy())


@functools.partial(jax.jit, static_argnums=5)
def _jax_fwd_and_vjp(hp, scores, src, dst, mask, n, cot):
    out, vjp = jax.vjp(lambda s: jax_k3_ref(hp, s, src, dst, mask, n),
                       scores)
    return out, vjp(cot)[0]


def _constants(*names):
    cu = (ROOT / "src/repro_torch/csrc/fused_edge_softmax_aggregate.cu"
          ).read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", cu).group(1))
                 for n in names)


def test_design_constants_are_the_librarys():
    """The wrappers check the library's constants at the first launch;
    here, that kernel.py states its source's."""
    assert _constants("kGatherFloats", "kMaxVecsPerLane", "kMaxHeads",
                      "kSmallHeadVecs", "kBwdMinBlocks") == k3.DESIGN


# (H, Dh, column vector width) beyond the tests' blocks: rows past 256
# floats, which take more slabs or more vectors a lane
WIDE_SHAPES = [(1, 1024, 1), (1, 2048, 4), (2, 256, 4), (2, 256, 1),
               (4, 40, 1), (12, 128, 4)]


@pytest.mark.parametrize("h,dh,vec", FWD_SHAPES + WIDE_SHAPES,
                         ids=_ids(FWD_SHAPES + WIDE_SHAPES))
def test_forward_plan_covers_the_row(h, dh, vec):
    """The forward's plan holds a row of up to 32 x MAX_VECS_PER_LANE
    vectors in one warp's lanes, so that its edges are walked once (at F
    = 256, the step's layers 0-1, too), and a wider row in slabs of that
    many; its alphas come in chunks of 2 heads where H <= 2, else of
    MAX_HEADS; U rows of the budget in flight, at least 1."""
    cols = h * (dh // vec)
    for gf in (k3.GATHER_FLOATS, 4, 16, 32):
        p = emu.k3_plan(False, h, dh // vec, vec, gf)
        assert p["vecs"] in (1, 2, 4, 8) and p["vecs"] <= k3.MAX_VECS_PER_LANE
        assert p["slabs"] == -(-cols // (32 * p["vecs"]))
        assert p["slabs"] == 1 or p["vecs"] == k3.MAX_VECS_PER_LANE
        assert p["heads"] == (2 if h <= 2 else k3.MAX_HEADS)
        assert p["rows"] == min(32, max(1, gf // (p["vecs"] * vec)))
    if h * dh <= 256:
        assert emu.k3_plan(False, h, dh // vec, vec)["slabs"] == 1


@pytest.mark.parametrize("h,dh,vec,subwarp,w", [
    (2, 128, 4, 0, None), (2, 128, 1, 0, None), (2, 8, 4, 1, 4),
    (2, 8, 1, 1, 16), (1, 3, 1, 1, 4), (8, 8, 4, 1, 16), (8, 8, 1, 0, None),
    (8, 128, 4, 0, None), (3, 4, 4, 1, 3)])
def test_backward_plan_follows_the_head_width(h, dh, vec, subwarp, w):
    """Heads of at most SMALL_HEAD_VECS column vectors take sub-warps of W
    = H x (their vectors rounded up to a power of two) lanes, where W fits
    a warp; the others a warp, HS heads a slab, NVH vectors a lane of
    each, the row of a slab within MAX_VECS_PER_LANE vectors a lane."""
    for gf in (k3.GATHER_FLOATS, 4, 16, 32):
        p = emu.k3_plan(True, h, dh // vec, vec, gf)
        assert p["subwarp"] == subwarp
        assert 1 <= p["rows"] <= 32
        if subwarp:
            assert h * p["lanes"] == w and w <= 32
            assert p["lanes"] >= dh // vec and p["heads"] == h
            assert p["rows"] < 2 * -(-32 // (32 // w))
        else:
            assert p["lanes"] == 32
            assert p["vecs"] * 32 >= min(dh // vec,
                                         32 * k3.MAX_VECS_PER_LANE)
            assert p["vecs"] * p["heads"] <= k3.MAX_VECS_PER_LANE
            assert p["heads"] * p["slabs"] >= h
            if p["vecs"] * p["heads"] * vec <= gf:
                assert p["rows"] * p["vecs"] * p["heads"] * vec <= gf


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_subwarp_butterfly_gives_the_warp_butterflys_bits(lanes):
    """The butterfly over a head's ``lanes`` lanes, side by side with other
    heads in a sub-warp, gives in float32 the bits of ``warp_sum``'s
    32-lane butterfly over the same values padded with zeros, on every
    lane of the head: the offsets at or above ``lanes`` only add exact
    zeros (a partial sum that starts at +0 is never -0), and the rest
    build the same tree."""
    rng = np.random.default_rng(lanes)
    heads = max(1, 32 // lanes // 2)
    for trial in range(200):
        # unit values and values of wildly different magnitudes, some
        # cancelling, so that the order of the adds shows in the bits
        x = (rng.standard_normal((heads, lanes))
             * 10.0 ** rng.integers(-6, 7, (heads, lanes))).astype(
                 np.float32)
        x[:, rng.integers(1, lanes + 1):] = 0   # spare lanes
        sub = emu.butterfly(x.reshape(heads * lanes), lanes).reshape(
            heads, lanes)
        for hd in range(heads):
            full = emu.butterfly(np.r_[x[hd], np.zeros(32 - lanes,
                                                       np.float32)], 32)
            assert (sub[hd].view(np.uint32)
                    == full[:lanes].view(np.uint32)).all(), (trial, hd)
            assert (full == full[0]).all()


@pytest.mark.parametrize("h,dh,vec", FWD_SHAPES, ids=_ids(FWD_SHAPES))
def test_forward_schedule_loads_once_and_adds_in_stable_order(h, dh, vec):
    """Groups of every length 0-100: each live position's order entry and
    source index is loaded once a slab, its alpha computed once a head,
    each of its column vectors gathered once, and added once in the
    group's stable order; the sums match the JAX package's oracle (and
    its Pallas kernel in interpret mode) within rtol = atol = 1e-5, and
    the port's plain version, groups with no live edge exactly 0."""
    src, dst, mask, hp, scores, cot, order, offsets = _case(h, dh, h * dh)
    n = len(LENGTHS)
    m, z = _stats(scores, dst, mask, n)
    got, log = emu.k3_forward_mirror(hp, scores, src, order, offsets, m, z,
                                     vec)
    plan, hcols = log["plan"], dh // vec
    nv, slabs, u = plan["vecs"], plan["slabs"], plan["rows"]
    if h * dh <= 256:
        assert slabs == 1                 # the edges are walked once
    assert (log["index_loads"] == slabs).all()
    assert (log["row_loads"] == 1).all()
    spans = np.zeros(h, int)            # slabs whose columns reach a head
    for slab in range(slabs):
        cs = np.arange(slab * nv * 32, min((slab + 1) * nv * 32, h * hcols))
        spans[np.unique(cs // hcols)] += 1
    assert (log["alpha"] == spans).all()
    assert max(len(r) for r in log["rounds"]) <= u
    for d in range(n):
        seen = []
        for cols, adds in log["adds"][d]:
            assert adds == list(range(offsets[d], offsets[d + 1]))
            seen += cols
        assert sorted(seen) == list(range(h * hcols))
    assert not got[np.array(LENGTHS) == 0].any()
    want, _ = _jax_fwd_and_vjp(*map(jnp.asarray, (hp, scores, src, dst,
                                                  mask)), n,
                               jnp.asarray(cot))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    plain = fused_edge_softmax_aggregate_ref(
        *map(torch.from_numpy, (hp, scores, src, dst, mask)), n)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    if (h, dh, vec) in PALLAS_SHAPES:
        pallas = fused_edge_softmax_aggregate_pallas(
            *map(jnp.asarray, (hp, scores, src, dst, mask)), n)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("h,dh,vec", BWD_SHAPES, ids=_ids(BWD_SHAPES))
def test_backward_schedule_writes_each_live_edge_once(h, dh, vec):
    """Groups of every length 0-100: each live edge's ds is written once a
    head (padded edges keep the wrapper's 0), each live position's row is
    gathered in one round of at most U edges a warp or sub-warp; the ds
    are bitwise those of the schedule the kernel replaced (one edge at a
    time, every dot over a whole warp), and within rtol = atol = 1e-5 of
    ``jax.vjp`` of the JAX package's oracle with respect to the scores."""
    src, dst, mask, hp, scores, cot, order, offsets = _case(h, dh, h + dh)
    n = len(LENGTHS)
    m, z = _stats(scores, dst, mask, n)
    alpha = _alpha(scores, dst, mask, m, z)
    out, _ = emu.k3_forward_mirror(hp, scores, src, order, offsets, m, z,
                                   vec)
    ds, log = emu.k3_backward_mirror(cot, hp, out, alpha, src, order,
                                     offsets, vec)
    plan = log["plan"]
    assert (log["writes"][mask] == 1).all()
    assert not log["writes"][~mask].any() and not ds[~mask].any()
    per_round = plan["rows"] * (32 // (h * plan["lanes"]) if plan["subwarp"]
                                else 1)
    slabs = plan["slabs"]
    taken = np.zeros(int(offsets[-1]), int)
    for rounds in log["rounds"]:
        for r in rounds:
            assert 1 <= len(r) <= per_round
            taken[r] += 1
    assert (taken == slabs).all()
    parent, _ = emu.k3_backward_mirror(cot, hp, out, alpha, src, order,
                                       offsets, vec, parent=True)
    assert (ds.view(np.uint32) == parent.view(np.uint32)).all()
    _, want = _jax_fwd_and_vjp(*map(jnp.asarray, (hp, scores, src, dst,
                                                  mask)), n,
                               jnp.asarray(cot))
    np.testing.assert_allclose(ds, np.asarray(want), **TOL)


@pytest.mark.parametrize("h,dh,vec", [(2, 128, 4), (2, 8, 4)],
                         ids=_ids([(2, 128, 4), (2, 8, 4)]))
def test_no_bit_depends_on_the_budget_or_the_lanes(h, dh, vec):
    """The budget (U rows in flight, the sweep's ``GF<n>``) and the
    sub-warp's least lanes a head (W, its ``L<n>``) move loads, never
    additions: the forward
    and the backward give the same bits under every choice, with scores
    spread over +-80 so that exp underflows inside a group."""
    src, dst, mask, hp, scores, cot, order, offsets = _case(h, dh, 7,
                                                            spread=80.0)
    n = len(LENGTHS)
    m, z = _stats(scores, dst, mask, n)
    alpha = _alpha(scores, dst, mask, m, z)
    budgets = (k3.GATHER_FLOATS, 4, 16, 32, 128)
    hcols = dh // vec
    outs = [emu.k3_forward_mirror(hp, scores, src, order, offsets, m, z, vec,
                                  emu.k3_plan(False, h, hcols, vec, gf))[0]
            for gf in budgets]
    for o in outs[1:]:
        assert (o.view(np.uint32) == outs[0].view(np.uint32)).all()
    dss = [emu.k3_backward_mirror(cot, hp, outs[0], alpha, src, order,
                                  offsets, vec,
                                  emu.k3_plan(True, h, hcols, vec, gf,
                                              lanes))[0]
           for gf in budgets for lanes in (1, 2, 4, 8, 16)]
    for d in dss[1:]:
        assert (d.view(np.uint32) == dss[0].view(np.uint32)).all()
    want, want_ds = _jax_fwd_and_vjp(*map(jnp.asarray, (hp, scores, src, dst,
                                                        mask)), n,
                                     jnp.asarray(cot))
    np.testing.assert_allclose(outs[0], np.asarray(want), **TOL)
    np.testing.assert_allclose(dss[0], np.asarray(want_ds), **TOL)


@pytest.mark.cuda
def test_cuda_plan_model_is_the_librarys():
    """On the card: the library's exported plan, which its launchers
    follow, is the mirrors' model of it on every shape the tests and the
    sweep take, both column routes, both kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    for h, dh, vec in FWD_SHAPES + WIDE_SHAPES + [(3, 4, 4), (4, 8, 4),
                                                  (8, 4, 1), (16, 8, 4)]:
        want = k3.launch_plan(False, h, dh, vec == 4)
        assert emu.k3_plan(False, h, dh // vec, vec) == want, (h, dh, vec)
        if h <= k3.MAX_HEADS:
            want = k3.launch_plan(True, h, dh, vec == 4)
            assert emu.k3_plan(True, h, dh // vec, vec) == want, (h, dh, vec)


@pytest.mark.cuda
@pytest.mark.parametrize("h,dh", [(2, 128), (2, 8), (1, 3), (8, 8),
                                  (8, 128), (12, 8)])
def test_cuda_k3_kernels_on_card(h, dh):
    """On the card: K3's forward and its backward into the scores on
    groups of every length 0-100 and one of 5,000, both column routes
    where Dh allows, each equal to a second launch and within rtol = atol
    = 1e-5 of the mirrors' float32 replay (the card fuses multiply-adds),
    padded edges 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    lengths = LENGTHS + [5000]
    src, dst, mask, hp, scores, cot, order, offsets = _case(
        h, dh, 11, lengths=lengths)
    n = len(lengths)
    m, z = _stats(scores, dst, mask, n)
    alpha = _alpha(scores, dst, mask, m, z)
    es, ed, em = (torch.from_numpy(x).cuda() for x in (src, dst, mask))
    g = dst_groups(ed, em, n)
    dev = [torch.from_numpy(x).cuda() for x in (hp, scores, m, z, cot,
                                                 alpha)]
    hp_c, s_c, m_c, z_c, cot_c, a_c = dev
    # 4 bytes past a 16-byte boundary: the scalar columns
    odd = torch.empty(hp_c.numel() + 1, device="cuda")[1:].view(
        hp_c.shape).copy_(hp_c)
    for vec, h_in in ((4, hp_c), (1, odd)):
        if vec == 4 and dh % 4:
            continue
        out = fused_edge_softmax_aggregate_cuda(h_in, s_c, es, g, m_c, z_c)
        assert torch.equal(out, fused_edge_softmax_aggregate_cuda(
            h_in, s_c, es, g, m_c, z_c))
        want, _ = emu.k3_forward_mirror(hp, scores, src, order, offsets, m,
                                        z, vec, k3.launch_plan(
                                            False, h, dh, vec == 4))
        np.testing.assert_allclose(out.cpu().numpy(), want, **TOL)
        if h > k3.MAX_HEADS:
            continue
        ds = fused_edge_softmax_aggregate_bwd_cuda(cot_c, h_in, out, a_c,
                                                   es, g)
        assert torch.equal(ds, fused_edge_softmax_aggregate_bwd_cuda(
            cot_c, h_in, out, a_c, es, g))
        want_ds, _ = emu.k3_backward_mirror(
            cot, hp, out.cpu().numpy(), alpha, src, order, offsets, vec,
            k3.launch_plan(True, h, dh, vec == 4))
        np.testing.assert_allclose(ds.cpu().numpy(), want_ds, **TOL)
        assert not ds[~em].any()
