"""The source-keyed kernel (``csrc/src_scatter.cu``, K1's backward and K3's
backward into h_proj): its chunk and carry bookkeeping, through the
Python mirror of the kernel in ``_torch_emulated_cuda`` (``chunk_plan``),
on blocks at the edges the design has to get right: one source row with
all the edges, rows of exactly C, C - 1, C + 1 and 3C edges, rows that
start at a chunk boundary and mid-chunk, a block with no live edge.
Each live edge is summed exactly once, a row across chunks goes on from
its carry in chunk order, every row with an edge is stored once and the
others are zero. The mirror's sums are bitwise the plain version's (the
kernel adds in the plain version's order), and both are held to the JAX
package: ``jax.grad`` of ``repro``'s plain K1 (unweighted) and of its
plain K3 with respect to h_proj (weighted by alpha), at the reference's
kernel tolerance rtol = atol = 1e-5.

The kernel itself runs on the card: the ``cuda``-marked test holds it
against the plain version there, and ``chip_smoke.py`` does so on the
same edge cases and on the paper's batch.
"""
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.kernels.edge_softmax.ref import edge_softmax_ref as jax_es_ref
from repro.kernels.fused_edge_softmax_aggregate.ref import \
    fused_edge_softmax_aggregate_ref as jax_k3_ref
from repro.kernels.fused_gather_aggregate import \
    fused_gather_aggregate as jax_k1
from repro_torch.kernels import (FusedGatherAggregate, dst_groups,
                                 fused_edge_softmax_aggregate, src_groups,
                                 src_scatter_cuda, src_scatter_ref)
from repro_torch.kernels.src_scatter.kernel import CHUNK as C

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(seed, degrees, v, num_dst, pad):
    """Edges of a source-keyed block: ``degrees`` maps a source row to its
    live edges, each to a seeded destination; ``pad`` masked slots (src 0,
    dst 0, as ``pad_block`` pads) mixed in; the slots shuffled."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.array(list(degrees), dtype=np.int32),
                    list(degrees.values()))
    dst = rng.integers(0, num_dst, src.size).astype(np.int32)
    mask = np.r_[np.ones(src.size, bool), np.zeros(pad, bool)]
    src = np.r_[src, np.zeros(pad, np.int32)]
    dst = np.r_[dst, np.zeros(pad, np.int32)]
    perm = rng.permutation(src.size)
    return src[perm], dst[perm], mask[perm]


def _boundary_degrees():
    """Rows of C, C - 1, C + 1 and 3C edges (and short ones), spaced by
    empty rows; row 1 starts the first chunk, row 5 the second, others
    start mid-chunk."""
    degs = [C, C - 1, 1, C + 1, 3 * C, 2, C + 1, C - 1, 3 * C, C, 5,
            2 * C + 3]
    return {r * 4 + 1: d for r, d in enumerate(degs)}, 4 * len(degs) + 3


def _skewed_degrees(seed, rows, cap):
    rng = np.random.default_rng(seed)
    return {r: int(d) for r, d in enumerate(rng.zipf(1.6, rows).clip(0, cap))
            if r % 3}


# name -> (degrees by source row, V, num_dst, masked slots)
CASES = {
    "star": ({3: 20 * C + 7}, 8, 50, 40),
    "degrees C-1..3C": (*_boundary_degrees(), 30, 60),
    "one row of exactly C": ({0: C}, 2, 9, 0),
    "one row of 3C from a boundary": ({1: 3 * C}, 3, 9, 5),
    "skewed": (_skewed_degrees(1, 300, 200), 300, 40, 100),
    "no live edge": ({}, 20, 10, 50),
    "single edge": ({4: 1}, 6, 3, 2),
}
IDS = list(CASES)


def _groups(name, seed=0):
    degrees, v, n, pad = CASES[name]
    src, dst, mask = _block(seed, degrees, v, n, pad)
    return (src, dst, mask,
            src_groups(torch.from_numpy(src), torch.from_numpy(mask), v))


def test_wrapper_chunk_is_the_kernels():
    """The wrapper sizes its scratch with the kernel's compile-time C."""
    cu = (ROOT / "src/repro_torch/csrc/src_scatter.cu").read_text()
    (chunk,) = re.findall(r"constexpr int kChunk = (\d+);", cu)
    assert int(chunk) == C and 1 <= C <= 32


@pytest.mark.parametrize("name", IDS)
def test_edge_groups_keep_each_positions_sorted_key(name):
    src, _dst, mask, g = _groups(name)
    keys = g.keys.numpy()
    order = g.order.numpy()
    n_live = int(g.offsets[-1])
    assert g.keys.dtype == torch.int32 and keys.shape == order.shape
    assert (np.diff(keys) >= 0).all()
    np.testing.assert_array_equal(keys[:n_live], src[order[:n_live]])
    assert (keys[n_live:] == g.num_groups).all()
    assert not mask[order[n_live:]].any()


@pytest.mark.parametrize("name", IDS)
def test_chunk_plan_sums_each_live_edge_once(name):
    """Every live position lies in exactly one segment of one chunk, no
    chunk holds more than C positions, and every position of a segment
    belongs to the segment's row."""
    _src, _dst, _mask, g = _groups(name)
    keys, n_live = g.keys.numpy(), int(g.offsets[-1])
    plan = emu.chunk_plan(keys, g.offsets.numpy(), C)
    assert len(plan) == -(-n_live // C)
    seen = np.zeros(n_live, int)
    for k, segs in enumerate(plan):
        for row, b, e, _start, _finish in segs:
            assert k * C <= b < e <= min((k + 1) * C, n_live)
            assert (keys[b:e] == row).all()
            seen[b:e] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("name", IDS)
def test_chunk_plan_carries_rows_on_in_chunk_order(name):
    """A row that crosses chunk boundaries starts from 0 in the chunk
    holding its first edge, publishes its running sum there and in every
    chunk it fills, and takes that carry in the next chunk, whose first
    segment it is; a warp publishes before it waits (its carried segment
    comes last). Rows inside one chunk neither take nor publish a carry."""
    _src, _dst, _mask, g = _groups(name)
    offsets = g.offsets.numpy()
    plan = emu.chunk_plan(g.keys.numpy(), offsets, C)
    published = None
    for k, segs in enumerate(plan):
        carried = [s for s in segs if s[3] == "carry"]
        if published is None:
            assert not carried
        else:
            assert [s[0] for s in carried] == [published]
            assert segs[-1] is carried[0] and carried[0][1] == k * C
        outs = [s for s in segs if s[4] == "carry"]
        assert len(outs) <= 1
        published = outs[0][0] if outs else None
        if outs:
            assert outs[0][2] == (k + 1) * C
            assert offsets[outs[0][0] + 1] > (k + 1) * C
        for row, b, e, start, finish in segs:
            inside = (offsets[row] >= k * C
                      and offsets[row + 1] <= (k + 1) * C)
            assert inside == (start == "zero" and finish == "out")
    assert published is None


@pytest.mark.parametrize("name", IDS)
def test_chunk_plan_stores_every_row_once_and_leaves_empty_rows(name):
    _src, _dst, _mask, g = _groups(name)
    offsets = g.offsets.numpy()
    plan = emu.chunk_plan(g.keys.numpy(), offsets, C)
    stored = Counter(s[0] for segs in plan for s in segs if s[4] == "out")
    live = np.flatnonzero(np.diff(offsets) > 0)
    assert sorted(stored) == live.tolist()
    assert set(stored.values()) <= {1}
    # the row's stored segment is its last: it ends where the row ends
    for segs in plan:
        for row, _b, e, _start, finish in segs:
            if finish == "out":
                assert e == offsets[row + 1]


@pytest.mark.parametrize("weighted", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("name", IDS)
def test_kernel_order_is_bitwise_the_plain_version(name, weighted):
    """The mirror adds each row's terms in the kernel's order, which is
    the plain version's: the sums agree to the bit, empty rows are 0."""
    src, dst, mask, g = _groups(name)
    v, n = CASES[name][1], CASES[name][2]
    rng = np.random.default_rng(7)
    grad = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    w = (torch.from_numpy(rng.random((len(src), 2)).astype(np.float32))
         if weighted else None)
    got = emu.src_scatter_chunked(grad, torch.from_numpy(dst), g, w)
    want = src_scatter_ref(grad, *map(torch.from_numpy, (src, dst, mask)),
                           v, w)
    assert torch.equal(got, want)
    assert not got[torch.from_numpy(np.diff(g.offsets.numpy()) == 0)].any()


def _jax_k1_grad(src, dst, mask, v, cot):
    def f(h):
        return (jax_k1(h, src, dst, mask, cot.shape[0], impl="ref")
                * cot).sum()
    return np.asarray(jax.grad(f)(jnp.zeros((v, cot.shape[1]),
                                            jnp.float32)))


def test_unweighted_sum_matches_jax_grad_of_k1():
    """K1's backward on a skewed block (one source row with 20C + 7 edges
    beside a power-law tail): ``jax.grad`` of the reference's plain K1."""
    degrees = dict(_skewed_degrees(2, 120, 60))
    degrees[5] = 20 * C + 7
    src, dst, mask = _block(3, degrees, 120, 30, 80)
    cot = np.random.default_rng(4).standard_normal((30, 24)).astype(
        np.float32)
    want = _jax_k1_grad(*(jnp.asarray(x) for x in (src, dst, mask)), 120,
                        jnp.asarray(cot))
    g = src_groups(torch.from_numpy(src), torch.from_numpy(mask), 120)
    got = emu.src_scatter_chunked(torch.from_numpy(cot),
                                  torch.from_numpy(dst), g)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_weighted_sum_matches_jax_grad_of_k3_into_h_proj():
    """K3's backward into h_proj on the same kind of block: the sum
    weighted by the reference's attention weights against ``jax.grad``
    of its plain K3 with respect to h_proj."""
    h, dh, v, n = 2, 8, 90, 25
    degrees = dict(_skewed_degrees(5, v, 50))
    degrees[7] = 12 * C + 3
    src, dst, mask = _block(6, degrees, v, n, 60)
    rng = np.random.default_rng(8)
    scores = (rng.standard_normal((len(src), h)) * 2).astype(np.float32)
    hp = rng.standard_normal((v, h, dh)).astype(np.float32)
    cot = rng.standard_normal((n, h * dh)).astype(np.float32)
    j = [jnp.asarray(x) for x in (hp, scores, src, dst, mask)]
    want = jax.grad(lambda x: (jax_k3_ref(x, *j[1:], n) * cot).sum())(j[0])
    alpha = np.array(jax_es_ref(j[1], j[3], j[4], n))
    g = src_groups(torch.from_numpy(src), torch.from_numpy(mask), v)
    got = emu.src_scatter_chunked(torch.from_numpy(cot),
                                  torch.from_numpy(dst), g,
                                  torch.from_numpy(alpha))
    np.testing.assert_allclose(got.numpy().reshape(v, h, dh),
                               np.asarray(want), **TOL)


def test_card_path_backward_on_a_hot_row(monkeypatch):
    """K1's and K3's autograd Functions on a block with one hot source
    row, through the kernels' CPU stand-ins (the source-keyed sum in the
    kernel's order): the gradients into h_src and h_proj are the plain
    path's, bit for bit here, and each backward launches the source-keyed
    kernel once."""
    fns = emu.emulate_cuda(monkeypatch)
    degrees = dict(_skewed_degrees(9, 60, 40))
    degrees[2] = 9 * C + 1
    src, dst, mask = _block(10, degrees, 60, 20, 30)
    rng = np.random.default_rng(11)
    s_t, d_t, m_t = map(torch.from_numpy, (src, dst, mask))
    h = torch.from_numpy(rng.standard_normal((60, 12)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((20, 12)).astype(np.float32))
    hg = h.clone().requires_grad_()
    out = FusedGatherAggregate.apply(hg, s_t, d_t, m_t,
                                     dst_groups(d_t, m_t, 20))
    (got,) = torch.autograd.grad((out * cot).sum(), hg)
    assert fns["src_scatter"].launches == 1
    assert torch.equal(got, src_scatter_ref(cot, s_t, d_t, m_t, 60))

    hp = torch.from_numpy(rng.standard_normal((60, 2, 6)).astype(
        np.float32)).requires_grad_()
    scores = torch.from_numpy(rng.standard_normal((len(src), 2)).astype(
        np.float32))
    out = fused_edge_softmax_aggregate(hp, scores, s_t, d_t, m_t, 20)
    (got,) = torch.autograd.grad((out * cot).sum(), hp)
    plain = hp.detach().clone().requires_grad_()
    ref = fused_edge_softmax_aggregate(plain, scores, s_t, d_t, m_t, 20,
                                       impl="ref")
    (want,) = torch.autograd.grad((ref * cot).sum(), plain)
    assert fns["src_scatter"].launches == 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", IDS)
def test_cuda_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    src, dst, mask, _ = _groups(name)
    v, n = CASES[name][1], CASES[name][2]
    s_t, d_t, m_t = (torch.from_numpy(x).cuda() for x in (src, dst, mask))
    g = src_groups(s_t, m_t, v)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for f, h in ((256, 2), (100, 2), (16, 2)):
        grad = torch.randn((n, f), generator=gen, device="cuda")
        w = torch.rand((len(src), h), generator=gen, device="cuda")
        for weights in (None, w):
            got = src_scatter_cuda(grad, d_t, g, weights)
            again = src_scatter_cuda(grad, d_t, g, weights)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                want = src_scatter_ref(grad, s_t, d_t, m_t, v, weights)
            finally:
                torch.use_deterministic_algorithms(False)
            assert torch.equal(got, again)
            torch.testing.assert_close(got, want, **TOL)
