"""K4's statistics and normalize kernels (``csrc/edge_softmax.cu``): their
schedules, through the Python mirrors in ``_torch_emulated_cuda`` built
from the constants in ``kernel.py``, run in float32.

The statistics take a thread a destination and two heads (one where H is
odd): a batch of up to ``STATS_EDGES`` order entries, then their scores,
is loaded before the online chain runs over it; a group of more than
``WARP_FROM`` live edges goes to the whole warp, 32 edges a batch, the
max before each edge from a scan of the chain's max rule over the lanes
and the denominator's chain over the lanes' exponentials in the stable
order. The normalize takes a thread a run of ``NORM_SLOTS`` consecutive
slots and gathers the statistics of live slots only. On blocks whose
groups hold every length from 0 to 100 live edges and one of 5,000, the
mirrors load each live edge's scores once and write each (destination,
head) once, and every slot once (padded ones exactly 0); they give the
bits of the one-thread-per-(destination, head) chain the kernels replace,
whatever U and the warp threshold; and they agree with the JAX package
(its oracle, its Pallas kernel in interpret mode) within its kernel
tolerance rtol = atol = 1e-5. The kernels themselves run on the card: the
``cuda``-marked tests hold them there; ``chip_smoke.py`` holds them at the
schedules' edges and at the main path's shapes.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.kernels.edge_softmax.kernel import edge_softmax_pallas
from repro.kernels.edge_softmax.ref import edge_softmax_ref as jax_es_ref
from repro_torch.kernels import (dst_groups, edge_softmax_norm_cuda,
                                 edge_softmax_ref, edge_softmax_stats_cuda)
from repro_torch.kernels.edge_softmax import kernel as k4

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = list(range(101)) + [5000]     # every group length 0-100, and long
HEADS = [1, 2, 8, 12]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(seed, lengths=LENGTHS, pad=301, spread=3.0, h=2,
           pad_dst=0):
    """Destination-keyed slots: group d holds ``lengths[d]`` live edges;
    ``pad`` masked slots with destination ``pad_dst`` (``pad_block`` pads
    with 0) mixed in; the slots shuffled, so the grouped order is not the
    slot order. Scores seeded, with ties and signed zeros. Returns (dst,
    mask, scores, order, offsets)."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    mask = np.r_[np.ones(dst.size, bool), np.zeros(pad, bool)]
    dst = np.r_[dst, np.full(pad, pad_dst, np.int32)]
    perm = rng.permutation(dst.size)
    dst, mask = dst[perm], mask[perm]
    scores = (rng.standard_normal((dst.size, h)) * spread).astype(np.float32)
    scores.flat[::7] = 1.25
    scores.flat[3::11] = np.where(np.arange(scores.flat[3::11].size) % 2,
                                  0.0, -0.0)
    g = dst_groups(torch.from_numpy(np.where(mask, dst, 0)),
                   torch.from_numpy(mask), len(lengths))
    return dst, mask, scores, g.order.numpy(), g.offsets.numpy()


def _chain(scores, order, offsets):
    """The chain the kernels replace (``tests/test_torch_gat.py``'s): one
    thread a (destination, head) walking its live edges in the stable
    order with the online max and denominator, in float32."""
    n, h = len(offsets) - 1, scores.shape[1]
    m = np.full((n, h), -1e30, np.float32)
    z = np.zeros((n, h), np.float32)
    for d in range(n):
        for i in order[offsets[d]:offsets[d + 1]]:
            s = scores[i]
            with np.errstate(over="ignore"):    # the branch not taken
                z[d] = np.where(s > m[d], z[d] * np.exp(m[d] - s) + 1,
                                z[d] + np.exp(s - m[d]))
            m[d] = np.where(s > m[d], s, m[d])
    empty = m <= -5e29
    m[empty], z[empty] = 0, 0
    return m, z


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_design_constants_are_the_librarys():
    """The wrappers check the library's constants at the first launch;
    here, that kernel.py states its source's."""
    cu = (ROOT / "src/repro_torch/csrc/edge_softmax.cu").read_text()
    got = tuple(int(re.search(rf"constexpr int {n} = (\d+);", cu).group(1))
                for n in ("kStatsEdges", "kWarpFrom", "kRing", "kNormSlots"))
    assert got == k4.DESIGN


@pytest.mark.parametrize("h", HEADS)
def test_stats_schedule_loads_once_and_writes_once(h):
    """Groups of every length 0-100 and one of 5,000: each live edge's
    order entry is loaded once a thread (H / heads a thread times) and
    each of its scores once; each (destination, head) is written once; a
    thread batch holds at most U consecutive positions of one group, and
    only groups past the threshold take the warp route."""
    dst, mask, scores, order, offsets = _block(h, h=h)
    m, z, log = emu.k4_stats_mirror(scores, order, offsets)
    lengths = np.diff(offsets)
    assert (log["score_loads"] == 1).all()
    assert (log["order_loads"] == h // emu.k4_stats_heads(h)).all()
    assert (log["writes"] == 1).all()
    assert (log["warp"] == (lengths > k4.WARP_FROM)).all()
    assert log["warp"][-1] and not log["warp"][:k4.WARP_FROM + 1].any()
    # a new max is rare in a long group in no particular order: most of
    # the 5,000-edge group's 157 batches of 32 skip the scan (a head takes
    # about ln 157 + 0.6 = 5.6 of them)
    *_, log = emu.k4_stats_mirror(scores, order[offsets[-2]:],
                                  np.array([0, 5000]))
    assert h <= log["scans"] <= 12 * h
    for batch in log["batches"]:
        assert 1 <= len(batch) <= k4.STATS_EDGES
        assert batch == list(range(batch[0], batch[0] + len(batch)))
    empty = lengths == 0
    assert not m[empty].any() and not z[empty].any()


@pytest.mark.parametrize("h", HEADS)
def test_stats_mirror_gives_the_chains_bits(h):
    """Both routes, at every U and threshold, give the bits of the
    one-thread chain (float32, the same operations in the same order),
    on scores spread over +-80 so that exp underflows inside a group, with
    ties and signed zeros, and one long group whose max is 0, reached
    first as -0."""
    dst, mask, scores, order, offsets = _block(10 + h, h=h, spread=80.0)
    long_group = order[offsets[-3]:offsets[-2]]     # 100 live edges
    scores[long_group] = -np.abs(scores[long_group]) - 1
    scores[long_group[40]] = -0.0
    scores[long_group[70]] = 0.0
    want_m, want_z = _chain(scores, order, offsets)
    assert _bits(want_m[-2]).tolist() == [0x80000000] * h
    for u, warp_from in ((None, None), (4, 0), (8, 32), (16, 1 << 30)):
        m, z, _ = emu.k4_stats_mirror(scores, order, offsets, u, warp_from)
        assert (_bits(m) == _bits(want_m)).all(), (u, warp_from)
        assert (_bits(z) == _bits(want_z)).all(), (u, warp_from)


def test_warp_scan_is_the_chains_max():
    """The scan's operator is associative on the chain's max rule: a NaN
    (no edge) is its identity, and of equal scores the earlier stays, so
    the scan's max before each lane is the chain's, bit for bit, NaN
    scores included (the chain never takes one as its max)."""
    rng = np.random.default_rng(5)
    for trial in range(200):
        s = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0, 2.0, np.nan, -1e30,
                                 -np.inf], np.float32), 32)
        m0 = np.float32(rng.choice([-1e30, -1.0, -0.0]))
        want, m = [], m0
        for x in s:
            want.append(m)
            m = x if x > m else m
        lane = np.arange(32)
        x = s.copy()
        for off in (1, 2, 4, 8, 16):
            y = np.r_[x[:off], x[:-off]]
            x = np.where(lane >= off, emu.first_max(y, x), x)
        before = np.r_[m0, emu.first_max(np.full(31, m0, np.float32),
                                         x[:-1])]
        assert (_bits(before) == _bits(np.array(want))).all(), trial
        assert _bits(emu.first_max(m0, x[31])) == _bits(m), trial


@pytest.mark.parametrize("h", HEADS)
def test_norm_schedule_writes_every_slot_once(h):
    """Every slot's alpha is written once (padded ones exactly +0), the
    statistics are gathered for live slots only (once a thread), and the
    scores are loaded only for runs holding a live slot; the result is
    the normalize expression's bits."""
    dst, mask, scores, order, offsets = _block(20 + h, h=h)
    m, z = _chain(scores, order, offsets)
    alpha, log = emu.k4_norm_mirror(scores, dst, mask, m, z)
    chunks = h // emu.k4_norm_heads(h)
    assert (log["writes"] == 1).all()
    assert (log["stat_loads"][mask] == chunks).all()
    assert not log["stat_loads"][~mask].any()
    assert (_bits(alpha[~mask]) == 0).all()
    runs = mask[:(mask.size // 4) * 4].reshape(-1, 4).any(1)
    loaded = log["score_loads"][:runs.size * 4].reshape(-1, 4, h)
    assert (loaded[runs] == 1).all() and not loaded[~runs].any()
    with np.errstate(over="ignore"):
        want = np.where(mask[:, None], np.exp(scores - m[dst])
                        / np.maximum(z[dst], np.float32(1e-30)), 0)
    assert (_bits(alpha) == _bits(want)).all()


def test_norm_never_indexes_a_padded_destination():
    """A padded slot's destination is not promised in range: the normalize
    gathers nothing by it (here 2**30, far past the statistics)."""
    dst, mask, scores, order, offsets = _block(3, pad_dst=2 ** 30)
    m, z, _ = emu.k4_stats_mirror(scores, order, offsets)
    alpha, log = emu.k4_norm_mirror(scores, dst, mask, m, z)
    assert not alpha[~mask].any() and not log["stat_loads"][~mask].any()


@pytest.mark.parametrize("h", HEADS)
def test_mirrors_match_the_jax_package(h):
    """Statistics then normalize, as the mirrors schedule them, against
    the JAX package's oracle and its Pallas kernel in interpret mode, and
    the port's plain version, within rtol = atol = 1e-5."""
    dst, mask, scores, order, offsets = _block(30 + h, h=h)
    n = len(LENGTHS)
    m, z, _ = emu.k4_stats_mirror(scores, order, offsets)
    alpha, _ = emu.k4_norm_mirror(scores, dst, mask, m, z)
    args = [jnp.asarray(x) for x in (scores, dst, mask)]
    np.testing.assert_allclose(alpha, np.asarray(jax_es_ref(*args, n)),
                               **TOL)
    np.testing.assert_allclose(
        alpha, np.asarray(edge_softmax_pallas(*args, n)), **TOL)
    plain = edge_softmax_ref(*map(torch.from_numpy, (scores, dst, mask)), n)
    np.testing.assert_allclose(alpha, plain.numpy(), **TOL)


@pytest.mark.cuda
def test_cuda_design_symbol_is_kernel_pys():
    """On the card: the library's exported constants are kernel.py's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    assert k4._library_design() == k4.DESIGN


@pytest.mark.cuda
@pytest.mark.parametrize("h", HEADS)
def test_cuda_k4_kernels_on_card(h):
    """On the card: the statistics and the normalize on groups of every
    length 0-100 and one of 5,000, padded destinations out of range, on
    the aligned route and from scores 4 bytes past a 16-byte boundary: m
    exactly the mirror's (the plain max), z and alpha within rtol = atol =
    1e-5 of the mirrors' float32 replay (the card fuses the chain's
    multiply-add) and of the plain version, each equal to a second
    launch, padded slots 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    dst, mask, scores, order, offsets = _block(40 + h, h=h,
                                               pad_dst=2 ** 30)
    n = len(LENGTHS)
    want_m, want_z, _ = emu.k4_stats_mirror(scores, order, offsets)
    want_a, _ = emu.k4_norm_mirror(scores, dst, mask, want_m, want_z)
    ed, em = torch.from_numpy(dst).cuda(), torch.from_numpy(mask).cuda()
    g = dst_groups(ed, em, n)
    s_c = torch.from_numpy(scores).cuda()
    odd = torch.empty(s_c.numel() + 1, device="cuda")[1:].view(
        s_c.shape).copy_(s_c)
    plain = edge_softmax_ref(torch.from_numpy(scores),
                             torch.from_numpy(np.where(mask, dst, 0)),
                             torch.from_numpy(mask), n).numpy()
    for s in (s_c, odd):
        m, z = edge_softmax_stats_cuda(s, g)
        m2, z2 = edge_softmax_stats_cuda(s, g)
        alpha = edge_softmax_norm_cuda(s, ed, em, m, z)
        assert torch.equal(alpha, edge_softmax_norm_cuda(s, ed, em, m, z))
        assert torch.equal(m, m2) and torch.equal(z, z2)
        assert np.array_equal(m.cpu().numpy(), want_m)
        np.testing.assert_allclose(z.cpu().numpy(), want_z, **TOL)
        np.testing.assert_allclose(alpha.cpu().numpy(), want_a, **TOL)
        np.testing.assert_allclose(alpha.cpu().numpy(), plain, **TOL)
        assert not alpha[~em].any()
