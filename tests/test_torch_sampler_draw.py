"""The port's neighbour draw ranks only the candidates below a per-seed
threshold, where the reference ranks every candidate slot with one
``lexsort``. The two must give the same positions, byte for byte, and
leave the generator in the same state; a seed's sampled blocks must be
the reference sampler's. Nothing here has a tolerance."""
import numpy as np
import pytest

from repro.api import DistGraph as RefDistGraph
from repro.core.sampler import DistributedSampler as RefSampler
from repro.core.sampler.neighbor import \
    _subsample_positions as ref_subsample_positions
from repro.graph import get_dataset as ref_get_dataset
from repro_torch.api import DistGraph
from repro_torch.core.sampler import DistributedSampler
from repro_torch.core.sampler import neighbor
from repro_torch.graph import get_dataset
from test_torch_host import _assert_same

FANOUTS = [1, 5, 10, 15, 25]


def _degrees(case: str, fanout: int) -> np.ndarray:
    rng = np.random.default_rng(fanout)
    if case == "fanout_plus_one":
        return np.full(300, fanout + 1, dtype=np.int64)
    if case == "pareto":
        tail = (rng.pareto(1.1, 400) * 40).astype(np.int64)
        degs = np.minimum(fanout + 1 + tail, 20_000)
        degs[0] = 20_000
        return degs
    if case == "single":
        return np.array([5_000], dtype=np.int64)
    raise ValueError(case)


def _starts(degs: np.ndarray) -> np.ndarray:
    """Segments spread over an adjacency array, with gaps between them."""
    gaps = np.random.default_rng(1).integers(0, 50, len(degs))
    return np.cumsum(degs + gaps) - degs


def _draw_both(starts, degs, fanout, make_rng):
    """The reference's and the port's positions, the port's counts and
    each generator's next draw."""
    r_ref, r_port = make_rng(), make_rng()
    want = ref_subsample_positions(starts, degs, fanout, r_ref)
    draw = neighbor.DrawCounts()
    got = neighbor._subsample_positions(starts, degs, fanout, r_port, draw)
    return want, got, draw, r_ref.random(8), r_port.random(8)


def _assert_draw_equal(want, got, next_ref, next_port):
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()
    assert next_ref.tobytes() == next_port.tobytes()


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("case", ["fanout_plus_one", "pareto", "single"])
def test_draw_equal_to_reference_lexsort(case, fanout):
    degs = _degrees(case, fanout)
    starts = _starts(degs)
    want, got, counts, nr, npt = _draw_both(
        starts, degs, fanout, lambda: np.random.default_rng(2147483647))
    _assert_draw_equal(want, got, nr, npt)
    assert len(got) == len(degs) * fanout
    assert counts.candidates == degs.sum()
    assert fanout * len(degs) <= counts.sorted <= counts.candidates
    if case == "pareto":
        assert counts.sorted < counts.candidates / 4


@pytest.mark.parametrize("fanout", FANOUTS)
@pytest.mark.parametrize("case", ["fanout_plus_one", "pareto"])
def test_draw_refills_short_seeds_exactly(monkeypatch, case, fanout):
    """Margins of zero leave about half the seeds short of ``fanout``
    candidates below their threshold: each ranks all its candidates."""
    monkeypatch.setattr(neighbor, "FILTER_SIGMAS", 0.0)
    monkeypatch.setattr(neighbor, "FILTER_SLACK", 0.0)
    degs = _degrees(case, fanout)
    want, got, counts, nr, npt = _draw_both(
        _starts(degs), degs, fanout, lambda: np.random.default_rng(99))
    _assert_draw_equal(want, got, nr, npt)
    assert 0 < counts.refills < len(degs)


class _CoarseKeys:
    """A generator whose keys take 16 values, so that keys tie often."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def random(self, size):
        return np.floor(self._rng.random(size) * 16) / 16


@pytest.mark.parametrize("fanout", [1, 10])
def test_draw_orders_tied_keys_by_position(fanout):
    degs = _degrees("pareto", fanout)
    want, got, _, nr, npt = _draw_both(_starts(degs), degs, fanout,
                                       lambda: _CoarseKeys(5))
    _assert_draw_equal(want, got, nr, npt)


@pytest.fixture(scope="module")
def skewed_worlds():
    """R-MAT at scale 12: a frontier's degrees run from 1 to hundreds."""
    kw = dict(num_machines=2, trainers_per_machine=2, seed=4)
    ref = RefDistGraph(ref_get_dataset("product-sim", scale=12), **kw)
    port = DistGraph(get_dataset("product-sim", scale=12), **kw)
    return ref, port


def _subsampled_seeds(sampler, mb, fanouts):
    """Seeds with more in-neighbours than their layer's fanout, summed
    over the hops, times that fanout."""
    book, parts = sampler.book, sampler.partitions
    need = 0
    for block, fanout in zip(mb.blocks, fanouts):
        dst = block.src_gids[:block.num_dst]
        owner = book.nid2part(dst)
        local = book.nid2local(dst, owner)
        for p in np.unique(owner):
            ip = parts[p].indptr
            ids = local[owner == p]
            need += fanout * int(((ip[ids + 1] - ip[ids]) > fanout).sum())
    return need


@pytest.mark.parametrize("forced", [False, True])
def test_sampler_blocks_equal_reference_on_skewed_graph(
        skewed_worlds, monkeypatch, forced):
    if forced:
        monkeypatch.setattr(neighbor, "FILTER_SIGMAS", 0.0)
        monkeypatch.setattr(neighbor, "FILTER_SLACK", 0.0)
    ref, port = skewed_worlds
    fanouts, batch = [15, 10, 5], 64
    kw = dict(machine=0, transport=None, seed=7)
    rs = RefSampler(ref.book, ref.partitions, fanouts, batch, **kw)
    ps = DistributedSampler(port.book, port.partitions, fanouts, batch, **kw)
    seeds = port.trainer_view(0).node_split()[:batch]
    need = 0
    for index in range(2):
        mb = ps.sample(seeds, batch_index=index, epoch=1)
        _assert_same(rs.sample(seeds, batch_index=index, epoch=1), mb,
                     f"minibatch {index}")
        need += _subsampled_seeds(ps, mb, fanouts)
    st = ps.stats.as_dict()
    assert st["draw_sorted"] >= need > 0
    assert st["draw_sorted"] <= st["draw_candidates"]
    if forced:
        assert st["draw_refills"] > 0
    else:
        assert st["draw_refills"] == 0
        assert st["draw_sorted"] < st["draw_candidates"] / 2
