"""K2 (``csrc/segment_sum.cu``) and K1's forward
(``csrc/fused_gather_aggregate.cu``): their schedules, through the Python
mirrors in ``_torch_emulated_cuda`` built from the constants in each
``kernel.py``.

K2's schedule is keyed on F alone: lanes across edges up to
``SMALL_F_MAX`` features (sub-warps of ``SUB_WARP`` lanes, each loading
``EDGE_LOADS`` edges a batch), lanes across features above it, as K1's
forward always is (U rows gathered before the adds). On a block whose
groups hold every length from 0 to 100 live edges, the mirrors load and
add each live edge exactly once, in the group's stable order; replayed in
float32 one add at a time, they give ``segment_sum_ref`` and
``fused_gather_aggregate_ref`` to the bit, on unit-scale values that
nearly cancel within each group, and the JAX package's plain versions
within its kernel tolerance rtol = atol = 1e-5.

The emulated card route shows the launch counts the redesign keeps: one
``sage_layer`` forward launches K1 and K2 once each, one GAT training step
of three layers launches K2 six times. The kernels themselves run on the
card: the ``cuda``-marked test holds them bitwise against the plain
versions there, and ``chip_smoke.py`` does so at the schedules' edges and
at the main paths' shapes.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.kernels.fused_gather_aggregate.ref import \
    fused_gather_aggregate_ref as jax_k1_ref
from repro.kernels.segment_sum.ref import segment_sum_ref as jax_k2_ref
from repro_torch.api import DistGNNTrainer, TrainJobConfig
from repro_torch.graph import get_dataset
from repro_torch.kernels import (dst_groups, fused_gather_aggregate_cuda,
                                 fused_gather_aggregate_ref, segment_sum_cuda,
                                 segment_sum_ref)
from repro_torch.kernels.fused_gather_aggregate import kernel as k1
from repro_torch.kernels.segment_sum import kernel as k2
from repro_torch.models.gnn import GNNConfig, init_gnn, sage_layer

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = list(range(101))          # every group length 0-100
V = 300                             # K1's source rows


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _cancelling(rng, keys, mask, f, num_keys):
    """Unit-scale rows whose live ones nearly cancel within each key: the
    key's float64 mean is taken off before the rows are rounded to
    float32, so each group's sum is rounding noise and its last bits
    depend on the order of the adds."""
    x = rng.standard_normal((keys.size, f))
    live = np.flatnonzero(mask)
    sums = np.zeros((num_keys, f))
    np.add.at(sums, keys[live], x[live])
    counts = np.bincount(keys[live], minlength=num_keys)[:, None]
    x[live] -= (sums / np.maximum(counts, 1))[keys[live]]
    return x.astype(np.float32)


def _constants(name, *names):
    cu = (ROOT / f"src/repro_torch/csrc/{name}.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", cu).group(1))
                 for n in names)


def test_design_constants_are_the_libraries():
    """The wrappers check the libraries' constants at the first launch;
    here, that each kernel.py states its source's."""
    assert _constants("segment_sum", "kSmallFMax", "kSubWarp", "kEdgeLoads",
                      "kGatherFloats", "kMaxVecsPerLane") == k2.DESIGN
    assert _constants("fused_gather_aggregate", "kGatherFloatsFew",
                      "kGatherFloatsMid", "kGatherFloatsMany", "kFewDst",
                      "kManyDst", "kMaxVecsPerLane") == k1.DESIGN
    assert 32 % k2.SUB_WARP == 0 and k2.SUB_WARP * k2.EDGE_LOADS <= 64


@pytest.mark.parametrize("f", [1, 2, 3, 8, 9, 16, 100, 256])
def test_segment_sum_schedule_is_keyed_on_f(f):
    """Lanes across edges for the F = 1 of ``_degrees`` and the F = 2 of
    GAT's logit gradients, lanes across features for the rows of F = 100
    and 256; the switch reads nothing but F."""
    want = "edges" if f <= 8 else "rows"
    assert k2.SMALL_F_MAX == 8
    assert k2.schedule(f) == want
    cu = (ROOT / "src/repro_torch/csrc/segment_sum.cu").read_text()
    assert "F <= kSmallFMax ? F : 0" in cu


@pytest.mark.parametrize("num_dst,budget", [
    (1, "few"), (64, "few"), (1024, "few"), (1025, "mid"), (4224, "mid"),
    (8192, "mid"), (8193, "many"), (66000, "many")])
def test_k1_register_budget_is_keyed_on_the_launch_size(num_dst, budget):
    """K1 gathers more rows at once in a launch of few destinations and
    keeps more warps resident in one of many; the choice reads nothing but
    the number of destinations."""
    want = {"few": k1.GATHER_FLOATS_FEW, "mid": k1.GATHER_FLOATS_MID,
            "many": k1.GATHER_FLOATS_MANY}[budget]
    assert k1.gather_floats(num_dst) == want
    assert (k1.GATHER_FLOATS_MANY <= k1.GATHER_FLOATS_MID
            <= k1.GATHER_FLOATS_FEW)
    cu = (ROOT / "src/repro_torch/csrc/fused_gather_aggregate.cu").read_text()
    assert "if (num_dst > kManyDst)" in cu and "if (num_dst > kFewDst)" in cu


@pytest.mark.parametrize("cols,vec", [(1, 1), (3, 1), (25, 4), (100, 1),
                                      (64, 4), (256, 1), (300, 4)])
def test_row_tiling_covers_every_column_once(cols, vec):
    """NV column vectors a lane, slabs of 32 * NV, U rows in flight: every
    column vector of the row is held by exactly one (slab, lane, j), and a
    lane never holds more than its budget of gathered floats where one
    row fits in it."""
    for consts in ((k2.GATHER_FLOATS, k2.MAX_VECS_PER_LANE),
                   (k1.GATHER_FLOATS_FEW, k1.MAX_VECS_PER_LANE),
                   (k1.GATHER_FLOATS_MID, k1.MAX_VECS_PER_LANE),
                   (k1.GATHER_FLOATS_MANY, k1.MAX_VECS_PER_LANE)):
        nv, slabs, u = k2.row_tiling(cols, vec, *consts)
        assert nv <= consts[1] and 1 <= u <= 32
        held = sorted(c for c, _ in emu.row_columns(cols, nv, slabs))
        assert held == list(range(cols))
        if nv * vec <= consts[0]:
            assert u * nv * vec <= consts[0]


def _plan(kernel, f, vec, offsets, num_dst=None):
    """{group: positions in the order they are added}, with each live
    position's order-entry and row loads counted; K1's budget is the one
    of a launch of ``num_dst`` destinations (the block's own by default)."""
    n_live = int(offsets[-1])
    index_loads = np.zeros(n_live, int)
    row_loads = np.zeros(n_live, int)
    adds = {}
    if kernel == "K2" and k2.schedule(f) == "edges":
        for warp in emu.edge_schedule(offsets):
            longest = max(-(-int(offsets[g + 1] - offsets[g])
                            // (k2.SUB_WARP * k2.EDGE_LOADS))
                          for g in warp[0]) if warp else 0
            assert len(warp) == longest
            for batch in warp:
                for g, (index, rows, added) in batch.items():
                    beg, end = int(offsets[g]), int(offsets[g + 1])
                    for lane, p in index + rows:
                        assert beg <= p < end
                        assert lane == (p - beg) % k2.SUB_WARP
                    for _lane, p in index:
                        index_loads[p] += 1
                    for _lane, p in rows:
                        row_loads[p] += 1
                    adds.setdefault(g, []).extend(added)
        return adds, index_loads, row_loads
    if num_dst is None:
        num_dst = len(offsets) - 1
    consts = ((k2.GATHER_FLOATS, k2.MAX_VECS_PER_LANE) if kernel == "K2"
              else (k1.gather_floats(num_dst), k1.MAX_VECS_PER_LANE))
    for g in range(len(offsets) - 1):
        beg = int(offsets[g])
        (nv, _slabs, u), batches = emu.row_schedule(
            int(offsets[g + 1]) - beg, f, vec, *consts)
        assert u * nv * vec <= max(consts[0], nv * vec)
        adds[g] = []
        for index, rounds in batches:
            for lane, p in index:
                assert lane == p % 32
                index_loads[beg + p] += 1
            for positions in rounds:
                assert len(positions) <= u
                for p in positions:
                    row_loads[beg + p] += 1
                adds[g].extend(beg + p for p in positions)
    return adds, index_loads, row_loads


# (kernel, F, column vector width, K1's launch size: few or many)
CASES = ([("K2", f, v, None) for f, v in ((1, 1), (2, 1), (3, 1), (100, 4),
                                          (100, 1), (256, 4), (256, 1))]
         + [("K1", f, v, few) for f, v in ((1, 1), (2, 1), (3, 1), (100, 4),
                                           (100, 1), (256, 4), (256, 1))
            for few in ("few", "mid", "many")])


@pytest.mark.parametrize(
    "kernel,f,vec,launch", CASES,
    ids=[f"{k}-F{f}-vec{v}" + (f"-{n}" if n else "") for k, f, v, n in CASES])
def test_schedule_adds_each_live_edge_once_in_stable_order(kernel, f, vec,
                                                          launch):
    """Groups of every length 0-100: each live position's order entry and
    row are loaded once and added once, in the group's stable order;
    replayed in float32 the sums are the plain version's to the bit, and
    the JAX package's within its tolerance."""
    src, dst, mask = _block(f * 7 + vec, LENGTHS, 300)
    n = len(LENGTHS)
    groups = dst_groups(torch.from_numpy(dst), torch.from_numpy(mask), n)
    offsets, order = groups.offsets.numpy(), groups.order.numpy()
    adds, index_loads, row_loads = _plan(
        kernel, f, vec, offsets,
        {"mid": k1.FEW_DST + 1, "many": k1.MANY_DST + 1}.get(launch))
    assert (index_loads == 1).all() and (row_loads == 1).all()
    assert sorted(adds) == list(range(n))
    for d in range(n):
        assert adds[d] == list(range(offsets[d], offsets[d + 1]))
        np.testing.assert_array_equal(
            order[offsets[d]:offsets[d + 1]],
            np.flatnonzero(mask & (dst == d)))

    rng = np.random.default_rng(f)
    src_t, dst_t, mask_t = map(torch.from_numpy, (src, dst, mask))
    if kernel == "K2":
        msg = _cancelling(rng, dst, mask, f, n)
        rows = torch.from_numpy(msg)[groups.order.long()]
        want = segment_sum_ref(torch.from_numpy(msg), dst_t, mask_t, n)
        jax_want = jax_k2_ref(*map(jnp.asarray, (msg, dst, mask)), n)
    else:
        # each live edge's source row differs, so the rows cancel as the
        # messages do: h has one row per live edge, edge_src points at it
        live = np.flatnonzero(mask)
        src = np.zeros_like(src)
        src[live] = np.arange(live.size, dtype=np.int32)
        h = _cancelling(rng, dst, mask, f, n)[live]
        src_t = torch.from_numpy(src)
        rows = torch.from_numpy(h)[src_t[groups.order.long()].long()]
        want = fused_gather_aggregate_ref(torch.from_numpy(h), src_t, dst_t,
                                          mask_t, n)
        jax_want = jax_k1_ref(*map(jnp.asarray, (h, src, dst, mask)), n)
    got = torch.stack([emu.replay(rows, adds[d]) for d in range(n)])
    assert torch.equal(got, want)
    assert not got[0].any()                        # the empty group
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want), **TOL)


def test_short_groups_share_a_warp_and_long_ones_run_in_batches():
    """Lanes across edges on the tick's groups (at most 15 edges, several
    to a warp) beside a 308-edge group (the largest source group of the
    GAT step): a warp runs its longest group's batch count, and the long
    group's batches follow each other in its order."""
    lengths = [15, 3, 0, 15, 1, 9, 308, 2, 14, 15, 0, 7]
    _src, dst, mask = _block(3, lengths, 40)
    g = dst_groups(torch.from_numpy(dst), torch.from_numpy(mask),
                   len(lengths))
    offsets = g.offsets.numpy()
    per_warp = 32 // k2.SUB_WARP
    b = k2.SUB_WARP * k2.EDGE_LOADS
    warps = emu.edge_schedule(offsets)
    assert len(warps) == -(-len(lengths) // per_warp)
    for w, batches in enumerate(warps):
        mine = lengths[w * per_warp:(w + 1) * per_warp]
        assert len(batches) == max(-(-n // b) for n in mine)
        assert all(set(batch) == set(range(w * per_warp,
                                           w * per_warp + len(mine)))
                   for batch in batches)
    long_warp = warps[6 // per_warp]
    added = [p for batch in long_warp for p in batch[6][2]]
    assert added == list(range(offsets[6], offsets[7]))
    assert len(long_warp) == -(-308 // b)


def test_bf16_sums_in_float32_and_rounds_once():
    """K2 in bfloat16: the schedule's float32 sum rounded once, on the
    store, is the plain version's sum taken in float32 and rounded once,
    and within the JAX package's bfloat16 tolerance."""
    lengths = [0, 1, 15, 31, 32, 33, 64, 100]
    _src, dst, mask = _block(4, lengths, 20)
    n, f = len(lengths), 100
    rng = np.random.default_rng(4)
    msg = torch.from_numpy(_cancelling(rng, dst, mask, f, n)).to(
        torch.bfloat16)
    g = dst_groups(torch.from_numpy(dst), torch.from_numpy(mask), n)
    adds, _, _ = _plan("K2", f, 4, g.offsets.numpy())
    rows = msg[g.order.long()]
    got = torch.stack([emu.replay(rows, adds.get(d, []))
                       for d in range(n)]).to(torch.bfloat16)
    dst_t, mask_t = torch.from_numpy(dst), torch.from_numpy(mask)
    assert torch.equal(got, segment_sum_ref(msg.float(), dst_t, mask_t,
                                            n).to(torch.bfloat16))
    want = jax_k2_ref(jnp.asarray(msg.float().numpy(), jnp.bfloat16),
                      jnp.asarray(dst), jnp.asarray(mask), n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.1,
                               atol=0.5)


def test_sage_layer_forward_launches_k1_and_k2_once(monkeypatch):
    """One ``sage_layer`` forward on the emulated card route: K1, then
    ``agg / _degrees(...)`` with K2 over the mask, one launch each, and the
    plain path's output."""
    fns = emu.emulate_cuda(monkeypatch)
    rng = np.random.default_rng(12)
    src, dst, mask = _block(12, [3, 0, 5, 15, 1, 7], 10)
    block = {"edge_src": torch.from_numpy(src),
             "edge_dst": torch.from_numpy(dst),
             "edge_mask": torch.from_numpy(mask)}
    cfg = GNNConfig(arch="graphsage", in_dim=12, hidden_dim=8,
                    num_classes=4, fanouts=[15], batch_size=6)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    h = torch.from_numpy(rng.standard_normal((V, 12)).astype(np.float32))
    got = sage_layer(params["layers"][0], h, block, 6)
    assert {k: f.launches for k, f in fns.items() if f.launches} == {
        "fused_gather_aggregate": 1, "segment_sum": 1}
    want = sage_layer(params["layers"][0], h, block, 6, impl="ref")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_gat_step_launches_k2_six_times(monkeypatch):
    """One GAT training step of three layers on the emulated card route:
    the gradients of each layer's source and destination logits are K2
    over the source and the destination groups, two launches a layer."""
    tr = DistGNNTrainer(get_dataset("product-sim", scale=10),
                        GNNConfig(arch="gat", in_dim=100, hidden_dim=16,
                                  num_classes=16, fanouts=[3, 3, 3],
                                  batch_size=8, num_heads=2),
                        TrainJobConfig(num_machines=2,
                                       trainers_per_machine=1, sync=True),
                        device="cpu")
    try:
        stacked = tr._stack([next(ld.epoch(0)).model_input()
                             for ld in tr.loaders])
    finally:
        tr.stop()
    fns = emu.emulate_cuda(monkeypatch)
    loss, _acc, _grads = tr.loss_and_grads(stacked)
    assert np.isfinite(float(loss))
    assert fns["segment_sum"].launches == 6
    assert fns["fused_gather_aggregate"].launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2, 3, 100, 256])
def test_cuda_kernels_bitwise_on_card(f):
    """On the card: K1 and K2 (float32, both column routes) bitwise equal
    to the plain versions and to a second launch, on groups of every
    length 0-100 and one of 5,000; K2 in bfloat16 bitwise the float32 sum
    rounded once. The plain versions run on the CPU, where ``index_add_``
    adds in order (on the card its deterministic kernel sums a group of
    32 or more with a warp tree where F = 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    src, dst, mask = _block(f, LENGTHS + [5000], 500)
    n = len(LENGTHS) + 1
    s_t, d_t, m_t = (torch.from_numpy(x).cuda() for x in (src, dst, mask))
    g = dst_groups(d_t, m_t, n)
    rng = np.random.default_rng(f)
    msg = torch.from_numpy(_cancelling(rng, dst, mask, f, n)).cuda()
    h = torch.from_numpy(rng.standard_normal((V, f)).astype(np.float32))
    h = h.cuda()
    # 4 bytes past a 16-byte boundary: the scalar columns
    h_odd = torch.empty(V * f + 1, device="cuda")[1:].view(V, f).copy_(h)
    msg_odd = torch.empty(msg.numel() + 1, device="cuda")[1:].view(
        msg.shape).copy_(msg)
    host = [torch.from_numpy(x) for x in (src, dst, mask)]
    for x in (msg, msg_odd):
        got = segment_sum_cuda(x, g)
        assert torch.equal(got, segment_sum_cuda(x, g))
        assert torch.equal(got.cpu(), segment_sum_ref(x.cpu(), *host[1:],
                                                      n))
    bf = msg.to(torch.bfloat16)
    got = segment_sum_cuda(bf, g)
    assert torch.equal(got.cpu(), segment_sum_ref(
        bf.float().cpu(), *host[1:], n).to(torch.bfloat16))
    for x in (h, h_odd):
        got = fused_gather_aggregate_cuda(x, s_t, g)
        assert torch.equal(got, fused_gather_aggregate_cuda(x, s_t, g))
        assert torch.equal(got.cpu(), fused_gather_aggregate_ref(
            x.cpu(), *host, n))
