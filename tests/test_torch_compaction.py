"""The port's device-side ``to_block`` compaction and ``segment_max_ref``
against the JAX package.

``to_block_device`` is held to the reference's ``to_block_device`` and to
``to_block_reference`` on the live entries, exactly: ``n_uniq``,
``uniq[:n_uniq]`` and ``edge_src`` where ``edge_mask`` is set (the padded
slots' ranks are free: every padded id ties at ``_BIG``). The draws are
``tests/test_sampler.py``'s, plus the blocks of a real product-sim batch,
whose host order is first occurrence, so the result also equals the
block's own ``src_gids`` and ``edge_src``. ``segment_max_ref`` is held
bit for bit, destinations with no edge and int32 included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.sampler import to_block_device as ref_to_block_device
from repro.core.sampler import to_block_reference as ref_to_block_reference
from repro.kernels import segment_max_ref as ref_segment_max
from repro_torch.api import DistGraph
from repro_torch.core.sampler import (DistributedSampler, sample_ego_networks,
                                      to_block_device, to_block_reference)
from repro_torch.graph import get_dataset
from repro_torch.kernels import segment_max_ref


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seed_g, seed_m, eg, em, cap):
    u, n, es = to_block_device(torch.from_numpy(seed_g),
                               torch.from_numpy(seed_m),
                               torch.from_numpy(eg), torch.from_numpy(em),
                               cap)
    assert u.dtype == es.dtype == n.dtype == torch.int32
    assert u.shape == (cap,) and es.shape == eg.shape
    return u.numpy(), int(n), es.numpy()


def _check_live(got, want, em):
    u, n, es = got
    u_w, n_w, es_w = want
    assert n == n_w
    assert np.array_equal(u[:n], np.asarray(u_w)[:n])
    assert np.array_equal(es[em], np.asarray(es_w)[em])


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_to_block_device_matches_reference(data):
    rng_seed = data.draw(st.integers(0, 1000))
    rng = np.random.default_rng(rng_seed)
    n_seed = data.draw(st.integers(1, 8))
    n_edge = data.draw(st.integers(1, 32))
    seed_g = rng.integers(0, 50, n_seed).astype(np.int64)
    seed_g = np.unique(seed_g)  # seeds are unique in real batches
    n_seed = len(seed_g)
    seed_m = np.ones(n_seed, bool)
    eg = rng.integers(0, 50, n_edge).astype(np.int64)
    em = rng.random(n_edge) > 0.2
    cap = n_seed + n_edge
    got = _port(seed_g, seed_m, eg, em, cap)
    _check_live(got, to_block_reference(seed_g, seed_m, eg, em, cap), em)
    _check_live(got, ref_to_block_reference(seed_g, seed_m, eg, em, cap),
                em)
    ref = ref_to_block_device(seed_g, seed_m, eg, em, cap_src=cap)
    _check_live(got, ref, em)
    # the padded slots repeat slot 0, as the reference's do
    assert np.array_equal(got[0], np.asarray(ref[0]))


@pytest.mark.parametrize("cut", [1, 3])
def test_to_block_device_drops_ranks_past_cap_src(cut):
    """A ``cap_src`` below the unique count drops the later ranks (the
    reference's ``mode="drop"``); every kept slot and edge index is the
    reference's."""
    rng = np.random.default_rng(cut)
    seed_g = np.arange(4, dtype=np.int64) * 7
    seed_m = np.array([True, True, False, True])
    eg = rng.integers(0, 60, 40).astype(np.int64)
    em = rng.random(40) > 0.25
    n_live = len(np.unique(np.concatenate([seed_g[seed_m], eg[em]])))
    cap = n_live // cut - 1
    got = _port(seed_g, seed_m, eg, em, cap)
    u, n, es = (np.asarray(x) for x in ref_to_block_device(
        seed_g, seed_m, eg, em, cap_src=cap))
    assert got[1] == int(n) == n_live
    assert np.array_equal(got[0], u)
    assert np.array_equal(got[2][em], es[em])


@pytest.fixture(scope="module")
def real_batch():
    """One product-sim batch (scale 10, 64 seeds, fanouts 5/4/3) sampled
    by the port's host sampler."""
    g = DistGraph(get_dataset("product-sim", scale=10), num_machines=2,
                  trainers_per_machine=1, seed=0)
    sampler = DistributedSampler(g.book, g.partitions, [5, 4, 3], 64,
                                 machine=g.machine, transport=None, seed=0)
    seeds = np.random.default_rng(0).choice(g.num_nodes(), 64,
                                            replace=False)
    return next(sample_ego_networks(sampler, g.new_client(), g.feat_name,
                                    seeds, drop_last=False))


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_to_block_device_on_a_real_batch(real_batch, layer):
    b = real_batch.blocks[layer]
    cap_dst = b.cap_src - b.cap_edge
    seed_g = b.src_gids[:cap_dst]
    seed_m = np.arange(cap_dst) < b.num_dst
    eg = b.src_gids[b.edge_src]
    em = b.edge_mask
    got = _port(seed_g, seed_m, eg, em, b.cap_src)
    _check_live(got, to_block_reference(seed_g, seed_m, eg, em, b.cap_src),
                em)
    _check_live(got, ref_to_block_device(seed_g, seed_m, eg, em,
                                         cap_src=b.cap_src), em)
    # the sampler's host order is first occurrence: the block itself
    assert got[1] == b.num_src
    assert np.array_equal(got[0][:b.num_src], b.src_gids[:b.num_src])
    assert np.array_equal(got[2][em], b.edge_src[em])


@pytest.mark.parametrize("dtype,neutral", [
    (np.float32, -1e30), (np.float32, -3.5), (np.int32, -7),
    (np.int32, -1e30)])
@pytest.mark.parametrize("seed", range(4))
def test_segment_max_ref_matches_reference(dtype, neutral, seed):
    rng = np.random.default_rng(seed)
    e, n = 60, 23
    x = (rng.standard_normal(e) * 10).astype(dtype)
    # destinations past num_dst are dropped; several get no edge at all
    dst = rng.integers(0, n + 3, e).astype(np.int32)
    dst[dst == 5] = 6
    mask = rng.random(e) > 0.3
    mask[dst == 9] = False            # only masked edges: ``neutral``
    want = np.asarray(ref_segment_max(jnp.asarray(x), jnp.asarray(dst),
                                      jnp.asarray(mask), n,
                                      neutral=neutral))
    got = segment_max_ref(torch.from_numpy(x), torch.from_numpy(dst),
                          torch.from_numpy(mask), n,
                          neutral=neutral).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert want[5] == (-np.inf if want.dtype.kind == "f"
                       else np.iinfo(want.dtype).min)


def test_segment_max_ref_rows():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    dst = rng.integers(0, 12, 30).astype(np.int32)
    mask = rng.random(30) > 0.4
    want = np.asarray(ref_segment_max(jnp.asarray(x), jnp.asarray(dst),
                                      jnp.asarray(mask)[:, None], 12))
    got = segment_max_ref(torch.from_numpy(x), torch.from_numpy(dst),
                          torch.from_numpy(mask)[:, None], 12).numpy()
    assert got.tobytes() == want.tobytes()
