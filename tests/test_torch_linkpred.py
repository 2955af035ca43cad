"""The port's link-prediction host plane and score heads against the JAX
package's (``tests/test_linkpred.py``'s checks, mirrored): edge mini-batches
from ``repro_torch.api.EdgeDataLoader`` byte-identical to
``repro.api.EdgeDataLoader``'s (homogeneous product-sim and typed
mag-hetero at scale 9; uniform, in-batch and exclusion negatives; cache on
and off; async and sync pipelines; the eval protocol), the edge schedule
and the negative sampler, and ``init_lp_head``, ``lp_pair_scores``,
``lp_loss_from_scores``, ``lp_ranks`` and ``lp_metrics`` on seeded inputs.

Tolerances: scores, losses and their gradients rtol 1e-4, atol 1e-5 (XLA's
``einsum`` and the port's product-and-sum add in different orders);
integer-valued embeddings make every score exact, so there the scores,
ranks and MRR compare bitwise; batches, schedules, negatives and ranks
computed from the same scores compare exactly.
"""
import dataclasses
import hashlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_emulated_cuda as emu
from repro.api import DistGraph as RefDistGraph
from repro.api import EdgeDataLoader as RefEdgeLoader
from repro.core.kvstore import CacheConfig as RefCacheConfig
from repro.core.sampler import NegativeSampler as RefNegativeSampler
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import init_lp_head as ref_init_lp_head
from repro.models.gnn import lp_loss as ref_lp_loss
from repro.models.gnn import lp_loss_from_scores as ref_lp_loss_from_scores
from repro.models.gnn import lp_metrics as ref_lp_metrics
from repro.models.gnn import lp_pair_scores as ref_lp_pair_scores
from repro.models.gnn import lp_ranks as ref_lp_ranks
from repro_torch.api import DistGNNTrainer, DistGraph, EdgeDataLoader
from repro_torch.api import TrainJobConfig
from repro_torch.core.kvstore import CacheConfig
from repro_torch.core.sampler import (DistributedSampler, EdgeBatchSampler,
                                      NegativeSampler)
from repro_torch.graph import get_dataset
from repro_torch.models.gnn import (GNNConfig, init_lp_head, lp_loss,
                                    lp_loss_from_scores, lp_metrics,
                                    lp_pair_scores, lp_ranks)

SCALE = 9
FANOUTS = {"cites": 4, "writes": 3, "rev_writes": 2, "employs": 2}
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# edge mini-batches: byte-identical to the reference's loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    out = {}
    for kind, name, hetero in (("homo", "product-sim", False),
                               ("typed", "mag-hetero", True)):
        kw = dict(num_machines=2, trainers_per_machine=1, seed=0,
                  hetero=hetero)
        out[kind] = (
            RefDistGraph(ref_get_dataset(name, scale=SCALE), **kw),
            DistGraph(get_dataset(name, scale=SCALE), **kw))
    return out


def _fanouts(kind):
    return [dict(FANOUTS)] * 2 if kind == "typed" else [4, 3]


def _edge_leaves(batch) -> dict:
    """Every array of an edge batch the step or the scorer reads, keyed by
    path (the staged tree and the pair graph's gids)."""
    tree = batch.model_input()
    out = {k: np.asarray(tree[k]) for k in tree if k != "blocks"}
    for i, b in enumerate(tree["blocks"]):
        for k, v in b.items():
            if v is not None:
                out[f"blocks/{i}/{k}"] = np.asarray(v)
    for k in ("pos_eids", "pos_src", "pos_dst", "neg_dst", "input_nodes"):
        out[k] = np.asarray(getattr(batch, k))
    out["etype"] = np.asarray(batch.etype)
    return out


def _loader_batches(cls, graph, kind, n, **kw):
    view = graph.trainer_view(1)
    cache_cls = RefCacheConfig if cls is RefEdgeLoader else CacheConfig
    cache = (view.feature_cache(cache_cls.from_mb(8)) if kw.pop("cache")
             else None)
    with cls(view, view.edge_split(), _fanouts(kind), cache=cache,
             **kw) as ld:
        got = [_edge_leaves(b) for b in itertools.islice(ld.epoch(0), n)]
        return got, len(ld), cache


CASES = {
    # id: (world, neg_mode, neg_exclude, cache, sync, mode)
    "homo-uniform-async": ("homo", "uniform", False, False, False, "train"),
    "homo-inbatch-sync": ("homo", "in-batch", False, False, True, "train"),
    "homo-exclude-cache": ("homo", "uniform", True, True, False, "train"),
    "typed-exclude-async": ("typed", "uniform", True, False, False, "train"),
    "typed-inbatch-cache-sync": ("typed", "in-batch", False, True, True,
                                 "train"),
    "homo-eval": ("homo", "uniform", False, False, False, "eval"),
    "typed-eval": ("typed", "uniform", False, False, False, "eval"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_edge_loader_batches_byte_identical(worlds, case):
    kind, neg_mode, exclude, cache, sync, mode = CASES[case]
    ref_g, g = worlds[kind]
    kw = dict(batch_size=8, num_negs=3, neg_mode=neg_mode,
              neg_exclude=exclude, cache=cache, mode=mode, seed=5,
              sampler_seed=7, edge_seed=9)
    if mode == "train":
        kw["sync"] = sync
    want, want_len, _ = _loader_batches(RefEdgeLoader, ref_g, kind, 4,
                                        **dict(kw))
    got, got_len, port_cache = _loader_batches(EdgeDataLoader, g, kind, 4,
                                               **dict(kw))
    assert got_len == want_len >= 4
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    if kind == "typed":
        assert all(b["edge_etypes"].tolist() == [int(b["etype"])] * 8
                   for b in got)
    if cache:
        assert port_cache.stats()["hits"] > 0


def _stream_hash(g, cache, sync):
    """One epoch of a 256-edge pool through the port's edge loader, every
    array and feature row hashed."""
    view = g.trainer_view(0)
    c = view.feature_cache(CacheConfig.from_mb(8)) if cache else None
    h = hashlib.sha256()
    with EdgeDataLoader(view, view.edge_split()[:256], [4, 3], batch_size=16,
                        num_negs=2, cache=c, sync=sync, non_stop=False,
                        seed=43, edge_seed=41) as ld:
        n = 0
        for b in ld.epoch(0):
            for v in _edge_leaves(b).values():
                h.update(np.ascontiguousarray(v).tobytes())
            n += 1
    return h.hexdigest(), n, c


def test_edge_stream_unchanged_by_cache_and_pipelining(worlds):
    _ref_g, g = worlds["homo"]
    plain, n, _ = _stream_hash(g, cache=False, sync=True)
    assert n == 256 // 16
    cached, _, cache = _stream_hash(g, cache=True, sync=False)
    assert cached == plain
    assert cache.stats()["hits"] > 0, "cache never hit: proves nothing"
    assert _stream_hash(g, cache=False, sync=False)[0] == plain


# ---------------------------------------------------------------------------
# the edge schedule
# ---------------------------------------------------------------------------

def _edge_sampler(g, B, K, **kw):
    view = g.trainer_view(0)
    node = DistributedSampler(
        view.book, view.partitions, kw.pop("fanouts", [5, 5]),
        EdgeBatchSampler.required_node_batch(B, K, kw.get("neg_mode",
                                                           "uniform")),
        machine=0, seed=5, schema=view.schema if view.hetero else None,
        ntype_of_node=view.typed.ntype_of_node if view.hetero else None)
    e_src, e_dst = view.edge_endpoints()
    return EdgeBatchSampler(node, e_src, e_dst, view.edge_split(), B, K,
                            seed=5, **kw)


def test_schedule_covers_owned_edges_without_repeats(worlds):
    _ref_g, g = worlds["homo"]
    es = _edge_sampler(g, 64, 3)
    owned = g.trainer_view(0).edge_split()
    seen = [eids for _e, _b, _et, eids in
            es.schedule(np.random.default_rng(1), 0)]
    assert all(len(e) == 64 for e in seen)
    flat = np.concatenate(seen)
    assert len(flat) == len(np.unique(flat)), "an edge was scheduled twice"
    assert np.isin(flat, owned).all()
    assert len(seen) == es.batches_per_epoch == len(owned) // 64
    # fast-forward skips emissions only: the rest is the live schedule's
    tail = [eids for _e, _b, _et, eids in
            es.schedule(np.random.default_rng(1), 0, start_batch=3)]
    assert all(np.array_equal(a, b) for a, b in zip(seen[3:], tail))


def test_typed_schedule_single_relation_batches(worlds):
    _ref_g, g = worlds["typed"]
    view = g.trainer_view(0)
    typed, schema = view.typed, view.schema
    pools = [typed.type2node[schema.dst_ntype_id(r)]
             for r in range(schema.num_etypes)]
    es = _edge_sampler(g, 16, 3, fanouts=[dict(FANOUTS)] * 2,
                       etype_of_edge=typed.etype_of_edge, schema=schema,
                       neg_pools=pools)
    counts = [len(p) // 16 for p in es._etype_pools]
    assert es.batches_per_epoch == sum(counts) < len(es.owned_eids) // 16
    seen = {}
    for _e, b, et, eids in es.schedule(np.random.default_rng(2), 0):
        assert (typed.etype_of_edge[eids] == et).all(), \
            "typed batch mixes relations"
        seen[et] = seen.get(et, 0) + 1
        if seen[et] == 1:
            emb = es.sample_edges(eids, etype=et, batch_index=b)
            assert emb.etype == et and (emb.edge_etypes == et).all()
            want = schema.dst_ntype_id(et)
            assert (typed.ntype_of_node[emb.neg_dst.ravel()] == want).all()
    assert [seen.get(r, 0) for r in range(schema.num_etypes)] == counts
    assert sum(c > 0 for c in counts) >= 2


def test_edge_minibatch_layout(worlds):
    _ref_g, g = worlds["homo"]
    B, K = 16, 3
    es = _edge_sampler(g, B, K)
    owned = es.owned_eids
    emb = es.sample_edges(owned[:B])
    seeds = emb.mb.seeds
    assert np.array_equal(seeds[emb.pos_u], emb.pos_src)
    assert np.array_equal(seeds[emb.pos_v], emb.pos_dst)
    assert np.array_equal(seeds[emb.neg_v], emb.neg_dst)
    assert emb.pair_mask.all() and emb.neg_v.shape == (B, K)
    emb2 = es.sample_edges(owned[:5])
    assert emb2.pair_mask.sum() == 5 and len(emb2.pair_mask) == B
    assert emb2.mb.seeds.shape == emb.mb.seeds.shape


# ---------------------------------------------------------------------------
# the negative sampler
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_negative_sampler_no_false_negatives(data):
    """Static (B, K) shapes, no negative equal to a positive pair of the
    batch under exclusion (unless the row's whole candidate set is
    positive), and the reference sampler's draws exactly."""
    seed = data.draw(st.integers(0, 10_000))
    B = data.draw(st.integers(2, 24))
    K = data.draw(st.integers(1, 6))
    n = data.draw(st.integers(3, 40))
    mode = data.draw(st.sampled_from(["uniform", "in-batch"]))
    exclude = data.draw(st.booleans())
    rng = np.random.default_rng(seed)
    pos_src = rng.integers(0, n, size=B).astype(np.int64)
    pos_dst = rng.integers(0, n, size=B).astype(np.int64)

    kw = dict(mode=mode, seed=seed + 1, exclude_batch_positives=exclude)
    neg, idx = NegativeSampler(n, K, **kw).sample(pos_src, pos_dst, -1,
                                                  epoch=2, batch_index=3)
    want, want_idx = RefNegativeSampler(n, K, **kw).sample(
        pos_src, pos_dst, -1, epoch=2, batch_index=3)
    assert neg.dtype == want.dtype and neg.tobytes() == want.tobytes()
    assert neg.shape == (B, K) and (0 <= neg).all() and (neg < n).all()
    if mode == "in-batch":
        assert idx.shape == (B, K) and idx.tobytes() == want_idx.tobytes()
        assert np.array_equal(neg, pos_dst[idx])
    if not exclude:
        return
    pos_keys = set((pos_src * n + pos_dst).tolist())
    cand = pos_dst if mode == "in-batch" else np.arange(n, dtype=np.int64)
    for i in range(B):
        if all(int(pos_src[i] * n + c) in pos_keys for c in cand):
            continue
        for k in range(K):
            assert int(pos_src[i] * n + neg[i, k]) not in pos_keys, (
                f"false negative at ({i},{k})")


def test_negative_pools_restrict_candidates():
    rng = np.random.default_rng(0)
    pool = np.array([100, 200, 300, 400], dtype=np.int64)
    neg, _ = NegativeSampler(1000, 4, pools=[pool], seed=3).sample(
        rng.integers(0, 1000, 8), rng.integers(0, 1000, 8), etype=0)
    assert np.isin(neg, pool).all()


# ---------------------------------------------------------------------------
# the score heads, the loss, ranks and metrics
# ---------------------------------------------------------------------------

S, B, K, D, R = 2, 12, 5, 16, 3
N = 2 * B + B * K


def _head_inputs(seed=0, scale=1.0):
    """Seeded (S, ...) stacked inputs: embeddings, the [u | v | neg] index
    layout (neg_v into the v section for in-batch draws on slot 1),
    relation ids and a relation table."""
    rng = np.random.default_rng(seed)
    h = (scale * rng.standard_normal((S, N, D))).astype(np.float32)
    pos_u = np.tile(np.arange(B, dtype=np.int32), (S, 1))
    pos_v = B + pos_u
    neg_v = np.stack([
        (2 * B + np.arange(B * K, dtype=np.int32)).reshape(B, K),
        B + rng.integers(0, B, size=(B, K)).astype(np.int32)])
    etypes = rng.integers(0, R, size=(S, B)).astype(np.int32)
    rel_emb = (1 + 0.3 * rng.standard_normal((R, D))).astype(np.float32)
    mask = np.ones((S, B), dtype=bool)
    mask[1, -4:] = False
    return h, pos_u, pos_v, neg_v, etypes, rel_emb, mask


@pytest.mark.parametrize("score_fn", ["dot", "distmult", "cosine"])
def test_init_lp_head_matches_reference(score_fn):
    if score_fn == "cosine":
        for fn in (init_lp_head, ref_init_lp_head):
            with pytest.raises(ValueError, match="unknown score_fn"):
                fn(score_fn, R, D)
        return
    got, want = init_lp_head(score_fn, R, D), ref_init_lp_head(score_fn, R, D)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()


@pytest.mark.parametrize("stacked", [False, True], ids=["flat", "stacked"])
@pytest.mark.parametrize("negatives", [False, True], ids=["pos", "neg"])
@pytest.mark.parametrize("score_fn", ["dot", "distmult"])
def test_pair_scores_match_reference(score_fn, negatives, stacked):
    h, pos_u, pos_v, neg_v, etypes, rel_emb, _ = _head_inputs()
    v = neg_v if negatives else pos_v
    head = {"rel_emb": rel_emb} if score_fn == "distmult" else {}

    def ref(hh, u, vv, et):
        return ref_lp_pair_scores(hh, u, vv, head=jax.tree.map(
            jnp.asarray, head), score_fn=score_fn, etypes=et)

    if stacked:
        want = np.asarray(jax.vmap(ref)(h, pos_u, v, etypes))
        args = (h, pos_u, v, etypes)
    else:
        want = np.asarray(ref(h[1], pos_u[1], v[1], etypes[1]))
        args = (h[1], pos_u[1], v[1], etypes[1])
    th, tu, tv, te = (torch.from_numpy(a) for a in args)
    got = lp_pair_scores(th, tu, tv, head={k: torch.from_numpy(x)
                                           for k, x in head.items()},
                         score_fn=score_fn, etypes=te)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="unknown score_fn"):
        lp_pair_scores(th, tu, tv, score_fn="cosine")


def test_loss_from_scores_and_gradients_match_reference():
    """Scores up to +-200, where softplus is x or 0 to float32 precision,
    and the reference's ``logaddexp(x, 0)`` and PyTorch's thresholded
    ``softplus`` part ways."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-200, 200, size=(S, B)).astype(np.float32)
    neg = rng.uniform(-200, 200, size=(S, B, K)).astype(np.float32)
    pos[0, :4] = [-30.0, 25.0, 0.0, -80.0]
    mask = _head_inputs()[-1]

    def ref(p, n):
        return jax.vmap(ref_lp_loss_from_scores)(p, n, mask).mean()

    want, (want_gp, want_gn) = jax.value_and_grad(ref, argnums=(0, 1))(
        pos, neg)
    tp = torch.from_numpy(pos).requires_grad_()
    tn = torch.from_numpy(neg).requires_grad_()
    losses = lp_loss_from_scores(tp, tn, torch.from_numpy(mask))
    assert losses.shape == (S,)
    got = losses.mean()
    gp, gn = torch.autograd.grad(got, (tp, tn))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(want_gp), **TOL)
    np.testing.assert_allclose(gn.numpy(), np.asarray(want_gn), **TOL)
    assert not gp[1, -4:].any() and not gn[1, -4:].any()   # masked slots


def test_lp_loss_matches_reference():
    h, pos_u, pos_v, neg_v, _et, _rel, mask = _head_inputs(seed=2)
    want = float(ref_lp_loss(h[0], pos_u[0], pos_v[0], neg_v[0], mask[0]))
    got = lp_loss(*(torch.from_numpy(a[0]) for a in (h, pos_u, pos_v, neg_v,
                                                     mask)))
    np.testing.assert_allclose(float(got), want, **TOL)


def test_ranks_and_metrics_match_reference():
    """Ranks from the same scores are exact (ties, planted here, count
    against the positive); MRR and Hits@k at rtol 1e-6 per slot."""
    rng = np.random.default_rng(4)
    pos = rng.integers(-5, 6, size=(S, B)).astype(np.float32)
    neg = rng.integers(-5, 6, size=(S, B, K)).astype(np.float32)
    mask = _head_inputs()[-1]
    want = np.asarray(jax.vmap(ref_lp_ranks)(pos, neg))
    got = lp_ranks(torch.from_numpy(pos), torch.from_numpy(neg))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (neg == pos[..., None]).any(), "no tie planted"
    want_m = jax.vmap(ref_lp_metrics)(want, mask)
    got_m = lp_metrics(got, torch.from_numpy(mask))
    assert got_m.keys() == want_m.keys() == {"mrr", "hits@1", "hits@3",
                                             "hits@10"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("score_fn", ["dot", "distmult"])
def test_mrr_oracle_bitwise(score_fn):
    """Integer-valued embeddings make every product and sum exact: the
    port's scores, ranks and MRR equal a dense NumPy oracle bit for bit
    (the reference's ``test_mrr_oracle_bitwise``)."""
    rng = np.random.default_rng(42)
    b, k, d, r = 32, 5, 16, 4
    n = 2 * b + b * k
    h = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    pos_u = np.arange(b, dtype=np.int32)
    pos_v = b + np.arange(b, dtype=np.int32)
    neg_v = (2 * b + np.arange(b * k, dtype=np.int32)).reshape(b, k)
    etypes = rng.integers(0, r, size=b).astype(np.int32)
    mask = np.ones(b, dtype=bool)
    mask[-3:] = False
    head = {}
    if score_fn == "distmult":
        head = {"rel_emb": rng.integers(-3, 4, size=(r, d)).astype(
            np.float32)}
    th = {k_: torch.from_numpy(v) for k_, v in head.items()}
    kw = dict(head=th, score_fn=score_fn, etypes=torch.from_numpy(etypes))
    ht = torch.from_numpy(h)
    pos = lp_pair_scores(ht, torch.from_numpy(pos_u), torch.from_numpy(pos_v),
                         **kw).numpy()
    neg = lp_pair_scores(ht, torch.from_numpy(pos_u), torch.from_numpy(neg_v),
                         **kw).numpy()
    ranks = lp_ranks(torch.from_numpy(pos), torch.from_numpy(neg))
    metrics = lp_metrics(ranks, torch.from_numpy(mask))

    hu = h[pos_u]
    if score_fn == "distmult":
        hu = hu * head["rel_emb"][etypes]
    pos_o = (hu * h[pos_v]).sum(axis=1)
    neg_o = (hu[:, None, :] * h[neg_v]).sum(axis=2)
    assert np.array_equal(pos, pos_o) and np.array_equal(neg, neg_o)
    ranks_o = 1 + (neg_o >= pos_o[:, None]).sum(axis=1)
    assert np.array_equal(ranks.numpy(), ranks_o)
    rr = ranks_o[mask].astype(np.float64)
    assert float(metrics["mrr"]) == pytest.approx((1.0 / rr).mean(),
                                                  abs=1e-6)
    for k_ in (1, 3, 10):
        assert float(metrics[f"hits@{k_}"]) == pytest.approx(
            (rr <= k_).mean(), abs=1e-6)


@pytest.mark.parametrize("score_fn", ["dot", "distmult"])
def test_card_path_head_gradients_sum_in_a_fixed_order(monkeypatch,
                                                       score_fn):
    """On the card the head's gathers go through ``gather_edges``, whose
    backward is K2 over the indices grouped in their order (here its CPU
    stand-in): the same scores and, since each row's gradient is summed
    in index order as ``index_select``'s CPU backward sums it, the same
    gradient bits as the plain path, the in-batch negatives' repeated rows
    and distmult's one relation row included. K2 launches once for each
    gather that needs a gradient."""
    h, pos_u, pos_v, neg_v, etypes, rel_emb, mask = _head_inputs(seed=3)

    def run():
        th = torch.from_numpy(h).requires_grad_()
        rel = torch.from_numpy(rel_emb).requires_grad_()
        head = {"rel_emb": rel} if score_fn == "distmult" else {}
        kw = dict(head=head, score_fn=score_fn,
                  etypes=torch.from_numpy(etypes))
        u = torch.from_numpy(pos_u)
        pos = lp_pair_scores(th, u, torch.from_numpy(pos_v), **kw)
        neg = lp_pair_scores(th, u, torch.from_numpy(neg_v), **kw)
        loss = lp_loss_from_scores(pos, neg, torch.from_numpy(mask)).mean()
        leaves = (th, rel) if head else (th,)
        return pos, neg, torch.autograd.grad(loss, leaves)

    want = run()
    # the gathers are kernels.keyed_rows, whose impl switch emulate_cuda
    # routes to the card's path
    fns = emu.emulate_cuda(monkeypatch)
    got = run()
    for a, b in zip(got[:2] + got[2], want[:2] + want[2]):
        assert torch.equal(a, b)
    assert fns["segment_sum"].launches == (6 if score_fn == "distmult"
                                           else 4)


def test_lp_rejects_bad_config(worlds):
    ds = get_dataset("product-sim", scale=7)
    cfg = GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                    hidden_dim=8, num_classes=8, fanouts=[3], batch_size=8)
    with pytest.raises(ValueError, match="unknown task"):
        TrainJobConfig(task="edge_divination")
    # a node sampler of another capacity is refused up front
    _ref_g, g = worlds["homo"]
    view = g.trainer_view(0)
    e_src, e_dst = view.edge_endpoints()
    s = DistributedSampler(view.book, view.partitions, [3], 10, machine=0)
    with pytest.raises(ValueError, match="endpoint capacity"):
        EdgeBatchSampler(s, e_src, e_dst, np.arange(100), 8, 4)
    with pytest.raises(ValueError, match="unknown negative mode"):
        NegativeSampler(10, 2, mode="hard")
    # an edge batch larger than a trainer's owned pool
    with pytest.raises(ValueError, match="exceeds the per-trainer "
                                         "owned-edge pool"):
        DistGNNTrainer(ds, dataclasses.replace(cfg, batch_size=4096),
                       TrainJobConfig(num_machines=2, trainers_per_machine=1,
                                      task="link_prediction", num_negs=2),
                       device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("score_fn", ["dot", "distmult"])
def test_cuda_head_is_deterministic_and_matches_plain(score_fn):
    """On the card the head's scores and gradients are bitwise equal
    between two runs (K2 sums the repeated rows' gradients in a fixed
    order) and within rtol 1e-4, atol 1e-5 of the CPU plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    h, pos_u, pos_v, neg_v, etypes, rel_emb, mask = _head_inputs(seed=5)

    def run(device):
        th = torch.from_numpy(h).to(device).requires_grad_()
        rel = torch.from_numpy(rel_emb).to(device).requires_grad_()
        head = {"rel_emb": rel} if score_fn == "distmult" else {}
        kw = dict(head=head, score_fn=score_fn,
                  etypes=torch.from_numpy(etypes).to(device))
        u = torch.from_numpy(pos_u).to(device)
        pos = lp_pair_scores(th, u, torch.from_numpy(pos_v).to(device), **kw)
        neg = lp_pair_scores(th, u, torch.from_numpy(neg_v).to(device), **kw)
        loss = lp_loss_from_scores(pos, neg,
                                   torch.from_numpy(mask).to(device)).mean()
        leaves = (th, rel) if head else (th,)
        return [t.detach().cpu() for t in
                (pos, neg, *torch.autograd.grad(loss, leaves))]

    first, second, plain = run("cuda"), run("cuda"), run("cpu")
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, **TOL)
