"""The port's link-prediction trainer against the JAX package's
``repro.training.DistGNNTrainer`` on the CPU, from the reference's initial
parameters (``params_from_numpy`` carries ``{"gnn": ..., "lp": ...}``
across): the first step's loss, MRR and gradients and three steps' losses
for GraphSAGE + dot and GAT + dot (uniform negatives), typed RGCN +
distmult (exclusion) and GraphSAGE + dot with in-batch negatives on
product-sim / mag-hetero scale 6-7 (hidden 16-32, 2 machines x 1 trainer,
unpipelined so both sample the same batches); ``evaluate_lp``'s ranks;
and that link prediction learns
(``tests/test_linkpred.py::test_lp_trainer_learns`` at its thresholds).
Fault tolerance and the launcher are in ``tests/test_torch_lp_chaos.py``.

Tolerances: losses, scores and gradients rtol 1e-4, atol 1e-5 (XLA's and
PyTorch's CPU GEMMs and scatters add in different orders); ranks exactly
wherever no candidate's score lies within twice the measured port-vs-
reference score gap of its positive's. A negative can be the positive's
own destination (an in-batch draw, or a uniform one that hits it): the
port scores it bitwise equal to the positive (one product-and-sum), so
the pessimistic rank counts it, while the reference's two einsums round
it to either side. Such self-draws are the only near ties allowed; the
tests print them, require no other, and hold MRR within what they can
move (each at most 1 / the live positives).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import DistGNNTrainer as RefTrainer
from repro.api import EdgeDataLoader as RefEdgeLoader
from repro.api import TrainJobConfig as RefJob
from repro.core.sampler import EdgeBatchSampler as RefEdgeBatchSampler
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import lp_loss_from_scores as ref_lp_loss_from_scores
from repro.models.gnn import lp_metrics as ref_lp_metrics
from repro.models.gnn import lp_ranks as ref_lp_ranks
from repro_torch.api import DistGNNTrainer, TrainJobConfig
from repro_torch.graph import get_dataset
from repro_torch.models.gnn import GNNConfig, lp_ranks, params_from_numpy
from repro_torch.optim.optimizers import tree_leaves

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

# id: (dataset, scale, model config, link-prediction job fields)
CONFIGS = {
    "graphsage-dot": ("product-sim", 7, dict(
        arch="graphsage", in_dim=100, hidden_dim=32, num_classes=32,
        fanouts=[4, 3], batch_size=16), dict(num_negs=4)),
    "gat-dot": ("product-sim", 7, dict(
        arch="gat", in_dim=100, hidden_dim=32, num_classes=32,
        fanouts=[4, 3], batch_size=16), dict(num_negs=4)),
    "rgcn-distmult-exclude": ("mag-hetero", 7, dict(
        arch="rgcn", in_dim=64, hidden_dim=16, num_classes=16,
        fanouts=[dict(FANOUTS)] * 2, batch_size=8, num_rels=4), dict(
        num_negs=2, score_fn="distmult", neg_exclude=True)),
    "graphsage-dot-inbatch": ("product-sim", 6, dict(
        arch="graphsage", in_dim=100, hidden_dim=16, num_classes=16,
        fanouts=[3, 2], batch_size=16), dict(num_negs=4,
                                             neg_mode="in-batch")),
}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    """The port's tree in the reference's leaf order (jax sorts dict
    keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _port_leaves(v)]
    return [tree.detach().cpu().numpy()]


def _check_ranks(ref_scores, port_scores, mask, self_draw):
    """Scores at the tolerance, ranks exactly outside near ties -> (ranks
    compared, rows excluded for a self-draw, other near ties). Scores
    (..., B) and (..., B, K); ``self_draw`` (..., B, K) marks candidates
    that are the positive's own destination. The window of a near tie is
    the measured gap: with every live score within ``gap`` of the
    reference's, a candidate more than ``2 * gap`` from its positive in the
    reference is on the same side of it in the port."""
    (pos_r, neg_r), (pos_p, neg_p) = ref_scores, port_scores
    assert neg_p.shape == neg_r.shape
    np.testing.assert_allclose(pos_p, pos_r, **TOL)
    np.testing.assert_allclose(neg_p, neg_r, **TOL)
    ranks_r = np.asarray(ref_lp_ranks(pos_r.reshape(-1),
                                      neg_r.reshape(-1, neg_r.shape[-1])))
    ranks_p = lp_ranks(torch.from_numpy(pos_p),
                       torch.from_numpy(neg_p)).numpy().reshape(-1)
    mask = mask.reshape(-1)
    live = mask.reshape(pos_r.shape)
    gap = max(float(np.abs(pos_p - pos_r)[live].max(initial=0.0)),
              float(np.abs(neg_p - neg_r)[live].max(initial=0.0)))
    near = np.abs(neg_r - pos_r[..., None]) <= 2 * gap
    own = (near & self_draw).any(-1).reshape(-1) & mask
    other = (near & ~self_draw).any(-1).reshape(-1) & mask
    for i in np.nonzero(own | other)[0]:
        print(f"near tie{' (self-draw)' if own[i] else ''}, gap {gap:.3e}: "
              f"ranks {ranks_r[i]} (reference) / {ranks_p[i]}")
    keep = mask & ~own & ~other
    assert np.array_equal(ranks_p[keep], ranks_r[keep])
    return int(keep.sum()), int((own & ~other).sum()), int(other.sum())


def _self_draws(batches):
    """(..., B, K): the negatives that are their positive's destination."""
    return np.stack([b.neg_dst == b.pos_dst[:, None] for b in batches])


def _ref_eval_scores(ref, num_batches):
    """The reference's ``evaluate_lp`` batches and scores (the protocol of
    ``repro/training/trainer.py::evaluate_lp``)."""
    b, k = min(ref.cfg.batch_size, 16), 49
    eval_cfg = dataclasses.replace(
        ref.node_cfg,
        batch_size=RefEdgeBatchSampler.required_node_batch(b, k, "uniform"))
    g0 = ref.graph.trainer_view(0)
    loader = RefEdgeLoader(
        g0, np.arange(g0.num_edges(), dtype=np.int64), eval_cfg.fanouts,
        batch_size=b, num_negs=k, mode="eval",
        sampler_seed=ref.job.seed + 998, edge_seed=ref.job.seed + 977)
    scores = jax.jit(lambda p, b: ref._lp_scores(p, b, cfg=eval_cfg))
    out = []
    with loader:
        for i, batch in enumerate(loader):
            if i == num_batches:
                break
            pos, neg = scores(ref.params, batch.model_input())
            out.append((batch.pair_mask, np.asarray(pos), np.asarray(neg)))
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def trained(request):
    """Reference and port trainers from the same initial params: the
    evaluation scores at those params, the first stacked batch's loss,
    MRR and gradients, then three steps."""
    name, scale, model, lp = CONFIGS[request.param]
    job = dict(num_machines=2, trainers_per_machine=1, sync=True,
               task="link_prediction", **lp)
    ref = RefTrainer(ref_get_dataset(name, scale=scale),
                     RefConfig(**model, impl="ref"), RefJob(**job))
    params0 = jax.tree.map(np.asarray, ref.params)
    port = DistGNNTrainer(get_dataset(name, scale=scale), GNNConfig(**model),
                          TrainJobConfig(**job), device="cpu",
                          params=params_from_numpy(params0))
    try:
        assert port.node_cfg.batch_size == ref.node_cfg.batch_size
        assert port.batches_per_epoch == ref.batches_per_epoch >= 3
        assert port.params.keys() == {"gnn", "lp"}
        ref_eval = _ref_eval_scores(ref, 3)
        port_eval = [(b.pair_mask, pos.numpy(), neg.numpy(),
                      _self_draws([b])[0])
                     for b, pos, neg in port.lp_eval_batches(3)]
        eval_metrics = (ref.evaluate_lp(num_batches=3),
                        port.evaluate_lp(num_batches=3))

        ref_it = [ld.epoch(0) for ld in ref.loaders]
        port_it = [ld.epoch(0) for ld in port.loaders]
        ref_first = [next(it).model_input() for it in ref_it]
        first_batches = [next(it) for it in port_it]
        port_first = [b.model_input() for b in first_batches]

        def ref_loss(p):
            def one(b):
                pos, neg = ref._lp_scores(p, b)
                return (ref_lp_loss_from_scores(pos, neg, b["pair_mask"]),
                        (ref_lp_metrics(ref_lp_ranks(pos, neg),
                                        b["pair_mask"])["mrr"], pos, neg))
            losses, (mrrs, pos, neg) = jax.vmap(one)(ref._stack(ref_first))
            return losses.mean(), (mrrs.mean(), pos, neg)

        (want_loss, (want_mrr, *want_scores)), want_grads = jax.jit(
            jax.value_and_grad(ref_loss, has_aux=True))(ref.params)
        port_stacked = port._stack(port_first)
        loss, mrr, grads = port.loss_and_grads(port_stacked)
        with torch.no_grad():
            scores = port._lp_scores(port.params, port_stacked,
                                     port.node_cfg)
        first_mask = port_stacked["pair_mask"].numpy()
        ref_steps, port_steps = [], []
        for k in range(3):
            if k:
                ref_first = [next(it).model_input() for it in ref_it]
                port_stacked = port._stack([next(it).model_input()
                                            for it in port_it])
            ref.params, ref.opt, l_ref, m_ref = ref._step(
                ref.params, ref.opt, ref._stack(ref_first))
            ref_steps.append((float(l_ref), float(m_ref)))
            l_port, m_port = port.train_step(port_stacked)
            port_steps.append((float(l_port), float(m_port)))
    finally:
        ref.stop()
        port.stop()
    return dict(ref_loss=float(want_loss), loss=float(loss),
                ref_mrr=float(want_mrr), mrr=float(mrr),
                ref_grads=_np_leaves(want_grads), grads=_port_leaves(grads),
                ref_scores=[np.asarray(x) for x in want_scores],
                scores=[x.numpy() for x in scores],
                pair_mask=first_mask, self_draw=_self_draws(first_batches),
                ref_steps=ref_steps, port_steps=port_steps,
                ref_eval=ref_eval, port_eval=port_eval,
                eval_metrics=eval_metrics, lp=lp,
                eval_b=min(model["batch_size"], 16))


def test_first_step_loss_mrr_and_gradients_match_reference(trained):
    np.testing.assert_allclose(trained["loss"], trained["ref_loss"], **TOL)
    ranked, own, near = _check_ranks(
        trained["ref_scores"], trained["scores"], trained["pair_mask"],
        trained["self_draw"])
    print(f"first step: {ranked} ranks equal, {own} self-draws and {near} "
          f"other near ties excluded")
    assert near == 0
    # slots hold equal live counts: an excluded row moves the mean MRR by
    # at most 1 / the live positives
    assert abs(trained["mrr"] - trained["ref_mrr"]) <= (
        own / (ranked + own) + TOL["atol"] + TOL["rtol"] * trained["mrr"])
    assert len(trained["grads"]) == len(trained["ref_grads"])
    if trained["lp"].get("score_fn") == "distmult":
        assert trained["grads"][-1].shape == (4, 16)      # rel_emb
    for got, want in zip(trained["grads"], trained["ref_grads"]):
        assert got.shape == want.shape
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, **TOL)


def test_three_step_losses_match_reference(trained):
    got, want = np.array(trained["port_steps"]), np.array(
        trained["ref_steps"])
    np.testing.assert_allclose(got[:, 0], want[:, 0], **TOL)       # losses
    if trained["lp"].get("neg_mode") != "in-batch":
        np.testing.assert_allclose(got[:, 1], want[:, 1], **TOL)   # MRR
    assert trained["port_steps"][0][0] == pytest.approx(trained["loss"],
                                                        rel=1e-6)


def test_evaluate_lp_ranks_match_reference(trained):
    ranked, own, near = 0, 0, 0
    for (mask_r, pos_r, neg_r), (mask_p, pos_p, neg_p, self_draw) in zip(
            trained["ref_eval"], trained["port_eval"]):
        assert mask_r.tobytes() == mask_p.tobytes()
        assert neg_p.shape[1] == 49
        n, o, t = _check_ranks((pos_r, neg_r), (pos_p, neg_p), mask_r,
                               self_draw)
        ranked, own, near = ranked + n, own + o, near + t
    print(f"evaluate_lp: {ranked} ranks equal, {own} self-draws and {near} "
          f"other near ties excluded")
    assert near == 0
    # a self-draw may rank either way in the reference, and moves MRR by
    # at most 1 / ranked positives each
    assert ranked + own == 3 * trained["eval_b"]
    want, got = trained["eval_metrics"]
    assert got.keys() == want.keys() and got["num_edges"] == ranked + own
    for k in want:
        assert abs(got[k] - want[k]) <= own / (ranked + own) + 1e-12, k


# ---------------------------------------------------------------------------
# link prediction learns
# ---------------------------------------------------------------------------

def test_lp_trainer_learns():
    """The port's ``test_lp_trainer_learns``, at its thresholds."""
    ds = get_dataset("product-sim", scale=9)
    cfg = GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                    hidden_dim=32, num_classes=32, fanouts=[5, 5],
                    batch_size=64)
    tr = DistGNNTrainer(ds, cfg, TrainJobConfig(
        num_machines=2, trainers_per_machine=1, task="link_prediction",
        num_negs=16, seed=7), device="cpu")
    assert tr.node_cfg.batch_size == 2 * 64 + 64 * 16
    assert len({len(e) for e in tr.trainer_edges}) == 1
    val0 = tr.evaluate_lp(num_batches=8)
    hist = [tr.train_epoch(e) for e in range(3)]
    val = tr.evaluate_lp(num_batches=8)
    tr.stop()
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert all(h["train_mrr"] == h["acc"] for h in hist)
    assert 0.0 < val["mrr"] <= 1.0
    assert val["mrr"] > 1.2 * val0["mrr"], (val0, val)
    assert val["mrr"] > 0.11
    assert val["hits@1"] <= val["hits@3"] <= val["hits@10"] <= 1.0
    assert val["hits@10"] < 1.0 or val["hits@1"] > 0.9
    assert val["num_edges"] == 8 * 16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("typed", [False, True], ids=["dot", "distmult"])
def test_cuda_lp_step_matches_plain_and_replays(typed):
    """On the card the link-prediction step (K1, K2, K1's backward and the
    head's K2 gathers) holds to ``impl="ref"`` on the same card (rtol
    1e-4, atol 1e-5), and two trainers end one epoch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    from repro_torch.kernels import CUDA_WRAPPERS

    ds = get_dataset("mag-hetero" if typed else "product-sim", scale=6)
    if typed:
        cfg = GNNConfig(arch="rgcn", in_dim=ds.feats.shape[1],
                        hidden_dim=16, num_classes=16,
                        fanouts=[dict(FANOUTS)] * 2, batch_size=8,
                        num_rels=ds.schema.num_etypes)
    else:
        cfg = GNNConfig(arch="graphsage", in_dim=ds.feats.shape[1],
                        hidden_dim=16, num_classes=16, fanouts=[3, 2],
                        batch_size=8)

    def trainer():
        job = TrainJobConfig(num_machines=2, trainers_per_machine=1,
                             task="link_prediction", num_negs=4, seed=5,
                             score_fn="distmult" if typed else "dot")
        return DistGNNTrainer(ds, cfg, job, device="cuda")

    a, b = trainer(), trainer()
    batch = a._stack([next(ld.epoch(0)).model_input() for ld in a.loaders])
    a.stop()
    for w in CUDA_WRAPPERS.values():
        w.launches = 0
    loss, mrr, grads = a.loss_and_grads(batch)
    assert CUDA_WRAPPERS["fused_gather_aggregate"].launches > 0
    assert CUDA_WRAPPERS["segment_sum"].launches > 0
    assert CUDA_WRAPPERS["src_scatter"].launches > 0
    ref_loss, ref_mrr, ref_grads = a.loss_and_grads(batch, impl="ref")
    torch.testing.assert_close(loss, ref_loss, **TOL)
    torch.testing.assert_close(mrr, ref_mrr, **TOL)
    for x, y in zip(tree_leaves(grads), tree_leaves(ref_grads)):
        torch.testing.assert_close(x, y, **TOL)
    a2 = trainer()
    a2.train_epoch(0)
    b.train_epoch(0)
    a2.stop()
    b.stop()
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a2.params),
                                                 tree_leaves(b.params)))
