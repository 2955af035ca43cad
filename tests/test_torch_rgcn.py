"""The port's RGCN against ``repro.models.gnn``: ``rgcn_layer`` in the
typed (relation-major, static ``rel_offsets``) and the untyped
(``edge_types`` mask) layout, with the stack axis, and the 2-layer
``apply_gnn`` on real padded batches sampled from mag-hetero (typed) and
mag-sim (untyped), with the reference's ``init_gnn`` parameters carried
across through ``params_from_numpy``.

Tolerances: one layer on synthetic blocks rtol = atol = 1e-5, the
reference's own kernel tolerance (``tests/test_kernels.py``), against the
reference's plain version and its Pallas kernels in interpret mode; the
model rtol = 1e-4, atol = 1e-5, because XLA's and PyTorch's CPU GEMMs
accumulate in different orders. The card's path (K1, its backward and K2
as autograd Functions over grouped orders) runs here through the kernels'
CPU stand-ins (``_torch_emulated_cuda``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.api import DistGraph as RefDistGraph
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import apply_gnn as ref_apply_gnn
from repro.models.gnn import init_gnn as ref_init_gnn
from repro.models.gnn.layers import rgcn_layer as ref_rgcn_layer
from repro_torch.api import DistGraph
from repro_torch.core.pipeline.minibatch import host_blocks
from repro_torch.core.sampler import (DistributedSampler, pad_typed_block,
                                      sample_ego_networks)
from repro_torch.graph import get_dataset
from repro_torch.models.gnn import (GNNConfig, apply_gnn, init_gnn,
                                    params_from_numpy, rgcn_layer)
from repro_torch.optim.optimizers import tree_leaves, tree_map

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
TYPED_FANOUTS = {"cites": 4, "writes": 3, "rev_writes": 2, "employs": 2}
NUM_DST, NUM_RELS, CAP_SRC = 5, 3, 14
REL_OFFSETS = (0, 10, 15, 25)        # relation budgets of 10, 5 and 10 slots


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(rng, empty_rel=None):
    """A typed block of NUM_RELS relations (3, 2 and 6 live edges; none
    for ``empty_rel``) padded with ``pad_typed_block``, as the host
    arrays the layers take."""
    src_gids = np.arange(11, dtype=np.int64)
    sizes = [0 if r == empty_rel else k for r, k in enumerate((3, 2, 6))]
    rel_es = [rng.integers(0, 11, k).astype(np.int32) for k in sizes]
    rel_ed = [rng.integers(0, NUM_DST, k).astype(np.int32) for k in sizes]
    b = pad_typed_block(src_gids, rel_es, rel_ed, num_dst=NUM_DST,
                        cap_src=CAP_SRC, rel_offsets=np.array(REL_OFFSETS))
    return dict(edge_src=b.edge_src, edge_dst=b.edge_dst,
                edge_mask=b.edge_mask, edge_types=b.edge_types)


def _params(rng, d_in, d_out):
    return {"w_rel": rng.standard_normal((NUM_RELS, d_in, d_out)).astype(
                np.float32),
            "w_self": rng.standard_normal((d_in, d_out)).astype(np.float32),
            "b": rng.standard_normal(d_out).astype(np.float32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_impl", ["ref", "pallas"])
@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
@pytest.mark.parametrize("d_in,d_out", [(6, 5), (16, 16)])
@pytest.mark.parametrize("act", ["relu", None])
def test_rgcn_layer_matches_reference(ref_impl, typed, d_in, d_out, act):
    rng = np.random.default_rng(d_in)
    block = _block(rng)
    h = rng.standard_normal((CAP_SRC, d_in)).astype(np.float32)
    params = _params(rng, d_in, d_out)
    offs = REL_OFFSETS if typed else None
    want = ref_rgcn_layer(_jax_tree(params), jnp.asarray(h),
                          _jax_tree(block), NUM_DST, NUM_RELS,
                          activation=jax.nn.relu if act else None,
                          impl=ref_impl, rel_offsets=offs)
    got = rgcn_layer(params_from_numpy(params), torch.from_numpy(h),
                     _torch_tree(block), NUM_DST, NUM_RELS,
                     activation=torch.relu if act else None,
                     rel_offsets=offs)
    assert got.shape == (NUM_DST, d_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("empty_rel", [None, 1])
def test_typed_layout_equals_untyped_and_ignores_padded_slots(empty_rel):
    """As ``tests/test_hetero.py::test_typed_padding_masked_out_of_
    aggregation`` pins it for the reference: the typed slices give the
    untyped masks' result, and in-range garbage in the padded slots
    changes no bit; a relation with no live edge adds nothing."""
    rng = np.random.default_rng(0)
    block = _block(rng, empty_rel)
    h = torch.from_numpy(rng.standard_normal((CAP_SRC, 6)).astype(
        np.float32))
    params = params_from_numpy(_params(rng, 6, 5))
    typed = rgcn_layer(params, h, _torch_tree(block), NUM_DST, NUM_RELS,
                       rel_offsets=REL_OFFSETS)
    untyped = rgcn_layer(params, h, _torch_tree(block), NUM_DST, NUM_RELS)
    np.testing.assert_allclose(typed.numpy(), untyped.numpy(), atol=1e-6)

    pad = ~block["edge_mask"]
    block["edge_src"][pad] = rng.integers(0, CAP_SRC, pad.sum())
    block["edge_dst"][pad] = rng.integers(0, NUM_DST, pad.sum())
    garbage = rgcn_layer(params, h, _torch_tree(block), NUM_DST, NUM_RELS,
                         rel_offsets=REL_OFFSETS)
    assert torch.equal(garbage, typed)


@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
def test_stacked_layer_equals_each_slot_bitwise(typed):
    """A stack of S = 3 blocks: each slot's rows are the bytes of its
    block run alone (the typed slices are cut per slot before the slots
    are offset into one flat block)."""
    rng = np.random.default_rng(3)
    blocks = [_block(rng), _block(rng, empty_rel=0), _block(rng)]
    hs = rng.standard_normal((3, CAP_SRC, 16)).astype(np.float32)
    params = params_from_numpy(_params(rng, 16, 16))
    offs = REL_OFFSETS if typed else None
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *blocks)
    got = rgcn_layer(params, torch.from_numpy(hs), _torch_tree(stacked),
                     NUM_DST, NUM_RELS, rel_offsets=offs)
    assert got.shape == (3, NUM_DST, 16)
    for i, b in enumerate(blocks):
        alone = rgcn_layer(params, torch.from_numpy(hs[i]), _torch_tree(b),
                           NUM_DST, NUM_RELS, rel_offsets=offs)
        assert torch.equal(got[i], alone)


# ---------------------------------------------------------------------------
# init and the model
# ---------------------------------------------------------------------------

def test_init_gnn_rgcn_has_reference_limits_and_is_seeded():
    """``w_rel`` (R, d_in, d_out) takes its fan-in from R, as the
    reference's ``_glorot`` does, and is then divided by sqrt(R)."""
    kw = dict(arch="rgcn", in_dim=20, hidden_dim=24, num_classes=6,
              fanouts=[3, 2], batch_size=4, num_rels=4)
    p = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0))
    q = init_gnn(GNNConfig(**kw), torch.Generator().manual_seed(0))
    ref = ref_init_gnn(RefConfig(**kw), jax.random.PRNGKey(0))
    for lp, lq, lr in zip(p["layers"], q["layers"], ref["layers"]):
        assert set(lp) == set(lr) == {"w_rel", "w_self", "b"}
        for k in lp:
            assert tuple(lp[k].shape) == tuple(lr[k].shape)
            assert torch.equal(lp[k], lq[k])
        r, d_in, d_out = lp["w_rel"].shape
        for w, lim in ((lp["w_rel"], np.sqrt(6.0 / (r + d_out)) / np.sqrt(r)),
                       (lp["w_self"], np.sqrt(6.0 / (d_in + d_out)))):
            assert float(w.abs().max()) <= lim * (1 + 1e-6)
            assert float(w.abs().max()) > 0.5 * lim
        assert not lp["b"].any()
    assert not torch.equal(p["layers"][0]["w_rel"],
                           init_gnn(GNNConfig(**kw), torch.Generator()
                                    .manual_seed(1))["layers"][0]["w_rel"])


def _sampled(dataset, fanouts, hetero, batch_size=8, scale=10):
    """The reference's config and params and two real padded host batches
    (the second ragged) of ``dataset``."""
    ds = get_dataset(dataset, scale=scale)
    g = DistGraph(ds, num_machines=2, trainers_per_machine=1, seed=0,
                  hetero=hetero)
    kw = dict(arch="rgcn", in_dim=ds.feats.shape[1], hidden_dim=16,
              num_classes=ds.num_classes, fanouts=fanouts,
              batch_size=batch_size, num_rels=ds.graph.num_etypes)
    sampler = DistributedSampler(
        g.book, g.partitions, fanouts, batch_size, machine=0,
        transport=None, seed=0, schema=g.schema if hetero else None,
        ntype_of_node=g.typed.ntype_of_node if hetero else None)
    batches = [{"input_feats": mb.input_feats, "blocks": host_blocks(mb)}
               for mb in sample_ego_networks(
                   sampler, g.new_client(), g.feat_name,
                   np.arange(3, 160, 11), typed=g.typed,
                   drop_last=False)]
    ref_params = jax.tree.map(np.asarray, ref_init_gnn(
        RefConfig(**kw), jax.random.PRNGKey(2)))
    return kw, g, ref_params, batches


@pytest.mark.parametrize("dataset,hetero", [("mag-hetero", True),
                                            ("mag-sim", False)],
                         ids=["typed-mag-hetero", "untyped-mag-sim"])
def test_apply_gnn_matches_reference(dataset, hetero):
    fanouts = ([dict(TYPED_FANOUTS)] * 2 if hetero else [4, 3])
    kw, g, ref_params, batches = _sampled(dataset, fanouts, hetero)
    etype_id = g.schema.etype_id if hetero else None
    assert len(batches) == 2
    params = params_from_numpy(ref_params)
    for batch in batches:
        if hetero:
            assert batch["blocks"][0]["edge_types"] is not None
        want = ref_apply_gnn(RefConfig(**kw, impl="ref"),
                             _jax_tree(ref_params), _jax_tree(batch),
                             etype_id=etype_id)
        got = apply_gnn(GNNConfig(**kw), params, _torch_tree(batch),
                        etype_id=etype_id)
        assert got.shape == (kw["batch_size"], kw["num_classes"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)


def test_reference_world_samples_the_same_typed_batches():
    """The batches above are the reference's own: the typed host plane
    is the reference's, byte for byte."""
    fanouts = [dict(TYPED_FANOUTS)] * 2
    _kw, g, _p, batches = _sampled("mag-hetero", fanouts, True)
    from repro.core.sampler import DistributedSampler as RefSampler
    from repro.core.sampler import sample_ego_networks as ref_sample
    rg = RefDistGraph(ref_get_dataset("mag-hetero", scale=10),
                      num_machines=2, trainers_per_machine=1, seed=0,
                      hetero=True)
    rs = RefSampler(rg.book, rg.partitions, fanouts, 8, machine=0,
                    transport=None, seed=0, schema=rg.schema,
                    ntype_of_node=rg.typed.ntype_of_node)
    ref = list(ref_sample(rs, rg.new_client(), rg.feat_name,
                          np.arange(3, 160, 11), typed=rg.typed,
                          drop_last=False))
    assert len(ref) == len(batches)
    for mb, batch in zip(ref, batches):
        assert mb.input_feats.tobytes() == batch["input_feats"].tobytes()
        for rb, b in zip(mb.blocks, batch["blocks"]):
            for k in ("edge_src", "edge_dst", "edge_mask", "edge_types"):
                assert getattr(rb, k).tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the card's path, with the kernels' CPU stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
def test_card_path_forward_and_backward_match_plain_path(monkeypatch,
                                                         typed):
    """RGCN through the autograd Functions, the grouped orders and the
    backward kernel (CPU stand-ins) gives the plain path's logits and
    gradients. K1 and K2 launch once for each live relation of each
    layer; K1's backward runs at both layers, since layer 0's
    projections need a gradient for ``w_rel``."""
    fanouts = ([dict(TYPED_FANOUTS)] * 2 if typed else [4, 3])
    dataset = "mag-hetero" if typed else "mag-sim"
    kw, g, ref_params, batches = _sampled(dataset, fanouts, typed)
    etype_id = g.schema.etype_id if typed else None
    cfg = GNNConfig(**kw)
    stacked = _torch_tree(jax.tree.map(lambda *xs: np.stack(xs), *batches))
    params = params_from_numpy(ref_params)

    def loss_and_grads():
        leaves = [p.clone().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _p: next(it), params)
        logits = apply_gnn(cfg, live, stacked, etype_id=etype_id)
        loss = (logits * torch.linspace(-1, 1, logits.numel()).view(
            logits.shape)).sum()
        return logits.detach(), torch.autograd.grad(loss, leaves)

    want_logits, want_grads = loss_and_grads()
    fns = emu.emulate_cuda(monkeypatch)
    got_logits, got_grads = loss_and_grads()
    np.testing.assert_allclose(got_logits.numpy(), want_logits.numpy(),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    launches = 2 * kw["num_rels"]        # every relation, both layers
    assert fns["fused_gather_aggregate"].launches == launches
    assert fns["segment_sum"].launches == launches
    assert fns["src_scatter"].launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("typed", [True, False], ids=["typed", "untyped"])
def test_cuda_rgcn_matches_reference_and_launches_on_card(typed):
    """On the card the RGCN forward (K1, K2) gives the reference's logits
    (rtol 1e-4, atol 1e-5), and its gradients through K1's backward are
    the plain path's on the card within the same tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    from repro_torch.kernels import CUDA_WRAPPERS

    fanouts = ([dict(TYPED_FANOUTS)] * 2 if typed else [4, 3])
    kw, g, ref_params, batches = _sampled(
        "mag-hetero" if typed else "mag-sim", fanouts, typed)
    etype_id = g.schema.etype_id if typed else None
    cfg = GNNConfig(**kw)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *batches)
    want = np.asarray(jax.vmap(lambda b: ref_apply_gnn(
        RefConfig(**kw, impl="ref"), _jax_tree(ref_params), b,
        etype_id=etype_id))(_jax_tree(stacked)))
    on_card = tree_map(lambda t: t.cuda(), _torch_tree(stacked))

    def run(impl):
        leaves = [p.clone().requires_grad_()
                  for p in tree_leaves(params_from_numpy(ref_params, "cuda"))]
        it = iter(leaves)
        live = tree_map(lambda _p: next(it), params_from_numpy(ref_params))
        logits = apply_gnn(GNNConfig(**{**kw, "impl": impl}), live, on_card,
                           etype_id=etype_id)
        return logits.detach(), torch.autograd.grad(logits.square().sum(),
                                                    leaves)

    for w in CUDA_WRAPPERS.values():
        w.launches = 0
    logits, grads = run("auto")
    assert CUDA_WRAPPERS["fused_gather_aggregate"].launches == 2 * cfg.num_rels
    assert CUDA_WRAPPERS["segment_sum"].launches == 2 * cfg.num_rels
    assert CUDA_WRAPPERS["src_scatter"].launches == 2 * cfg.num_rels
    np.testing.assert_allclose(logits.cpu().numpy(), want, **MODEL_TOL)
    _plain_logits, plain_grads = run("ref")
    for a, b in zip(grads, plain_grads):
        torch.testing.assert_close(a, b, **MODEL_TOL)
