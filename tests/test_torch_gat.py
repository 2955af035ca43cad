"""The port's GAT against ``repro``'s: K4 (edge softmax) and K3 (the fused
attention tail) as plain versions against the reference's oracles and its
Pallas kernels in interpret mode, values and gradients (``torch.autograd``
against ``jax.grad`` of the oracle), empty destinations and all-padded
blocks included; the card's path through the autograd Function with the
kernels' CPU stand-ins; ``gat_layer`` and a GAT ``apply_gnn`` with the
reference's ``init_gnn`` parameters, with and without the stack axis; and
GAT serving against the reference's server.

Tolerances: kernels rtol = atol = 1e-5 in float32 (the reference's own,
``tests/test_kernels.py``); layers and logits rtol = 1e-4, atol = 1e-5
(XLA's and PyTorch's CPU GEMMs accumulate in different orders).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.api import DistGraph as RefDistGraph
from repro.api import InferenceServer as RefServer
from repro.graph import get_dataset as ref_get_dataset
from repro.kernels.edge_softmax.kernel import edge_softmax_pallas
from repro.kernels.edge_softmax.ref import edge_softmax_ref as jax_es_ref
from repro.kernels.fused_edge_softmax_aggregate.kernel import (
    fused_edge_softmax_aggregate_pallas)
from repro.kernels.fused_edge_softmax_aggregate.ref import \
    fused_edge_softmax_aggregate_ref as jax_k3_ref
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import apply_gnn as ref_apply_gnn
from repro.models.gnn import gat_layer as ref_gat_layer
from repro.models.gnn import init_gnn as ref_init_gnn
from repro_torch.api import DistGraph, InferenceServer
from repro_torch.configs import get_config
from repro_torch.core.sampler import (DistributedSampler, capacities,
                                      sample_ego_networks)
from repro_torch.graph import get_dataset
from repro_torch.kernels import (dst_groups, edge_softmax,
                                 edge_softmax_stats_cuda,
                                 fused_edge_softmax_aggregate,
                                 fused_edge_softmax_aggregate_bwd_cuda,
                                 fused_edge_softmax_aggregate_cuda,
                                 src_scatter_cuda)
from repro_torch.launch import gnn_serve
from repro_torch.models.gnn import (GNNConfig, apply_gnn, gat_layer,
                                    init_gnn, params_from_numpy)

KTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(arch="gat", in_dim=100, hidden_dim=32, num_classes=16,
           fanouts=[4, 3, 2], batch_size=8, num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(rng, e, src_n, dst_n, live=0.7, empty=0):
    """Random edges padded as ``pad_block`` pads them (masked slots carry
    src 0 and dst 0); destinations below ``empty`` get no live edge."""
    src = rng.integers(0, src_n, e).astype(np.int32)
    dst = rng.integers(empty, dst_n, e).astype(np.int32)
    mask = rng.random(e) < live
    src[~mask] = 0
    dst[~mask] = 0
    return src, dst, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (E, H, Dh, V, num_dst, live fraction, empty destinations)
CASES = [(100, 2, 8, 40, 13, 0.7, 3), (600, 4, 8, 200, 128, 0.75, 10),
         (64, 1, 16, 30, 200, 0.7, 0), (300, 2, 128, 90, 40, 0.7, 5),
         (50, 2, 8, 20, 12, 0.0, 0), (1, 1, 4, 1, 1, 1.0, 0)]
IDS = ["small", "4heads", "mostly-empty", "dh128", "all-padded", "one-edge"]
# the Pallas kernels in interpret mode compile per shape (seconds each):
# they are held on the cases with empty destinations and no live edge
PALLAS_CASES = {"small", "all-padded"}


def _case(e, h, dh, v, n, live, empty):
    rng = np.random.default_rng(e * 7 + h)
    src, dst, mask = _edges(rng, e, v, n, live, empty)
    scores = (rng.standard_normal((e, h)) * 3).astype(np.float32)
    hp = rng.standard_normal((v, h, dh)).astype(np.float32)
    cot = rng.standard_normal((n, h * dh)).astype(np.float32)
    return src, dst, mask, scores, hp, cot


@functools.partial(jax.jit, static_argnums=3)
def _jax_es(scores, dst, mask, n, w):
    """The reference oracle's alpha and its gradient against ``w``."""
    def f(x):
        return jax_es_ref(x, dst, mask, n)
    return f(scores), jax.grad(lambda x: (f(x) * w).sum())(scores)


@functools.partial(jax.jit, static_argnums=5)
def _jax_k3(hp, scores, src, dst, mask, n, cot):
    """The reference oracle's output and its gradients (h_proj, scores)
    against ``cot``."""
    def f(a, b):
        return jax_k3_ref(a, b, src, dst, mask, n)
    grads = jax.grad(lambda a, b: (f(a, b) * cot).sum(),
                     argnums=(0, 1))(hp, scores)
    return f(hp, scores), grads


# ---------------------------------------------------------------------------
# K4 and K3, plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_edge_softmax_matches_reference_values_and_grads(case):
    e, h, dh, v, n, live, empty = case
    src, dst, mask, scores, _, _ = _case(*case)
    w = np.random.default_rng(1).standard_normal((e, h)).astype(np.float32)
    args = [jnp.asarray(x) for x in (scores, dst, mask)]
    want, want_grad = _jax_es(*args, n, w)
    s = torch.from_numpy(scores).requires_grad_()
    got = edge_softmax(s, *_t(dst, mask), n)
    np.testing.assert_allclose(got.detach().numpy(), want, **KTOL)
    if IDS[CASES.index(case)] in PALLAS_CASES:
        pallas = np.asarray(edge_softmax_pallas(*args, n))
        np.testing.assert_allclose(got.detach().numpy(), pallas, **KTOL)
    assert not got.detach().numpy()[~mask].any()
    (grad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), s)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **KTOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_edge_softmax_aggregate_matches_reference(case):
    e, h, dh, v, n, live, empty = case
    src, dst, mask, scores, hp, cot = _case(*case)
    jargs = [jnp.asarray(x) for x in (hp, scores, src, dst, mask)]
    want, want_grads = _jax_k3(*jargs, n, cot)
    hp_t, s_t = (torch.from_numpy(x).requires_grad_() for x in (hp, scores))
    got = fused_edge_softmax_aggregate(hp_t, s_t, *_t(src, dst, mask), n)
    assert got.shape == (n, h * dh)
    np.testing.assert_allclose(got.detach().numpy(), want, **KTOL)
    if IDS[CASES.index(case)] in PALLAS_CASES:
        pallas = np.asarray(fused_edge_softmax_aggregate_pallas(*jargs, n))
        np.testing.assert_allclose(got.detach().numpy(), pallas, **KTOL)
    assert not got.detach().numpy()[:empty].any()
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                (hp_t, s_t))
    for g, wg in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **KTOL)


# ---------------------------------------------------------------------------
# the card's algorithms, with the kernels' CPU stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_card_path_gradients_match_reference(monkeypatch, case):
    """The autograd Function's backward: K4's normalize on the saved
    statistics, FlashAttention's identity for the scores' gradient, and
    the source-keyed sum for h_proj's, against ``jax.grad``."""
    fns = emu.emulate_cuda(monkeypatch)
    e, h, dh, v, n, live, empty = case
    src, dst, mask, scores, hp, cot = _case(*case)
    jargs = [jnp.asarray(x) for x in (hp, scores, src, dst, mask)]
    want, want_grads = _jax_k3(*jargs, n, cot)
    hp_t, s_t = (torch.from_numpy(x).requires_grad_() for x in (hp, scores))
    got = fused_edge_softmax_aggregate(hp_t, s_t, *_t(src, dst, mask), n)
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), want, **KTOL)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                (hp_t, s_t))
    for g, wg in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **KTOL)
    assert not grads[1].numpy()[~mask].any()
    for name in ("edge_softmax_stats", "fused_edge_softmax_aggregate",
                 "edge_softmax_norm", "fused_edge_softmax_aggregate_bwd",
                 "src_scatter"):
        assert fns[name].launches == 1, name


def test_online_softmax_statistics_match_reference():
    """The stats kernel's one-pass online max and denominator, run in
    numpy over the destination-grouped order, against the oracle's."""
    e, h, n = 400, 2, 60
    rng = np.random.default_rng(4)
    _, dst, mask = _edges(rng, e, 1, n, 0.7, 6)
    scores = (rng.standard_normal((e, h)) * 3).astype(np.float32)
    g = dst_groups(*_t(dst, mask), n)
    order, offsets = g.order.numpy(), g.offsets.numpy()
    m = np.full((n, h), -1e30, np.float32)
    z = np.zeros((n, h), np.float32)
    for d in range(n):
        for i in order[offsets[d]:offsets[d + 1]]:
            s = scores[i]
            with np.errstate(over="ignore"):    # the branch not taken
                z[d] = np.where(s > m[d], z[d] * np.exp(m[d] - s) + 1,
                                z[d] + np.exp(s - m[d]))
            m[d] = np.maximum(m[d], s)
    empty = m <= -5e29
    m[empty], z[empty] = 0, 0
    alpha = np.where(mask[:, None], np.exp(scores - m[dst])
                     / np.maximum(z[dst], 1e-30), 0)
    want, _ = _jax_es(*[jnp.asarray(x) for x in (scores, dst, mask)], n,
                      np.ones_like(scores))
    np.testing.assert_allclose(alpha, want, **KTOL)
    assert empty[:6].all() and not empty[6:].any()


def test_card_wrappers_refuse_cpu_tensors_and_grad_inputs(monkeypatch):
    g = dst_groups(torch.zeros(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.bool), 2)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        edge_softmax_stats_cuda(torch.ones(4, 2), g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_edge_softmax_aggregate_cuda(torch.ones(3, 2, 4),
                                          torch.ones(4, 2), idx, g,
                                          torch.ones(2, 2), torch.ones(2, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_edge_softmax_aggregate_bwd_cuda(
            torch.ones(2, 8), torch.ones(3, 2, 4), torch.ones(2, 8),
            torch.ones(4, 2), idx, g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        src_scatter_cuda(torch.ones(2, 8), idx, g)
    # K4 on the card has no backward of its own: it refuses to cut a graph
    emu.emulate_cuda(monkeypatch)
    s = torch.ones(4, 2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B"):
        edge_softmax(s, idx, torch.ones(4, dtype=torch.bool), 2)


# ---------------------------------------------------------------------------
# layers and models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batches():
    """Two real padded host batches (the second a ragged chunk)."""
    g = DistGraph(get_dataset("product-sim", scale=9), num_machines=2,
                  trainers_per_machine=1, seed=0)
    s = DistributedSampler(g.book, g.partitions, CFG["fanouts"],
                           CFG["batch_size"], machine=0, transport=None,
                           seed=0)
    out = []
    for mb in sample_ego_networks(s, g.new_client(), "feat",
                                  np.arange(3, 300, 23), drop_last=False):
        out.append({"input_feats": mb.input_feats,
                    "blocks": [dict(edge_src=b.edge_src, edge_dst=b.edge_dst,
                                    edge_mask=b.edge_mask)
                               for b in mb.blocks]})
    return out


def _ref_params(cfg: dict, seed: int = 4):
    p = ref_init_gnn(RefConfig(**cfg), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, p)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("stacked", [False, True])
def test_gat_layer_matches_reference(batches, layer, stacked):
    ref_params = _ref_params(CFG)
    num_dst = RefConfig(**CFG).dst_caps()[layer]
    rng = np.random.default_rng(layer)
    d_in = ref_params["layers"][layer]["w"].shape[0]
    cap_src = capacities(CFG["batch_size"], CFG["fanouts"])[layer][0]
    hs = [(b["input_feats"] if layer == 0 else
           rng.standard_normal((cap_src, d_in)).astype(np.float32))
          for b in batches]
    blocks = [b["blocks"][layer] for b in batches]
    act = None if layer == 2 else jax.nn.elu
    p = params_from_numpy(ref_params["layers"][layer])
    ref_layer = jax.jit(ref_gat_layer, static_argnums=(3, 4))
    wants = [np.asarray(ref_layer(_jax_tree(ref_params["layers"][layer]),
                                  jnp.asarray(h), _jax_tree(blk), num_dst,
                                  act))
             for h, blk in zip(hs, blocks)]
    t_act = None if layer == 2 else torch.nn.functional.elu
    if stacked:
        block = _torch_tree(jax.tree.map(lambda *x: np.stack(x), *blocks))
        got = gat_layer(p, torch.from_numpy(np.stack(hs)), block, num_dst,
                        activation=t_act)
        assert got.shape == (len(hs), num_dst, wants[0].shape[1])
        for i, want in enumerate(wants):
            np.testing.assert_allclose(got[i].numpy(), want, **TOL)
    else:
        for h, blk, want in zip(hs, blocks, wants):
            got = gat_layer(p, torch.from_numpy(h), _torch_tree(blk),
                            num_dst, activation=t_act)
            np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("num_classes", [16, 15])
def test_gat_apply_gnn_matches_reference(batches, num_classes):
    """16 classes: the last layer's 2 x 8 heads are the logits; 15: they
    are not, and the model has the ``head`` projection."""
    cfg = {**CFG, "num_classes": num_classes}
    ref_params = _ref_params(cfg)
    assert ("head" in ref_params) == (num_classes != 16)
    params = params_from_numpy(ref_params)
    ref_forward = jax.jit(functools.partial(ref_apply_gnn,
                                            RefConfig(**cfg, impl="ref")))
    for batch in batches:
        want = ref_forward(_jax_tree(ref_params), _jax_tree(batch))
        got = apply_gnn(GNNConfig(**cfg), params, _torch_tree(batch))
        assert got.shape == (CFG["batch_size"], num_classes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stacked = _torch_tree(jax.tree.map(lambda *x: np.stack(x), *batches))
    got = apply_gnn(GNNConfig(**cfg), params, stacked)
    for i, batch in enumerate(batches):
        assert torch.equal(got[i], apply_gnn(GNNConfig(**cfg), params,
                                             _torch_tree(batch)))


@pytest.mark.parametrize("num_classes", [16, 15])
def test_gat_init_matches_reference_tree(num_classes):
    cfg = {**CFG, "num_classes": num_classes}
    ref = _ref_params(cfg)
    got = init_gnn(GNNConfig(**cfg), torch.Generator().manual_seed(0))
    assert got.keys() == ref.keys()
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat_ref:
        node = got
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == leaf.shape, path
    for layer in got["layers"]:
        d_in, heads, d_h = layer["w"].shape
        lim = np.sqrt(6.0 / (d_in + d_h))
        assert 0.5 * lim < float(layer["w"].abs().max()) <= lim
        assert not layer["b"].any()


def test_gat_config_is_the_papers():
    cfg = get_config("gat")
    assert (cfg.in_dim, cfg.hidden_dim, cfg.num_classes, cfg.num_heads,
            list(cfg.fanouts), cfg.batch_size) == (100, 256, 16, 2,
                                                   [15, 10, 5], 1000)


# ---------------------------------------------------------------------------
# serving GAT
# ---------------------------------------------------------------------------

def test_gat_server_matches_reference_server():
    cfg = dict(CFG, fanouts=[4, 3], batch_size=4)
    world = dict(num_machines=2, trainers_per_machine=1, seed=0)
    ref_g = RefDistGraph(ref_get_dataset("product-sim", scale=10), **world)
    g = DistGraph(get_dataset("product-sim", scale=10), **world)
    ref_params = ref_init_gnn(RefConfig(**cfg), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params))
    nids = np.arange(5, 400, 11)
    with RefServer(ref_g, RefConfig(**cfg, impl="ref"), ref_params,
                   micro_batch_capacity=4) as srv:
        want = srv.predict(nids)
    with InferenceServer(g, GNNConfig(**cfg), params, micro_batch_capacity=4,
                         device="cpu") as srv:
        got = srv.predict(nids)
    assert got.shape == (len(nids), cfg["num_classes"])
    np.testing.assert_allclose(got, want, **TOL)


def test_gnn_serve_gat_smoke_on_cpu(capsys):
    out = gnn_serve.main(["--arch", "gat", "--smoke", "--device", "cpu",
                          "--scale", "9"])
    assert out["served"] == out["requests"] == 8
    assert '"mode": "serving"' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("h,dh", [(2, 128), (2, 8), (3, 5)])
def test_cuda_k3_k4_match_plain_on_card(h, dh):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    rng = np.random.default_rng(h * dh)
    e, v, n = 5000, 700, 300
    src, dst, mask = [t.cuda() for t in _t(*_edges(rng, e, v, n, 0.7, 20))]
    hp = torch.randn(v, h, dh, device="cuda", requires_grad=True)
    s = torch.randn(e, h, device="cuda", requires_grad=True)
    outs = [fused_edge_softmax_aggregate(hp, s, src, dst, mask, n, impl=i)
            for i in ("cuda", "ref")]
    torch.testing.assert_close(outs[0], outs[1], **KTOL)
    cot = torch.randn_like(outs[0])
    got, want = (torch.autograd.grad(o, (hp, s), cot) for o in outs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **KTOL)
    with torch.no_grad():
        torch.testing.assert_close(
            edge_softmax(s, dst, mask, n, impl="cuda"),
            edge_softmax(s, dst, mask, n, impl="ref"), **KTOL)
