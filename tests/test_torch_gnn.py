"""The port's GraphSAGE against ``repro.models.gnn``: ``sage_layer`` and a
3-layer ``apply_gnn`` on real padded blocks sampled from product-sim, with
the reference's ``init_gnn`` parameters carried across through
``params_from_numpy``. Tolerance rtol = 1e-4, atol = 1e-5: the products
are full float32 on both sides, but XLA's and PyTorch's CPU GEMMs
accumulate in different orders."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import apply_gnn as ref_apply_gnn
from repro.models.gnn import init_gnn as ref_init_gnn
from repro.models.gnn import sage_layer as ref_sage_layer
from repro_torch.api import DistGraph
from repro_torch.configs import get_config
from repro_torch.core.sampler import (DistributedSampler, capacities,
                                      sample_ego_networks)
from repro_torch.graph import get_dataset
from repro_torch.models.gnn import (GNNConfig, apply_gnn, init_gnn,
                                    params_from_numpy, sage_layer)

CFG = dict(arch="graphsage", in_dim=100, hidden_dim=32, num_classes=16,
           fanouts=[4, 3, 2], batch_size=8)
TOL = dict(rtol=1e-4, atol=1e-5)


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


@pytest.fixture(scope="module")
def ref_params():
    p = ref_init_gnn(RefConfig(**CFG), jax.random.PRNGKey(4))
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
@pytest.mark.parametrize("act", ["relu", None])
def test_sage_layer_matches_reference(batches, ref_params, layer, act):
    batch = batches[0]
    num_dst = RefConfig(**CFG).dst_caps()[layer]
    rng = np.random.default_rng(layer)
    d_in = ref_params["layers"][layer]["w_self"].shape[0]
    cap_src = capacities(CFG["batch_size"], CFG["fanouts"])[layer][0]
    h = (batch["input_feats"] if layer == 0 else
         rng.standard_normal((cap_src, d_in)).astype(np.float32))
    block = batch["blocks"][layer]
    want = ref_sage_layer(_jax_tree(ref_params["layers"][layer]),
                          jnp.asarray(h), _jax_tree(block), num_dst,
                          activation=jax.nn.relu if act else None,
                          impl="ref")
    got = sage_layer(params_from_numpy(ref_params["layers"][layer]),
                     torch.from_numpy(h), _torch_tree(block), num_dst,
                     activation=torch.relu if act else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_gnn_three_layers_matches_reference(batches, ref_params):
    params = params_from_numpy(ref_params)
    for batch in batches:
        want = ref_apply_gnn(RefConfig(**CFG, impl="ref"),
                             _jax_tree(ref_params), _jax_tree(batch))
        got = apply_gnn(GNNConfig(**CFG), params, _torch_tree(batch))
        assert got.shape == (CFG["batch_size"], CFG["num_classes"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stacked_forward_equals_each_slot_bitwise(batches, ref_params):
    """The explicit stack axis that replaces the reference's vmap: a
    slot's logits are the bytes of the same chunk run alone."""
    params = params_from_numpy(ref_params)
    cfg = GNNConfig(**CFG)
    order = [batches[1], batches[0], batches[1]]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *order)
    got = apply_gnn(cfg, params, _torch_tree(stacked))
    assert got.shape == (3, CFG["batch_size"], CFG["num_classes"])
    for i, b in enumerate(order):
        alone = apply_gnn(cfg, params, _torch_tree(b))
        assert torch.equal(got[i], alone)


def test_params_from_numpy_keeps_bytes(ref_params):
    params = params_from_numpy(ref_params)
    for a, b in zip(ref_params["layers"], params["layers"]):
        for k in ("w_self", "w_neigh", "b"):
            assert b[k].dtype == torch.float32
            assert b[k].numpy().tobytes() == a[k].tobytes()


def test_init_gnn_glorot_limits_and_seeded():
    cfg = GNNConfig(**CFG)
    p = init_gnn(cfg, torch.Generator().manual_seed(0))
    q = init_gnn(cfg, torch.Generator().manual_seed(0))
    ref = ref_init_gnn(RefConfig(**CFG), jax.random.PRNGKey(0))
    for lp, lq, lr in zip(p["layers"], q["layers"], ref["layers"]):
        for k in ("w_self", "w_neigh", "b"):
            assert tuple(lp[k].shape) == tuple(lr[k].shape)
            assert torch.equal(lp[k], lq[k])
        d_in, d_out = lp["w_self"].shape
        lim = np.sqrt(6.0 / (d_in + d_out))
        assert float(lp["w_self"].abs().max()) <= lim
        assert float(lp["w_self"].abs().max()) > 0.5 * lim
        assert not lp["b"].any()


def test_configs_and_unported_archs():
    ref = ref_get_config("graphsage")
    port = get_config("graphsage")
    # the port keeps the reference's GraphSAGE fields, with the same values
    # (the GAT and RGCN fields come with those archs)
    want = dataclasses.asdict(ref)
    assert dataclasses.asdict(port) == {
        k: want[k] for k in ("arch", "in_dim", "hidden_dim", "num_classes",
                             "fanouts", "batch_size", "impl")}
    for arch in ("gat", "rgcn"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_gnn(GNNConfig(**{**CFG, "arch": arch}),
                     torch.Generator().manual_seed(0))
