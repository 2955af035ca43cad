"""The port's offline layer-wise pass (``repro_torch.api.offline_embeddings``
and ``gnn_serve --offline``) against the JAX package's, on the CPU.

Mirrors ``tests/test_inference.py``'s offline cases: every layer's tensor
for every node against ``repro.api.offline_embeddings`` on the same world
with the same parameters (GraphSAGE, GAT, RGCN untyped and typed; rtol =
1e-4, atol = 1e-5, since XLA's and PyTorch's CPU GEMMs accumulate in
different orders); the last layer bitwise equal to the port's own
full-neighbour mini-batch forward (homo and hetero), a ragged last chunk
written, the bytes invariant to the chunk size, ``chunk_size < 2``
refused, and the launcher's JSON against the reference launcher's. The
card's code path (the autograd Functions over grouped orders, under
``torch.inference_mode``) runs here through the kernels' CPU stand-ins.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_emulated_cuda as emu
from repro.api import DistGraph as RefDistGraph
from repro.api import offline_embeddings as ref_offline_embeddings
from repro.graph import get_dataset as ref_get_dataset
from repro.launch import gnn_serve as ref_gnn_serve
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import init_gnn as ref_init_gnn
from repro_torch.api import DistGraph, NodeDataLoader, offline_embeddings
from repro_torch.api.inference import OFFLINE_ROW_TILE
from repro_torch.core.sampler import full_neighbor_fanouts
from repro_torch.graph import get_dataset
from repro_torch.graph.csr import CSRGraph
from repro_torch.launch import gnn_serve
from repro_torch.models.gnn import GNNConfig, apply_gnn, params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
FANOUTS_TYPED = {"cites": 5, "writes": 3, "rev_writes": 2, "employs": 2}
WORLD = dict(num_machines=2, trainers_per_machine=1, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# id: (dataset, scale, hetero, model config)
CASES = {
    "graphsage": ("product-sim", 8, False,
                  dict(arch="graphsage", hidden_dim=8, fanouts=[3, 2])),
    "gat": ("product-sim", 8, False,
            dict(arch="gat", hidden_dim=8, fanouts=[3, 2], num_heads=2)),
    "rgcn-untyped": ("mag-sim", 8, False,
                     dict(arch="rgcn", hidden_dim=8, fanouts=[3, 2])),
    "rgcn-typed": ("mag-hetero", 7, True,
                   dict(arch="rgcn", hidden_dim=8,
                        fanouts=[dict(FANOUTS_TYPED)] * 2)),
}


def _cfg_kw(ds, model: dict) -> dict:
    return dict(model, in_dim=int(ds.feats.shape[1]),
                num_classes=int(ds.num_classes), batch_size=4,
                num_rels=int(ds.graph.num_etypes))


def _worlds(case: str):
    """The port's and the reference's world for ``case``, with the
    reference's ``init_gnn`` parameters carried across."""
    dataset, scale, hetero, model = CASES[case]
    ds = get_dataset(dataset, scale=scale)
    kw = _cfg_kw(ds, model)
    g = DistGraph(ds, hetero=hetero, **WORLD)
    ref_g = RefDistGraph(ref_get_dataset(dataset, scale=scale),
                         hetero=hetero, **WORLD)
    ref_params = jax.tree.map(np.asarray, ref_init_gnn(
        RefConfig(**kw), jax.random.PRNGKey(0)))
    return kw, g, ref_g, ref_params


def _all_rows(embs) -> list:
    return [np.ascontiguousarray(e[np.arange(e.shape[0], dtype=np.int64)])
            for e in embs]


@pytest.mark.parametrize("case", list(CASES))
def test_offline_embeddings_match_reference(case):
    kw, g, ref_g, ref_params = _worlds(case)
    want = _all_rows(ref_offline_embeddings(
        ref_g, RefConfig(**kw, impl="ref"), ref_params, chunk_size=8,
        prefix="ref_emb"))
    embs = offline_embeddings(g, GNNConfig(**kw),
                              params_from_numpy(ref_params), chunk_size=8,
                              device="cpu")
    got = _all_rows(embs)
    assert len(got) == len(want) == 2
    for l, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (g.num_nodes(), b.shape[1]), l
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"layer {l}")
    assert [e.name for e in embs] == ["emb0", "emb1"]
    assert embs[-1].shape == (g.num_nodes(), kw["num_classes"])


def test_offline_graphsage_matches_reference_pallas_interpret():
    """The same world through the reference's Pallas kernels in interpret
    mode (K1 and K2 on its forward)."""
    kw, g, ref_g, ref_params = _worlds("graphsage")
    want = _all_rows(ref_offline_embeddings(
        ref_g, RefConfig(**kw, impl="pallas"), ref_params, chunk_size=64,
        prefix="ref_pallas"))
    got = _all_rows(offline_embeddings(
        g, GNNConfig(**kw), params_from_numpy(ref_params), chunk_size=64,
        device="cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# exactness: the port's own full-neighbour mini-batch forward, chunk sizes
# ---------------------------------------------------------------------------

def _cap_in_degree(g: CSRGraph, k: int) -> CSRGraph:
    """Keep at most ``k`` in-edges a node (earliest in edge order), as
    ``tests/test_inference.py`` does: the full-neighbour mini-batch
    oracle's capacities multiply across layers (cap_src = batch x (1 + D)
    ^ L), and mag-hetero's citation hubs have in-degrees in the hundreds."""
    dst = g.indices
    order = np.argsort(dst, kind="stable")
    sd = dst[order]
    new_run = np.r_[True, sd[1:] != sd[:-1]]
    run_start = np.maximum.accumulate(
        np.where(new_run, np.arange(len(sd)), 0))
    keep = np.zeros(len(dst), dtype=bool)
    keep[order] = (np.arange(len(sd)) - run_start) < k
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                    np.diff(g.indptr))
    new_indptr = np.zeros(g.num_nodes + 1, dtype=np.int64)
    new_indptr[1:] = np.cumsum(np.bincount(src[keep],
                                           minlength=g.num_nodes))
    return CSRGraph(indptr=new_indptr, indices=g.indices[keep],
                    edge_ids=np.arange(int(keep.sum()), dtype=np.int64),
                    etypes=None if g.etypes is None else g.etypes[keep],
                    ntypes=g.ntypes, num_etypes=g.num_etypes,
                    num_ntypes=g.num_ntypes)


@pytest.fixture(scope="module")
def homo_g():
    return DistGraph(get_dataset("product-sim", scale=8), **WORLD)


@pytest.fixture(scope="module")
def hetero_capped_g():
    ds = get_dataset("mag-hetero", scale=7)
    ds = dataclasses.replace(ds, graph=_cap_in_degree(ds.graph, 6))
    return DistGraph(ds, hetero=True, **WORLD)


def _model(g, hetero=False):
    """``tests/test_inference.py``'s models, with the port's seeded
    initialisation."""
    if hetero:
        halved = {r: max(1, f // 2) for r, f in FANOUTS_TYPED.items()}
        model = dict(arch="rgcn", hidden_dim=8,
                     fanouts=[dict(FANOUTS_TYPED), halved])
    else:
        model = dict(arch="graphsage", hidden_dim=8, fanouts=[3, 2])
    cfg = GNNConfig(**_cfg_kw(g.ds, model))
    from repro_torch.models.gnn import init_gnn
    return cfg, init_gnn(cfg, torch.Generator().manual_seed(0))


def _direct_full_neighbor(g, cfg, params, nids, batch_size=4):
    """Oracle: the port's own eval-mode mini-batch forward with
    full-neighbour fanouts, its products in the pass's row tiles."""
    full = full_neighbor_fanouts(g.partitions, cfg.num_layers,
                                 schema=g.schema if g.hetero else None)
    cfg_full = dataclasses.replace(cfg, fanouts=full, batch_size=batch_size)
    loader = NodeDataLoader(g, nids, cfg_full.fanouts,
                            batch_size=batch_size, mode="eval",
                            sampler_seed=0)
    etype_id = g.schema.etype_id if g.hetero else None
    with torch.inference_mode():
        out = [apply_gnn(cfg_full, params, jax.tree.map(
                   torch.from_numpy, nb.model_input()),
                   etype_id=etype_id, row_tile=OFFLINE_ROW_TILE)
               for nb in loader]
    return torch.cat(out).numpy()


@pytest.mark.parametrize("kind", ["homo", "hetero"])
def test_offline_embeddings_match_minibatch_forward(kind, homo_g,
                                                    hetero_capped_g):
    g = homo_g if kind == "homo" else hetero_capped_g
    cfg, params = _model(g, hetero=kind == "hetero")
    embs = offline_embeddings(g, cfg, params, chunk_size=8,
                              prefix=f"emb_{kind}_", device="cpu")
    assert len(embs) == cfg.num_layers
    assert embs[-1].shape == (g.num_nodes(), cfg.num_classes)
    check = np.arange(16, dtype=np.int64)
    direct = _direct_full_neighbor(g, cfg, params, check)
    assert embs[-1][check].tobytes() == direct.tobytes()


def test_offline_embeddings_cover_every_node(homo_g):
    """drop_last=False chunking: the ragged tail chunk is still written
    back, so rows exist for ALL nodes including the last partial chunk."""
    g = homo_g
    cfg, params = _model(g)
    assert g.num_nodes() % 7 != 0
    embs = offline_embeddings(g, cfg, params, chunk_size=7,
                              prefix="emb_tail_", device="cpu")
    tail = np.arange(g.num_nodes() - 5, g.num_nodes(), dtype=np.int64)
    direct = _direct_full_neighbor(g, cfg, params,
                                   np.pad(tail, (0, 3), mode="edge"))
    assert embs[-1][tail].tobytes() == direct[: len(tail)].tobytes()


# hypothesis @given cannot take pytest fixtures; a memoized module-level
# world is built on first use and shared read-only across examples
_SMALL: dict = {}


def _small_world() -> dict:
    if not _SMALL:
        g = DistGraph(get_dataset("product-sim", scale=8), **WORLD)
        cfg, params = _model(g)
        base = offline_embeddings(g, cfg, params, chunk_size=cfg.batch_size,
                                  prefix="emb_base_", device="cpu")
        _SMALL.update(g=g, cfg=cfg, params=params,
                      baseline=[r.tobytes() for r in _all_rows(base)])
    return _SMALL


@settings(max_examples=4, deadline=None)
@given(chunk_size=st.integers(min_value=2, max_value=16))
def test_offline_chunk_size_invariance(chunk_size):
    """Every layer's bytes are a function of (graph, params) only, never
    of how the pass chunks the node set."""
    w = _small_world()
    embs = offline_embeddings(w["g"], w["cfg"], w["params"],
                              chunk_size=chunk_size,
                              prefix=f"emb_c{chunk_size}_", device="cpu")
    assert [r.tobytes() for r in _all_rows(embs)] == w["baseline"]


@pytest.mark.parametrize("chunk_size", [1, 0, -3])
def test_chunk_size_below_two_is_refused(homo_g, chunk_size):
    cfg, params = _model(homo_g)
    with pytest.raises(ValueError, match="chunk_size must be >= 2"):
        offline_embeddings(homo_g, cfg, params, chunk_size=chunk_size,
                           device="cpu")


def test_default_device_is_the_card(homo_g):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg, params = _model(homo_g)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        offline_embeddings(homo_g, cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gnn_serve.main(["--offline", "--scale", "8"])


# ---------------------------------------------------------------------------
# the card's code path, through the kernels' CPU stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["graphsage", "gat", "rgcn-typed"])
def test_card_path_matches_plain_path(monkeypatch, case):
    """The pass through the autograd Functions and grouped orders (CPU
    stand-ins of K1, K2, K3 and K4) under ``inference_mode`` gives the
    plain path's bytes for GraphSAGE and RGCN (K1 and K2 sum each group in
    its stable order) and GAT within 1e-6; each kernel launches once a
    chunk and layer (RGCN: once a live relation), no backward kernel
    launches, and the spans cover the pass's steps."""
    kw, g, _ref_g, ref_params = _worlds(case)
    cfg, params = GNNConfig(**kw), params_from_numpy(ref_params)
    want = _all_rows(offline_embeddings(g, cfg, params, chunk_size=16,
                                        prefix="plain", device="cpu"))
    fns = emu.emulate_cuda(monkeypatch)
    spans = {}
    got = _all_rows(offline_embeddings(g, cfg, params, chunk_size=16,
                                       prefix="card", device="cpu",
                                       spans=spans))
    for a, b in zip(got, want):
        if case == "gat":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert a.tobytes() == b.tobytes()
    chunks = -(-g.num_nodes() // 16)
    if case == "gat":
        expected = {"edge_softmax_stats": 2 * chunks,
                    "fused_edge_softmax_aggregate": 2 * chunks}
    else:
        relations = cfg.num_rels if cfg.arch == "rgcn" else 1
        expected = {"fused_gather_aggregate": 2 * chunks * relations,
                    "segment_sum": 2 * chunks * relations}
    for name, fn in fns.items():
        assert fn.launches == expected.get(name, 0), name
    assert set(spans) == {"sample", "pull", "stage", "forward",
                          "device_forward", "push"}
    for k in ("sample", "pull", "stage", "forward", "push"):
        assert spans[k] > 0, k
    assert spans["device_forward"] == 0.0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_gnn_serve_offline_on_cpu(capsys):
    out = gnn_serve.main(["--offline", "--device", "cpu", "--scale", "10"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    want = ref_gnn_serve.main(["--offline", "--scale", "10"])
    capsys.readouterr()
    assert set(out) == set(want) == {"mode", "num_nodes", "layers",
                                     "wall_s", "nodes_per_s"}
    assert out["mode"] == want["mode"] == "offline"
    assert out["num_nodes"] == want["num_nodes"] == 1024
    assert out["layers"] == want["layers"] == [[1024, 256], [1024, 256],
                                               [1024, 16]]
    assert out["wall_s"] > 0 and out["nodes_per_s"] > 0


def test_gnn_serve_chunk_size_flag_reaches_the_pass(monkeypatch):
    seen = {}

    def fake(g, cfg, params, *, chunk_size=None, device=None):
        seen.update(chunk_size=chunk_size, device=device,
                    batch_size=cfg.batch_size)
        return []

    import repro_torch.api as api
    monkeypatch.setattr(api, "offline_embeddings", fake)
    gnn_serve.main(["--offline", "--device", "cpu", "--scale", "8",
                    "--chunk-size", "5"])
    assert seen == dict(chunk_size=5, device="cpu", batch_size=8)
    gnn_serve.main(["--offline", "--device", "cpu", "--scale", "8"])
    assert seen["chunk_size"] is None        # 0: the model's batch size
