"""The port's per-array staging, the reference's staging ablation
baseline, against its packed staging and against the JAX package:

  * ``device_stage(tree, device, packed=False)`` gives the packed path's
    bytes, ``None`` leaves included, with the reference's staging casts
    (int64 -> int32, uint64 -> uint32, float64 -> float32), as
    ``tests/test_pack.py`` holds the reference;
  * both loaders' staged batches are byte-identical packed and per array
    (homogeneous and typed, node and edge), and per array equal to the
    reference loaders' per-array ``device_put``s;
  * ``model_input(packed=True)`` raises unless the loader has both
    ``device_prefetch`` and ``packed_staging``;
  * the golden pin: the trainer per array with ``impl="ref"`` and packed
    with ``impl="auto"`` end with bit-identical losses and parameter bytes
    on the reference's four configurations (node and link prediction,
    GraphSAGE and RGCN), and ``launch.train --no-packed-staging`` with
    the packed run's, GNN and LM;
  * per-array losses against the reference's per-array run from the same
    weights (``params_from_numpy``), within rtol 1e-4, atol 1e-5: XLA's and
    PyTorch's CPU products add in different orders.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import DistGNNTrainer as RefTrainer
from repro.api import DistGraph as RefDistGraph
from repro.api import EdgeDataLoader as RefEdgeLoader
from repro.api import NodeDataLoader as RefNodeLoader
from repro.api import TrainJobConfig as RefJob
from repro.graph import get_dataset as ref_get_dataset
from repro.kernels.pack import PackSpec as RefPackSpec
from repro.kernels.pack import device_stage as ref_device_stage
from repro.models.gnn import GNNConfig as RefConfig
from repro_torch.api import (DistGNNTrainer, DistGraph, EdgeDataLoader,
                             NodeBatch, NodeDataLoader, TrainJobConfig)
from repro_torch.graph import get_dataset
from repro_torch.kernels import PackedBatch, unpack_flat
from repro_torch.kernels.pack import device_stage, flatten_tree, pack
from repro_torch.launch import train as train_cli
from repro_torch.models.gnn import GNNConfig, params_from_numpy
from repro_torch.optim.optimizers import tree_leaves

FANOUTS_TYPED = {"cites": 5, "writes": 3, "rev_writes": 2, "employs": 2}
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_tree(seed=0):
    """A MiniBatch-shaped tree covering every staged dtype family,
    including x64 leaves (cast) and None leaves (``tests/test_pack.py``'s
    tree)."""
    rng = np.random.default_rng(seed)
    return dict(
        input_feats=rng.standard_normal((16, 32)).astype(np.float32),
        seeds=rng.integers(0, 100, 16).astype(np.int64),
        seed_mask=rng.integers(0, 2, 16).astype(bool),
        labels=None,
        blocks=[dict(edge_src=rng.integers(0, 50, 40).astype(np.int32),
                     edge_dst=rng.integers(0, 16, 40).astype(np.int32),
                     edge_mask=rng.integers(0, 2, 40).astype(bool),
                     edge_types=None),
                dict(edge_src=rng.integers(0, 50, 80).astype(np.int32),
                     edge_dst=rng.integers(0, 50, 80).astype(np.int32),
                     edge_mask=rng.integers(0, 2, 80).astype(bool),
                     edge_types=rng.integers(0, 4, 80).astype(np.int64))])


def _tree_bytes(tree) -> dict:
    """{path: (dtype, shape, bytes)} of a staged tree (a PackedBatch, a
    tree of tensors or of JAX arrays), with its ``None`` paths."""
    if isinstance(tree, PackedBatch):
        tree = tree.unpack()
    tree = jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
        tree)
    flat, nones = flatten_tree(tree)
    out = {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in flat.items()}
    out["__none__"] = nones
    return out


# ---------------------------------------------------------------------------
# device_stage
# ---------------------------------------------------------------------------

def test_per_array_bytes_equal_packed_and_reference():
    tree = _batch_tree()
    packed = device_stage(tree, "cpu")
    per_array = device_stage(tree, "cpu", packed=False)
    assert isinstance(packed, PackedBatch)
    assert isinstance(per_array, dict)
    assert _tree_bytes(packed) == _tree_bytes(per_array)
    assert _tree_bytes(per_array) == _tree_bytes(
        ref_device_stage(tree, packed=False))
    # None leaves pass through in place
    assert per_array["labels"] is None
    assert per_array["blocks"][0]["edge_types"] is None
    assert isinstance(per_array["blocks"], list)
    # each leaf is a copy of its own: staging never aliases the host batch
    per_array["input_feats"][0, 0] = 1e6
    assert tree["input_feats"][0, 0] != 1e6


def test_per_array_casts_are_the_reference_staging_casts():
    tree = dict(a=np.arange(7, dtype=np.int64),
                b=np.linspace(0, 1, 5).astype(np.float64),
                c=np.arange(3, dtype=np.uint64),
                d=np.float64(2.5))
    per_array = device_stage(tree, "cpu", packed=False)
    packed = device_stage(tree, "cpu").unpack()
    ref = jax.tree.map(jax.device_put, tree)
    for k in tree:
        want = np.asarray(ref[k])
        for got in (per_array[k], packed[k]):
            got = got.numpy()
            assert got.dtype == want.dtype, k
            assert got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k


def test_packed_batch_getitem_num_buffers_and_unpack_flat():
    tree = _batch_tree(1)
    staged = device_stage(tree, "cpu")
    assert staged.unpack() is staged.unpack()
    assert torch.equal(staged["seeds"], staged.unpack()["seeds"])
    assert staged["labels"] is None
    spec, arena = pack(tree)
    ref_spec = RefPackSpec(spec.fields, spec.none_paths)
    assert spec.num_buffers == ref_spec.num_buffers == 3   # f32, i32, bool
    flat = unpack_flat(spec, torch.from_numpy(arena))
    assert torch.equal(flat["blocks/1/edge_types"],
                       torch.from_numpy(tree["blocks"][1]["edge_types"]
                                        .astype(np.int32)))


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """(reference, port) worlds: product-sim and typed mag-hetero, scale
    10, 2 machines x 1 trainer."""
    out = {}
    for name, ds, hetero in (("homo", "product-sim", False),
                             ("hetero", "mag-hetero", True)):
        kw = dict(num_machines=2, trainers_per_machine=1, hetero=hetero,
                  seed=0)
        out[name] = (RefDistGraph(ref_get_dataset(ds, scale=10), **kw),
                     DistGraph(get_dataset(ds, scale=10), **kw))
    return out


def _staged_stream(loader_cls, g, ids, fanouts, packed, **kw):
    ld = loader_cls(g, ids, fanouts, device_prefetch=True,
                    packed_staging=packed, sync=True, non_stop=False,
                    **kw)
    out = [_tree_bytes(b.device) for b in ld.epoch(0)]
    ld.close()
    return out


def _check_streams(port_cls, ref_cls, worlds, name, ids_of, kw):
    ref_g, g = worlds[name]
    fanouts = [dict(FANOUTS_TYPED)] * 2 if g.hetero else [5, 5]
    packed = _staged_stream(port_cls, g, ids_of(g), fanouts, True,
                            device="cpu", **kw)
    per_arr = _staged_stream(port_cls, g, ids_of(g), fanouts, False,
                             device="cpu", **kw)
    ref = _staged_stream(ref_cls, ref_g, ids_of(ref_g), fanouts, False,
                         **kw)
    assert len(packed) == len(per_arr) == len(ref) > 0
    assert packed == per_arr, "per-array staging changed the device bytes"
    assert per_arr == ref, "the port's staged bytes differ from the reference"


@pytest.mark.parametrize("name", ["homo", "hetero"])
def test_per_array_staging_byte_identity_node(worlds, name):
    def seeds(g):
        return g.train_nids[:64]

    _check_streams(NodeDataLoader, RefNodeLoader, worlds, name, seeds,
                   dict(batch_size=16, seed=31, sampler_seed=32,
                        labels=worlds[name][1].labels[seeds(
                            worlds[name][1])]))


@pytest.mark.parametrize("name", ["homo", "hetero"])
def test_per_array_staging_byte_identity_edge(worlds, name):
    def owned(g):
        return g.edge_split()[:64]

    _check_streams(EdgeDataLoader, RefEdgeLoader, worlds, name, owned,
                   dict(batch_size=8, num_negs=3, seed=33, sampler_seed=34,
                        edge_seed=35))


def test_model_input_packed_contract(worlds):
    _, g = worlds["homo"]
    seeds = g.train_nids[:32]
    kw = dict(batch_size=16, labels=g.labels[seeds], sync=True,
              non_stop=False, seed=41, device="cpu")
    with NodeDataLoader(g, seeds, [5, 5], device_prefetch=True,
                        packed_staging=True, **kw) as ld:
        b = next(iter(ld))
        staged = b.model_input(packed=True)
        assert isinstance(staged, PackedBatch)
        # the unpacked model_input is a view of the SAME staged batch
        mi = b.model_input()
        assert set(mi) == set(NodeBatch._model_keys)
        assert torch.equal(mi["input_feats"], staged["input_feats"])
    # per-array and host-side loaders refuse the packed form
    with NodeDataLoader(g, seeds, [5, 5], device_prefetch=True,
                        packed_staging=False, **kw) as ld:
        b = next(iter(ld))
        assert set(b.model_input()) == set(NodeBatch._model_keys)
        with pytest.raises(ValueError, match="packed"):
            b.model_input(packed=True)
    with NodeDataLoader(g, seeds, [5, 5], **kw) as ld:
        with pytest.raises(ValueError, match="packed"):
            next(iter(ld)).model_input(packed=True)


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------

def _port_cfg(task, arch, ds):
    return GNNConfig(arch=arch, in_dim=ds.feats.shape[1], hidden_dim=16,
                     num_classes=(16 if task == "link_prediction"
                                  else ds.num_classes),
                     fanouts=[5, 5], batch_size=32,
                     num_rels=ds.graph.num_etypes)


def _train_golden(ds, cfg, job_kw, epochs, params=None):
    tr = DistGNNTrainer(ds, cfg, TrainJobConfig(
        num_machines=2, trainers_per_machine=1, seed=5, **job_kw),
        device="cpu", params=params)
    try:
        metrics = [tr.train_epoch(e) for e in range(epochs)]
    finally:
        tr.stop()
    losses = [x for m in metrics for x in m["losses"]]
    accs = [m["acc"] for m in metrics]
    blob = b"".join(p.detach().numpy().tobytes()
                    for p in tree_leaves(tr.params))
    return losses, accs, blob, [m["loss"] for m in metrics]


# the reference's four configurations (tests/test_api.py); link prediction
# schedules every owned edge an epoch, so its graphs are smaller
GOLDEN = [("node_classification", "graphsage", "product-sim", 11, 2),
          ("node_classification", "rgcn", "mag-sim", 13, 2),
          ("link_prediction", "graphsage", "product-sim", 9, 1),
          ("link_prediction", "rgcn", "mag-sim", 10, 1)]


@pytest.mark.parametrize("task,arch,dataset,scale,epochs", GOLDEN)
def test_trainer_per_array_golden_bytes(task, arch, dataset, scale, epochs):
    """The acceptance pin: per-array staging with the plain versions and
    packed staging with ``impl="auto"`` train to bit-identical losses,
    accuracies (MRR) and parameter bytes."""
    ds = get_dataset(dataset, scale=scale)
    cfg = _port_cfg(task, arch, ds)
    kw = dict(task=task)
    if task == "link_prediction":
        kw["num_negs"] = 3
    per_array = _train_golden(ds, cfg, dict(packed_staging=False,
                                            impl="ref", **kw), epochs)
    packed = _train_golden(ds, cfg, dict(packed_staging=True, impl="auto",
                                         **kw), epochs)
    assert len(per_array[0]) >= epochs
    assert packed[0] == per_array[0], "losses diverged"
    assert packed[1] == per_array[1], "accuracies diverged"
    assert packed[2] == per_array[2], "parameter bytes diverged"


def test_per_array_losses_match_the_reference_per_array_run():
    ref_ds = ref_get_dataset("product-sim", scale=11)
    ref_cfg = RefConfig(arch="graphsage", in_dim=ref_ds.feats.shape[1],
                        hidden_dim=16, num_classes=ref_ds.num_classes,
                        fanouts=[5, 5], batch_size=32)
    ref = RefTrainer(ref_ds, ref_cfg, RefJob(
        num_machines=2, trainers_per_machine=1, seed=5,
        packed_staging=False, impl="ref"))
    params0 = jax.tree.map(np.asarray, ref.params)
    try:
        ref_losses = [ref.train_epoch(e)["loss"] for e in range(2)]
    finally:
        ref.stop()
    ds = get_dataset("product-sim", scale=11)
    losses, _, _, epoch_losses = _train_golden(
        ds, _port_cfg("node_classification", "graphsage", ds),
        dict(packed_staging=False, impl="ref"), 2,
        params=params_from_numpy(params0))
    # the reference reports each epoch's mean step loss
    assert len(losses) > len(epoch_losses) == len(ref_losses) == 2
    np.testing.assert_allclose(epoch_losses, ref_losses, **LOSS_TOL)


def test_evaluation_follows_the_staging_flag():
    ds = get_dataset("product-sim", scale=10)
    cfg = _port_cfg("node_classification", "graphsage", ds)
    accs = []
    for packed in (True, False):
        tr = DistGNNTrainer(ds, cfg, TrainJobConfig(
            num_machines=2, trainers_per_machine=1, seed=5,
            packed_staging=packed), device="cpu")
        staged = []
        stage = tr._stage
        tr._stage = lambda tree: staged.append(stage(tree)) or staged[-1]
        try:
            accs.append(tr.evaluate(ds.val_nids, max_batches=2))
        finally:
            tr.stop()
        assert staged and isinstance(staged[0], dict)
        assert all(isinstance(t["input_feats"], torch.Tensor)
                   for t in staged)
    assert accs[0] == accs[1]


def _gnn_run(extra):
    args = train_cli.build_parser().parse_args(
        ["--arch", "graphsage", "--scale", "10", "--epochs", "1",
         "--batch-size", "16", "--trainers-per-machine", "1",
         "--device", "cpu"] + extra)
    out = train_cli.run_gnn(args)
    blob = b"".join(p.detach().numpy().tobytes()
                    for p in tree_leaves(out["trainer"].params))
    assert out["trainer"].job.packed_staging == ("--no-packed-staging"
                                                 not in extra)
    return out["epochs"][0]["losses"], out["epochs"][0]["acc"], \
        out["val_acc"], blob


def _lm_run(extra):
    args = train_cli.build_parser().parse_args(
        ["--arch", "qwen2-0.5b", "--smoke", "--steps", "3", "--batch-size",
         "2", "--seq-len", "16", "--device", "cpu"] + extra)
    out = train_cli.run_lm(args)
    blob = b"".join(p.detach().numpy().tobytes()
                    for p in tree_leaves(out["params"]))
    return out["loss"], out["grad_norm"], blob


@pytest.mark.parametrize("run", [_gnn_run, _lm_run], ids=["gnn", "lm"])
def test_launcher_no_packed_staging_keeps_the_bytes(run, capsys):
    packed = run([])
    per_array = run(["--no-packed-staging"])
    assert packed == per_array
    assert len(packed[0]) >= 1 and np.all(np.isfinite(packed[0]))
    capsys.readouterr()
