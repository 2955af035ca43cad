"""The port's training slice against the JAX package's: dense AdamW
against ``repro.optim.adamw_update``, the node loaders' batches against
``repro.api.NodeDataLoader``'s (byte-identical), and the whole synchronous
trainer against ``repro.training.DistGNNTrainer`` for GraphSAGE and GAT on
product-sim scale 11 (hidden 32, fanouts [5, 5], batch 32, 2 machines x 2
trainers, ``sync=True``), from the reference's initial parameters.

Tolerances: AdamW rtol 1e-6 (the same float32 formula; it is bitwise
equal here). First-step gradients rtol 1e-4, atol 1e-6 and per-step losses
rtol 1e-4, atol 1e-5: the products are full float32 on both sides, but
XLA's and PyTorch's CPU GEMMs and scatters add in different orders. Final
parameters after 3 steps (lr 3e-3): rtol = atol = 1e-4. Adam's first step
is nearly ``lr * sign(g)``, so a gradient element within rounding of 0
could step the other way on one side; none does on these inputs (the
largest difference is under 1e-5), and the tolerance stays at 1e-4.

The card's own path (the autograd Functions and their backward kernels)
runs here through CPU stand-ins of the kernels (``_torch_emulated_cuda``);
the kernels are held against their plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.api import DistGraph as RefDistGraph
from repro.api import NodeDataLoader as RefLoader
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import apply_gnn as ref_apply_gnn
from repro.models.gnn import nc_loss as ref_nc_loss
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.api import DistGNNTrainer as RefTrainer
from repro.api import TrainJobConfig as RefJob
from repro_torch.api import (DistGNNTrainer, DistGraph, NodeDataLoader,
                             TrainJobConfig)
from repro_torch.graph import get_dataset
from repro_torch.kernels import (FusedGatherAggregate, dst_groups,
                                 fused_gather_aggregate)
from repro_torch.launch import train as train_cli
from repro_torch.models.gnn import GNNConfig, params_from_numpy
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim.optimizers import tree_leaves

SCALE = 11
MODEL = dict(in_dim=100, hidden_dim=32, num_classes=16, fanouts=[5, 5],
             batch_size=32)
JOB = dict(num_machines=2, trainers_per_machine=2, sync=True)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _host_leaves(batch: dict):
    """A host batch's arrays, keyed by path, ``None`` leaves dropped."""
    out = {}
    for k in ("input_feats", "labels", "seed_mask"):
        out[k] = np.asarray(batch[k])
    for i, b in enumerate(batch["blocks"]):
        for k, v in b.items():
            if v is not None:
                out[f"blocks/{i}/{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference_over_three_steps(weight_decay):
    rng = np.random.default_rng(3)
    p = {"layers": [{"w": rng.standard_normal((7, 5)).astype(np.float32),
                     "b": np.zeros(5, np.float32)}],
         "head": rng.standard_normal((5, 3)).astype(np.float32)}
    ref_p = jax.tree.map(jnp.asarray, p)
    ref_s = ref_adamw_init(ref_p)
    port_p = params_from_numpy(p)
    port_s = adamw_init(port_p)
    assert port_s.step.dtype == torch.int32
    for _ in range(3):
        g = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p)
        ref_p, ref_s = ref_adamw_update(ref_p, jax.tree.map(jnp.asarray, g),
                                        ref_s, lr=3e-3,
                                        weight_decay=weight_decay)
        port_p, port_s = adamw_update(port_p, params_from_numpy(g), port_s,
                                      lr=3e-3, weight_decay=weight_decay)
        for a, b in zip(_np_leaves(ref_p), _port_leaves(port_p)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        for a, b in zip(_np_leaves(ref_s.mu) + _np_leaves(ref_s.nu),
                        _port_leaves(port_s.mu) + _port_leaves(port_s.nu)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    assert int(port_s.step) == int(ref_s.step) == 3


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    world = dict(num_machines=2, trainers_per_machine=2, seed=0)
    return (RefDistGraph(ref_get_dataset("product-sim", scale=10), **world),
            DistGraph(get_dataset("product-sim", scale=10), **world))


@pytest.mark.parametrize("mode,sync,workers", [
    ("train", False, 1), ("train", True, 1), ("train", False, 2),
    ("eval", False, 1)])
def test_node_loader_batches_byte_identical(graphs, mode, sync, workers):
    ref_g, g = graphs
    kw = dict(batch_size=16, mode=mode, seed=5, sampler_seed=7)
    if mode == "train":
        kw.update(sync=sync, sample_workers=workers)
    got_batches = {}
    for name, graph, cls in (("ref", ref_g, RefLoader),
                             ("port", g, NodeDataLoader)):
        view = graph.trainer_view(1)
        seeds = view.train_nids
        with cls(view, seeds, [4, 3], labels=view.labels[seeds],
                 **kw) as ld:
            got_batches[name] = [
                [_host_leaves(b.model_input()) for b in ld.epoch(e)]
                for e in range(2)]
    ref, port = got_batches["ref"], got_batches["port"]
    assert len(ref[0]) == len(port[0]) >= 2
    for ref_epoch, port_epoch in zip(ref, port):
        for a, b in zip(ref_epoch, port_epoch):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                assert a[k].tobytes() == b[k].tobytes(), k


def test_node_loader_device_prefetch_stages_the_batch(graphs):
    _, g = graphs
    view = g.trainer_view(0)
    seeds = view.node_splits(view.train_nids, seed=0)[0]
    with NodeDataLoader(view, seeds, [4, 3], batch_size=16,
                        labels=view.labels[seeds], device_prefetch=True,
                        device="cpu") as ld:
        batch = next(iter(ld))
        staged = batch.model_input()
        host = _host_leaves(dict(input_feats=batch.input_feats,
                                 labels=batch.labels,
                                 seed_mask=batch.seed_mask,
                                 blocks=[dict(edge_src=b.edge_src,
                                              edge_dst=b.edge_dst,
                                              edge_mask=b.edge_mask)
                                         for b in batch.blocks]))
        assert torch.equal(staged["input_feats"],
                           torch.from_numpy(host["input_feats"]))
        assert staged["blocks"][0]["edge_mask"].dtype == torch.bool
        assert batch.model_input(packed=True).total_bytes() > 0


# ---------------------------------------------------------------------------
# the whole slice against the reference trainer
# ---------------------------------------------------------------------------

def _ref_loss_and_grads(cfg, params, stacked):
    def loss_fn(p):
        def one(b):
            return ref_nc_loss(ref_apply_gnn(cfg, p, b), b["labels"],
                               b["seed_mask"])
        return jax.vmap(one)(stacked).mean()
    return jax.value_and_grad(loss_fn)(params)


@pytest.fixture(scope="module", params=["graphsage", "gat"])
def trained(request):
    """Reference and port trainers from the same initial params: the first
    stacked batch's loss and gradients on both, then 3 training steps."""
    arch = request.param
    ref_cfg = RefConfig(arch=arch, num_heads=2, impl="ref", **MODEL)
    ref = RefTrainer(ref_get_dataset("product-sim", scale=SCALE), ref_cfg,
                     RefJob(**JOB))
    params0 = jax.tree.map(np.asarray, ref.params)
    port = DistGNNTrainer(get_dataset("product-sim", scale=SCALE),
                          GNNConfig(arch=arch, num_heads=2, **MODEL),
                          TrainJobConfig(**JOB), device="cpu",
                          params=params_from_numpy(params0))
    try:
        assert port.batches_per_epoch == ref.batches_per_epoch == 1
        ref_first = [next(ld.epoch(0)).model_input() for ld in ref.loaders]
        port_first = [next(ld.epoch(0)).model_input() for ld in port.loaders]
        for a, b in zip(ref_first, port_first):
            a, b = _host_leaves(a), _host_leaves(b)
            assert all(a[k].tobytes() == b[k].tobytes() for k in a)
        ref_loss, ref_grads = _ref_loss_and_grads(
            ref_cfg, ref.params, ref._stack(ref_first))
        loss, _acc, grads = port.loss_and_grads(port._stack(port_first))
        ref_epochs = [ref.train_epoch(e) for e in range(3)]
        port_epochs = [port.train_epoch(e) for e in range(3)]
    finally:
        ref.stop()
        port.stop()
    return dict(arch=arch, params0=params0, ref_loss=float(ref_loss),
                loss=float(loss), ref_grads=_np_leaves(ref_grads),
                grads=_port_leaves(grads), ref_epochs=ref_epochs,
                port_epochs=port_epochs,
                ref_params=_np_leaves(ref.params),
                params=_port_leaves(port.params), port=port)


def test_first_step_loss_and_gradients_match_reference(trained):
    np.testing.assert_allclose(trained["loss"], trained["ref_loss"],
                               **LOSS_TOL)
    assert len(trained["grads"]) == len(trained["ref_grads"])
    for got, want in zip(trained["grads"], trained["ref_grads"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_per_step_losses_match_reference(trained):
    ref = [m["loss"] for m in trained["ref_epochs"]]
    got = [l for m in trained["port_epochs"] for l in m["losses"]]
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got, ref, **LOSS_TOL)
    np.testing.assert_allclose(got[0], trained["ref_loss"], **LOSS_TOL)
    np.testing.assert_allclose([m["acc"] for m in trained["port_epochs"]],
                               [m["acc"] for m in trained["ref_epochs"]],
                               rtol=0, atol=1e-6)
    assert got[-1] < got[0]


def test_final_params_match_reference(trained):
    for got, want, start in zip(trained["params"], trained["ref_params"],
                                _np_leaves(trained["params0"])):
        np.testing.assert_allclose(got, want, **PARAM_TOL)
        assert not np.array_equal(got, start)        # every leaf moved


def test_trainer_reports_spans_and_stats(trained):
    port = trained["port"]
    spans = port.spans_ms()
    assert set(spans) == {"wait_loaders", "stack_stage", "forward",
                          "backward", "optimizer", "read_loss", "stack_host",
                          "stage_pack", "stack_stage_cpu", "sample",
                          "sample_cpu", "pull", "pull_cpu"}
    assert all(v >= 0 for v in spans.values())
    assert set(port.counters()) == {"staged_bytes"}
    assert port.counters()["staged_bytes"] > 0
    assert spans["forward"] > 0 and spans["backward"] > 0
    stats = port.sampling_stats()
    assert stats["transport"]["remote_requests"] > 0
    assert port.global_step == 3


# ---------------------------------------------------------------------------
# the card's path, with the kernels' CPU stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["graphsage", "gat"])
def test_card_path_training_step_matches_plain_path(monkeypatch, arch):
    """One trainer step through the autograd Functions and their backward
    kernels (CPU stand-ins) gives the plain path's loss and gradients,
    every kernel of the path launching."""
    tr = DistGNNTrainer(get_dataset("product-sim", scale=SCALE),
                        GNNConfig(arch=arch, num_heads=2, **MODEL),
                        TrainJobConfig(**JOB), device="cpu")
    try:
        stacked = tr._stack([next(ld.epoch(0)).model_input()
                             for ld in tr.loaders])
    finally:
        tr.stop()
    want = tr.loss_and_grads(stacked, impl="ref")
    fns = emu.emulate_cuda(monkeypatch)
    got = tr.loss_and_grads(stacked)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
    for a, b in zip(tree_leaves(got[2]), tree_leaves(want[2])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    launched = {k for k, f in fns.items() if f.launches}
    if arch == "graphsage":
        # layer 0's input is features: K1's backward runs on layer 1 only
        assert launched == {"fused_gather_aggregate", "segment_sum",
                            "src_scatter"}
        assert fns["src_scatter"].launches == 1
    else:
        # every stand-in but K1's and K5's (the embedding's update)
        assert launched == set(fns) - {"fused_gather_aggregate",
                                       "sparse_adam"}


def test_k1_backward_launches_only_when_its_input_needs_a_gradient(
        monkeypatch):
    """On the card K1's output carries a gradient to h_src through the
    source-keyed kernel (a kernel output without ``grad_fn`` would
    silently drop the neighbour sum's gradient), and an input that needs
    none launches nothing."""
    fns = emu.emulate_cuda(monkeypatch)
    rng = np.random.default_rng(0)
    e, v, n, f = 300, 40, 25, 8
    src = torch.from_numpy(rng.integers(0, v, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    mask = torch.from_numpy(rng.random(e) < 0.7)
    h = torch.from_numpy(rng.standard_normal((v, f)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    groups = dst_groups(dst, mask, n)
    out = FusedGatherAggregate.apply(h, src, dst, mask, groups)
    assert out.grad_fn is None and fns["src_scatter"].launches == 0
    hg = h.clone().requires_grad_()
    out = FusedGatherAggregate.apply(hg, src, dst, mask, groups)
    assert out.grad_fn is not None
    (grad,) = torch.autograd.grad((out * w).sum(), hg)
    assert fns["src_scatter"].launches == 1
    plain = h.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        (fused_gather_aggregate(plain, src, dst, mask, n, impl="ref")
         * w).sum(), plain)
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_k1_backward_reaches_h_src_on_card():
    """On the card K1's output has a gradient function, and its gradient
    into h_src (the source-keyed kernel) equals the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    rng = np.random.default_rng(1)
    e, v, n, f = 5000, 700, 300, 256
    src = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).cuda()
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32)).cuda()
    mask = torch.from_numpy(rng.random(e) < 0.7).cuda()
    h = torch.from_numpy(rng.standard_normal((v, f)).astype(
        np.float32)).cuda().requires_grad_()
    w = torch.randn(n, f, device="cuda")
    out = fused_gather_aggregate(h, src, dst, mask, n, impl="cuda")
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad((out * w).sum(), h)
    (want,) = torch.autograd.grad(
        (fused_gather_aggregate(h, src, dst, mask, n, impl="ref")
         * w).sum(), h)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_cpu_when_asked(capsys):
    summary = train_cli.main(["--arch", "gat", "--device", "cpu",
                              "--scale", "10", "--epochs", "1",
                              "--batch-size", "16"])
    assert summary["epochs"][0]["batches"] >= 1
    assert np.isfinite(summary["epochs"][0]["loss"])
    assert 0.0 <= summary["val_acc"] <= 1.0
    assert "[final] val_acc=" in capsys.readouterr().out


def test_parser_takes_every_lm_flag_of_the_reference():
    """Every flag of the reference's parser that its help marks as an LM
    flag parses in the port's, with the reference's default and value."""
    from repro.launch.train import build_parser as ref_build_parser

    ref = ref_build_parser()
    lm = [a for a in ref._actions
          if a.option_strings and "LM" in a.help and not a.required]
    assert {a.option_strings[0] for a in lm} >= {
        "--steps", "--batch-size", "--seq-len", "--lr", "--smoke"}
    port_defaults = vars(train_cli.build_parser().parse_args(
        ["--arch", "qwen2-0.5b"]))
    for a in lm:
        assert port_defaults[a.dest] == a.default, a.dest
        argv = ["--arch", "qwen2-0.5b", a.option_strings[0]]
        if a.nargs != 0:
            argv.append("7")
        want = vars(ref.parse_args(argv))[a.dest]
        got = vars(train_cli.build_parser().parse_args(argv))[a.dest]
        assert got == want and type(got) is type(want), a.dest


MAG_RELS = ("cites", "writes", "rev_writes", "employs")


@pytest.mark.parametrize("argv,fanouts", [
    (["--hetero"], [dict.fromkeys(MAG_RELS, f) for f in (25, 15)]),
    (["--hetero", "--rel-fanout", "cites=5", "--rel-fanout", "employs=0"],
     [{**dict.fromkeys(MAG_RELS, f), "cites": 5, "employs": 0}
      for f in (25, 15)]),
    ([], [25, 15]),
])
def test_rgcn_and_typed_options_build_their_trainer(argv, fanouts):
    """``--arch rgcn`` (typed with ``--hetero``, ``--rel-fanout``
    overriding a relation's fanout; untyped without) builds a trainer of
    the reference's config: num_rels from the dataset, a typed world only
    under ``--hetero``."""
    args = train_cli.build_parser().parse_args(
        ["--arch", "rgcn", "--dataset", "mag-hetero", "--device", "cpu",
         "--scale", "9", "--batch-size", "4", *argv])
    _ds, tr = train_cli.build_trainer(args)
    tr.stop()
    assert tr.cfg.arch == "rgcn" and tr.cfg.num_rels == 4
    assert tr.cfg.fanouts == fanouts
    assert tr.cfg.typed == tr.hetero == bool(argv)
    assert (tr.typed is not None) == bool(argv)


@pytest.mark.parametrize("argv,message", [
    (["--dataset", "product-sim", "--hetero"], "needs a schema'd dataset"),
    (["--dataset", "mag-hetero", "--hetero", "--rel-fanout", "cites"],
     "expects <relation>=<int>"),
    (["--dataset", "mag-hetero", "--hetero", "--rel-fanout", "likes=3"],
     "unknown relation 'likes'"),
])
def test_typed_options_refuse_what_the_reference_refuses(argv, message):
    args = train_cli.build_parser().parse_args(
        ["--arch", "rgcn", "--device", "cpu", "--scale", "9", *argv])
    with pytest.raises(SystemExit, match=message):
        train_cli.build_trainer(args)


@pytest.mark.parametrize("fields", [
    dict(task="link_prediction", score_fn="distmult", neg_mode="in-batch"),
])
def test_job_config_builds_link_prediction_fields(fields):
    """Link prediction is ported (ROADMAP queue A item 5): the job takes
    the task and its fields and keeps them."""
    job = TrainJobConfig(**fields)
    assert {k: getattr(job, k) for k in fields} == fields
    assert job.num_negs == 16 and job.neg_exclude is False


@pytest.mark.parametrize("argv", [
    ["--checkpoint-dir", "ckpt"],
    ["--checkpoint-dir", "ckpt", "--checkpoint-interval", "5"],
    ["--checkpoint-dir", "ckpt", "--inject-fault", "0:1"],
    ["--rpc-fault-rate", "0.1", "--fault-seed", "3"],
])
def test_recovery_options_reach_the_job(argv):
    """Checkpoints, recovery and fault injection are ported (ROADMAP
    queue A item 7): the flags land in the trainer's job."""
    args = train_cli.build_parser().parse_args(
        ["--arch", "graphsage", "--device", "cpu", "--scale", "10",
         "--batch-size", "16", *argv])
    _ds, tr = train_cli.build_trainer(args)
    tr.stop()
    assert tr.job.checkpoint_dir == args.checkpoint_dir
    assert tr.job.checkpoint_interval == args.checkpoint_interval
    inj = tr.job.fault_injector
    assert (inj is None) == (not args.inject_fault and not args.rpc_fault_rate)
    if inj is not None:
        assert tr.transport.fault_injector is inj


def test_trainer_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistGNNTrainer(get_dataset("product-sim", scale=10),
                       GNNConfig(arch="graphsage", **MODEL),
                       TrainJobConfig(**JOB))
