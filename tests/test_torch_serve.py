"""The port's serving path against the reference's: ``InferenceServer``
on the CPU serves the logits ``repro``'s server serves on the same world
(rtol = 1e-4, atol = 1e-5: XLA's and PyTorch's CPU GEMMs accumulate in
different orders), micro-batched requests return the bytes of the same
requests served one at a time, and ``gnn_serve`` runs on the CPU only
when asked to."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.api import DistGraph as RefDistGraph
from repro.api import InferenceServer as RefServer
from repro.core.kvstore import CacheConfig as RefCacheConfig
from repro.graph import get_dataset as ref_get_dataset
from repro.models.gnn import GNNConfig as RefConfig
from repro.models.gnn import init_gnn as ref_init_gnn
from repro_torch.api import DistGraph, InferenceServer, ServerOverloaded
from repro_torch.core.kvstore import CacheConfig
from repro_torch.graph import get_dataset
from repro_torch.launch import gnn_serve
from repro_torch.models.gnn import GNNConfig, params_from_numpy

CFG = dict(arch="graphsage", in_dim=100, hidden_dim=16, num_classes=16,
           fanouts=[4, 3], batch_size=4)
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


@pytest.fixture(scope="module")
def world():
    ref_g = RefDistGraph(ref_get_dataset("product-sim", scale=10), **WORLD)
    g = DistGraph(get_dataset("product-sim", scale=10), **WORLD)
    ref_params = ref_init_gnn(RefConfig(**CFG), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params))
    return ref_g, g, ref_params, params


@pytest.mark.parametrize("cache_mb", [0.0, 1.0])
def test_server_matches_reference_server(world, cache_mb):
    ref_g, g, ref_params, params = world
    nids = np.arange(5, 400, 11)            # 37 nodes: 10 chunks, ragged
    with RefServer(ref_g, RefConfig(**CFG, impl="ref"), ref_params,
                   micro_batch_capacity=4,
                   cache=RefCacheConfig.from_mb(cache_mb) if cache_mb
                   else None) as srv:
        want = srv.predict(nids)
    with InferenceServer(g, GNNConfig(**CFG), params, micro_batch_capacity=4,
                         cache=CacheConfig.from_mb(cache_mb) if cache_mb
                         else None, device="cpu") as srv:
        got = srv.predict(nids)
        assert srv.stats()["ticks"] >= 3
    assert got.shape == (len(nids), CFG["num_classes"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_micro_batched_equals_sequential_bitwise(world):
    _, g, _, params = world
    nids = [[3], [77, 78], [500], [9, 10, 11, 12, 13], [3]]
    with InferenceServer(g, GNNConfig(**CFG), params, micro_batch_capacity=4,
                         micro_batch_window_ms=50.0, device="cpu") as srv:
        alone = [srv.predict(n) for n in nids]
        handles = [srv.submit(n) for n in nids]
        together = [h.result(timeout=60) for h in handles]
        assert max(srv.tick_chunks) > 1          # really co-batched
    for a, b in zip(alone, together):
        assert a.tobytes() == b.tobytes()


def test_server_spans_cover_its_request_path(world):
    _, g, _, params = world
    with InferenceServer(g, GNNConfig(**CFG), params, micro_batch_capacity=4,
                         device="cpu") as srv:
        srv.predict(np.arange(4 * CFG["batch_size"]))
        spans = srv.stats()["spans_ms"]
    assert set(spans) == {"sample", "pull", "stack", "stage", "forward",
                          "device_forward"}
    for k in ("sample", "pull", "stack", "stage", "forward"):
        assert spans[k] > 0, k
    assert spans["device_forward"] == 0.0      # no card: no device events


def test_admission_control_rejects_oversized_request(world):
    _, g, _, params = world
    with InferenceServer(g, GNNConfig(**CFG), params, max_pending_chunks=2,
                         device="cpu") as srv:
        with pytest.raises(ServerOverloaded):
            srv.submit(np.arange(3 * CFG["batch_size"]))
        assert srv.stats()["rejected_requests"] == 1


def test_default_device_is_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, g, _, params = world
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(g, GNNConfig(**CFG), params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gnn_serve.main(["--smoke", "--scale", "9"])


def test_gnn_serve_smoke_on_cpu(capsys):
    out = gnn_serve.main(["--smoke", "--device", "cpu", "--scale", "9"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert out["mode"] == "serving" and out["device"] == "cpu"
    assert out["served"] == out["requests"] == 8
    for k in ("p50_ms", "p99_ms", "throughput_req_s", "mean_tick_occupancy",
              "cache", "shed", "rejected", "degraded"):
        assert k in out
