"""K4's public op (``repro_torch.kernels.edge_softmax``) on the card's
route, with the kernels' CPU stand-ins: it has no backward kernel, so it
refuses scores that require a gradient where autograd records, and it
runs on them under ``torch.no_grad()``, where no graph is built (as
``tests/test_torch_gat.py::test_cuda_k3_k4_match_plain_on_card`` calls it
on the card). Values against the JAX package's oracle within its kernel
tolerance rtol = atol = 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_emulated_cuda as emu
from repro.kernels.edge_softmax.ref import edge_softmax_ref as jax_es_ref
from repro_torch.kernels import edge_softmax

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h", [1, 2, 3])
def test_card_route_refuses_a_tracked_input_and_runs_under_no_grad(
        monkeypatch, h):
    fns = emu.emulate_cuda(monkeypatch)
    rng = np.random.default_rng(h)
    e, n = 400, 60
    dst = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    dst[~mask] = 0
    scores = (rng.standard_normal((e, h)) * 3).astype(np.float32)
    s = torch.from_numpy(scores).requires_grad_()
    d, m = torch.from_numpy(dst), torch.from_numpy(mask)
    with pytest.raises(NotImplementedError):
        edge_softmax(s, d, m, n, impl="cuda")
    assert fns["edge_softmax_stats"].launches == 0
    with torch.no_grad():
        got = edge_softmax(s, d, m, n, impl="cuda")
    assert not got.requires_grad
    assert fns["edge_softmax_stats"].launches == 1
    assert fns["edge_softmax_norm"].launches == 1
    want = jax_es_ref(*map(jnp.asarray, (scores, dst, mask)), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got.numpy()[~mask].any()
