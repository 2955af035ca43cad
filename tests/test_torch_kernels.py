"""The port's K1 (fused gather -> aggregate) and K2 (masked segment-sum)
against the JAX package's: the plain PyTorch versions against ``repro``'s
``impl="ref"`` oracles and its Pallas kernels in interpret mode, on the
same numpy inputs. Tolerances are the reference's own kernel tolerances
(``tests/test_kernels.py``): rtol = atol = 1e-5 in float32, rtol = 0.1,
atol = 0.5 in bfloat16.

The CUDA kernels themselves run only on a card: the destination-grouped
order they reduce over is checked here against a numpy oracle, and the
``cuda``-marked test holds them against the plain versions on the card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_gather_aggregate.kernel import (
    fused_gather_aggregate_pallas)
from repro.kernels.fused_gather_aggregate.ref import \
    fused_gather_aggregate_ref as jax_fga_ref
from repro.kernels.segment_sum.kernel import segment_sum_pallas
from repro.kernels.segment_sum.ref import segment_sum_ref as jax_ss_ref
from repro_torch.kernels import (dst_groups, fused_gather_aggregate,
                                 fused_gather_aggregate_cuda, segment_sum,
                                 segment_sum_cuda)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(rng, e, src_n, dst_n, live=0.7):
    """Random edges; masked-off edges carry dst 0 and src 0, exactly as
    ``pad_block`` pads them."""
    src = rng.integers(0, src_n, e).astype(np.int32)
    dst = rng.integers(0, dst_n, e).astype(np.int32)
    mask = rng.random(e) < live
    src[~mask] = 0
    dst[~mask] = 0
    return src, dst, mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


SHAPES = [  # (E, F, num_dst): F in {1, 100, 256}, ragged and tiny
    (64, 1, 8), (1000, 1, 77), (300, 100, 50), (513, 100, 257),
    (200, 256, 33), (1, 1, 1), (100, 7, 300),
]


@pytest.mark.parametrize("e,f,n", SHAPES)
def test_segment_sum_plain_matches_reference(e, f, n):
    rng = np.random.default_rng(e * 31 + f)
    msg = rng.standard_normal((e, f)).astype(np.float32)
    _, dst, mask = _edges(rng, e, 1, n)
    want_ref = np.asarray(jax_ss_ref(jnp.asarray(msg), jnp.asarray(dst),
                                     jnp.asarray(mask), n))
    want_pallas = np.asarray(segment_sum_pallas(
        jnp.asarray(msg), jnp.asarray(dst), jnp.asarray(mask), n))
    got = segment_sum(*_t(msg, dst, mask), n).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("e,f,n", SHAPES)
def test_fused_gather_aggregate_plain_matches_reference(e, f, n):
    rng = np.random.default_rng(e * 17 + f)
    v = 40
    h = rng.standard_normal((v, f)).astype(np.float32)
    src, dst, mask = _edges(rng, e, v, n)
    args = [jnp.asarray(x) for x in (h, src, dst, mask)]
    want_ref = np.asarray(jax_fga_ref(*args, n))
    want_pallas = np.asarray(fused_gather_aggregate_pallas(*args, n))
    got = fused_gather_aggregate(*_t(h, src, dst, mask), n).numpy()
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


def test_segment_sum_bf16_matches_reference():
    rng = np.random.default_rng(0)
    e, f, n = 256, 64, 32
    msg32 = (rng.standard_normal((e, f)) / 8).astype(np.float32)
    _, dst, mask = _edges(rng, e, 1, n, live=0.8)
    want = np.asarray(jax_ss_ref(jnp.asarray(msg32, jnp.bfloat16),
                                 jnp.asarray(dst), jnp.asarray(mask), n),
                      np.float32)
    msg, dst_t, mask_t = _t(msg32, dst, mask)
    got = segment_sum(msg.to(torch.bfloat16), dst_t, mask_t, n)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.1,
                               atol=0.5)


@pytest.mark.parametrize("op", ["segment_sum", "fused_gather_aggregate"])
def test_padding_rules(op):
    """Padded edges with dst 0 add nothing, destinations with no edges
    are 0, and an all-masked block is all zeros."""
    rng = np.random.default_rng(5)
    e, f, n, v = 50, 100, 12, 20
    h = rng.standard_normal((v, f)).astype(np.float32)
    src, dst, mask = _edges(rng, e, v, n)
    dst[mask] = np.where(dst[mask] >= 6, dst[mask], dst[mask] + 6)  # 0..5 empty
    for m in (mask, np.zeros(e, bool)):
        if op == "segment_sum":
            got = segment_sum(*_t(h[src], dst, m), n).numpy()
            want = np.asarray(jax_ss_ref(jnp.asarray(h[src]),
                                         jnp.asarray(dst), jnp.asarray(m), n))
        else:
            got = fused_gather_aggregate(*_t(h, src, dst, m), n).numpy()
            want = np.asarray(jax_fga_ref(jnp.asarray(h), jnp.asarray(src),
                                          jnp.asarray(dst), jnp.asarray(m),
                                          n))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not got[:6].any()
        if not m.any():
            assert not got.any()


@pytest.mark.parametrize("e,n,live", [(200, 17, 0.7), (64, 1, 0.5),
                                      (30, 40, 0.0), (1, 1, 1.0)])
def test_dst_groups_is_stable_destination_order(e, n, live):
    """The order the CUDA kernels reduce over: live edges grouped by dst,
    each group in original edge order, masked edges past offsets[n]."""
    rng = np.random.default_rng(e + n)
    _, dst, mask = _edges(rng, e, 1, n, live=live)
    g = dst_groups(*_t(dst, mask), n)
    order, offsets = g.order.numpy(), g.offsets.numpy()
    assert g.order.dtype == torch.int32 and g.offsets.dtype == torch.int32
    assert offsets[0] == 0 and offsets[-1] == mask.sum()
    for d in range(n):
        want = np.flatnonzero(mask & (dst == d))
        np.testing.assert_array_equal(order[offsets[d]:offsets[d + 1]], want)
    assert sorted(order.tolist()) == list(range(e))


def test_kernel_algorithm_on_grouped_order_matches_reference():
    """The CUDA kernels' arithmetic, run in numpy: per destination, fp32
    sums over the grouped order. It matches the reference's scatter."""
    rng = np.random.default_rng(9)
    e, f, n, v = 400, 100, 60, 90
    h = rng.standard_normal((v, f)).astype(np.float32)
    src, dst, mask = _edges(rng, e, v, n)
    g = dst_groups(*_t(dst, mask), n)
    order, offsets = g.order.numpy(), g.offsets.numpy()
    out = np.zeros((n, f), np.float32)
    for d in range(n):
        for i in order[offsets[d]:offsets[d + 1]]:
            out[d] += h[src[i]]
    want = np.asarray(jax_fga_ref(jnp.asarray(h), jnp.asarray(src),
                                  jnp.asarray(dst), jnp.asarray(mask), n))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_impl_switch():
    rng = np.random.default_rng(1)
    h = rng.standard_normal((10, 4)).astype(np.float32)
    src, dst, mask = _edges(rng, 30, 10, 5)
    args = _t(h, src, dst, mask)
    ref = fused_gather_aggregate(*args, 5, impl="ref")
    assert torch.equal(fused_gather_aggregate(*args, 5, impl="auto"), ref)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        fused_gather_aggregate(*args, 5, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        segment_sum(args[0][args[1].long()], args[2], args[3], 5,
                    impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        segment_sum(args[0], args[2][:10], args[3][:10], 5, impl="pallas")


def test_cuda_wrappers_refuse_cpu_tensors():
    g = dst_groups(torch.zeros(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.bool), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_sum_cuda(torch.ones(4, 1), g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_gather_aggregate_cuda(torch.ones(3, 2),
                                    torch.zeros(4, dtype=torch.int32), g)


def test_import_and_cpu_path_need_no_nvcc(tmp_path):
    """Importing the kernels, and running them on CPU tensors, builds
    nothing and needs no CUDA toolkit."""
    code = (
        "import sys, torch\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.kernels import _cuda, segment_sum\n"
        "out = segment_sum(torch.ones(3, 1), torch.tensor([0, 1, 0]),\n"
        "                  torch.tensor([True, True, False]), 2)\n"
        "assert out[:, 0].tolist() == [1.0, 1.0], out\n"
        "assert not _cuda._loaded\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)         # no nvcc reachable
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 100, 256])
def test_cuda_kernels_match_plain_on_card(f):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (run on the card)")
    rng = np.random.default_rng(f)
    e, n, v = 5000, 300, 700
    h = rng.standard_normal((v, f)).astype(np.float32)
    src, dst, mask = [t.cuda() for t in _t(*_edges(rng, e, v, n))]
    hc = torch.from_numpy(h).cuda()
    got = fused_gather_aggregate(hc, src, dst, mask, n, impl="cuda")
    want = fused_gather_aggregate(hc, src, dst, mask, n, impl="ref")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    msg = hc[src.long()]
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, None)):
        got = segment_sum(msg.to(dt), dst, mask, n, impl="cuda")
        want = segment_sum(msg.to(dt), dst, mask, n, impl="ref")
        if tol is None:
            torch.testing.assert_close(got.float(), want.float(), rtol=0.1,
                                       atol=0.5)
        else:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
