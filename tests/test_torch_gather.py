"""K6, the row gather, against the JAX package's: the port's
``gather_rows`` (the plain version on CPU tensors) against
``repro.kernels.gather``'s ``gather_rows_ref`` and ``gather_rows_pallas``
in interpret mode, on the same NumPy inputs. A gather copies bytes, so
every comparison is exact. The ``cuda``-marked test holds the CUDA kernel
against the plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather import gather_rows_pallas, gather_rows_ref
from repro_torch.kernels import gather_rows, gather_rows_cuda
from repro_torch.kernels import gather_rows_ref as port_ref


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("v,f,n", [(50, 100, 37), (9, 7, 20), (40, 600, 5)])
def test_gather_rows_exact_vs_reference(v, f, n, idx_dtype):
    rng = np.random.default_rng(v + f + n)
    table = rng.standard_normal((v, f)).astype(np.float32)
    idx = rng.integers(0, v, n).astype(idx_dtype)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (n, f)
    for ref in (gather_rows_ref(jnp.asarray(table), jnp.asarray(idx)),
                gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx),
                                   interpret=True)):
        assert np.asarray(ref).tobytes() == got.numpy().tobytes()
    assert torch.equal(port_ref(torch.from_numpy(table),
                                torch.from_numpy(idx)), got)


def test_gather_rows_bfloat16_rows_copied_bit_for_bit():
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((30, 100)).astype(
        np.float32)).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 30, 64).astype(np.int32))
    got = gather_rows(table, idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       table.view(torch.int16)[idx.long()])


def test_gather_rows_cuda_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows_cuda(torch.zeros(4, 2), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        gather_rows(torch.zeros(4, 2), torch.zeros(1, dtype=torch.int32),
                    impl="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((5000, 100), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(0, 5000, (7000,), generator=gen, device="cuda")
    for ix in (idx, idx.to(torch.int32)):
        got = gather_rows(table, ix)
        torch.cuda.synchronize()
        assert torch.equal(got, table[ix.long()])
