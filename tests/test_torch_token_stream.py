"""The port's LM token stream (``repro_torch.data.TokenStream``) against the
JAX package's (``repro.data.TokenStream``) on the CPU: the same seed,
``host_index`` and ``host_count`` give byte-identical tokens from the
synthetic source and from a memory-mapped token file, and byte-identical
vlm / audio stub embeddings; packed and unpacked staging, and the
synchronous pipeline, give the same bytes.

The reference draws a vlm / audio batch's stub embeddings on another
pipeline thread than its tokens, from the same generator, so only its
synchronous run has fixed bytes there; the port draws both on one thread
in that run's order, and its asynchronous stream is held to the
reference's synchronous one."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.data import TokenStream as RefTokenStream
from repro.data.stream import _synthetic_tokens as ref_synthetic_tokens
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import TokenStream
from repro_torch.data.stream import _synthetic_tokens

BATCHES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _take(stream, n=BATCHES):
    out = []
    try:
        for i, b in enumerate(stream):
            if i >= n:
                break
            out.append({k: np.asarray(v) for k, v in b.items()})
    finally:
        stream.stop()
    return out


def _port_take(stream, n=BATCHES):
    out = []
    try:
        for i, b in enumerate(stream):
            if i >= n:
                break
            assert all(v.device.type == "cpu" for v in b.values())
            out.append({k: v.numpy() for k, v in b.items()})
    finally:
        stream.stop()
    return out


def _same_bytes(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        for k in r:
            assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape, k
            assert p[k].tobytes() == r[k].tobytes(), k


@pytest.mark.parametrize("vocab,n,seed", [(100, 257, 0), (503, 4096, 3),
                                          (151936, 1000, 7)])
def test_synthetic_tokens_byte_identical(vocab, n, seed):
    got = _synthetic_tokens(np.random.default_rng(seed), vocab, n)
    want = ref_synthetic_tokens(np.random.default_rng(seed), vocab, n)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed,host_index,host_count", [
    (0, 0, 1), (5, 0, 2), (5, 1, 2), (2, 3, 4)])
def test_synthetic_stream_byte_identical(seed, host_index, host_count):
    kw = dict(vocab=97, batch=4, seq=32, seed=seed, host_index=host_index,
              host_count=host_count)
    port = _port_take(TokenStream(device="cpu", **kw))
    _same_bytes(port, _take(RefTokenStream(**kw)))
    assert port[0]["tokens"].shape == (4, 32)
    assert int(max(b["tokens"].max() for b in port)) < 97


def test_host_split_gives_other_streams():
    a, b = (_port_take(TokenStream(vocab=50, batch=2, seq=16, seed=0,
                                   host_index=i, host_count=2,
                                   device="cpu"), n=1) for i in range(2))
    assert a[0]["tokens"].tobytes() != b[0]["tokens"].tobytes()


def test_file_source_byte_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(11).integers(0, 1000, 20_000).astype(
        np.int32).tofile(path)
    kw = dict(vocab=1000, batch=3, seq=64, seed=4, file=str(path))
    _same_bytes(_port_take(TokenStream(device="cpu", **kw)),
                _take(RefTokenStream(**kw)))


@pytest.mark.parametrize("arch_id", ["pixtral-12b", "whisper-base"])
def test_vlm_and_audio_extras_byte_identical(arch_id):
    rcfg = ref_smoke_variant(ref_get_config(arch_id))
    cfg = smoke_variant(get_config(arch_id))
    kw = dict(vocab=cfg.vocab_size, batch=2, seq=24, seed=1)
    port = _port_take(TokenStream(cfg=cfg, device="cpu", **kw))
    _same_bytes(port, _take(RefTokenStream(cfg=rcfg, sync=True, **kw)))
    extra = "image_embeds" if cfg.arch_type == "vlm" else "encoder_embeds"
    assert port[0][extra].dtype == np.float32


@pytest.mark.parametrize("packed,sync", [(False, False), (True, True)])
def test_staging_and_sync_keep_the_bytes(packed, sync):
    cfg = smoke_variant(get_config("pixtral-12b"))
    kw = dict(vocab=cfg.vocab_size, batch=2, seq=16, seed=9, cfg=cfg,
              device="cpu")
    _same_bytes(_port_take(TokenStream(packed=packed, sync=sync, **kw)),
                _port_take(TokenStream(**kw)))


def test_stream_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    stream = TokenStream(vocab=10, batch=1, seq=4, sync=True)
    with pytest.raises((RuntimeError, AssertionError)):
        next(stream)
    stream.stop()
