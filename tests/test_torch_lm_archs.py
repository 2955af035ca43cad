"""Every assigned LM architecture through the port's serving path
(``repro_torch.models.lm``, ``repro_torch.launch.serve``) against the JAX
package's on the CPU, at ``smoke_variant`` width (float32).

The parameters are the reference's ``init_params`` tree carried over by
``params_from_numpy``; the prompt (and the vlm / audio stub embeddings)
come from one numpy seed. ``forward``'s logits and aux loss,
``prefill``'s last logits and every cache entry, and a ``decode_step``'s
logits and cache agree within rtol = 1e-4, atol = 1e-5 (XLA's and
PyTorch's CPU products accumulate in different orders).

The atol grows with the tensor's scale above 4 (atol = 1e-5 x max|ref| / 4):
a float32 sum's rounding error scales with its terms, not with its result,
so an element that cancels to near 0 carries its row's error. The untied
families' logits stay under 4.7; the tied ones (qwen2, mamba2, granite)
multiply by the embedding, drawn at 0.02 sqrt(d) = 0.32 an entry against
``lm_head``'s 1/sqrt(d) = 0.0625, and reach 22-70; SSD states reach 13-18.
The largest errors measured were 0.75-3.3e-6 of max|ref| in each family
(mamba2's logits 9.5e-5 against 70, zamba2's tail SSD state 4.2e-5
against 12.7).

A greedy loop of 8 tokens through the port's launcher
functions picks the reference loop's tokens, except where the
reference's top two logits lie within twice the measured gap (a near
tie, counted and printed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models.lm import forward as ref_forward
from repro.models.lm import init_params as ref_init_params
from repro.models.lm import make_decode_step as ref_make_decode_step
from repro.models.lm import make_prefill_step as ref_make_prefill_step
from repro.models.lm.decode import _ring_fill as ref_ring_fill
from repro_torch.configs import (ARCH_IDS, GNN_ARCHS, all_configs,
                                 get_config, smoke_variant)
from repro_torch.launch import serve
from repro_torch.models.lm import (decode_step, forward, params_from_numpy,
                                   prefill)
from repro_torch.models.lm.decode import _ring_fill

TOL = dict(rtol=1e-4, atol=1e-5)
B, S, GEN = 2, 24, 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(port, ref, what):
    ref = _np(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)) / 4)
    np.testing.assert_allclose(_np(port), ref, err_msg=what,
                               rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def _world(arch_id, window=None):
    """(reference config, port config, reference params, port params,
    numpy batch) at smoke width."""
    rcfg = ref_smoke_variant(ref_get_config(arch_id))
    cfg = smoke_variant(get_config(arch_id))
    if window is not None:
        rcfg = dataclasses.replace(rcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["encoder_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    rparams = jax.tree.map(np.asarray,
                           ref_init_params(rcfg, jax.random.key(0)))
    return rcfg, cfg, rparams, params_from_numpy(rparams), batch


def _ref_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _extras(batch):
    return {k: v for k, v in batch.items() if k != "tokens"}


def _check_cache(port, ref, what):
    assert set(port) == set(ref), what
    assert port["pos"] == int(ref["pos"]), what
    for k in ref:
        if k != "pos":
            assert tuple(port[k].shape) == ref[k].shape, (what, k)
            _close(port[k], ref[k], f"{what}: cache[{k!r}]")


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_forward_prefill_decode_match_the_reference(arch_id):
    rcfg, cfg, rparams, params, batch = _world(arch_id)
    rb, pb = _ref_batch(batch), _port_batch(batch)
    logits_r, aux_r = jax.jit(lambda p, b: ref_forward(
        rcfg, p, b["tokens"], **_extras(b)))(rparams, rb)
    logits_p, aux_p = forward(cfg, params, pb["tokens"], **_extras(pb))
    assert tuple(logits_p.shape) == logits_r.shape
    _close(logits_p, logits_r, f"{arch_id}: forward logits")
    _close(aux_p, aux_r, f"{arch_id}: aux loss")

    cache_len = serve.serve_cache_len(cfg, S, GEN)
    last_r, cache_r = jax.jit(ref_make_prefill_step(rcfg, cache_len))(
        rparams, rb)
    last_p, cache_p = prefill(cfg, params, pb["tokens"], cache_len,
                              **_extras(pb))
    _close(last_p, last_r, f"{arch_id}: prefill logits")
    _check_cache(cache_p, cache_r, f"{arch_id}: prefill")

    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 1))
    dec_r, cache_r = jax.jit(ref_make_decode_step(rcfg))(
        rparams, cache_r, jnp.asarray(nxt, jnp.int32))
    dec_p, cache_p = decode_step(cfg, params, cache_p, torch.as_tensor(nxt))
    _close(dec_p, dec_r, f"{arch_id}: decode logits")
    _check_cache(cache_p, cache_r, f"{arch_id}: decode")


def _ref_greedy(rcfg, rparams, rb, cache_len):
    """The reference launcher's greedy loop (``repro/launch/serve.py``)."""
    prefill_r = jax.jit(ref_make_prefill_step(rcfg, cache_len))
    decode_r = jax.jit(ref_make_decode_step(rcfg))

    def pick(logits):
        return logits[:, :rcfg.vocab_size].argmax(-1)[:, None].astype(
            jnp.int32)

    logits, cache = prefill_r(rparams, rb)
    tok = pick(logits)
    toks, steps = [tok], [logits]
    for _ in range(GEN - 1):
        logits, cache = decode_r(rparams, cache, tok)
        tok = pick(logits)
        toks.append(tok)
        steps.append(logits)
    return np.concatenate([np.asarray(t) for t in toks], 1), steps


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_greedy_loop_matches_the_reference(arch_id):
    rcfg, cfg, rparams, params, batch = _world(arch_id)
    cache_len = serve.serve_cache_len(cfg, S, GEN)
    toks_r, steps_r = _ref_greedy(rcfg, rparams, _ref_batch(batch),
                                  cache_len)
    out = serve.generate(cfg, params, _port_batch(batch), GEN, cache_len)
    toks_p = out["tokens"].numpy()
    assert toks_p.shape == (B, GEN) and len(out["logits"]) == GEN
    near_ties = 0
    for i, (lp, lr) in enumerate(zip(out["logits"], steps_r)):
        # both loops have fed the same tokens up to step i
        _close(lp, lr, f"{arch_id}: greedy step {i} logits")
        if np.array_equal(toks_p[:, i], toks_r[:, i]):
            continue
        lr = np.asarray(lr)[:, :cfg.vocab_size]
        gap = float(np.abs(_np(lp)[:, :cfg.vocab_size] - lr).max())
        top2 = np.sort(lr, axis=-1)[:, -2:]
        tied = (top2[:, 1] - top2[:, 0]) <= 2 * gap
        rows = toks_p[:, i] != toks_r[:, i]
        assert tied[rows].all(), (
            f"{arch_id}: step {i} picked {toks_p[:, i]} against the "
            f"reference's {toks_r[:, i]} with no near tie (gap {gap:.3e})")
        near_ties += 1
        print(f"{arch_id}: near tie at step {i}, gap {gap:.3e}; the loops "
              f"part here")
        break
    print(f"{arch_id}: {GEN} greedy steps, near ties {near_ties}")


def test_sliding_window_ring_wraps_in_prefill_and_decode():
    """A window of 10 slots under a 24-token prompt: prefill keeps the last
    10 positions in slot pos % 10, decode writes over the oldest."""
    rcfg, cfg, rparams, params, batch = _world("llama3-8b", window=10)
    rb, pb = _ref_batch(batch), _port_batch(batch)
    last_r, cache_r = jax.jit(ref_make_prefill_step(rcfg, 10))(rparams, rb)
    last_p, cache_p = prefill(cfg, params, pb["tokens"], 10)
    _close(last_p, last_r, "windowed prefill logits")
    _check_cache(cache_p, cache_r, "windowed prefill")
    decode_r = jax.jit(ref_make_decode_step(rcfg))
    for i, t in enumerate(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (3, B, 1))):
        dec_r, cache_r = decode_r(rparams, cache_r, jnp.asarray(t, jnp.int32))
        dec_p, cache_p = decode_step(cfg, params, cache_p, torch.as_tensor(t))
        _close(dec_p, dec_r, f"windowed decode step {i}")
        _check_cache(cache_p, cache_r, f"windowed decode step {i}")


@pytest.mark.parametrize("s,w", [(5, 8), (8, 8), (13, 8), (24, 10)])
def test_ring_fill(s, w):
    k = np.random.default_rng(s).standard_normal((2, s, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _ring_fill(torch.from_numpy(k), w).numpy(),
        np.asarray(ref_ring_fill(jnp.asarray(k), w)))


def test_configs_match_the_reference_field_for_field():
    assert list(all_configs()) == ARCH_IDS
    for arch_id in ARCH_IDS:
        full = dataclasses.asdict(get_config(arch_id))
        assert full == dataclasses.asdict(ref_get_config(arch_id)), arch_id
        assert dataclasses.asdict(smoke_variant(get_config(arch_id))) == \
            dataclasses.asdict(ref_smoke_variant(ref_get_config(arch_id)))
        assert get_config(arch_id).param_count() == \
            ref_get_config(arch_id).param_count()
    assert [get_config(a).arch for a in GNN_ARCHS] == GNN_ARCHS


@pytest.mark.parametrize("arch_id", ["qwen2-0.5b", "mamba2-2.7b",
                                     "granite-moe-3b-a800m", "whisper-base",
                                     "pixtral-12b"])
def test_launcher_serves_on_the_cpu(arch_id, capsys):
    res = serve.main(["--arch", arch_id, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[prefill] 2x8 in " in out
    assert "[decode]  3 steps in " in out and "tok/s)" in out
    assert "[sample generations]" in out
    assert tuple(res["tokens"].shape) == (2, 4)
    assert int(res["tokens"].max()) < smoke_variant(
        get_config(arch_id)).vocab_size


def test_launcher_samples_deterministically_at_a_temperature():
    argv = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "6", "--gen", "5", "--temperature", "0.9"]
    a, b = serve.main(argv), serve.main(argv)
    assert torch.equal(a["tokens"], b["tokens"])
    greedy = serve.main(argv[:-2])
    assert not torch.equal(a["tokens"], greedy["tokens"])


def test_launcher_forwards_task_gnn(monkeypatch):
    from repro_torch.launch import gnn_serve

    seen = []
    monkeypatch.setattr(gnn_serve, "main", lambda argv: seen.append(argv))
    serve.main(["--task", "gnn", "--device", "cpu", "--scale", "9"])
    serve.main(["--device", "cpu", "--task=gnn"])
    assert seen == [["--device", "cpu", "--scale", "9"], ["--device", "cpu"]]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "graphsage", "--device", "cpu"])


def test_launcher_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: cuda does not raise here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke"])
