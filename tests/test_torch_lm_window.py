"""The LM entry points' ``window=`` override and ``attn_project_qkv``
against the JAX package on the CPU, at ``smoke_variant`` width (float32).

``forward``, ``prefill`` and ``decode_step`` take ``window=``, which
overrides ``cfg.sliding_window`` for one call (the reference's
``repro/models/lm/model.py::forward``, ``decode.py::prefill`` and
``decode_step``). No LM config sets a window, so the keyword is how a
caller serves a dense model with a banded window. The parameters are the
reference's ``init_params`` tree carried over by ``params_from_numpy``;
the prompt, the stub embeddings and the fed tokens come from numpy seeds.
Values agree within rtol = 1e-4, atol = 1e-5, the atol scaled by
max|ref| / 4 above 4, as ``tests/test_torch_lm_archs.py`` holds them.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models.lm import forward as ref_forward
from repro.models.lm import init_params as ref_init_params
from repro.models.lm.decode import decode_step as ref_decode_step
from repro.models.lm.decode import prefill as ref_prefill
from repro.models.lm.layers import attn_project_qkv as ref_attn_project_qkv
from repro.sharding.rules import maybe_constrain as ref_maybe_constrain
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve
from repro_torch.models.lm import (decode_step, forward, params_from_numpy,
                                   prefill)
from repro_torch.models.lm import layers
from repro_torch.models.lm.layers import attn_block, attn_project_qkv
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sharding import rules
from repro_torch.sharding.rules import batch_spec, maybe_constrain

TOL = dict(rtol=1e-4, atol=1e-5)
B, S, STEPS, WINDOW = 2, 24, 4, 10
# one id of each family with attention: dense, moe, vlm, audio, hybrid
WINDOWED = ["llama3-8b", "granite-moe-3b-a800m", "pixtral-12b",
            "whisper-base", "zamba2-7b"]


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
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(port, ref, what, rtol=TOL["rtol"], atol=TOL["atol"]):
    ref = _np(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)) / 4)
    np.testing.assert_allclose(_np(port), ref, err_msg=what, rtol=rtol,
                               atol=atol * scale)


def _world(arch_id, **upd):
    """(reference config, port config, reference params, port params,
    numpy batch, numpy decode tokens (STEPS, B, 1)) at smoke width."""
    rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config(arch_id)),
                               **upd)
    cfg = dataclasses.replace(smoke_variant(get_config(arch_id)), **upd)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["encoder_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    steps = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                              (STEPS, B, 1))
    rparams = jax.tree.map(np.asarray,
                           ref_init_params(rcfg, jax.random.key(0)))
    return rcfg, cfg, rparams, params_from_numpy(rparams), batch, steps


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


def _ref_serve(rcfg, rparams, rb, steps, cache_len, window):
    """The reference's prefill and ``len(steps)`` decode steps with
    ``window=``: ([logits], [cache after each call])."""
    pre = jax.jit(lambda p, b: ref_prefill(
        rcfg, p, b["tokens"], cache_len, window=window, **_extras(b)))
    dec = jax.jit(lambda p, c, t: ref_decode_step(rcfg, p, c, t,
                                                  window=window))
    logits, cache = pre(rparams, rb)
    out, caches = [logits], [cache]
    for t in steps:
        logits, cache = dec(rparams, cache, jnp.asarray(t, jnp.int32))
        out.append(logits)
        caches.append(cache)
    return out, caches


def _port_serve(cfg, params, pb, steps, cache_len, **kw):
    """The port's prefill and decode steps: ([logits], [a copy of the
    cache after each call]) (``decode_step`` updates it in place)."""
    logits, cache = prefill(cfg, params, pb["tokens"], cache_len,
                            **_extras(pb), **kw)
    snap = lambda c: {k: v.clone() if isinstance(v, torch.Tensor) else v
                      for k, v in c.items()}
    out, caches = [logits], [snap(cache)]
    for t in steps:
        logits, cache = decode_step(cfg, params, cache, torch.as_tensor(t),
                                    **kw)
        out.append(logits)
        caches.append(snap(cache))
    return out, caches


@pytest.mark.parametrize("arch_id", WINDOWED)
def test_window_keyword_matches_the_reference(arch_id):
    """A window of 10 under a 24-token prompt (plus the vlm's image
    tokens, which the window covers too) in the keyword, on a config
    whose ``sliding_window`` is None: the forward, the prefill's logits and
    caches and 4 decode steps against the reference's with the same
    keyword."""
    rcfg, cfg, rparams, params, batch, steps = _world(arch_id)
    assert cfg.sliding_window is None and rcfg.sliding_window is None
    rb, pb = _ref_batch(batch), _port_batch(batch)
    logits_r, aux_r = jax.jit(lambda p, b: ref_forward(
        rcfg, p, b["tokens"], window=WINDOW, **_extras(b)))(rparams, rb)
    logits_p, aux_p = forward(cfg, params, pb["tokens"], window=WINDOW,
                              **_extras(pb))
    assert tuple(logits_p.shape) == logits_r.shape
    _close(logits_p, logits_r, f"{arch_id}: windowed forward logits")
    _close(aux_p, aux_r, f"{arch_id}: windowed aux loss")

    cache_len = serve.serve_cache_len(cfg, S, STEPS)
    out_r, caches_r = _ref_serve(rcfg, rparams, rb, steps, cache_len,
                                 WINDOW)
    out_p, caches_p = _port_serve(cfg, params, pb, steps, cache_len,
                                  window=WINDOW)
    for i, (lp, lr, cp, cr) in enumerate(zip(out_p, out_r, caches_p,
                                             caches_r)):
        what = f"{arch_id}: windowed {'prefill' if i == 0 else f'step {i}'}"
        _close(lp, lr, f"{what} logits")
        _check_cache(cp, cr, what)

    # the window bites: the unwindowed forward's last logits differ
    full, _ = forward(cfg, params, pb["tokens"], **_extras(pb))
    assert not torch.allclose(full[:, -1], logits_p[:, -1], **TOL), arch_id


@pytest.mark.parametrize("arch_id", WINDOWED + ["mamba2-2.7b"])
def test_window_keyword_is_the_replaced_config(arch_id):
    """``window=10`` is bit for bit ``sliding_window=10`` in the config,
    and ``window=None`` bit for bit the config's own window, in all three
    entry points."""
    _, cfg, _, params, batch, steps = _world(arch_id)
    pb = _port_batch(batch)
    wcfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    cache_len = serve.serve_cache_len(cfg, S, STEPS)
    for base, kw, other in ((cfg, {"window": WINDOW}, wcfg),
                            (cfg, {"window": None}, cfg),
                            (wcfg, {"window": None}, wcfg)):
        a, _ = forward(base, params, pb["tokens"], **_extras(pb), **kw)
        b, _ = forward(other, params, pb["tokens"], **_extras(pb))
        assert torch.equal(a, b), (arch_id, kw)
        got, gc = _port_serve(base, params, pb, steps, cache_len, **kw)
        want, wc = _port_serve(other, params, pb, steps, cache_len)
        for i, (x, y, cx, cy) in enumerate(zip(got, want, gc, wc)):
            assert torch.equal(x, y), (arch_id, kw, i)
            assert all(torch.equal(cx[k], cy[k]) for k in cx
                       if k != "pos"), (arch_id, kw, i)


@pytest.mark.parametrize("arch_id", ["llama3-8b", "zamba2-7b"])
@pytest.mark.parametrize("window,cache_len", [(16, 10), (40, 10)])
def test_window_beyond_cache_len_matches_the_reference(arch_id, window,
                                                       cache_len):
    """A window larger than the ring: prefill attends over the window, the
    ring keeps the last ``cache_len`` positions, and decode masks only
    what the ring has already dropped (the reference's
    ``slot_pos > pos - window`` then masks nothing more)."""
    rcfg, cfg, rparams, params, batch, steps = _world(arch_id)
    rb, pb = _ref_batch(batch), _port_batch(batch)
    out_r, caches_r = _ref_serve(rcfg, rparams, rb, steps, cache_len,
                                 window)
    out_p, caches_p = _port_serve(cfg, params, pb, steps, cache_len,
                                  window=window)
    for i, (lp, lr, cp, cr) in enumerate(zip(out_p, out_r, caches_p,
                                             caches_r)):
        what = f"{arch_id}: window {window}, ring {cache_len}, call {i}"
        _close(lp, lr, f"{what} logits")
        _check_cache(cp, cr, what)


def test_ssm_is_unchanged_by_the_window():
    """mamba2-2.7b has no attention: the keyword changes no bit."""
    _, cfg, _, params, batch, steps = _world("mamba2-2.7b")
    pb = _port_batch(batch)
    a, aux_a = forward(cfg, params, pb["tokens"], window=WINDOW)
    b, aux_b = forward(cfg, params, pb["tokens"])
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    cache_len = serve.serve_cache_len(cfg, S, STEPS)
    got, gc = _port_serve(cfg, params, pb, steps, cache_len, window=WINDOW)
    want, wc = _port_serve(cfg, params, pb, steps, cache_len)
    for x, y, cx, cy in zip(got, want, gc, wc):
        assert torch.equal(x, y)
        assert all(torch.equal(cx[k], cy[k]) for k in cx if k != "pos")


@pytest.mark.parametrize("arch_id", ["llama3-8b", "zamba2-7b",
                                     "whisper-base"])
def test_remat_recomputes_with_the_window(arch_id):
    """Under ``remat`` each checkpointed block takes the window as its
    argument: the gradients of a windowed forward are the same bits with
    and without remat, and differ from the unwindowed forward's."""
    _, cfg, _, params, batch, _ = _world(arch_id)
    pb = _port_batch(batch)

    def grads(remat, window):
        c = dataclasses.replace(cfg, remat=remat)
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits, aux = forward(c, p, pb["tokens"], window=window,
                              **_extras(pb))
        loss = logits.float().square().mean() + aux
        return torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)

    windowed = grads(True, WINDOW)
    for g, h in zip(windowed, grads(False, WINDOW)):
        assert (g is None) == (h is None)
        assert g is None or torch.equal(g, h), arch_id
    assert any(g is not None and not torch.allclose(g, h, **TOL)
               for g, h in zip(windowed, grads(True, None))), arch_id


@pytest.mark.parametrize("arch_id", ["llama3-8b", "qwen2-0.5b",
                                     "qwen3-8b"])
def test_attn_project_qkv_matches_the_reference(arch_id, monkeypatch):
    """Roped q, k and v (with qwen2's QKV bias, qwen3's q/k norms) within
    rtol = atol = 1e-5, and ``attn_block``'s self-attention goes through
    it."""
    rcfg, cfg, rparams, params, _, _ = _world(arch_id)
    ap_r = jax.tree.map(lambda t: t[0], rparams["blocks"]["attn"])
    ap = tree_map(lambda t: t[0], params["blocks"]["attn"])
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    positions = np.arange(S)
    want = jax.jit(lambda p, x: ref_attn_project_qkv(
        p, x, rcfg, jnp.asarray(positions)))(ap_r, jnp.asarray(x))
    got = attn_project_qkv(ap, torch.from_numpy(x), cfg,
                           torch.as_tensor(positions))
    for name, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{arch_id}: {name}")

    calls = []

    def spy(*args):
        calls.append(1)
        return attn_project_qkv(*args)

    monkeypatch.setattr(layers, "attn_project_qkv", spy)
    attn_block(ap, torch.from_numpy(x), cfg,
               positions=torch.as_tensor(positions), window=WINDOW)
    assert calls == [1]


def test_maybe_constrain_takes_the_reference_keyword():
    """The second parameter is ``spec``, as in the reference: a caller may
    pass it by name. Without a mesh it is the identity."""
    assert (list(inspect.signature(maybe_constrain).parameters)
            == list(inspect.signature(ref_maybe_constrain).parameters))
    x = torch.arange(6.0).reshape(2, 3)
    assert maybe_constrain(x, spec=batch_spec(None)) is x
    assert rules.maybe_constrain(x, spec=rules.spec("data", None)) is x
