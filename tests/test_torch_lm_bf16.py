"""One LM architecture of each family through the port's serving path in
bfloat16, the dtype it serves in, against the JAX package's on the CPU at
``smoke_variant`` width.

The parameters are the reference's ``init_params`` tree in bfloat16,
carried over as 16-bit patterns by ``params_from_numpy``; the leaves drawn
as one constant get a seeded spread, so that a cast moved across a product
with a norm scale, a bias or ``D`` shows. ``forward``'s logits and aux
loss, ``prefill``'s last logits and every cache entry, and a
``decode_step``'s logits and cache must have the reference's dtype, and
agree within a bound in units of bfloat16's unit roundoff u = 2^-8: the
largest difference within ``BOUNDS[id][0]`` u of the tensor's max |ref|,
the mean difference within ``BOUNDS[id][1]`` u of its mean |ref|.

Two things in the reference's numerics are not the casts this test holds
the port to, and it sets them aside:

* XLA's CPU backend keeps float32 across the casts inside a fusion
  (``xla_allow_excess_precision``). The reference is compiled with that
  option off, so every bfloat16 op rounds where its jaxpr says.
* XLA expands a bfloat16 ``jax.nn.silu``, ``gelu`` or ``softplus`` into
  ops that each round to bfloat16, where torch computes the activation in
  float32 and rounds once: 40%, 44% and 16% of such outputs differ by one
  or two units. The test gives the reference the round-once form of each.

Without both, every family differs by 2-3 u on average and a moved cast
hides under that. With both, the largest differences measured, in u, as
(max, mean) over logits and caches, are: llama3-8b (dense) 1.63, 0.38;
granite-moe-3b-a800m (moe) 0.06, 0.00; pixtral-12b (vlm) 1.10, 0.59;
whisper-base (audio) 2.34, 1.98, where XLA's float32 tanh inside the GeLU
still differs from torch's; mamba2-2.7b (ssm) 0.47, 0.08; zamba2-7b
(hybrid) 1.17, 0.06. The bounds are those values times 1.5, rounded up,
and at least 0.5 u and 0.1 u. Each of these moved casts fails them: the
router's product in bfloat16 (mean 2.04 u), RMSNorm rounding before its
scale (5.89 u), SiLU as sigmoid then product in bfloat16 (1.28 u), the SSD
decode's sum with ``x * D`` in float32 (1.80 u), the SSD chunk outputs
kept in float32 (1.94 u).
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
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve
from repro_torch.models.lm import (decode_step, forward, params_from_numpy,
                                   prefill)

B, S, GEN = 2, 24, 8
U = 2.0 ** -8
# one id of each family -> (max, mean) bound in u
BOUNDS = {"llama3-8b": (2.5, 0.6), "granite-moe-3b-a800m": (0.5, 0.1),
          "pixtral-12b": (1.7, 0.9), "whisper-base": (3.6, 3.0),
          "mamba2-2.7b": (0.75, 0.15), "zamba2-7b": (1.8, 0.1)}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, what, bounds):
    ref_dtype = np.asarray(ref).dtype.name
    assert str(port.dtype) == f"torch.{ref_dtype}", (what, port.dtype,
                                                     ref_dtype)
    p = port.float().numpy()
    r = np.asarray(ref).astype(np.float32)
    assert p.shape == r.shape, what
    d = np.abs(p - r)
    max_u = float(d.max()) / max(float(np.abs(r).max()), 1e-30) / U
    mean_u = float(d.mean()) / max(float(np.abs(r).mean()), 1e-30) / U
    print(f"{what}: max {max_u:.3f} u, mean {mean_u:.3f} u")
    assert max_u <= bounds[0] and mean_u <= bounds[1], (
        f"{what}: max {max_u:.3f} u, mean {mean_u:.3f} u against "
        f"{bounds} u")


def _check_cache(port, ref, what, bounds):
    assert set(port) == set(ref), what
    assert port["pos"] == int(ref["pos"]), what
    for k in ref:
        if k != "pos":
            _close(port[k], ref[k], f"{what}: cache[{k!r}]", bounds)


def _compile(fn, *args):
    """``fn`` jitted with every bfloat16 op rounded where its jaxpr says:
    by default XLA's CPU backend keeps float32 across a fusion's casts."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _round_once(act):
    """``act`` in float32, rounded once to its input's dtype, as torch's
    ``F.silu`` / ``F.gelu`` compute."""
    return lambda x, *a, **kw: act(x.astype(jnp.float32), *a, **kw).astype(
        x.dtype)


def _spread_constants(tree):
    """Leaves drawn as one constant (norm scales, biases, ``D``, ``a_log``,
    ``dt_bias``) get a seeded spread of 0.1, so that a cast moved across a
    product with them changes the result."""
    rng = np.random.default_rng(3)

    def spread(a):
        if a.size < 2 or not np.all(a == a.flat[0]):
            return a
        return (a.astype(np.float32) + 0.1 * rng.standard_normal(
            a.shape, np.float32)).astype(a.dtype)
    return jax.tree.map(spread, tree)


@pytest.mark.parametrize("arch_id", list(BOUNDS))
def test_bf16_forward_prefill_decode_match_the_reference(arch_id,
                                                         monkeypatch):
    monkeypatch.setattr(jax.nn, "silu", _round_once(jax.nn.silu))
    monkeypatch.setattr(jax.nn, "gelu", _round_once(jax.nn.gelu))
    monkeypatch.setattr(jax.nn, "softplus", _round_once(jax.nn.softplus))
    bounds = BOUNDS[arch_id]
    rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config(arch_id)),
                               dtype="bfloat16")
    cfg = dataclasses.replace(smoke_variant(get_config(arch_id)),
                              dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["encoder_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    rparams = _spread_constants(jax.tree.map(
        np.asarray, ref_init_params(rcfg, jax.random.key(0))))
    params = params_from_numpy(rparams)
    assert params["embed"].dtype == torch.bfloat16
    rb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in batch.items()}
    pb = {k: torch.as_tensor(v) for k, v in batch.items()}
    px = {k: v for k, v in pb.items() if k != "tokens"}

    logits_r, aux_r = _compile(lambda p, b: ref_forward(
        rcfg, p, b["tokens"], **{k: v for k, v in b.items()
                                 if k != "tokens"}), rparams, rb)(rparams, rb)
    logits_p, aux_p = forward(cfg, params, pb["tokens"], **px)
    _close(logits_p, logits_r, f"{arch_id}: forward logits", bounds)
    _close(aux_p, aux_r, f"{arch_id}: aux loss", bounds)

    cache_len = serve.serve_cache_len(cfg, S, GEN)
    last_r, cache_r = _compile(ref_make_prefill_step(rcfg, cache_len),
                               rparams, rb)(rparams, rb)
    last_p, cache_p = prefill(cfg, params, pb["tokens"], cache_len, **px)
    _close(last_p, last_r, f"{arch_id}: prefill logits", bounds)
    _check_cache(cache_p, cache_r, f"{arch_id}: prefill", bounds)

    nxt = jnp.asarray(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 1)), jnp.int32)
    dec_r, cache_r = _compile(ref_make_decode_step(rcfg), rparams, cache_r,
                              nxt)(rparams, cache_r, nxt)
    dec_p, cache_p = decode_step(cfg, params, cache_p,
                                 torch.tensor(np.asarray(nxt), dtype=torch.int64))
    _close(dec_p, dec_r, f"{arch_id}: decode logits", bounds)
    _check_cache(cache_p, cache_r, f"{arch_id}: decode", bounds)
