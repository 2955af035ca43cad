"""LM training in the port (``repro_torch.models.lm.steps``,
``repro_torch.optim``, ``repro_torch.launch.train``'s LM branch) against
the JAX package's on the CPU, at ``smoke_variant`` width in float32.

The parameters are the reference's ``init_train_state`` tree carried over
by ``params_from_numpy``; the batches come from one numpy seed.

Tolerances, as for the serving path: the loss, ce and aux loss within
rtol 1e-4, atol 1e-5; every gradient leaf within 1e-4 x the leaf's max
|g| + 1e-5 of ``jax.grad``'s (XLA's and PyTorch's CPU products add in
other orders; the largest error measured was 3% of that bound). Both with
``cfg.remat`` off and on.

After three AdamW steps the parameters are held within rtol 1e-4, atol
1e-5, except where Adam's first step amplifies rounding: its update is
nearly ``lr * sign(g)``, so an element whose gradient lies at rounding
level can step the other way on one side. The rule: an element whose
reference gradient at step 1 is below 1e-3 of its leaf's RMS gradient is
not held to the tolerance; those of them outside it are counted, printed,
and capped at 1e-4 of all elements (measured: 2 of 1,313,024 for
qwen2-0.5b, 5 of 920,832 for granite-moe-3b-a800m, 3 of 1,313,024 at 4
microbatches). Every other element is held.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_emulated_cuda as emu
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models.lm import forward as ref_forward
from repro.models.lm import init_train_state as ref_init_train_state
from repro.models.lm import make_train_step as ref_make_train_step
from repro.models.lm.steps import lm_loss as ref_lm_loss
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import sgd_update as ref_sgd_update
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.launch import train as train_cli
from repro_torch.models.lm import (forward, init_train_state, lm_loss,
                                   make_train_step, params_from_numpy)
from repro_torch.models.lm import steps
from repro_torch.models.lm.steps import adamw_update_, loss_and_grads
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, sgd_update)
from repro_torch.optim.optimizers import clip_scale, tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 24
SIGN_FLIP_RMS = 1e-3        # "at rounding level": below this x leaf RMS
SIGN_FLIP_SHARE = 1e-4      # at most this share of all elements flips
U = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch_id, **upd):
    return (dataclasses.replace(ref_smoke_variant(ref_get_config(arch_id)),
                                **upd),
            dataclasses.replace(smoke_variant(get_config(arch_id)), **upd))


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "audio":
        batch["encoder_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _ref_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
            for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _port_state(ref_opt):
    return AdamWState(torch.tensor(int(ref_opt.step), dtype=torch.int32),
                      _to_port(ref_opt.mu), _to_port(ref_opt.nu))


def _clone(tree):
    return tree_map(torch.clone, tree)


def _scalars_close(port, ref, what):
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(port[k]), float(ref[k]),
                                   err_msg=f"{what}: {k}", **TOL)


def _grads_close(port, ref, what):
    """Leaf by leaf: within 1e-4 x the leaf's max |g| + 1e-5."""
    def check(p, r, path=""):
        if isinstance(r, dict):
            assert set(p) == set(r), (what, path)
            for k in r:
                check(p[k], r[k], f"{path}/{k}")
            return
        r = np.asarray(r, np.float32)
        assert tuple(p.shape) == r.shape, (what, path)
        atol = 1e-4 * float(np.abs(r).max(initial=0.0)) + 1e-5
        np.testing.assert_allclose(p.float().numpy(), r, rtol=0, atol=atol,
                                   err_msg=f"{what}: grad {path}")
    check(port, jax.tree.map(np.asarray, ref))


# ---------------------------------------------------------------------------
# the loss and its gradients, every id, remat off and on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loss_and_gradients_match_reference(arch_id, remat):
    rcfg, cfg = _configs(arch_id, remat=remat)
    rparams, _ = ref_init_train_state(rcfg, seed=0)
    batch = _batch(cfg)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm_loss(rcfg, p, b), has_aux=True))(
            rparams, _ref_batch(batch))
    (loss, met), grads = loss_and_grads(cfg, _to_port(rparams),
                                        _port_batch(batch))
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    _scalars_close(met, rmet, arch_id)
    np.testing.assert_allclose(float(met["ppl_proxy"]),
                               float(rmet["ppl_proxy"]), rtol=1e-3)
    _grads_close(grads, rgrads, f"{arch_id} remat={remat}")


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_remat_recomputes_the_same_bits(arch_id):
    """The forward draws no random numbers, so the recomputed blocks give
    the first pass's bits: loss and every gradient bitwise equal with and
    without ``cfg.remat``."""
    cfg = smoke_variant(get_config(arch_id))
    params, _ = init_train_state(cfg, seed=0, device="cpu")
    batch = _port_batch(_batch(cfg))
    (l0, _), g0 = loss_and_grads(cfg, params, batch)
    (l1, _), g1 = loss_and_grads(dataclasses.replace(cfg, remat=True),
                                 params, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                 tree_leaves(g1)))


def test_ssd_gradients_stay_finite_where_the_decay_overflows():
    """With dt of about 8 a step, one chunk of 16 steps decays by e^128:
    the reference's ``where(tri, exp(seg), 0)`` then has a NaN gradient
    (exp is inf above the diagonal, times where's zero), the port's
    masked exponent does not. The port at chunks of 16 is held to the
    reference at chunks of 8 (the same function; its decays stay under
    e^88) under the gradient rule, and the loss to both."""
    rcfg, cfg = _configs("mamba2-2.7b")
    rparams, _ = ref_init_train_state(rcfg, seed=0)
    rparams = jax.tree.map(np.asarray, rparams)
    rparams["blocks"]["mamba"]["dt_bias"] = np.full_like(
        rparams["blocks"]["mamba"]["dt_bias"], 8.0)
    batch = _batch(cfg, s=32)
    out = {}
    for chunk in (16, 8):
        c = dataclasses.replace(rcfg, ssm_chunk=chunk)
        out[chunk] = jax.value_and_grad(
            lambda p: ref_lm_loss(c, p, _ref_batch(batch)), has_aux=True)(
                rparams)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(out[16][1]))
    assert not any(np.isnan(np.asarray(g)).any()
                   for g in jax.tree.leaves(out[8][1]))
    assert cfg.ssm_chunk == 16
    (loss, _), grads = loss_and_grads(cfg, _to_port(rparams),
                                      _port_batch(batch))
    for chunk in (16, 8):
        np.testing.assert_allclose(float(loss), float(out[chunk][0][0]),
                                   **TOL)
    _grads_close(grads, out[8][1], "mamba2 dt 8, chunk 16 against 8")


def test_loss_mask_and_vlm_prefix_follow_the_reference():
    """``loss_mask[:, 1:]`` weights the positions (masked ones drop out of
    ce's numerator and denominator) and the vlm image prefix is not
    predicted."""
    for arch_id in ("llama3-8b", "pixtral-12b"):
        rcfg, cfg = _configs(arch_id)
        rparams, _ = ref_init_train_state(rcfg, seed=0)
        batch = _batch(cfg)
        batch["loss_mask"] = (np.random.default_rng(5).random((B, S))
                              < 0.6).astype(np.float32)
        rloss, rmet = ref_lm_loss(rcfg, rparams, _ref_batch(batch))
        loss, met = lm_loss(cfg, _to_port(rparams), _port_batch(batch))
        np.testing.assert_allclose(float(loss), float(rloss), **TOL)
        _scalars_close(met, rmet, arch_id)


def test_chunked_ce_pads_to_whole_chunks():
    """S - 1 = 600 predicted positions: two chunks of 512, the second
    padded with mask 0."""
    rcfg, cfg = _configs("qwen2-0.5b")
    rparams, _ = ref_init_train_state(rcfg, seed=0)
    batch = _batch(cfg, b=1, s=601)
    rloss, rmet = jax.jit(lambda p, b: ref_lm_loss(rcfg, p, b))(
        rparams, _ref_batch(batch))
    loss, met = lm_loss(cfg, _to_port(rparams), _port_batch(batch))
    np.testing.assert_allclose(float(loss), float(rloss), **TOL)
    _scalars_close(met, rmet, "qwen2-0.5b S=601")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _sign_flip_check(port, ref, g1, what):
    """``port`` against ``ref`` under the module docstring's rule; returns
    (elements excluded and outside the tolerance, all elements)."""
    flipped = total = 0

    def check(p, r, g, path=""):
        nonlocal flipped, total
        if isinstance(r, dict):
            for k in r:
                check(p[k], r[k], g[k], f"{path}/{k}")
            return
        p = p.float().numpy()
        r, g = np.asarray(r, np.float32), np.abs(np.asarray(g, np.float32))
        small = g < SIGN_FLIP_RMS * np.sqrt(np.mean(g.astype(np.float64)
                                                    ** 2))
        bad = np.abs(p - r) > TOL["atol"] + TOL["rtol"] * np.abs(r)
        assert not (bad & ~small).any(), (
            f"{what}: {path}: {int((bad & ~small).sum())} elements with a "
            f"gradient above rounding level outside the tolerance (max "
            f"diff {float(np.abs(p - r)[~small].max()):.3e})")
        flipped += int((bad & small).sum())
        total += r.size
    check(port, jax.tree.map(np.asarray, ref), jax.tree.map(np.asarray, g1))
    print(f"{what}: {flipped} of {total} elements outside the tolerance, "
          f"all with a step-1 gradient below {SIGN_FLIP_RMS} x leaf RMS")
    assert flipped <= SIGN_FLIP_SHARE * total, (what, flipped, total)
    return flipped, total


@pytest.mark.parametrize("arch_id", ["qwen2-0.5b", "granite-moe-3b-a800m"])
def test_three_train_steps_match_reference(arch_id):
    rcfg, cfg = _configs(arch_id)
    rparams, ropt = ref_init_train_state(rcfg, seed=0)
    params, opt = _to_port(rparams), _port_state(ropt)
    batches = [_batch(cfg, b=4, seed=i) for i in range(3)]
    g1 = jax.grad(lambda p: ref_lm_loss(rcfg, p, _ref_batch(batches[0]))[0])(
        rparams)
    ref_step = jax.jit(ref_make_train_step(rcfg))
    step = make_train_step(cfg)
    for i, b in enumerate(batches):
        rparams, ropt, rm = ref_step(rparams, ropt, _ref_batch(b))
        params, opt, m = step(params, opt, _port_batch(b))
        for k in ("loss", "ce", "aux", "ppl_proxy", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                       err_msg=f"step {i + 1}: {k}", **TOL)
    assert int(opt.step) == int(ropt.step) == 3
    assert opt.step.dtype == torch.int32
    _sign_flip_check(params, rparams, g1, arch_id)
    for name, mine, ref in (("mu", opt.mu, ropt.mu), ("nu", opt.nu, ropt.nu)):
        for a, r in zip(tree_leaves(mine),
                        tree_leaves(_to_port(ref))):
            assert a.dtype == torch.float32
            scale = float(r.abs().max())
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0,
                                       atol=1e-4 * scale + 1e-12,
                                       err_msg=name)


def test_microbatches_match_one_batch_and_the_reference():
    """``microbatches=4`` against 1 on each side within the reference's
    own bounds (``tests/test_substrate.py``: loss within 2e-2, parameters
    within 5e-2), and the port's 4 against the reference's 4: metrics
    within the tolerance, parameters under the sign-flip rule."""
    rcfg, cfg = _configs("qwen2-0.5b")
    rparams, ropt = ref_init_train_state(rcfg, seed=0)
    batch = _batch(cfg, b=8)
    rb, pb = _ref_batch(batch), _port_batch(batch)
    g1 = jax.grad(lambda p: ref_lm_loss(rcfg, p, rb)[0])(rparams)
    rp1, _, rm1 = jax.jit(ref_make_train_step(rcfg, microbatches=1))(
        rparams, ropt, rb)
    rp4, _, rm4 = jax.jit(ref_make_train_step(rcfg, microbatches=4))(
        rparams, ropt, rb)
    p1, _, m1 = make_train_step(cfg, microbatches=1)(
        _to_port(rparams), _port_state(ropt), pb)
    p4, o4, m4 = make_train_step(cfg, microbatches=4)(
        _to_port(rparams), _port_state(ropt), pb)
    for a, b, c, d in ((m1, m4, p1, p4), (rm1, rm4, _to_port(rp1),
                                          _to_port(rp4))):
        assert abs(float(a["loss"]) - float(b["loss"])) < 2e-2
        assert max(float((x - y).abs().max()) for x, y in
                   zip(tree_leaves(c), tree_leaves(d))) < 5e-2
    for k in ("loss", "ce", "aux", "ppl_proxy", "grad_norm"):
        np.testing.assert_allclose(float(m4[k]), float(rm4[k]),
                                   err_msg=k, **TOL)
    _sign_flip_check(p4, rp4, g1, "microbatches=4")
    assert int(o4.step) == 1


def test_train_step_takes_gradients_after_an_update():
    """The step's outputs require no gradient (the update runs under
    ``no_grad``); the next step still differentiates with respect to
    them, and two steps from the same state give the same bits."""
    cfg = smoke_variant(get_config("llama3-8b"))
    step = make_train_step(cfg)
    runs = []
    for _ in range(2):
        params, opt = init_train_state(cfg, seed=0, device="cpu")
        for i in range(2):
            params, opt, m = step(params, opt,
                                  _port_batch(_batch(cfg, seed=i)))
            assert not any(t.requires_grad for t in tree_leaves(params))
            assert float(m["grad_norm"]) > 0
        runs.append(params)
    assert all(torch.equal(a, b) for a, b in zip(*map(tree_leaves, runs)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_update_is_the_functional_update(dtype, monkeypatch):
    """``adamw_update_`` (a slice of a leaf at a time, in place) gives the
    bits of ``clip_by_global_norm`` then ``adamw_update``, a last slice
    shorter than the others included."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(6, 5, 4, generator=gen).to(dtype),
              "b": torch.randn(7, generator=gen).to(dtype)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                     .to(dtype), params)
    state = adamw_init(params)
    state = AdamWState(state.step + 2,
                       tree_map(lambda m: m + 0.1, state.mu),
                       tree_map(lambda v: v + 0.01, state.nu))
    clipped, gn = clip_by_global_norm(grads, 1.0)
    want_p, want_s = adamw_update(params, clipped, state, lr=1e-2,
                                  weight_decay=0.1)
    monkeypatch.setattr(steps, "UPDATE_SLICE", 48)   # "w" in 3 slices
    got_s = adamw_update_(params, tree_leaves(grads), AdamWState(
        state.step.clone(), _clone(state.mu), _clone(state.nu)),
        clip_scale(gn, 1.0), lr=1e-2, weight_decay=0.1)
    for a, b in zip(tree_leaves((params, got_s.mu, got_s.nu)),
                    tree_leaves((want_p, want_s.mu, want_s.nu))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got_s.step) == int(want_s.step) == 3


def _count_full_stacks(fn, shape):
    """How many tensors of ``shape`` the operators run inside ``fn``
    return."""
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and tuple(t.shape) == shape:
                    Count.n += 1
            return out

    with Count():
        fn()
    return Count.n


def test_backward_builds_each_stacked_gradient_once():
    """The forward takes its layers with one ``unbind`` a stacked leaf, so
    the backward builds each stacked gradient once; indexing one layer at
    a time (``layer(blocks, i)``) would build one whole-stack tensor for
    each of the 8 layers."""
    cfg = dataclasses.replace(smoke_variant(get_config("llama3-8b")),
                              num_layers=8)
    params, _ = init_train_state(cfg, seed=0, device="cpu")
    batch = _port_batch(_batch(cfg))
    shape = tuple(params["blocks"]["mlp"]["w_gateup"].shape)
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = lm_loss(cfg, alias, batch)
    leaf = alias["blocks"]["mlp"]["w_gateup"]
    n = _count_full_stacks(lambda: torch.autograd.grad(loss, [leaf]), shape)
    assert 1 <= n <= 2, n


def test_card_path_gradients_match_plain_path(monkeypatch):
    """The token embedding's and the MoE dispatch's gathers take
    ``gather_edges`` on the card, whose backward is K2 over the ids in a
    fixed order (a CPU stand-in here): the same loss and gradients as the
    plain path, K2 launching once for the embedding and once a MoE
    layer."""
    cfg = dataclasses.replace(smoke_variant(get_config(
        "granite-moe-3b-a800m")), remat=True)
    params, _ = init_train_state(cfg, seed=0, device="cpu")
    batch = _port_batch(_batch(cfg))
    (want, _), gw = loss_and_grads(cfg, params, batch)
    fns = emu.emulate_cuda(monkeypatch)
    (got, _), gg = loss_and_grads(cfg, params, batch)
    assert fns["segment_sum"].launches == 1 + cfg.num_layers
    assert {k for k, f in fns.items() if f.launches} == {"segment_sum"}
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for a, b in zip(tree_leaves(gg), tree_leaves(gw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def test_clip_by_global_norm_keeps_the_reference_float32_result():
    """A bfloat16 tree clips to float32 leaves, as in the reference
    (a bfloat16 gradient times its float32 scale is promoted by JAX); the
    norm sums the leaves in the reference's (sorted) key order."""
    rng = np.random.default_rng(0)
    tree = {"z": rng.standard_normal((5, 3)) * 4, "a": {
        "y": rng.standard_normal(7), "b": rng.standard_normal((2, 2)) * 9}}
    ref_tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    port_tree = params_from_numpy(jax.tree.map(np.asarray, ref_tree))
    assert port_tree["z"].dtype == torch.bfloat16
    for max_norm in (1.0, 1e3):
        rc, rgn = ref_clip(ref_tree, max_norm)
        pc, pgn = clip_by_global_norm(port_tree, max_norm)
        np.testing.assert_allclose(float(pgn), float(rgn), rtol=1e-6)
        for p, r in zip(tree_leaves(pc), tree_leaves(_to_port(rc))):
            assert r.dtype == p.dtype == torch.float32
            np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=1e-6)


def test_sgd_update_with_momentum_matches_reference():
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    rp, rb = p, jax.tree.map(np.zeros_like, p)
    pp = params_from_numpy(p)
    pb = tree_map(torch.zeros_like, pp)
    for i in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), p)
        rp, rb = ref_sgd_update(rp, g, lr=0.1, momentum_state=rb,
                                momentum=0.9)
        pp, pb = sgd_update(pp, params_from_numpy(g), lr=0.1,
                            momentum_state=pb, momentum=0.9)
        for mine, ref in ((pp, rp), (pb, rb)):
            for k in p:
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(ref[k]), rtol=1e-6,
                                           atol=1e-7)
    # without momentum the state passes through untouched
    np.testing.assert_allclose(
        sgd_update(pp, pp, lr=0.5)[0]["w"].numpy(),
        np.asarray(ref_sgd_update(jax.tree.map(np.asarray, rp), rp,
                                  lr=0.5)[0]["w"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# bfloat16 at model level
# ---------------------------------------------------------------------------

# (loss, ce and aux; the final hidden state's max; its mean) in u. Measured
# (loss and ce; hidden max, mean): llama3-8b 0.002; 0.962, 0.041,
# granite-moe-3b-a800m 0.000; 0.914, 0.010, pixtral-12b 0.012; 0.970, 0.066,
# whisper-base 0.003; 1.969, 1.428, mamba2-2.7b 0.000; 0.000, 0.000,
# zamba2-7b 0.000; 1.058, 0.023. The bounds are 1.5 x those, rounded up,
# and at least 0.05, 0.5 and 0.1 u.
BF16_BOUNDS = {"llama3-8b": (0.05, 1.5, 0.1),
               "granite-moe-3b-a800m": (0.05, 1.4, 0.1),
               "pixtral-12b": (0.05, 1.5, 0.1),
               "whisper-base": (0.05, 3.0, 2.2),
               "mamba2-2.7b": (0.05, 0.5, 0.1),
               "zamba2-7b": (0.05, 1.6, 0.1)}


def _round_once(act):
    return lambda x, *a, **kw: act(x.astype(jnp.float32), *a, **kw).astype(
        x.dtype)


@pytest.mark.parametrize("arch_id", list(BF16_BOUNDS))
def test_bf16_loss_matches_reference(arch_id, monkeypatch):
    """``lm_loss`` in bfloat16 against the reference compiled as
    ``tests/test_torch_lm_bf16.py`` compiles it (excess precision off,
    round-once SiLU, GeLU and softplus): ce and aux differ from the
    reference's by at most ``BF16_BOUNDS[id][0]`` u of the largest
    logit, u = 2^-8, and the final hidden state by the bounds' (max,
    mean) u of its max and mean |ref|."""
    monkeypatch.setattr(jax.nn, "silu", _round_once(jax.nn.silu))
    monkeypatch.setattr(jax.nn, "gelu", _round_once(jax.nn.gelu))
    monkeypatch.setattr(jax.nn, "softplus", _round_once(jax.nn.softplus))
    rcfg, cfg = _configs(arch_id, dtype="bfloat16")
    rparams, _ = ref_init_train_state(rcfg, seed=0)
    batch = _batch(cfg)
    rb, pb = _ref_batch(batch), _port_batch(batch)
    params = _to_port(rparams)
    assert params["embed"].dtype == torch.bfloat16

    def compiled(fn):
        return jax.jit(fn).lower(rparams, rb).compile(
            compiler_options={"xla_allow_excess_precision": False})
    extras = {k: v for k, v in rb.items() if k != "tokens"}
    pextras = {k: v for k, v in pb.items() if k != "tokens"}
    (rhid, _), (rlogits, _), (rloss, rmet) = compiled(lambda p, b: (
        ref_forward(rcfg, p, b["tokens"], return_hidden=True, **extras),
        ref_forward(rcfg, p, b["tokens"], **extras),
        ref_lm_loss(rcfg, p, b)))(rparams, rb)
    hid, _ = forward(cfg, params, pb["tokens"], return_hidden=True,
                     **pextras)
    loss, met = lm_loss(cfg, params, pb)
    assert hid.dtype == torch.bfloat16 and loss.dtype == torch.float32
    top = float(np.abs(np.asarray(rlogits, np.float32)).max())
    bounds = BF16_BOUNDS[arch_id]
    for name, p, r in (("loss", loss, rloss), ("ce", met["ce"], rmet["ce"]),
                       ("aux", met["aux"], rmet["aux"])):
        du = abs(float(p) - float(r)) / top / U
        print(f"{arch_id}: {name} {float(p):.6f} vs {float(r):.6f}: "
              f"{du:.3f} u of max |logit| {top:.2f}")
        assert du <= bounds[0], (name, du)
    r = np.asarray(rhid, np.float32)
    d = np.abs(hid.float().numpy() - r)
    max_u = float(d.max()) / float(np.abs(r).max()) / U
    mean_u = float(d.mean()) / float(np.abs(r).mean()) / U
    print(f"{arch_id}: hidden max {max_u:.3f} u, mean {mean_u:.3f} u")
    assert max_u <= bounds[1] and mean_u <= bounds[2], (max_u, mean_u)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_cli_trains_every_lm_id_on_cpu(arch_id, capsys):
    out = train_cli.main(["--arch", arch_id, "--smoke", "--steps", "4",
                          "--batch-size", "2", "--seq-len", "32",
                          "--device", "cpu"])
    text = capsys.readouterr().out
    assert [line.split("]")[0] for line in text.splitlines()
            if line.startswith("[step")] == [f"[step {i}" for i in
                                              range(1, 5)]
    assert "[done] 4 steps, " in text and text.rstrip().endswith("tok/s")
    assert len(out["loss"]) == len(out["ce"]) == len(out["grad_norm"]) == 4
    assert all(np.isfinite(out["loss"])) and out["tok_s"] > 0
    assert out["peak_gib"] is None and "params" not in out


def test_train_cli_lm_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_cli.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])
