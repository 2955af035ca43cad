"""The port's LM building blocks (``repro_torch.models.lm``: layers, ssm,
moe) against the JAX package's (``repro.models.lm``) on the CPU.

Inputs are made once from a numpy seed and go through both; float32
results agree within rtol = atol = 1e-5 (XLA's and PyTorch's CPU products
accumulate in different orders). In bfloat16 the casts that the port
mirrors (RMSNorm and RoPE in float32 with one cast; scores divided by
sqrt(d) rounded to bfloat16, in bfloat16; float32 softmax, probabilities
cast back) give the reference's bits exactly; a bfloat16 product over d
may round its float32 sum to the other neighbour than XLA's does: within
two units of bfloat16's epsilon (2^-7) of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import layers as R
from repro.models.lm import moe as RM
from repro.models.lm import ssm as RS
from repro.models.lm.config import LMConfig as RefLMConfig
from repro_torch.models.lm import layers as P
from repro_torch.models.lm import moe as PM
from repro_torch.models.lm import ssm as PS
from repro_torch.models.lm import LMConfig, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 * 2 ** -7, atol=2 * 2 ** -7)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module: its tensors are small, so more
    threads buy nothing alone, and with the suite spread over several
    worker processes they contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(a, dtype=np.float32):
    """One numpy array as (jax array, torch tensor) with the same bytes;
    ``dtype`` "bfloat16" rounds once, in JAX, and carries the bits."""
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        bits = np.asarray(j).view(np.uint16).copy()
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(_np(port), _np(ref), **(tol or TOL))


def _same_bits(port, ref) -> bool:
    return np.array_equal(port.view(torch.int16).numpy(),
                          np.asarray(ref).view(np.int16))


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def test_rmsnorm():
    rng = _rng()
    xj, xt = _pair(rng.standard_normal((3, 7, 64)) * 3)
    sj, st = _pair(1 + 0.1 * rng.standard_normal(64))
    for eps in (1e-6, 1e-5):
        _close(P.rmsnorm(xt, st, eps), R.rmsnorm(xj, sj, eps))


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
def test_rope(theta):
    rng = _rng(1)
    xj, xt = _pair(rng.standard_normal((2, 9, 3, 32)))
    pos = np.arange(9) + 17
    _close(P.rope(xt, torch.as_tensor(pos), theta),
           R.rope(xj, jnp.asarray(pos), theta))
    # one decode position, as decode_step passes it
    _close(P.rope(xt[:, :1], torch.full((1,), 40), theta),
           R.rope(xj[:, :1], jnp.full((1,), 40), theta))


def test_bf16_casts_match_the_reference_bit_for_bit():
    """RMSNorm and RoPE normalise and rotate in float32 and cast once; the
    scores divide by sqrt(d) rounded to bfloat16 (11.3125 for d = 128,
    not 11.3137), in bfloat16, before the float32 cast; the decode
    softmax's probabilities return to bfloat16 before the value product.
    Each is the reference's bits. Products over d (attention, MLPs)
    round their float32 sums as each library does: within 2 x 2^-7."""
    rng = _rng(2)
    bf = "bfloat16"
    xj, xt = _pair(rng.standard_normal((4, 16, 256)), bf)
    sj, st = _pair(1 + 0.1 * rng.standard_normal(256), bf)
    out = P.rmsnorm(xt, st)
    assert out.dtype == torch.bfloat16
    assert _same_bits(out, R.rmsnorm(xj, sj))
    qj, qt = _pair(rng.standard_normal((2, 24, 8, 128)), bf)
    kj, kt = _pair(rng.standard_normal((2, 24, 2, 128)), bf)
    vj, vt = _pair(rng.standard_normal((2, 24, 2, 128)), bf)
    pos = np.arange(24)
    assert _same_bits(P.rope(qt, torch.as_tensor(pos), 5e5),
                      R.rope(qj, jnp.asarray(pos), 5e5))
    assert _same_bits(P._gqa_scores(qt[:, :1], kt),
                      R._gqa_scores(qj[:, :1], kj))
    got = P.decode_attention(qt[:, :1], kt, vt, 30)
    assert got.dtype == torch.bfloat16
    assert _same_bits(got, R.decode_attention(qj[:, :1], kj, vj,
                                              jnp.asarray(30)))
    _close(P.attention(qt, kt, vt, chunk=8, window=5),
           R.attention(qj, kj, vj, chunk=8, window=5), **BF16_TOL)
    wj, wt = _pair(rng.standard_normal((256, 2, 512)) / 16, bf)
    dj, dt = _pair(rng.standard_normal((512, 256)) / 22, bf)
    _close(P.mlp_block({"w_gateup": wt, "w_down": dt}, xt),
           R.mlp_block({"w_gateup": wj, "w_down": dj}, xj), **BF16_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("chunk", [3, 8, 64])
def test_attention(chunk, g):
    """Causal, sliding-window, non-causal and offset queries, with head h
    reading KV head h // g."""
    rng = _rng(10 * chunk + g)
    kv = 2
    qj, qt = _pair(rng.standard_normal((2, 17, kv * g, 8)))
    kj, kt = _pair(rng.standard_normal((2, 17, kv, 8)))
    vj, vt = _pair(rng.standard_normal((2, 17, kv, 8)))
    for kw in (dict(causal=True), dict(causal=True, window=4),
               dict(causal=False), dict(causal=False, window=6),
               dict(causal=True, q_offset=5)):
        _close(P.attention(qt, kt, vt, chunk=chunk, **kw),
               R.attention(qj, kj, vj, chunk=chunk, **kw))
    # the GQA mapping: KV head 1 only reaches heads g..2g-1
    vt2 = vt.clone()
    vt2[:, :, 1] += 5.0
    diff = (P.attention(qt, kt, vt2, chunk=chunk)
            - P.attention(qt, kt, vt, chunk=chunk)).abs().amax(dim=(0, 1, 3))
    assert diff[:g].max() == 0 and bool((diff[g:] > 1.0).all())


def _ring(steps, w, kv, d, rng, window=None):
    """Write ``steps`` tokens into rings of W slots with ``cache_update`` on
    both sides and hold each step's ``decode_attention``."""
    b, h = 2, kv * 2
    kc_j = jnp.zeros((b, w, kv, d))
    vc_j = jnp.zeros((b, w, kv, d))
    kc_t = torch.zeros((b, w, kv, d))
    vc_t = torch.zeros((b, w, kv, d))
    for pos in range(steps):
        qj, qt = _pair(rng.standard_normal((b, 1, h, d)))
        kj, kt = _pair(rng.standard_normal((b, 1, kv, d)))
        vj, vt = _pair(rng.standard_normal((b, 1, kv, d)))
        kc_j, vc_j = R.cache_update(kc_j, vc_j, kj, vj, jnp.asarray(pos))
        kc_t, vc_t = P.cache_update(kc_t, vc_t, kt, vt, pos)
        np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
        np.testing.assert_array_equal(vc_t.numpy(), np.asarray(vc_j))
        _close(P.decode_attention(qt, kc_t, vc_t, pos, window=window),
               R.decode_attention(qj, kc_j, vc_j, jnp.asarray(pos),
                                  window=window))


@pytest.mark.parametrize("w,steps,window", [
    (4, 3, None), (4, 9, None), (7, 7, None), (7, 15, None),
    (10, 23, None), (10, 23, 6), (5, 12, 3),
], ids=lambda v: str(v))
def test_decode_attention_over_a_ring_cache(w, steps, window):
    """Ring slots written at pos % W, wrapping past W; slots whose implied
    position is negative or outside the window are masked."""
    _ring(steps, w, kv=2, d=8, rng=_rng(w * 100 + steps), window=window)


def test_cache_update_writes_one_slot():
    rng = _rng(3)
    kc_j, kc_t = _pair(rng.standard_normal((2, 5, 2, 4)))
    vc_j, vc_t = _pair(rng.standard_normal((2, 5, 2, 4)))
    kn_j, kn_t = _pair(rng.standard_normal((2, 1, 2, 4)))
    vn_j, vn_t = _pair(rng.standard_normal((2, 1, 2, 4)))
    for pos in (0, 4, 5, 13):
        rk, rv = R.cache_update(kc_j, vc_j, kn_j, vn_j, jnp.asarray(pos))
        pk, pv = P.cache_update(kc_t.clone(), vc_t.clone(), kn_t, vn_t, pos)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def test_mlp_block_swiglu_and_gelu():
    rng = _rng(4)
    xj, xt = _pair(rng.standard_normal((2, 5, 32)))
    sw = {"w_gateup": rng.standard_normal((32, 2, 48)) / 6,
          "w_down": rng.standard_normal((48, 32)) / 7}
    ge = {"w_up": rng.standard_normal((32, 48)) / 6,
          "b_up": rng.standard_normal(48) * 0.1,
          "w_down": rng.standard_normal((48, 32)) / 7,
          "b_down": rng.standard_normal(32) * 0.1}
    for kind, p in (("swiglu", sw), ("gelu", ge)):
        pj = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
        pt = params_from_numpy({k: v.astype(np.float32)
                                for k, v in p.items()})
        _close(P.mlp_block(pt, xt, kind), R.mlp_block(pj, xj, kind))
    # Whisper's GeLU is JAX's default, the tanh approximation
    zj, zt = _pair(np.linspace(-6, 6, 97))
    _close(torch.nn.functional.gelu(zt, approximate="tanh"), jax.nn.gelu(zj))
    assert float((torch.nn.functional.gelu(zt) - zt.new_tensor(
        np.asarray(jax.nn.gelu(zj)))).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

def test_softplus_is_jax_above_torchs_threshold():
    """``F.softplus`` returns x itself above 20; the port takes
    ``logaddexp(x, 0)`` as ``jax.nn.softplus`` does, at every x."""
    zj, zt = _pair(np.concatenate([np.linspace(-40, 40, 801),
                                   [19.9, 20.0, 20.1, 25.0, 88.0]]))
    _close(PS.softplus(zt), jax.nn.softplus(zj), rtol=1e-6, atol=1e-7)


def test_depthwise_causal_conv():
    rng = _rng(5)
    xj, xt = _pair(rng.standard_normal((2, 11, 6)))
    wj, wt = _pair(rng.standard_normal((4, 6)) / 2)
    bj, bt = _pair(rng.standard_normal(6) * 0.1)
    _close(PS._depthwise_causal_conv(xt, wt, bt),
           RS._depthwise_causal_conv(xj, wj, bj))


def _ssd_inputs(rng, l, b=2, h=3, p=4, n=5):
    x = rng.standard_normal((b, l, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) * 0.5))
    a_log = rng.standard_normal(h) * 0.3
    B = rng.standard_normal((b, l, n))
    C = rng.standard_normal((b, l, n))
    D = rng.standard_normal(h)
    return [_pair(a) for a in (x, dt, a_log, B, C, D)]


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("l", [5, 16, 23])
def test_ssd_chunked(chunk, l):
    """Chunk scans of lengths that are (16) and are not (5, 23) whole
    chunks: padded steps have dt = 0, so the final state is the
    reference's. With and without a carried ``init_state``."""
    rng = _rng(chunk * 31 + l)
    ins = _ssd_inputs(rng, l)
    ref_in = [a for a, _ in ins]
    port_in = [t for _, t in ins]
    s0j, s0t = _pair(rng.standard_normal((2, 3, 4, 5)))
    for init in (None, (s0j, s0t)):
        yr, sr = RS.ssd_chunked(*ref_in, chunk,
                                init_state=None if init is None else init[0])
        yp, sp = PS.ssd_chunked(*port_in, chunk,
                                init_state=None if init is None else init[1])
        assert sp.dtype == torch.float32
        _close(yp, yr)
        _close(sp, sr)


def test_ssd_decode_step_continues_the_scan():
    rng = _rng(6)
    (xj, xt), (dj, dt), (aj, at), (bj, bt), (cj, ct), (Dj, Dt) = \
        _ssd_inputs(rng, 9)
    _, sr = RS.ssd_chunked(xj[:, :8], dj[:, :8], aj, bj[:, :8], cj[:, :8],
                           Dj, 4)
    _, sp = PS.ssd_chunked(xt[:, :8], dt[:, :8], at, bt[:, :8], ct[:, :8],
                           Dt, 4)
    yr, sr2 = RS.ssd_decode_step(sr, xj[:, 8], dj[:, 8], aj, bj[:, 8],
                                 cj[:, 8], Dj)
    yp, sp2 = PS.ssd_decode_step(sp, xt[:, 8], dt[:, 8], at, bt[:, 8],
                                 ct[:, 8], Dt)
    _close(yp, yr)
    _close(sp2, sr2)
    # and equals the scan over all 9 steps
    yfull, sfull = PS.ssd_chunked(xt, dt, at, bt, ct, Dt, 4)
    _close(yp, yfull[:, 8])
    _close(sp2, sfull)


def _mamba_cfg(**kw):
    base = dict(name="m", arch_type="ssm", num_layers=1, d_model=32,
                num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=64,
                ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
                ssm_chunk=4, dtype="float32")
    base.update(kw)
    return RefLMConfig(**base), LMConfig(**base)


def _mamba_params(rng, d=32, di=64, n=8, h=4, k=4):
    p = {"in_proj": rng.standard_normal((d, 2 * di)) / np.sqrt(d),
         "bc_proj": rng.standard_normal((d, 2 * n + h)) / np.sqrt(d),
         "conv_w": rng.standard_normal((k, di)) / 2,
         "conv_b": rng.standard_normal(di) * 0.1,
         "conv_bc_w": rng.standard_normal((k, 2 * n)) / 2,
         "conv_bc_b": rng.standard_normal(2 * n) * 0.1,
         "dt_bias": rng.standard_normal(h) * 0.5,
         "a_log": rng.standard_normal(h) * 0.3,
         "D": rng.standard_normal(h),
         "out_proj": rng.standard_normal((di, d)) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, params_from_numpy(p)


def test_mamba2_block_prefill_and_decode():
    """Prefill over 7 steps (not a whole chunk of 4), then 3 decode steps
    from its states; each output and state the reference's."""
    rcfg, cfg = _mamba_cfg()
    rng = _rng(7)
    pj, pt = _mamba_params(rng)
    xj, xt = _pair(rng.standard_normal((2, 10, 32)))
    out_r, S_r, conv_r = RS.mamba2_block(pj, xj[:, :7], rcfg)
    out_p, S_p, conv_p = PS.mamba2_block(pt, xt[:, :7], cfg)
    _close(out_p, out_r)
    _close(S_p, S_r)
    _close(conv_p, conv_r)
    for i in range(7, 10):
        out_r, S_r, conv_r = RS.mamba2_block(pj, xj[:, i:i + 1], rcfg, S_r,
                                             conv_r, decode=True)
        out_p, S_p, conv_p = PS.mamba2_block(pt, xt[:, i:i + 1], cfg, S_p,
                                             conv_p, decode=True)
        _close(out_p, out_r)
        _close(S_p, S_r)
        _close(conv_p, conv_r)
    # 10 decode-path outputs continue the 10-step prefill
    full, _, _ = PS.mamba2_block(pt, xt, cfg)
    _close(out_p, full[:, -1:], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(rng, e=6, k=2, d=16, f=12, t=(2, 7)):
    router = rng.standard_normal((d, e)).astype(np.float32)
    router[:, 3] = -50.0          # expert 3 never wins: an empty group
    router[:, 5] = router[:, 4]   # experts 4 and 5 tie on every token
    p = {"router": router,
         "experts_gate": rng.standard_normal((e, d, f)) / 4,
         "experts_up": rng.standard_normal((e, d, f)) / 4,
         "experts_down": rng.standard_normal((e, f, d)) / 3.5}
    p = {k_: v.astype(np.float32) for k_, v in p.items()}
    x = np.abs(rng.standard_normal(t + (d,))).astype(np.float32)
    return p, x


def test_moe_local_routing_ties_and_empty_experts():
    rcfg = RefLMConfig(name="m", arch_type="moe", num_layers=1, d_model=16,
                       num_heads=2, num_kv_heads=1, d_ff=12, vocab_size=64,
                       num_experts=6, experts_per_tok=2, moe_d_ff=12,
                       dtype="float32")
    cfg = LMConfig(**{f: getattr(rcfg, f) for f in (
        "name", "arch_type", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "num_experts",
        "experts_per_tok", "moe_d_ff", "dtype")})
    p, x = _moe_case(_rng(8))
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = params_from_numpy(p)
    xj, xt = _pair(x)
    _, ti_r, _ = RM._route(xj.reshape(-1, 16), pj["router"], 2)
    _, ti_p, _ = PM._route(xt.reshape(-1, 16), pt["router"], 2)
    np.testing.assert_array_equal(ti_p.numpy(), np.asarray(ti_r))
    assert not (ti_p == 3).any(), "expert 3 was meant to receive no token"
    # the 4/5 tie goes to the lower index: 5 is taken only second, after 4
    assert bool((ti_p == 4).any())
    with5 = (ti_p == 5).any(-1)
    assert bool((ti_p[with5] == torch.tensor([4, 5])).all())
    out_r, aux_r = RM._moe_local(pj, xj, rcfg)
    out_p, aux_p = PM._moe_local(pt, xt, cfg)
    _close(out_p, out_r)
    _close(aux_p, aux_r)
    out_b, aux_b = PM.moe_block(pt, xt, cfg)
    assert torch.equal(out_b, out_p) and torch.equal(aux_b, aux_p)


def test_params_from_numpy_carries_bfloat16_bits():
    a = np.asarray(jnp.asarray(_rng(9).standard_normal((3, 4)),
                               jnp.bfloat16))
    t = params_from_numpy({"w": a})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


@pytest.mark.parametrize("name", ["silu", "gelu", "softplus"])
def test_bf16_activations_within_one_unit(name):
    """In bfloat16 XLA's CPU backend expands ``jax.nn.silu`` / ``gelu`` /
    ``softplus`` into ops that each round to bfloat16; the port's
    ``F.silu``, ``F.gelu(approximate="tanh")`` and ``softplus`` compute in
    float32 and round once. Every output lies within two units of the
    reference's (the roundings compound in silu at negative inputs), plus
    2^-8 |x| for the GeLU, whose bfloat16 ``1 + tanh`` cancels to 0 below
    x = -3 in the reference. silu and softplus are the reference's
    activation evaluated in float32 and rounded once, bit for bit. The
    bfloat16 model test (``tests/test_torch_lm_bf16.py``) relies on
    both."""
    port = {"silu": torch.nn.functional.silu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh"),
            "softplus": PS.softplus}[name]
    ref = getattr(jax.nn, name)
    zj, zt = _pair(3 * _rng(11).standard_normal(4096), "bfloat16")
    got = _np(port(zt))
    want = np.asarray(ref(zj).astype(jnp.float32))
    unit = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2 ** -126)))
                   - 7)
    slack = 2 ** -8 * np.abs(_np(zt)) if name == "gelu" else 0.0
    assert np.all(np.abs(got - want) <= 2 * unit + slack), name
    once = np.asarray(ref(zj.astype(jnp.float32)).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    if name != "gelu":          # XLA's float32 tanh is not torch's
        np.testing.assert_array_equal(got, once)
    assert np.mean(got != want) > 0.1, "the expansions differ here"
