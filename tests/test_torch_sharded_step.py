"""The port's sharded LM train step and MoE dispatches on a (2, 4) gloo
world of 8 CPU processes, against the JAX package.

Each multi-rank run is a subprocess of its own (``_torch_mesh_worker.py``,
one intra-op thread a rank, a ``FileStore`` in ``tmp_path``, 300 s).

* The train step: ``smoke_variant(qwen3-8b)`` at 2 layers in float32, the
  reference's ``init_train_state`` parameters carried over, one step at
  lr 1e-3, under the ``tp`` rules (batch 4 x 64 over "data") and the
  pure-FSDP rules (batch 8 x 64 over both axes: 4 rows do not divide over
  8 ranks). Held to the reference's SINGLE-DEVICE step (its sharded
  lowering does not run with this JAX: ``jax.make_mesh`` gives Explicit
  axes, which its ``with_sharding_constraint`` refuses): the loss within
  rtol 1e-4, atol 1e-5, and every updated parameter within the same,
  except where Adam's first step amplifies rounding. Its update is
  ``lr * g / (|g| + eps)``, so an element whose gradient lies at rounding
  level moves by up to ``lr`` when the gradient's last bits change (the
  sharded step sums its products in other orders). The rule of
  ``test_torch_lm_train.py``: an element whose reference gradient is
  below 1e-3 of its leaf's RMS gradient is not held to the tolerance;
  those of them outside it are counted, printed, and capped at 1e-4 of
  all elements (measured: 9 of 1,443,328 under tp, 8 under FSDP). Every
  other element is held. Since that first step carries only the
  gradient's sign, the gradients themselves are held too: every leaf of
  the port's ``loss_and_grads`` on the mesh against ``jax.grad`` of the
  reference's ``lm_loss``, and the step's gradient norm against the
  reference step's, within rtol 1e-4, atol 1e-5.
* ``moe_block``: 8 and 6 experts (6 pads to 8 over the model axis of 4),
  the allgather and the all-to-all dispatch, at the reference test's
  capacity factors and at 0.5, where assignments drop. Held to the
  reference's ``moe_block`` under its own (2, 4) ``shard_map`` mesh (an
  8-device JAX subprocess) within 1e-5, the aux loss too, and the
  gradients of (out^2).sum() + aux with respect to x and each weight
  against ``jax.grad`` through that ``shard_map`` within rtol 1e-5,
  atol 1e-5 (scaled by max|ref| / 4 above 4, as below).
* Serving: ``prefill`` of one 32-token prompt and 3 ``decode_step``s on
  the (2, 4) world under the tp rules, for qwen3-8b (4 heads, 2 KV
  heads: head_dim over "model"; a 48-slot ring over "data", and a
  16-slot sliding-window ring that the prompt wraps), mamba2-2.7b (SSD
  heads over "model"), zamba2-7b (both) and granite-moe-3b-a800m (the
  allgather dispatch), all at ``smoke_variant`` width. Held to the
  reference's single-device ``prefill`` and ``decode_step``: every
  step's logits and the last cache within rtol 1e-4, atol 1e-5 scaled
  by max|ref| / 4 above 4 (``test_torch_lm_archs.py``'s rule: tied
  logits reach 70).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models.lm import init_params as ref_init_params
from repro.models.lm import init_train_state as ref_init_train_state
from repro.models.lm import make_decode_step as ref_make_decode_step
from repro.models.lm import make_prefill_step as ref_make_prefill_step
from repro.models.lm import make_train_step as ref_make_train_step
from repro.models.lm.steps import lm_loss as ref_lm_loss

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TOL = dict(rtol=1e-4, atol=1e-5)
SIGN_FLIP_RMS = 1e-3        # "at rounding level": below this x leaf RMS
SIGN_FLIP_SHARE = 1e-4      # at most this share of all elements
LR = 1e-3


def _flatten(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _close(port, ref, what, rtol=TOL["rtol"], atol=TOL["atol"]):
    """Within rtol and atol, the atol scaled by max|ref| / 4 above 4."""
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)) / 4)
    np.testing.assert_allclose(np.asarray(port, np.float32), ref,
                               rtol=rtol, atol=atol * scale, err_msg=what)


def _worker(case: str, d):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, os.path.join(
        HERE, "_torch_mesh_worker.py"), case, str(d), "8"], env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(os.path.join(d, "out.npz")))


@pytest.mark.parametrize("rules,batch", [("tp", 4), ("fsdp", 8)])
def test_sharded_train_step_matches_single_device_reference(tmp_path, rules,
                                                           batch):
    cfg = dataclasses.replace(ref_smoke_variant(ref_get_config("qwen3-8b")),
                              num_layers=2)
    params, opt = ref_init_train_state(cfg, seed=0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch, 64)).astype(np.int32)
    rbatch = {"tokens": jnp.asarray(tokens)}
    p1, _, m1 = jax.jit(ref_make_train_step(cfg, lr=LR))(params, opt,
                                                          rbatch)
    grads = jax.grad(lambda p: ref_lm_loss(cfg, p, rbatch)[0])(params)
    np.savez(tmp_path / "in.npz", tokens=tokens,
             **{f"p/{k}": v for k, v in _flatten(
                 jax.tree.map(np.asarray, params)).items()})
    (tmp_path / "in.json").write_text(json.dumps(
        {"arch": "qwen3-8b", "rules": rules, "cfg": {"num_layers": 2},
         "lr": LR}))
    out = _worker("sharded_step", tmp_path)

    np.testing.assert_allclose(float(out["loss"]), float(m1["loss"]), **TOL)
    np.testing.assert_allclose(float(out["grad_norm"]),
                               float(m1["grad_norm"]), **TOL)
    ref, g = _flatten(jax.tree.map(np.asarray, p1)), _flatten(
        jax.tree.map(np.asarray, grads))
    assert set(ref) == {k[2:] for k in out if k.startswith("p/")}
    assert set(g) == {k[2:] for k in out if k.startswith("g/")}
    for k, r in g.items():
        np.testing.assert_allclose(out[f"g/{k}"], r, err_msg=f"grad {k}",
                                   **TOL)
    flipped = total = 0
    for k, r in ref.items():
        p = out[f"p/{k}"]
        assert p.shape == r.shape, k
        outside = np.abs(p - r) > TOL["atol"] + TOL["rtol"] * np.abs(r)
        rms = float(np.sqrt(np.mean(np.square(g[k], dtype=np.float64))))
        rounding = np.abs(g[k]) < SIGN_FLIP_RMS * rms
        assert not (outside & ~rounding).any(), (
            k, np.abs(p - r)[outside & ~rounding].max())
        flipped += int((outside & rounding).sum())
        total += r.size
    print(f"{rules}: {flipped} of {total} rounding-level elements outside "
          f"the tolerance")
    assert flipped <= SIGN_FLIP_SHARE * total


MOE_CASES = [dict(ne=8, dispatch="allgather", cf=2.0),
             dict(ne=6, dispatch="allgather", cf=2.0),
             dict(ne=8, dispatch="a2a", cf=8.0),
             dict(ne=6, dispatch="a2a", cf=8.0),
             dict(ne=8, dispatch="allgather", cf=0.5),
             dict(ne=6, dispatch="a2a", cf=0.5)]


def test_moe_dispatches_match_reference_shard_map(tmp_path):
    (tmp_path / "in.json").write_text(json.dumps({"cases": MOE_CASES}))
    code = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import numpy as np, jax, jax.numpy as jnp
        import repro.sharding.rules as R
        from repro.sharding import AxisRules, set_rules
        from repro.models.lm.config import LMConfig
        from repro.models.lm.moe import moe_block, _moe_local
        from repro.models.lm.model import _moe_params
        R.AXIS_SIZES.update({{"data": 2, "model": 4}})
        set_rules(AxisRules(batch_axes=("data",), model_axis_size=4))
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        d = {str(tmp_path)!r}
        cases = json.load(open(os.path.join(d, "in.json")))["cases"]
        rng = np.random.default_rng(0)
        arrays, out = {{}}, {{}}
        for i, c in enumerate(cases):
            cfg = LMConfig(name="t", arch_type="moe", num_layers=1,
                           d_model=32, num_heads=4, num_kv_heads=2, d_ff=0,
                           vocab_size=64, num_experts=c["ne"],
                           experts_per_tok=2, moe_d_ff=16, dtype="float32",
                           moe_dispatch=c["dispatch"],
                           moe_capacity_factor=c["cf"])
            p = jax.tree.map(np.asarray, _moe_params(
                cfg, jax.random.key(i), jnp.float32))
            x = rng.standard_normal((4, 8, 32)).astype(np.float32)
            arrays.update({{f"{{i}}/{{k}}": v for k, v in p.items()}})
            arrays[f"{{i}}/x"] = x
            with mesh:
                o, aux = jax.jit(lambda p, x: moe_block(p, x, cfg))(p, x)
            loc, _ = jax.jit(lambda p, x: _moe_local(p, x, cfg))(p, x)

            def objective(p, x):
                o, aux = moe_block(p, x, cfg)
                return (o ** 2).sum() + aux
            with mesh:
                gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(p, x)
            out[f"{{i}}/g/x"] = np.asarray(gx)
            out.update({{f"{{i}}/g/{{k}}": np.asarray(v)
                         for k, v in gp.items()}})
            out[f"{{i}}/out"] = np.asarray(o)
            out[f"{{i}}/aux"] = np.asarray(aux)
            out[f"{{i}}/local"] = np.asarray(loc)
        np.savez(os.path.join(d, "in.npz"), **arrays)
        np.savez(os.path.join(d, "ref.npz"), **out)
    """)
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    out = _worker("moe", tmp_path)
    dropped = 0
    for i, case in enumerate(MOE_CASES):
        np.testing.assert_allclose(out[f"{i}/out"], ref[f"{i}/out"],
                                   rtol=1e-5, atol=1e-5, err_msg=str(case))
        np.testing.assert_allclose(out[f"{i}/aux"], ref[f"{i}/aux"],
                                   rtol=1e-5, atol=1e-5, err_msg=str(case))
        for k in ("x", "router", "experts_gate", "experts_up",
                  "experts_down"):
            _close(out[f"{i}/g/{k}"], ref[f"{i}/g/{k}"],
                   f"{case}: gradient of {k}", rtol=1e-5, atol=1e-5)
        # at 0.5 the reference drops assignments: far from its local form
        if case["cf"] < 1:
            assert np.abs(ref[f"{i}/out"] - ref[f"{i}/local"]).max() > 0.1
            dropped += 1
    assert dropped == 2


SERVE_CASES = [dict(arch="qwen3-8b", window=None, cache_len=48),
               dict(arch="qwen3-8b", window=16, cache_len=16),
               dict(arch="mamba2-2.7b", window=None, cache_len=48),
               dict(arch="zamba2-7b", window=None, cache_len=48),
               dict(arch="granite-moe-3b-a800m", window=None, cache_len=48)]
PROMPT, STEPS = 32, 3


def test_sharded_prefill_and_decode_match_single_device_reference(tmp_path):
    rng = np.random.default_rng(0)
    arrays, ref = {}, []
    for i, case in enumerate(SERVE_CASES):
        cfg = dataclasses.replace(
            ref_smoke_variant(ref_get_config(case["arch"])),
            sliding_window=case["window"])
        params = ref_init_params(cfg, jax.random.key(i))
        prompt = rng.integers(0, cfg.vocab_size, (1, PROMPT))
        nxt = rng.integers(0, cfg.vocab_size, (1, STEPS))
        arrays.update({f"{i}/p/{k}": v for k, v in _flatten(
            jax.tree.map(np.asarray, params)).items()})
        arrays[f"{i}/prompt"], arrays[f"{i}/next"] = prompt, nxt
        logits, cache = jax.jit(ref_make_prefill_step(
            cfg, case["cache_len"]))(params,
                                     {"tokens": jnp.asarray(prompt,
                                                            jnp.int32)})
        steps = [logits]
        decode = jax.jit(ref_make_decode_step(cfg))
        for t in range(STEPS):
            logits, cache = decode(params, cache,
                                   jnp.asarray(nxt[:, t:t + 1], jnp.int32))
            steps.append(logits)
        ref.append((steps, cache))
    np.savez(tmp_path / "in.npz", **arrays)
    (tmp_path / "in.json").write_text(json.dumps({"cases": SERVE_CASES}))
    out = _worker("sharded_serve", tmp_path)

    for i, case in enumerate(SERVE_CASES):
        steps, cache = ref[i]
        specs = json.loads(str(out[f"{i}/specs"]))
        if "k" in specs:
            # one row: the ring over "data"; 2 KV heads do not divide
            # over "model", so head_dim does
            assert specs["k"] == [None, None, "data", None, "model"], specs
        if "ssm" in specs:
            assert "model" in specs["ssm"], specs
        for t, r in enumerate(steps):
            _close(out[f"{i}/logits/{t}"], r, f"{case}: logits {t}")
        assert int(out[f"{i}/pos"]) == int(cache["pos"]) == PROMPT + STEPS
        assert {k[len(f"{i}/cache/"):] for k in out
                if k.startswith(f"{i}/cache/")} == set(cache) - {"pos"}
        for k, r in cache.items():
            if k != "pos":
                _close(out[f"{i}/cache/{k}"], r, f"{case}: cache[{k!r}]")
