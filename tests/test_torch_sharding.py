"""The port's sharding rules (``repro_torch.sharding``), its dry-run inputs
(``launch.input_specs``) and roofline model (``launch.roofline``) against
the JAX package's, on the CPU.

Specs are compared exactly, as tuples: the port's spec is the contents of
the reference's ``PartitionSpec``. The reference's parameter trees come
from its ``abstract_params`` (``jax.eval_shape``), the port's from its
own (fake tensors); no full-size tensor is allocated on either side.
The roofline's model FLOPs, cache and memory bytes are held exactly; only
its three hardware constants differ (the H100's for the v5e's).
``placements`` of multi-axis specs is held to ``NamedSharding`` rank by
rank: an 8-device JAX subprocess's ``addressable_shards`` against the
port's local shards on a (2, 4) gloo world (a subprocess of 8 CPU
processes, one thread each, 300 s limit).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro.launch.dryrun as ref_dryrun
import repro.launch.roofline as ref_roofline
from repro.configs import get_config as ref_get_config
from repro.launch.input_specs import input_specs as ref_input_specs
from repro.models.lm import abstract_params as ref_abstract_params
from repro.sharding import AxisRules as RefAxisRules
from repro.sharding import param_pspecs as ref_param_pspecs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline
from repro_torch.launch.input_specs import SHAPES, input_specs
from repro_torch.models.lm import abstract_params
from repro_torch.sharding import AxisRules, param_pspecs
from repro_torch.sharding.rules import batch_pspecs, cache_pspecs

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
PAIRS = [(a, s) for a in ARCH_IDS for s in SHAPES]

# name -> (AxisRules kwargs, fsdp flag)
RULES = {
    "tp": (dict(), False),
    "tp_fsdp": (dict(), True),
    "pure_fsdp": (dict(batch_axes=("data", "model"), fsdp_axis=None,
                       seq_shard_activations=False, pure_fsdp=True), False),
    "multi_pod": (dict(batch_axes=("pod", "data"),
                       fsdp_axis=("pod", "data")), True),
    "multi_pod_fsdp": (dict(batch_axes=("pod", "data"), fsdp_axis=None,
                            pure_fsdp=True,
                            fsdp_param_axes=("pod", "data", "model")),
                       False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _ref_flat(tree) -> dict:
    """path -> leaf of a reference tree (PartitionSpecs as leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _port_flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return ref_abstract_params(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    return abstract_params(get_config(arch), "cpu")


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, rules):
    kw, fsdp = RULES[rules]
    ref = _ref_flat(ref_param_pspecs(_ref_abstract(arch), fsdp=fsdp,
                                     rules=RefAxisRules(**kw)))
    port = _port_flat(param_pspecs(_port_abstract(arch), fsdp=fsdp,
                                   rules=AxisRules(**kw)))
    assert set(port) == set(ref)
    for path, spec in ref.items():
        assert port[path] == tuple(spec), (path, port[path], spec)


def _shapes(flat: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat.items() if hasattr(v, "shape")}


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_reference(arch, shape):
    ref = ref_input_specs(ref_get_config(arch), shape)
    port = input_specs(get_config(arch), shape)
    assert port["kind"] == ref["kind"]
    assert port.get("cache_len") == ref.get("cache_len")
    for part in ("batch", "cache"):
        if part in ref:
            r = _ref_flat(ref[part])
            p = _port_flat(port[part])
            if part == "cache":
                # the position: an int32 scalar there, a Python int here
                assert r.pop("pos").shape == () and p.pop("pos") == 0
            assert _shapes(p) == _shapes(r), part
            assert set(p) == set(r)
    if "tokens" in ref:
        assert tuple(port["tokens"].shape) == ref["tokens"].shape
        assert port["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_cache_and_batch_pspecs_match_reference(arch, shape):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref, port = ref_input_specs(rcfg, shape), input_specs(cfg, shape)
    b = SHAPES[shape]["batch"]
    for kw in (dict(), RULES["multi_pod"][0], RULES["pure_fsdp"][0]):
        rrules, prules = RefAxisRules(**kw), AxisRules(**kw)
        if "cache" in ref:
            r = _ref_flat(ref_dryrun.cache_pspecs(rcfg, ref["cache"], b,
                                                  rrules))
            p = cache_pspecs(cfg, port["cache"], b, prules)
            assert {k.split("/")[-1]: tuple(v) for k, v in r.items()} == p
        if "batch" in ref:
            r = _ref_flat(ref_dryrun.batch_pspecs(ref["batch"], rrules))
            p = batch_pspecs(port["batch"], prules)
            assert {k: tuple(v) for k, v in r.items()} == p


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_roofline_model_matches_reference(arch, shape):
    assert roofline.tokens_per_step(shape) == \
        ref_roofline.tokens_per_step(shape)
    assert roofline.model_flops(arch, shape) == \
        ref_roofline.model_flops(arch, shape)
    assert roofline.cache_bytes(arch, shape) == \
        ref_roofline.cache_bytes(arch, shape)
    for chips in (256, 512):
        assert roofline.memory_bytes(arch, shape, chips) == \
            ref_roofline.memory_bytes(arch, shape, chips)
    # the same entry through both: every term is the reference's times
    # the ratio of the two constants
    entry = {"arch": arch, "shape": shape, "mesh": "16x16",
             "collectives": {"total": 123456789}, "flops_per_device": 1e15,
             "bytes_per_device": 1e12}
    p, r = roofline.analyze(entry, 256), ref_roofline.analyze(entry, 256)
    for term, const in (("t_compute", "PEAK_FLOPS"), ("t_memory", "HBM_BW"),
                        ("t_collective", "LINK_BW")):
        np.testing.assert_allclose(
            p[term] * getattr(roofline, const),
            r[term] * getattr(ref_roofline, const), rtol=1e-12)


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert (ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW) == (197e12, 819e9)


SPECS = [[["data", "model"], None], ["model", "data"],
         [None, ["data", "model"]], ["data", None], [None, "model"]]


def test_placements_match_named_sharding(tmp_path):
    """Every rank's shard of an (8, 16) array under each spec: JAX's
    ``addressable_shards`` on a (2, 4) mesh (the device at mesh
    coordinate (i, j)) against the port's rank i * 4 + j."""
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    np.savez(tmp_path / "in.npz", x=x)
    (tmp_path / "in.json").write_text(json.dumps({"specs": SPECS}))
    code = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import numpy as np, jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        specs = json.loads(open({str(tmp_path / 'in.json')!r}).read())["specs"]
        x = np.load({str(tmp_path / 'in.npz')!r})["x"]
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        out = {{}}
        for i, s in enumerate(specs):
            sp = P(*[tuple(e) if isinstance(e, list) else e for e in s])
            a = jax.device_put(x, NamedSharding(mesh, sp))
            by_dev = {{sh.device.id: np.asarray(sh.data)
                      for sh in a.addressable_shards}}
            for r, dev in enumerate(mesh.devices.reshape(-1)):
                out[f"{{i}}/r{{r}}"] = by_dev[dev.id]
        np.savez({str(tmp_path / 'ref.npz')!r}, **out)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "_torch_mesh_worker.py"),
                        "placement", str(tmp_path), "8"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref, port = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "out.npz")
    assert set(ref.files) == set(port.files)
    for k in ref.files:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
