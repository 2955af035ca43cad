"""The port's dry-run (``repro_torch.launch.dryrun``, ``gnn_dryrun``) on
fake worlds, on the CPU.

* ``collective_bytes``: a program of known collectives on a fake world of
  8 ranks, traced by ``StepTrace``; the expected bytes (an all-gather its
  gathered result, a reduce-scatter its scattered one, each rank's) are
  computed here from the shapes.
* A mini dry-run: ``smoke_variant(llama3-8b)`` at 2 layers with remat on a
  fake (2, 4) mesh (``train_4k``), under the tp and the pure-FSDP rules:
  the port's counterpart of the reference's
  ``test_mini_dryrun_lowers_on_mesh`` (which does not run with this
  JAX). It must return ok, collectives and a peak above 0, and trace
  FLOPs a rank within 0.1% of the step's products counted by hand (see
  ``_step_flops``), from both sides: a rank that computed a product over
  more than its share (a weight's gradient whole on every rank of
  "model") or skipped one would fall outside.
* ``gnn_dryrun`` of GraphSAGE on a fake 8-rank mesh: its all-reduce is
  exactly 4 bytes a parameter (the float32 gradients, once each).

Every fake world runs in a subprocess of its own (300 s).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.dryrun import KINDS, collective_bytes

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def _run(case: str, d) -> dict:
    r = subprocess.run([sys.executable, os.path.join(
        HERE, "_torch_mesh_worker.py"), case, str(d)],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


def test_collective_bytes_of_records():
    recs = [{"kind": "all-gather", "bytes": 10},
            {"kind": "all-gather", "bytes": 5},
            {"kind": "all-to-all", "bytes": 7}]
    out = collective_bytes(recs)
    assert out == {"all-gather": 15, "all-reduce": 0, "reduce-scatter": 0,
                   "all-to-all": 7, "collective-permute": 0, "count": 3,
                   "total": 22}
    assert set(KINDS) | {"count", "total"} == set(out)


def test_collective_bytes_of_a_traced_program(tmp_path):
    out = _run("fake_collectives", tmp_path)
    f32, bf16 = 4, 2
    gathered = 8 * 4 * 8 * f32          # (4, 8) gathered over 8 ranks
    reduced = 4 * 8 * f32 + 8 * 6 * bf16
    scattered = (32 // 8) * 8 * f32     # (32, 8) scattered over 8 ranks
    a2a = 8 * 6 * bf16
    assert out["collectives"] == {
        "all-gather": gathered, "all-reduce": reduced,
        "reduce-scatter": scattered, "all-to-all": a2a,
        "collective-permute": 0, "count": 5,
        "total": gathered + reduced + scattered + a2a}
    assert out["flops"] == 2 * 4 * 8 * 3     # the one product
    assert out["z"] == [4, 3]


def test_mini_dryrun_and_gnn_dryrun_on_fake_meshes(tmp_path):
    cases = [dict(arch="llama3-8b", shape="train_4k", parallel=p,
                  cfg=dict(num_layers=2, remat=True, attn_chunk=1024))
             for p in ("tp", "fsdp")]
    (tmp_path / "in.json").write_text(json.dumps({"lm": cases,
                                                  "gnn": ["graphsage"]}))
    out = _run("mini_dryrun", tmp_path)
    cfg = dataclasses.replace(smoke_variant(get_config("llama3-8b")),
                              num_layers=2)
    want = _step_flops(cfg, tokens=256 * 4096 / 8, seq=4096)
    for p in ("tp", "fsdp"):
        res = out[f"llama3-8b|train_4k|{p}"]
        assert res["ok"], res["error"]
        assert res["collectives"]["count"] > 0
        assert res["collectives"]["total"] > 0
        assert res["memory"]["peak_bytes"] > 0
        assert res["memory"]["params_bytes"] > 0
        assert abs(res["flops_per_device"] - want) <= 1e-3 * want, (
            p, res["flops_per_device"], want)
        assert res["mesh"] == "2x4" + ("+fsdp" if p == "fsdp" else "")
    gnn = out["gnn|graphsage"]
    assert gnn["collectives"]["all-reduce"] == 4 * gnn["params"]
    assert gnn["collectives"]["total"] == 4 * gnn["params"]
    assert gnn["memory"]["peak_bytes"] > 0


def _step_flops(cfg, tokens: float, seq: int) -> float:
    """The products of one remat train step of a dense ``cfg`` on
    ``tokens`` tokens a rank, as ``torch.utils.flop_counter`` counts them
    (2 a multiply-add; matrix products only):

    * every block weight of P entries: 2 P a token in the forward, 2 in
      the remat forward, 2 for the input's gradient and 2 for its own:
      8 P, less 2 P for the block's last product (``w_down``), which
      torch's checkpoint does not recompute (nothing of the backward
      reads its output);
    * the head: 8 P as well (each cross-entropy chunk is checkpointed);
    * attention: scores and values, 4 S H hd a token a layer in the
      forward, again in the remat forward, twice in the backward;
    * the embedding: a lookup, no product."""
    d, ff = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    per_layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * ff
    down = ff * d
    head = d * cfg.padded_vocab
    products = (cfg.num_layers * (8 * per_layer - 2 * down)
                + 8 * head) * tokens
    attn = 16 * cfg.num_layers * tokens * seq * h * hd
    return products + attn


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
