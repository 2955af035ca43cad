"""The correctness check, on the CPU at a size a test run holds: a sound
run of each cell's path comes out correct; the control (the reference
with TF32 matrix products in the program's place) and each fault a
training cell can have, planted in the program under a run, come out
not correct. The faults: a step that returns its state unchanged; half
of the trainers' batches left out of the step's mean; an answer altered
where it is produced (a pulled feature row, a sampled edge, a row of
the aggregation). One card and one process: no exchange between chips
to leave out."""
import copy
import time

import numpy as np
import pytest
import torch

from gnnbench import harness

CELLS = ("sage-products-b1000", "gat-products-b1000")


def tiny(name: str) -> harness.Cell:
    """The cell at 512 nodes and 8 seeds a trainer, its limits kept."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config["data"]["num_nodes"] = 512
    cell.traffic = {"seeds_per_trainer": 8}
    return cell


def run(cell, seed=2**31 + 11):
    return harness.run(cell, seed, 0.2, False, time.perf_counter(), "cpu",
                       log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(tiny(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_seeds_per_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = tiny(name)
    st = harness.setup(cell, 5, "cpu", log=lambda *a: None, steady=False)
    harness.free(st)
    values, decoded = harness.check_first_steps(cell, st, "cpu",
                                                log=lambda *a: None)
    r = harness.control_readings(cell, st, decoded, "cpu")
    assert harness.check.judge(r["program"], {
        k: v for k, v in cell.limits.items() if k in r["program"]})
    for planted in ("tf32", "half_batch"):
        assert not harness.check.judge(r[planted], {
            k: v for k, v in cell.limits.items() if k in r[planted]}), \
            (planted, r[planted])


def _unchanged(monkeypatch):
    monkeypatch.setattr("repro_torch.training.trainer.adamw_update",
                        lambda params, grads, state, **kw: (params, state))


def _half_batch(monkeypatch):
    from repro_torch.training import trainer

    whole = trainer.nc_loss
    monkeypatch.setattr(trainer, "nc_loss", lambda logits, labels, mask:
                        whole(logits, labels, mask)[:logits.shape[0] // 2])


def _pulled_row(monkeypatch):
    from repro_torch.core.kvstore.store import KVClient

    pull = KVClient.pull

    def altered(self, name, ids, *a, **kw):
        rows = np.array(pull(self, name, ids, *a, **kw))
        rows[0, 0] += 1.0
        return rows
    monkeypatch.setattr(KVClient, "pull", altered)


def _sampled_edge(monkeypatch):
    from repro_torch.api import dataloader

    blocks = dataloader.host_blocks

    def altered(mb):
        out = [dict(b) for b in blocks(mb)]
        es = out[-1]["edge_src"].copy()
        es[0] = out[-1]["edge_dst"][0]        # a self loop: no such edge
        out[-1]["edge_src"] = es
        return out
    monkeypatch.setattr(dataloader, "host_blocks", altered)


def _aggregation_row(monkeypatch):
    from repro_torch.models.gnn import layers

    k1 = layers.fused_gather_aggregate

    def altered(*a, **kw):
        out = k1(*a, **kw)
        return torch.cat([out[:1] * 2, out[1:]])
    monkeypatch.setattr(layers, "fused_gather_aggregate", altered)


FAULTS = {"unchanged_state": _unchanged, "half_batch": _half_batch,
          "pulled_row": _pulled_row, "sampled_edge": _sampled_edge,
          "aggregation_row": _aggregation_row}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(tiny("sage-products-b1000"))
    assert not out["correct"], out["checks"]
