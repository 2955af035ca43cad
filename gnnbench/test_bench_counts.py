"""The yardstick's arithmetic against hand counts at tiny shapes, the
trace reduction on a hand-made timeline, and a rate taken over the whole
window."""
import time
import types

import pytest

from gnnbench import counts, harness, trace

SAGE = harness.plugin("archs", "graphsage")
GAT = harness.plugin("archs", "gat")

PEAK_BYTES = {"hbm_byte_s": 1.0, "fp32_flop_s": 1e9}     # bytes bound
PEAK_OPS = {"hbm_byte_s": 1e9, "fp32_flop_s": 1.0}       # ops bound


def test_capacities_pad_fanout_slots_a_destination():
    # batch 2, fanouts [3, 2] (input layer first): the last layer has 2
    # destinations, 4 edge slots, 6 sources; the first 6, 18 and 24
    assert counts.capacities(2, [3, 2]) == [(24, 18, 6), (6, 4, 2)]
    assert counts.capacities(1000, [15, 10, 5])[0] == (1_056_000, 990_000,
                                                       66_000)


def test_k1_bytes_and_operations():
    # 10 slots (1 mask byte each), 4 live edges (8 index bytes each), 3
    # source rows and 2 output rows of 5 floats; 4 x 5 adds
    assert counts.k1_least_seconds(10, 4, 3, 2, 5, PEAK_BYTES) == \
        10 + 32 + 60 + 40
    assert counts.k1_least_seconds(10, 4, 3, 2, 5, PEAK_OPS) == 20


def test_k3_bytes_and_operations():
    # + 2 scores an edge, m and z of 2 heads a destination; f = 6
    assert counts.k3_least_seconds(10, 4, 3, 2, 2, 6, PEAK_BYTES) == \
        10 + 32 + 32 + 32 + 72 + 48
    assert counts.k3_least_seconds(10, 4, 3, 2, 2, 6, PEAK_OPS) == \
        4 * (2 * 6 + 3 * 2)


def _model(arch, classes, **kw):
    return dict(arch=arch, num_layers=1, in_dim=3, hidden_dim=4,
                num_classes=classes, fanouts=[2], **kw)


def test_model_flops_graphsage_by_hand():
    # one layer, batch 2, fanout 2: 2 destinations, 4 edge slots
    # forward: 2 products 2 x 3 x 2 (48) + 4 x 3 adds + 2 x 3 divisions;
    # backward: the weights' products again (layer 0: no input gradient)
    # and the edge reduction again
    assert SAGE.flops_per_step(_model("graphsage", 2), 2, 1) == \
        2 * (48 + 18)
    assert SAGE.flops_per_step(_model("graphsage", 2), 2, 4) == \
        4 * 2 * (48 + 18)


def test_model_flops_gat_by_hand():
    # projection 6 x 3 x 4 (144), head dots 2 x (6 + 2) x 4 (64), scores
    # and softmax 5 x 4 x 2 (40), weighted sum 2 x 4 x 4 (32)
    gat = _model("gat", 4, num_heads=2)
    assert GAT.flops_per_step(gat, 2, 1) == 2 * (144 + 136)
    # 3 classes: the last layer is 2 heads of 1 column, so a head product
    # 2 x 2 x 3 forward (24) and twice that backward
    gat3 = _model("gat", 3, num_heads=2)
    proj = 2 * 6 * 3 * 2
    edges = 2 * 8 * 2 + 5 * 4 * 2 + 2 * 4 * 2
    assert GAT.flops_per_step(gat3, 2, 1) == \
        2 * (proj + edges) + 3 * 24


def test_kernel_least_per_step_sums_the_layers():
    model = _model("graphsage", 2)
    model.update(num_layers=2, fanouts=[3, 2])
    live = [(12, 5, 6), (4, 3, 2)]
    got = SAGE.kernel_least_per_step(model, 2, 1, live, PEAK_OPS)
    assert got == {"fused_gather_aggregate": 12 * 3 + 4 * 4}


def test_peaks_of_the_card():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"fp32_flop_s": 67e12, "hbm_byte_s": 3.35e12}
    assert counts.peaks("cpu") is None


def test_trace_summary_by_hand():
    # a step: wait 0-10, stack 10-20, forward 20-30 (ns); kernels 12-15
    # and 22-30, a copy 14-18 overlapping the first
    marks = [(0, "start"), (10, "wait_loaders"), (20, "stack_stage"),
             (30, "forward")]
    device = [(12, 15, "k"), (14, 18, "copy"), (22, 30, "k")]
    s = trace.summarize(device, marks, 30e-9)
    assert s.busy_s == pytest.approx(14e-9)
    assert s.by_name == {"k": pytest.approx(11e-9),
                         "copy": pytest.approx(4e-9)}
    assert dict(s.idle_gaps) == {"wait_loaders": pytest.approx(10e-9),
                                 "stack_stage": pytest.approx(4e-9),
                                 "forward": pytest.approx(2e-9)}
    assert s.device_ops[0][0] == "k"
    assert trace.summarize(device, [], 1.0) is None


class _FakeTrainer:
    """Epochs of 2 steps of 0.05 s each, with the span totals a trainer
    keeps."""
    num_trainers = 4
    batches_per_epoch = 2

    def __init__(self):
        self.spans = types.SimpleNamespace(totals={"read_loss": 0.0})
        self.pipelines = []

    def train_epoch(self, epoch):
        time.sleep(0.1)
        self.spans.totals["read_loss"] += 0.01
        return {"batches": 2, "time_s": 0.1}


def test_the_rate_is_taken_over_the_whole_window():
    cell = types.SimpleNamespace(batch_size=10, model=_model("graphsage", 2),
                                 arch=SAGE)
    st = types.SimpleNamespace(tr=_FakeTrainer(), next_epoch=0)
    t0 = time.perf_counter()
    w = harness.window(cell, st, 0.25, False, t0, "cpu", log=lambda *a: None)
    # the window ends at the end of the epoch in which 0.25 s ran out:
    # three epochs, six steps, all of their time
    assert w.steps == 6 and w.seeds == 6 * 4 * 10
    assert w.seconds >= 0.3
    rate = harness.reader("train_seeds_per_s")(w)
    assert rate == pytest.approx(w.seeds / w.seconds)
    assert harness.reader("read_loss_ms")(w) == pytest.approx(5.0)
    assert w.setup_s >= 0
