"""BENCHMARK.json and the files it names, against the benchmark's
contract: keys, names, units, lengths, and that every configuration,
traffic mix, limit set and metric reader the manifest names is a file of
its own that the harness finds by name."""
import json
import math
import re
from pathlib import Path

import pytest

from gnnbench import harness

ROOT = Path(__file__).resolve().parents[1]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = [e["name"] for e in M["end_to_end"] + M["per_layer"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and len(M["command"]) <= 32
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in M["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert (runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200) <= 43200


def test_names_units_and_one_line_texts():
    names = [c["name"] for c in M["configs"]] + CELLS + METRICS
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in M["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0 < e["bound"] <= 0.25
    for p in M["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(p["layer"])
        assert p["moves"] in [e["name"] for e in M["end_to_end"]]
        if p["name"].endswith("_roofline") or "mfu" in p["name"]:
            assert p["unit"] == "%"
    assert "setup_s" in [e["name"] for e in M["end_to_end"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_reports_setup_a_rate_and_a_layer(cell):
    c = harness.load_cell(cell)
    reported = [e["name"] for e in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    assert c.batch_size > 0 and c.chips == 1
    assert set(c.limits) >= {"loss1_gap", "grad_gap", "change_med_gap",
                             "sample_faults", "row_faults", "seed_faults",
                             "shape_faults"}
    for k, v in c.limits.items():
        assert v >= 0 and math.isfinite(v)


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


# the source's own widths of the configurations that are pinned here
# (DistDGLv2 §6 on ogbn-products: 3 layers, 100 features, hidden 256, 47
# classes, fanouts 15/10/5)
PRODUCTS = {"num_layers": 3, "in_dim": 100, "hidden_dim": 256,
            "num_classes": 47, "fanouts": [15, 10, 5]}
PUBLISHED = {"graphsage-products": PRODUCTS, "gat-products": PRODUCTS}


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    """Each configuration at its source's published widths (``published``
    in its file), but for the keys it lists as ``reduced``."""
    path = ROOT / config["file"]
    assert path.is_file() and str(path.relative_to(ROOT)).startswith(
        tuple(M["paths"]))
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert sorted(cfg["reduced"]) == sorted(config["reduced"])
    assert any(w["config"] == config["name"] for w in M["workloads"])
    m, published = cfg["model"], cfg["published"]
    assert set(published) == {"num_layers", "in_dim", "hidden_dim",
                              "num_classes", "fanouts"}
    if config["name"] in PUBLISHED:
        assert published == PUBLISHED[config["name"]]
    for key, value in published.items():
        if key not in config["reduced"]:
            assert m[key] == value, key
    assert m["dtype"] == "float32"
    assert cfg["data"]["feat_dim"] == m["in_dim"]
    assert cfg["data"]["num_classes"] == m["num_classes"]


def test_files_are_named_from_name_characters():
    for p in (ROOT / "gnnbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = str(p.relative_to(ROOT))
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
