"""BENCHMARK.json against the benchmark's contract: names, units, files,
metrics and the cells that report them."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("entry", METRICS + MAN["configs"] + MAN["workloads"],
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
    assert harness.reader_path(ROOT / "portbench", metric["name"]).exists()
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_unique_names():
    for group in (METRICS, MAN["configs"], MAN["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_one_reported_metric(metric):
    """Each per-layer metric names one end-to-end metric, which every
    cell that reports it also reports."""
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert metric["moves"] in e2e
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]


def test_layers_consistent():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert all(1 <= len(layer) <= 200 for layer in layers)


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_reports(cell):
    files = harness.cell_files(MAN, cell["name"], ROOT / "portbench")
    assert cell["chips"] in (1, 4)
    assert files.builder.exists() and files.driver.exists() and files.model.exists()
    e2e = harness.metrics_of(MAN, cell["name"], False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.metrics_of(MAN, cell["name"], True)
    assert all(v is None or v >= 0 for v in files.limits.values())


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert config["file"].startswith("portbench/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    assert any(w["config"] == config["name"] for w in MAN["workloads"])


def test_budget():
    """A full check of 24 cells fits the driver's 43200 seconds."""
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells():
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(MAN["workloads"]) // 4)


def test_files_named_from_names():
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel
