"""BENCHMARK.json against the benchmark's contract and against the files
it names."""

import json
import re

import pytest

from mvsbench import manifest

DOC = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KINDS = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(DOC["paths"]) <= 16
    for p in DOC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(DOC["command"]) <= 32
    assert all(1 <= len(w) <= 200 for w in DOC["command"])
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) < 64 * 1024


@pytest.mark.parametrize("entry", DOC["configs"] + DOC["workloads"]
                         + DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in KINDS
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in DOC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end():
    names = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in names
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    assert next(m for m in DOC["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("w", DOC["workloads"], ids=lambda w: w["name"])
def test_cell_reports(w):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one, and each per-layer metric's `moves` in its cells."""
    cell = manifest.Cell(DOC, w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in DOC["per_layer"]:
        if w["name"] in m.get("workloads", [w["name"]]):
            assert m["moves"] in e2e, (m["name"], w["name"])
    assert w["chips"] in (1, 4)
    assert cell.limits, "each cell has its limits file"


def test_per_layer_metrics():
    layers = {}
    for m in DOC["per_layer"]:
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in DOC["workloads"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(1 <= len(k) <= 200 for k in layers)


@pytest.mark.parametrize("c", DOC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith(DOC["paths"][0] + "/")
    data = manifest.read_json(manifest.ROOT / c["file"])
    assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    assert data["source"] == c["source"]
    assert len({x["file"] for x in DOC["configs"]}) == len(DOC["configs"])
    assert any(w["config"] == c["name"] for w in DOC["workloads"])


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in DOC["workloads"])
    assert four <= max(1, len(DOC["workloads"]) // 4)


def test_run_seconds_fit():
    """A full check of 24 cells fits in 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
