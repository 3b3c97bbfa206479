"""Whole runs of toy cells on the CPU, past the harness's look for a card
(and one real cell on the card, marked `chip`):
the result line's shape with --trace 0 and 1; correct false under each
fault a cell can have, and under the control (the reference at float8
in the program's place); and a configuration and a cell that are only
new files and entries, picked up by name."""

import json
import shutil

import pytest
import torch

from mvsbench import calibrate, check, manifest, run
from mvsbench.tests import toy
from mvsbench.tests.test_mvsbench_counts import (check_flops_per_map,
                                                 count_flops)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
REAL = {}
for _w in manifest.load()["workloads"]:
    REAL.setdefault(_w["traffic"], _w["name"])
KIND_LIMITS = {
    kind: manifest.read_json(manifest.HERE / "limits" / f"{REAL[mix]}.json")
    for mix, kind in (("batch16", "batch"), ("request1", "request"),
                      ("train4", "train"))}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("toybench")
    return root, toy.write(root, KIND_LIMITS)


# one toy a real configuration and traffic kind, so a real cell added to
# BENCHMARK.json runs here with no edit
CELLS = list(dict.fromkeys(toy.names(manifest.load()).values()))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run(bench, name, trace):
    root, doc = bench
    cell = toy.cell(root, doc, name)
    res = run.measure(cell, SEED, 0.5, trace, CPU)
    compared = res["compared"]
    assert res["correct"] is all(c["value"] <= c["limit"]
                                 for c in compared.values())
    if cell.traffic["kind"] == "train":
        # the CPU's bfloat16 convolutions round otherwise than cuDNN's:
        # at toy sizes the gradient numbers read ~0.01, about the card's
        # limits, while the loss reads well inside them
        assert compared["loss_gap"]["value"] <= compared["loss_gap"]["limit"]
    else:
        assert res["correct"] is True, compared
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == set(check.COMPARED[cell.traffic["kind"]])
    json.dumps(run.finite(res))


FAULTS = [("toy-casdiffmvs-dtu.batch2", "half_batch"),
          ("toy-casdiffmvs-dtu.batch2", "altered"),
          ("toy-diffmvs-dtu.batch2", "altered"),
          ("toy-casdiffmvs-dtu.request1", "altered"),
          ("toy-casdiffmvs-dtu.train2", "half_batch"),
          ("toy-casdiffmvs-dtu.train2", "unchanged")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(bench, name, fault):
    root, doc = bench
    cell = toy.cell(root, doc, name)
    res = run.measure(cell, SEED, 0.2, False, CPU, fault=fault)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name):
    root, doc = bench
    cell = toy.cell(root, doc, name)
    got, _ = calibrate.control_numbers(cell, SEED, CPU)
    ok, compared = check.judge(cell.traffic["kind"], got, cell.limits)
    assert not ok, compared


NEW_CELLS = [
    pytest.param(dict(
        base="diffmvs-dtu", model={"numdepth_initial": 16}, shape={},
        mix=("pool3", dict(toy.TOY_TRAFFIC["request1"], pool=3)),
        like="toy-casdiffmvs-dtu.request1",
        end_to_end={"request_p90_ms", "peak_gib", "setup_s"},
        traces=[False]), id="request"),
    # the shape a published configuration other than DTU's brings, as
    # Tanks and Temples' (1056 / 32 = 33 is odd, 10 views, 96 coarse
    # planes, the BlendedMVS noise scales), at toy size, on a mix the
    # benchmark already has
    pytest.param(dict(
        base="casdiffmvs-dtu",
        model={"numdepth_initial": 16, "scale": [0.0, 0.125, 0.025]},
        shape={"image_hw": [96, 160], "views": 4}, mix=("batch2", None),
        like="toy-casdiffmvs-dtu.batch2",
        end_to_end={"maps_per_s", "peak_gib", "setup_s"},
        traces=[False, True]), id="batch"),
    # a fifth cell of the real BENCHMARK.json as a configuration brings it:
    # a configuration file of the Tanks and Temples shape at its own size,
    # a limits file and the entries, added to a copy of the real benchmark
    # from which the toy benchmark is then built
    pytest.param(dict(
        base="casdiffmvs-dtu", real=True,
        model={"numdepth_initial": 96, "scale": [0.0, 0.125, 0.025]},
        shape={"image_hw": [1056, 1920], "views": 10}, mix=("batch16", None),
        like="casdiffmvs-dtu.batch16",
        end_to_end={"maps_per_s", "peak_gib", "setup_s"},
        traces=[False, True]), id="real_fifth_cell"),
]


@pytest.mark.parametrize("new", NEW_CELLS)
def test_new_config_and_cell_need_no_edit(tmp_path, new):
    """A configuration file, a traffic file where the mix is new, a
    limits file and a cell entry whose name is appended to the workloads
    lists of the metrics it reports: nothing else changes. The `real`
    case adds them to a copy of the real benchmark, and runs the toy cell
    that the toy benchmark built from that copy gives the new cell."""
    if new.get("real"):
        here = tmp_path / "real"
        for sub in ("configs", "traffic", "limits"):
            shutil.copytree(manifest.HERE / sub, here / sub)
        doc = manifest.load()
        cfg = manifest.read_json(here / "configs" / f"{new['base']}.json")
        cfg["name"] = "new"
    else:
        root = here = tmp_path
        doc = toy.write(tmp_path, KIND_LIMITS)
        cfg = toy.toy_config(new["base"])
        cfg["name"] = "toy-new"
    cfg["model"].update(new["model"])
    cfg.update(new["shape"])
    if new["shape"]:
        # what a real configuration of this shape is held to
        cfg["flops_per_map"] = count_flops(cfg, *cfg["image_hw"])
        check_flops_per_map(cfg)
    (here / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    mix, traffic = new["mix"]
    if traffic is not None:
        (here / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    name, like = f"{cfg['name']}.{mix}", new["like"]
    kind = manifest.read_json(here / "traffic" / f"{mix}.json")["kind"]
    (here / "limits" / f"{name}.json").write_text(
        json.dumps(KIND_LIMITS[kind]))
    doc["workloads"].append({"name": name, "config": cfg["name"],
                             "traffic": mix, "chips": 1, "why": "new"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    if new.get("real"):
        doc["configs"].append({"name": cfg["name"], "source": "new",
                               "file": f"mvsbench/configs/{cfg['name']}.json",
                               "reduced": [], "why": "new"})
        assert {m["name"] for m in manifest.Cell(doc, name, here).per_layer} \
            == {m["name"] for m in manifest.Cell(doc, like, here).per_layer}
        toys = toy.names(doc, here)
        root = tmp_path / "toy"
        doc = toy.write(root, KIND_LIMITS, real=doc, real_dir=here)
        name, like = toys[name], toys[like]
        assert name == "toy-new.batch2"
    cell = toy.cell(root, doc, name)
    if new.get("real"):
        assert cell.config == toy.toy_config("new", here)
    else:
        assert cell.config["model"] == dict(
            toy.toy_config(new["base"])["model"], **new["model"])
    assert {m["name"] for m in cell.end_to_end} == new["end_to_end"]
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in toy.cell(root, doc, like).per_layer}
    for trace in new["traces"]:
        res = run.measure(cell, SEED, 0.3, trace, CPU)
        assert res["correct"] is True, res["compared"]
        if trace:
            assert res["metrics"]
            assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        else:
            assert set(res["metrics"]) == new["end_to_end"]


@pytest.mark.chip
def test_cell_on_the_card(card):
    """A real cell, briefly, on the card: the timed path against the
    reference at the timed sizes."""
    cell = manifest.Cell(manifest.load(), "casdiffmvs-dtu.request1")
    res = run.measure(cell, SEED, 3.0, False, card)
    assert res["correct"] is True, res["compared"]
    assert res["metrics"]["request_p90_ms"]["value"] > 0
