"""A toy benchmark beside the real one, for the CPU tests: the real
configurations' models at a few dozen pixels, the real traffic kinds at
small batches, and the real metric readers (linked, not copied)."""

from __future__ import annotations

import copy
import json
from math import prod
from pathlib import Path

from mvsbench import manifest

REAL = manifest.HERE
TOY_HW = [64, 96]


def toy_config(name: str):
    c = manifest.read_json(REAL / "configs" / f"{name}.json")
    c = copy.deepcopy(c)
    c["name"] = f"toy-{name}"
    c["model"].update(numdepth_initial=8, numdepth=32)
    c["flops_per_map"] = (c["flops_per_map"] * prod(TOY_HW)
                          / prod(c["image_hw"]))
    c["image_hw"] = TOY_HW
    c["views"] = 3
    return c


TOY_TRAFFIC = {
    "batch2": {"kind": "batch", "why": "toy", "batch": 2,
               "sample": {"units": 2, "answers": 2},
               "trace_units": 1},
    "request1": {"kind": "request", "why": "toy", "batch": 1, "pool": 2,
                 "sample": {"units": 3, "answers": 2},
                 "trace_units": 1},
    "train2": {"kind": "train", "why": "toy", "batch": 2,
               "image_hw": TOY_HW, "pool": 2, "steps_per_epoch": 10,
               "checked_steps": 3, "trace_units": 1},
}


def write(root: Path, limits=None):
    """A benchmark directory at root (configs/, traffic/, limits/ and a
    link to the real metrics/) and its manifest, a copy of the real
    BENCHMARK.json whose cells are toy ones."""
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    (root / "metrics").symlink_to(REAL / "metrics")
    real = manifest.load()
    cells = []
    for cfg in ("casdiffmvs-dtu", "diffmvs-dtu"):
        (root / "configs" / f"toy-{cfg}.json").write_text(
            json.dumps(toy_config(cfg)))
    for name, t in TOY_TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    pairs = [("toy-casdiffmvs-dtu", "batch2"), ("toy-diffmvs-dtu", "batch2"),
             ("toy-casdiffmvs-dtu", "request1"),
             ("toy-casdiffmvs-dtu", "train2")]
    for cfg, mix in pairs:
        cells.append({"name": f"{cfg}.{mix}", "config": cfg,
                      "traffic": mix, "chips": 1, "why": "toy"})
        if limits is not None:
            (root / "limits" / f"{cfg}.{mix}.json").write_text(
                json.dumps(limits[TOY_TRAFFIC[mix]["kind"]]))
    names = {real_name: toy["name"] for real_name, toy in zip(
        [w["name"] for w in real["workloads"]], cells)}
    doc = copy.deepcopy(real)
    doc["workloads"] = cells
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[w] for w in m["workloads"]]
    return doc


def cell(root: Path, doc, name: str):
    return manifest.Cell(doc, name, here=root)
