"""A toy benchmark beside the real one, for the CPU tests: the real
configurations' models at a few dozen pixels, the real traffic kinds at
small batches, and the real metric readers (linked, not copied). It is
derived from the real BENCHMARK.json, so every real configuration and
cell has its toy with no edit here."""

from __future__ import annotations

import copy
import json
from math import prod
from pathlib import Path

from mvsbench import manifest

REAL = manifest.HERE
TOY_HW = [64, 96]


def toy_config(name: str, real_dir: Path = REAL):
    c = manifest.read_json(real_dir / "configs" / f"{name}.json")
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
TOY_MIX = {t["kind"]: mix for mix, t in TOY_TRAFFIC.items()}


def toy_pair(w, real_dir: Path = REAL):
    """(toy configuration, toy mix) of a real cell: its configuration's toy
    under the toy mix of its traffic's kind."""
    kind = manifest.read_json(
        real_dir / "traffic" / f"{w['traffic']}.json")["kind"]
    return f"toy-{w['config']}", TOY_MIX[kind]


def names(real, real_dir: Path = REAL):
    """{real cell: toy cell}, the toy cell named toy-<config>.<toy mix>.
    Real cells of one configuration and traffic kind share a toy."""
    return {w["name"]: "{}.{}".format(*toy_pair(w, real_dir))
            for w in real["workloads"]}


def write(root: Path, limits=None, real=None, real_dir: Path = REAL):
    """A benchmark directory at root (configs/, traffic/, limits/ and a
    link to the real metrics/) and its manifest: a copy of the real
    BENCHMARK.json (`real`, the repository's when None) with a
    toy configuration for each real one and a toy cell for each distinct
    toy of a real cell, each metric's cells mapped to their toys."""
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    (root / "metrics").symlink_to(REAL / "metrics")
    if real is None:
        real = manifest.load()
    for c in real["configs"]:
        (root / "configs" / f"toy-{c['name']}.json").write_text(
            json.dumps(toy_config(c["name"], real_dir)))
    for name, t in TOY_TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    cells = {}
    for w in real["workloads"]:
        cfg, mix = toy_pair(w, real_dir)
        name = f"{cfg}.{mix}"
        cells[name] = {"name": name, "config": cfg, "traffic": mix,
                       "chips": 1, "why": "toy"}
        if limits is not None:
            (root / "limits" / f"{name}.json").write_text(
                json.dumps(limits[TOY_TRAFFIC[mix]["kind"]]))
    doc = copy.deepcopy(real)
    doc["workloads"] = list(cells.values())
    toys = names(real, real_dir)
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(dict.fromkeys(
                toys[w] for w in m["workloads"]))
    return doc


def cell(root: Path, doc, name: str):
    return manifest.Cell(doc, name, here=root)
