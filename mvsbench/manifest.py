"""BENCHMARK.json and the files it names: a cell's configuration
(mvsbench/configs/<config>.json), its traffic mix
(mvsbench/traffic/<traffic>.json), its limits
(mvsbench/limits/<cell>.json) and the readers of its per-layer metrics
(mvsbench/metrics/<metric>.py). Everything is found by name, so a new
configuration, mix or metric is a new file and a new entry."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell:
    """One entry of BENCHMARK.json's workloads, with what it names."""

    def __init__(self, manifest: Dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.here = here
        self.config = read_json(here / "configs" / f"{self.entry['config']}.json")
        self.traffic = read_json(here / "traffic" / f"{self.entry['traffic']}.json")
        limits = here / "limits" / f"{name}.json"
        self.limits = read_json(limits) if limits.exists() else {}
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def reader(self, metric: str):
        """The read(run) function of mvsbench/metrics/<metric>.py."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"mvsbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")

