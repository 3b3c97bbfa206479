"""Dataset registry (counterpart of diffmvs_tpu/data/registry.py)."""

from __future__ import annotations

import importlib


def find_dataset_def(name: str):
    """The MVSDataset class of diffmvs_tpu_torch.data.<name> (the
    training CLI's --dataset: dtu or blend)."""
    module = importlib.import_module(f"diffmvs_tpu_torch.data.{name}")
    return module.MVSDataset
