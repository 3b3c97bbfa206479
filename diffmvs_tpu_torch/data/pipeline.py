"""Host-side batching through a torch DataLoader.

Counterpart of diffmvs_tpu/data/pipeline.py:DataPipeline. The batches are
the JAX package's: `_collate` stacks the dataset's numpy samples into
{"imgs": uint8 [B, V, H, W, 3], "proj_matrices": {stage1..4:
[B, V, 2, 4, 4]}, "depth_values": [B, ND], "filename": [str]}, and the
arrays then become CPU tensors (so the DataLoader can pin them), in the
same order: shuffling draws numpy's RandomState(seed + epoch) permutation,
as the JAX pipeline does.

num_workers=0 loads in the calling process; num_workers > 0 runs that many
spawned worker processes (fork is unsafe in a process with threads, such
as one that has started CUDA; a spawned worker pays a fresh import of
torch, a few seconds, once per pipeline iteration). Workers run only the
dataset's __getitem__ (PIL, numpy, the native JPEG loader) and the
collate: they never touch CUDA. pin_memory=True (the CLI asks for it when
the device is CUDA) pins each batch in page-locked memory, so its upload
to the card can run asynchronously.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler


def _collate(samples: Sequence[dict]) -> dict:
    """Stack a list of dataset samples into a batch (numpy)."""
    out = {}
    first = samples[0]
    for key, value in first.items():
        if isinstance(value, dict):
            out[key] = {k: np.stack([s[key][k] for s in samples])
                        for k in value}
        elif isinstance(value, str):
            out[key] = [s[key] for s in samples]
        else:
            out[key] = np.stack([s[key] for s in samples])
    return out


def collate(samples: Sequence[dict]) -> dict:
    """_collate, with every array as a CPU tensor (strings stay lists)."""
    def to_tensor(v):
        if isinstance(v, dict):
            return {k: to_tensor(x) for k, x in v.items()}
        return v if isinstance(v, list) else torch.from_numpy(v)
    return to_tensor(_collate(samples))


class EpochShuffle(Sampler):
    """Indices in numpy's RandomState(seed + epoch) order, one epoch per
    iteration (the JAX pipeline's shuffle)."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return self.n

    def __iter__(self):
        order = np.arange(self.n)
        np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        return iter(order.tolist())


def _worker_init(_):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)


class DataPipeline:
    """Iterable over collated host batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0, pin_memory: bool = False):
        kwargs = {}
        if num_workers > 0:
            kwargs = dict(multiprocessing_context=mp.get_context("spawn"),
                          worker_init_fn=_worker_init)
        self.loader = DataLoader(
            dataset, batch_size=batch_size,
            sampler=EpochShuffle(len(dataset), seed) if shuffle else None,
            drop_last=drop_last, num_workers=num_workers,
            collate_fn=collate, pin_memory=pin_memory, **kwargs)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)
