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

Two additions to the JAX pipeline:
  * Worker seeding. The DataLoader draws its workers' base seed from a
    torch.Generator seeded with `seed`, and each worker seeds Python's
    `random` (the training datasets' source-view draws) from its own torch
    seed and its rank, so the draws repeat from run to run. The JAX
    pipeline's forked workers all inherit the parent's one `random` state
    instead; with num_workers=0 both draw from the calling process's
    `random`, so the same random.seed gives the same samples.
  * The rank split. batch_size is the GLOBAL batch: with world_size W,
    rank r loads rows [r*B/W, (r+1)*B/W) of each global batch of the one
    order every rank computes alike (EpochShuffle(seed + epoch)), so the
    ranks together load exactly the single-process batches.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import os
import random
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


class RankBatches(Sampler):
    """This rank's rows of each global batch: `order` (a sampler, or
    range(n)) cut into batches of batch_size (a short last one dropped
    with drop_last), and of each, rows [rank*b, (rank+1)*b) with
    b = batch_size // world_size."""

    def __init__(self, order, batch_size: int, drop_last: bool,
                 rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f"batch size {batch_size} does not divide "
                             f"over {world_size} ranks")
        if world_size > 1 and not drop_last:
            raise ValueError("a rank split needs drop_last=True: a short "
                             "last batch would not divide over the ranks")
        self.order = order
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.rank = rank
        self.per_rank = batch_size // world_size

    def __len__(self):
        n = len(self.order)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = list(self.order)
        lo = self.rank * self.per_rank
        for i in range(len(self)):
            rows = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield rows[lo:lo + self.per_rank]


def _worker_init(worker_id, rank=0):
    """Seeds Python's `random` from the worker's torch seed (drawn from
    the loader's seeded generator) and the rank."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    random.seed(f"{torch.utils.data.get_worker_info().seed}:{rank}")


class DataPipeline:
    """Iterable over collated host batches (this rank's rows of each
    global batch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0, pin_memory: bool = False,
                 rank: int = 0, world_size: int = 1):
        kwargs = {}
        if num_workers > 0:
            kwargs = dict(multiprocessing_context=mp.get_context("spawn"),
                          worker_init_fn=functools.partial(_worker_init,
                                                           rank=rank))
        order = (EpochShuffle(len(dataset), seed) if shuffle
                 else range(len(dataset)))
        self.loader = DataLoader(
            dataset, batch_sampler=RankBatches(order, batch_size, drop_last,
                                               rank, world_size),
            num_workers=num_workers, collate_fn=collate,
            pin_memory=pin_memory,
            generator=torch.Generator().manual_seed(seed), **kwargs)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader)
