"""Where the bench entry's training chains spread: each chain of the
training line (bf16 + remat, B = 4, 512x640, 48/384, 4 steps) timed on
the card's and the host's clock, step by step, with Python's garbage
collections, the process's CPU time, the caching allocator's counters
and a metronome (a fixed pure-Python loop timed before and after the
chain: the host core's speed) beside it.

    python3 -m diffmvs_tpu_torch.tools.chain_spread [--chains 8]
        [--gc on,off,on,off] [--device cuda|cpu]

One warm-up chain, then for each entry of --gc (on: the collector as
Python runs it; off: gc.collect() before the chain, the collector
disabled inside its window, as timeit times) --chains timed chains.
Prints one JSON line a chain and one a --gc entry (median card seconds
a step and the spread (max - min) / median over its chains), then one
over all chains: the correlation of card seconds with the seconds the
host took to issue the chain's steps, with CPU seconds and with the
metronome; the issue time's share of the card's (min, max), the card's
seconds left after the last step was issued, CPU seconds over issue
seconds, and the seconds of a step (min, median, max); then the card's
name and power limit. --device cpu runs
bench's CPU smoke configuration (host clock only).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import time
from collections import Counter

import torch

from diffmvs_tpu_torch import bench


class GcLog:
    """Durations of the collections Python runs, by generation, while
    registered (a context manager)."""

    def __init__(self):
        self.events, self._t0 = [], None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.events.append((info["generation"],
                                time.perf_counter() - self._t0))
            self._t0 = None

    def take(self):
        out, self.events = self.events, []
        return out


def metronome(n: int = 200_000) -> float:
    """Seconds of a fixed pure-Python loop: the host core's speed now."""
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i * i
    return time.perf_counter() - t0


def allocator(dev):
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {k: s.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc",
                                     "num_device_free")}


def timed_chain(state, cfg, batch, reps, dev, gc_on, gclog):
    """One chain of `reps` train steps, as bench.train_chain runs it, with
    an event after each step."""
    from diffmvs_tpu_torch.train.step import train_step

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tick = metronome()
    cuda = dev.type == "cuda"
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(reps + 1)] if cuda else []
    host_steps = []
    if not gc_on:
        gc.collect()
        gc.disable()
    try:
        gclog.take()
        alloc0 = allocator(dev)
        cpu0, t0 = time.process_time(), time.perf_counter()
        if cuda:
            events[0].record()
        acc = torch.zeros((), device=dev)
        for i in range(reps):
            ts = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(i)
            scalars, _ = train_step(state, cfg, batch, generator=gen)
            acc = acc + scalars["loss"].detach()
            if cuda:
                events[i + 1].record()
            host_steps.append(time.perf_counter() - ts)
        acc.item()
        host = time.perf_counter() - t0
        cpu = time.process_time() - cpu0
    finally:
        gc.enable()
    tick = (tick + metronome()) / 2
    collections = gclog.take()
    alloc1 = allocator(dev)
    card_steps = [events[i].elapsed_time(events[i + 1]) / 1e3
                  for i in range(reps)] if cuda else []
    return {
        "gc": "on" if gc_on else "off",
        "card_s": sum(card_steps) if cuda else None,
        "host_s": host,
        "card_s_steps": card_steps,
        "host_s_steps": host_steps,
        "cpu_s": cpu,
        "metronome_s": tick,
        "gc_collections": dict(sorted(Counter(
            g for g, _ in collections).items())),
        "gc_s": sum(d for _, d in collections),
        "gc_gen2_s": sum(d for g, d in collections if g == 2),
        "allocator": {k: alloc1[k] - alloc0[k] for k in alloc0},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--gc", default="on,off,on,off",
                    help="comma-separated on / off, a set of chains each")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from diffmvs_tpu_torch.api import resolve_device
    from diffmvs_tpu_torch.config import TrainConfig
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import batch_to_device

    modes = args.gc.split(",")
    if any(m not in ("on", "off") for m in modes):
        raise SystemExit(f"--gc {args.gc!r}: on / off entries")
    dev = resolve_device(args.device)
    model_cfg, shape = bench.train_config(dev.type)
    cfg = TrainConfig(model=model_cfg, batch_size=shape.batch)
    state = create_train_state(cfg, steps_per_epoch=100, device=dev, seed=0)
    batch = batch_to_device(
        bench.train_batch(shape.batch, shape.h, shape.w, shape.numdepth), dev)
    with GcLog() as gclog:
        measure(state, cfg, batch, shape, dev, modes, args.chains, gclog)
    print(bench.card_name(dev), flush=True)


def measure(state, cfg, batch, shape, dev, modes, chains, gclog):
    """The warm-up chain, then `chains` timed chains for each mode."""
    bench.train_chain(state, cfg, batch, shape.reps).item()     # warm-up
    print(json.dumps({"threads": torch.get_num_threads(),
                      "cpus": len(os.sched_getaffinity(0)),
                      "gc_threshold": gc.get_threshold(),
                      "gc_objects": len(gc.get_objects())}), flush=True)
    every = []
    for k, mode in enumerate(modes):
        rows = []
        for c in range(chains):
            row = timed_chain(state, cfg, batch, shape.reps, dev,
                              mode == "on", gclog)
            rows.append(row)
            print(json.dumps({"set": k, "chain": c, **row}), flush=True)
        per = [(r["card_s"] if r["card_s"] is not None else r["host_s"])
               / shape.reps for r in rows]
        med = statistics.median(per)
        print(json.dumps({
            "set": k, "gc": mode, "chains": len(rows),
            "s_per_step_median": med,
            "spread": (max(per) - min(per)) / med,
            "slowest_chain": per.index(max(per)),
            "samples_per_s": shape.batch / med,
            "gc_s_per_chain": [r["gc_s"] for r in rows]}), flush=True)
        every += rows
    clock = [r["card_s"] if r["card_s"] is not None else r["host_s"]
             for r in every]
    issue = [sum(r["host_s_steps"]) for r in every]
    steps = [s for r in every for s in (r["card_s_steps"]
                                        or r["host_s_steps"])]

    def span(xs):
        return [min(xs), max(xs)]

    def corr(xs, ys):
        # statistics.correlation rounds past +-1 (two chains: ~1 in 10)
        return max(-1.0, min(1.0, statistics.correlation(xs, ys)))

    print(json.dumps({
        "chains": len(every),
        "corr_s_issue_s": corr(clock, issue),
        "corr_s_cpu_s": corr(clock, [r["cpu_s"] for r in every]),
        "corr_s_metronome_s": corr(clock,
                                   [r["metronome_s"] for r in every]),
        "issue_share": span([i / c for i, c in zip(issue, clock)]),
        "after_issue_s": span([c - i for i, c in zip(issue, clock)]),
        "cpu_per_issue": span([r["cpu_s"] / i
                               for r, i in zip(every, issue)]),
        "step_s": [min(steps), statistics.median(steps), max(steps)]}),
        flush=True)


if __name__ == "__main__":
    main()
