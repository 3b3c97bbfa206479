"""The three kinds of traffic a mix file can name, driven through the
program's own entries:

  batch    closed loop of DepthRunner.__call__ on B view-sets resident on
           the card, at most IN_FLIGHT forwards queued;
  request  one client, closed loop: DepthRunner.__call__ on one view-set
           of a pool in host memory, its depth and confidences copied
           back to host memory, timed on the host's clock;
  train    train.step.train_step on batches of a pool in pinned host
           memory (the step uploads its batch), at most IN_FLIGHT
           steps queued; the first `checked_steps` steps run in set-up
           and are the ones the check follows.

Each unit (forward, request or step) draws its noise from a generator
seeded with inputs.unit_seed(seed, unit). Set-up warms up every shape
the window uses (inference: WARMUP_UNITS units); the window then runs units until --seconds have passed
on the host's clock, and its time is the card's, from an event before
the first unit to the event after the last. `fault` plants one of the
faults the check has to catch; runs never set it (tests and calibrate.py
do).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import torch

from mvsbench import inputs as I
from mvsbench.host import Usage
from mvsbench.trace import Spans, Trace

clock = time.perf_counter
FAULTS = ("half_batch", "altered", "unchanged")
IN_FLIGHT = 2       # units queued on the card in the batch and train kinds
WARMUP_UNITS = 2    # inference units of set-up


class Stamp:
    """A point on the card's clock (a CUDA event), or on the host's off
    the card (the tests' CPU runs)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.ev = torch.cuda.Event(enable_timing=True) if self.cuda else None
        self.t = None

    def record(self):
        if self.cuda:
            self.ev.record()
        else:
            self.t = clock()
        return self

    def wait(self):
        if self.cuda:
            self.ev.synchronize()

    def seconds_to(self, later: "Stamp") -> float:
        if self.cuda:
            return self.ev.elapsed_time(later.ev) / 1e3
        return later.t - self.t


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_config(config: Dict, remat: bool = False):
    """The program's ModelConfig for a configuration file."""
    from diffmvs_tpu_torch.config import ModelConfig

    model = {k: tuple(v) if isinstance(v, list) else v
             for k, v in config["model"].items()}
    model["remat"] = remat
    return ModelConfig(**model)


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers and the check."""
    kind: str
    batch: int
    hw: tuple
    views: int
    units: int = 0                       # units in the window
    window_s: float = 0.0                # the card's seconds of the window
    unit_s: List[float] = dataclasses.field(default_factory=list)
    first: int = 0                       # the window's first unit
    traced: range = range(0)
    trace: Optional[Trace] = None
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_setup: int = 0
    peak_window: int = 0
    config: Dict = dataclasses.field(default_factory=dict)
    host: Dict = dataclasses.field(default_factory=dict)   # host.py

    def untraced(self):
        """Indices (into the window's units) of the units outside the
        profiled ones."""
        return [k for k in range(self.units)
                if self.first + k not in self.traced]

    def untraced_rate(self) -> float:
        """Rows (maps or samples) a second of the card's time, over the
        window's units outside the profiled ones."""
        ks = self.untraced()
        return self.batch * len(ks) / sum(self.unit_s[k] for k in ks)


class Load:
    first = 0
    in_flight = IN_FLIGHT

    def __init__(self, cell, seed: int, dev, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.cell, self.seed, self.dev, self.fault = cell, seed, dev, fault
        self.config, self.traffic = cell.config, cell.traffic
        t = self.traffic
        self.rec = Record(t["kind"], t["batch"],
                          tuple(t.get("image_hw", self.config["image_hw"])),
                          self.config["views"], config=self.config)
        self.kept = {}

    @contextlib.contextmanager
    def timed(self, part: str):
        """A part of set-up, its seconds in setup_parts (the card's work
        included)."""
        t0 = clock()
        yield
        sync(self.dev)
        parts = self.rec.setup_parts
        parts[part] = parts.get(part, 0.0) + clock() - t0

    def build(self):
        """The program's kernels: nvcc on a fresh checkout, else loaded
        from its build directory inside the checkout."""
        if self.dev.type == "cuda":
            with self.timed("build_s"):
                from diffmvs_tpu_torch.ops import warp_corr
                warp_corr.build()

    def generator(self, i: int):
        return torch.Generator(device=self.dev).manual_seed(
            I.unit_seed(self.seed, i))

    def release(self):
        for name in ("runner", "inputs", "pool", "state"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


class InferLoad(Load):
    """batch and request: DepthRunner.__call__ in export mode."""

    def setup(self):
        from diffmvs_tpu_torch.api import DepthRunner

        self.build()
        t = self.traffic
        self.samples = I.sample(self.seed, t["sample"]["units"],
                                t["sample"]["answers"], t["batch"])
        with self.timed("weights_s"):
            sd = I.make_weights(self.config, self.seed, self.dev)
            self.runner = DepthRunner(program_config(self.config),
                                      state_dict=sd, device=self.dev)
            del sd
        with self.timed("inputs_s"):
            self.make_inputs()
        with self.timed("warmup_s"):
            for w in range(WARMUP_UNITS):
                self.unit(-1 - w)

    def answer(self, i, depth, confs):
        """Keep unit i's sampled answers (with a planted fault, as it
        would leave them)."""
        rows = [r for u, r in self.samples if u == i]
        if not rows:
            return
        b = depth.shape[0]
        for r in rows:
            src = r - b // 2 if self.fault == "half_batch" and r >= b // 2 \
                else r
            self.kept[(i, r)] = (torch.as_tensor(depth[src]).clone(),
                                 [torch.as_tensor(c[src]).clone()
                                  for c in confs])

    def noise_index(self, i):
        return i + 1 if self.fault == "altered" else i


class BatchLoad(InferLoad):
    def make_inputs(self):
        self.inputs = I.viewsets(self.config, self.traffic["batch"],
                                 self.seed, self.dev)

    def unit(self, i):
        depth, confs = self.runner(*self.inputs,
                                   generator=self.generator(
                                       self.noise_index(i)))
        self.answer(i, depth, confs)


class RequestLoad(InferLoad):
    in_flight = 0       # each request waits for its answers

    def make_inputs(self):
        self.pool = []
        for j in range(self.traffic["pool"]):
            imgs, projs, dv = I.viewsets(self.config, 1, self.seed, self.dev,
                                         index=j)
            self.pool.append((imgs.cpu().numpy(),
                              {k: v.cpu().numpy() for k, v in projs.items()},
                              dv.cpu().numpy()))

    def unit(self, i):
        imgs, projs, dv = self.pool[i % len(self.pool)]
        spans = self.rec.spans
        t0 = clock()
        with spans("call"):
            depth, confs = self.runner(imgs, projs, dv,
                                       generator=self.generator(
                                           self.noise_index(i)))
        with spans("download"):
            depth = depth.cpu().numpy()
            confs = [c.cpu().numpy() for c in confs]
        if i >= 0:
            self.rec.latencies_s.append(clock() - t0)
        self.answer(i, depth, confs)


class TrainLoad(Load):
    def setup(self):
        from diffmvs_tpu_torch.config import TrainConfig
        from diffmvs_tpu_torch.train.state import create_train_state

        self.build()
        c, t = self.config, self.traffic
        tr = c["train"]
        self.train_cfg = TrainConfig(
            model=program_config(c, remat=tr["remat"]), batch_size=t["batch"],
            lr=tr["lr"], lr_sche=tr["lr_sche"], epochs=tr["epochs"],
            weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"],
            loss_rate=tr["loss_rate"], conf_weight=tr["conf_weight"])
        with self.timed("weights_s"):
            sd = I.make_weights(c, self.seed, self.dev)
            self.state = create_train_state(
                self.train_cfg, steps_per_epoch=t["steps_per_epoch"],
                device=self.dev, state_dict=sd)
            del sd
        with self.timed("inputs_s"):
            self.pool = [I.to_pinned(I.train_batch(c, t, self.seed, j,
                                                   self.dev))
                         for j in range(t["pool"])]
        self.first = t["checked_steps"]
        with self.timed("warmup_s"):
            self.checked_steps()

    def named(self):
        return dict(self.state.model.named_parameters())

    def checked_steps(self):
        """The steps the check follows, through the window's own call:
        their losses, the first gradient as AdamW holds it after step 1,
        and the parameters' change after the last."""
        params = self.named()
        start = {k: p.detach().clone() for k, p in params.items()}
        if self.fault == "unchanged":
            opt = self.state.optimizer.state_dict()
        losses = []
        for i in range(self.first):
            losses.append(self.unit(i))
            if i == 0:
                beta1 = self.state.optimizer.param_groups[0]["betas"][0]
                st = self.state.optimizer.state
                self.first_grads = norms({
                    k: st[p]["exp_avg"] / (1.0 - beta1) if p in st
                    else torch.zeros_like(p) for k, p in params.items()})
        if self.fault == "unchanged":
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(start[k])
            self.state.optimizer.load_state_dict(opt)
        self.losses = [float(x) for x in losses]
        self.changes = norms({k: p.detach() - start[k]
                              for k, p in params.items()})

    def unit(self, i):
        from diffmvs_tpu_torch.train.step import train_step

        batch = self.pool[i % len(self.pool)]
        if self.fault == "half_batch":
            batch = half_rows(batch)
        with self.rec.spans("step"):
            scalars, _ = train_step(self.state, self.train_cfg, batch,
                                    generator=self.generator(i))
        return scalars["loss"].detach()


def half_rows(tree):
    if isinstance(tree, dict):
        return {k: half_rows(v) for k, v in tree.items()}
    return tree[: tree.shape[0] // 2]


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The float64 norm of each leaf, read back once."""
    keys = list(tree)
    vals = torch.stack([torch.linalg.vector_norm(tree[k].double())
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


LOADS = {"batch": BatchLoad, "request": RequestLoad,
           "train": TrainLoad}


def load_for(cell, seed, dev, fault=None) -> Load:
    return LOADS[cell.traffic["kind"]](cell, seed, dev, fault)


def run_window(drv: Load, seconds: float, trace: bool):
    """The measured window: units from drv.first until `seconds` have
    passed; with trace, torch.profiler over `trace_units` of them (from
    the window's second unit), inside a "traced" span."""
    rec, dev = drv.rec, drv.dev
    in_flight = drv.in_flight
    if trace:
        rec.traced = range(drv.first + 1,
                           drv.first + 1 + drv.traffic["trace_units"])
    prof, stack = None, contextlib.ExitStack()
    stamps: List[Stamp] = []
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    usage = Usage().start()
    start = Stamp(dev).record()
    t0 = clock()
    i = drv.first
    while clock() - t0 < seconds or i < rec.traced.stop:
        if in_flight and len(stamps) >= in_flight:
            with rec.spans("wait"):
                stamps[-in_flight].wait()
        if rec.traced and i == rec.traced.start:
            sync(dev)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            rec.spans.traced = True
            stack.enter_context(rec.spans("traced"))
        with rec.spans("issue"):
            drv.unit(i)
        stamps.append(Stamp(dev).record())
        if rec.traced and i == rec.traced.stop - 1:
            sync(dev)
            stack.close()
            prof.stop()
            rec.spans.traced = False
        i += 1
    sync(dev)
    rec.host["window"] = usage.stop()
    rec.units = len(stamps)
    rec.window_s = start.seconds_to(stamps[-1])
    rec.unit_s = [a.seconds_to(b) for a, b in zip([start] + stamps, stamps)]
    if dev.type == "cuda":
        rec.peak_window = torch.cuda.max_memory_allocated(dev)
    if prof is not None:
        rec.trace = Trace(prof, len(rec.traced))
    # answers the check samples beyond the window's last unit: due, so
    # produced now, outside the window
    for j in range(i, 1 + max((u for u, _ in getattr(drv, "samples", [])),
                              default=-1)):
        drv.unit(j)
    sync(dev)
