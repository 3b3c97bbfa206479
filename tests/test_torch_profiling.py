"""PyTorch port: the tracing registry (utils/profiling.py) and its spans in
the program: nesting, parents and units; thread-local stacks; counters
and the collector's runs credited to the innermost span; the spans'
ranges under torch.profiler on the CPU and their place on its timeline;
the ring's bound; the spans of DepthRunner.__call__, train_step (with
remat) and the export CLI; the warp kernels' launch counters read
through the registry; tools/profile_main.py's span table and gap labels.
"""

import dataclasses
import gc
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch import api
from diffmvs_tpu_torch.cli import test as tcli
from diffmvs_tpu_torch.ops import warp_corr
from diffmvs_tpu_torch.ops.correlation import warp_and_correlate_plain
from diffmvs_tpu_torch.tools import profile_main
from diffmvs_tpu_torch.train.state import create_train_state
from diffmvs_tpu_torch.train.step import train_step
from diffmvs_tpu_torch.utils import profiling
from diffmvs_tpu_torch.utils.synthetic import (synthetic_inputs,
                                               synthetic_train_batch)

from test_cli_e2e import _make_scene

SMALL = dict(numdepth_initial=8, numdepth=32)


class FakeClock:
    """A clock that moves only when told to (ns)."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t

    def advance(self, ns):
        self.t += ns


@pytest.fixture
def registry(monkeypatch):
    """A fresh registry in the module's place (the real clock)."""
    reg = profiling.Registry()
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    return reg


def tree(unit):
    return [(s.name, s.parent.name if s.parent else None)
            for s in unit.spans]


def test_nesting_parents_units_and_totals(monkeypatch):
    clock = FakeClock()
    reg = profiling.Registry(clock=clock, profiling=lambda: False)
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    for _ in range(2):
        with profiling.span("call") as call:
            clock.advance(10)
            with profiling.span("upload"):
                clock.advance(30)
            with profiling.span("forward"):
                clock.advance(100)
                with profiling.span("stage"):
                    clock.advance(50)
            clock.advance(5)
    first, second = profiling.units("call")
    assert second.id == first.id + 1
    assert tree(first) == tree(second) == [
        ("call", None), ("upload", "call"), ("forward", "call"),
        ("stage", "forward")]
    assert {s.unit.id for s in second.spans} == {second.id}
    assert call.ns == 195 and call.seconds == pytest.approx(195e-9)
    assert second.host_ms("forward") == pytest.approx(150e-6)
    assert second.host_ms("nothing") is None
    tot = profiling.totals()
    assert tot["call"]["count"] == 2
    assert tot["call"]["host_ms"] == pytest.approx(2 * 195e-6)
    assert tot["call"]["self_ms"] == pytest.approx(2 * 15e-6)
    assert tot["forward"]["self_ms"] == pytest.approx(2 * 100e-6)
    assert tot["stage"]["self_ms"] == tot["stage"]["host_ms"]
    # without the profiler a span takes no device time
    assert second.device_ms("stage") is None
    assert not second.profiled


class Doubled(torch.autograd.Function):
    """x * 2, whose backward runs `work` (as a kernel's backward counts
    its launches, or remat recomputes under autograd's engine)."""

    @staticmethod
    def forward(ctx, x, work):
        ctx.work = work
        return x * 2

    @staticmethod
    def backward(ctx, g):
        ctx.work()
        return g * 2, None


def run_in_thread(target):
    t = threading.Thread(target=target)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def test_thread_local_stacks(registry):
    """A thread with no span open that runs a backward pass (autograd's
    engine) works under the one open span that lends itself; its own
    spans nest on its own stack. Any other thread with no span open
    starts units of its own."""
    seen = {}

    def work():
        seen["innermost"] = registry.innermost()
        profiling.count("k2")
        with profiling.span("recompute") as sp:
            profiling.count("k1")
            seen["stack"] = list(registry.stack())
        seen["span"] = sp

    def backward():
        x = torch.ones(3, requires_grad=True)
        Doubled.apply(x, work).sum().backward()

    with profiling.span("step") as step:
        with profiling.span("step.backward", lend=True) as bwd:
            run_in_thread(backward)
            assert registry.stack() == [step, bwd]
    assert seen["innermost"] is bwd
    assert seen["stack"] == [seen["span"]]
    assert seen["span"].parent is bwd and seen["span"].unit is step.unit
    assert bwd.count("k2") == 1 and seen["span"].count("k1") == 1
    assert tree(step.unit) == [("step", None), ("step.backward", "step"),
                               ("recompute", "step.backward")]
    assert registry.lent == ()
    # outside a backward pass the lending span lends nothing
    with profiling.span("step") as step:
        with profiling.span("step.backward", lend=True) as bwd:
            run_in_thread(work)
    assert seen["innermost"] is None and seen["span"].parent is None
    assert bwd.count("k2") == 0 and tree(step.unit) == [
        ("step", None), ("step.backward", "step")]
    assert profiling.units("recompute")[-1] is seen["span"].unit
    # two backward passes at once: whose is which is not known
    with profiling.span("step.backward", lend=True):
        with profiling.span("step.backward", lend=True):
            run_in_thread(backward)
    assert seen["innermost"] is None and seen["span"].parent is None


@pytest.mark.parametrize("first", ["a", "b"])
def test_overlapping_units_in_two_threads(registry, first):
    """Two threads' requests that overlap are two units, whichever closes
    first, and the units after them still reach the ring."""
    opened = {n: threading.Event() for n in "ab"}
    go = {n: threading.Event() for n in "ab"}
    closed = {n: threading.Event() for n in "ab"}
    units = {}

    def client(name):
        with profiling.span("runner.call") as call:
            with profiling.span("runner.upload"):
                opened[name].set()
                assert go[name].wait(30)
            profiling.count("n")
        units[name] = call.unit
        closed[name].set()

    ts = {n: threading.Thread(target=client, args=(n,)) for n in "ab"}
    ts["a"].start()
    assert opened["a"].wait(30)
    ts["b"].start()
    assert opened["b"].wait(30)
    second = "b" if first == "a" else "a"
    for n in (first, second):
        go[n].set()
        assert closed[n].wait(30)
        ts[n].join(timeout=30)
    assert units["a"] is not units["b"]
    for u in units.values():
        assert tree(u) == [("runner.call", None),
                           ("runner.upload", "runner.call")]
        assert u.count("n") == 1
    kept = profiling.units("runner.call")
    assert kept[-2:] == [units[first], units[second]]
    with profiling.span("runner.call") as later:
        pass
    assert later.parent is None and later.unit.spans == [later]
    assert profiling.units("runner.call")[-1] is later.unit
    assert registry.stack() == []


def test_counters_credit_the_innermost_span(registry):
    profiling.count("outside", 7)
    with profiling.span("call") as call:
        profiling.count("bytes", 3)
        with profiling.span("inner") as inner:
            profiling.count("bytes", 5)
            profiling.count("launch", key=(1, 2))
            profiling.count("launch", key=(1, 2))
            profiling.count("launch", key=(3, 4))
        profiling.count("bytes", 11)
    assert call.count("bytes") == 14 and inner.count("bytes") == 5
    assert call.unit.count("bytes") == 19
    assert profiling.counter("bytes") == 19
    assert profiling.counter("outside") == 7
    assert profiling.counter("launch") == 3
    assert profiling.keyed("launch") == {(1, 2): 2, (3, 4): 1}
    assert profiling.counter("never") == 0 and not profiling.keyed("never")
    profiling.reset_counters("launch")
    assert profiling.counter("launch") == 0 and not profiling.keyed("launch")
    assert profiling.counter("bytes") == 19
    assert inner.count("launch") == 3     # a span keeps its counts


def test_collections_credit_the_span_open(registry):
    enabled = gc.isenabled()
    gc.disable()        # only the two runs asked for
    try:
        with profiling.span("step") as step:
            with profiling.span("step.backward") as bwd:
                gc.collect()
            gc.collect()
    finally:
        if enabled:
            gc.enable()
    assert bwd.count("gc.collections") == 1
    assert step.count("gc.collections") == 1
    assert 0 < bwd.count("gc.ns") <= bwd.ns
    assert step.unit.count("gc.collections") == 2
    assert profiling.counter("gc.collections") >= 2


def test_counters_from_many_threads(registry):
    """More threads than cores, each counting in units of its own at a
    short switch interval, lose no count and no unit."""
    threads, per = 16, 2000

    def worker():
        for _ in range(per // 100):
            with profiling.span("unit"):
                for _ in range(100):
                    profiling.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert profiling.counter("n") == threads * per
    kept = profiling.units("unit")
    assert len(kept) == threads * per // 100
    assert all(u.spans == [u.spans[0]] and u.count("n") == 100
               for u in kept)


def test_ring_keeps_the_last_units(monkeypatch):
    reg = profiling.Registry(profiling=lambda: False)
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    for _ in range(5000):
        with profiling.span("unit"):
            with profiling.span("child"):
                pass
    kept = profiling.units()
    assert len(kept) == profiling.RING == 1024
    assert [u.id for u in kept] == list(range(5000 - 1024, 5000))
    assert all(len(u.spans) == 2 for u in kept)
    assert profiling.totals()["child"]["count"] == 5000


def _ancestor(ev):
    """The nearest diffmvs.* range enclosing a profiler event."""
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(profiling.PREFIX):
        p = p.cpu_parent
    return p


def test_spans_under_the_profiler(registry):
    """Under torch.profiler the spans are diffmvs.* ranges nested as the
    tree kept in memory, a span given a device takes its host time as its
    device time (the CPU), and on_timeline puts a span within 50 us of
    its range."""
    x = torch.randn(64, 64)
    with pytest.raises(RuntimeError, match="no span"):
        profiling.on_timeline(None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("call") as call:
            with profiling.span("upload"):
                y = x + 1
            with profiling.span("forward"):
                with profiling.span("stage", device=torch.device("cpu")):
                    for _ in range(20):
                        y = y @ x
                time.sleep(0.002)
    assert call.unit.profiled
    ranges = [ev for ev in prof.events()
              if ev.name.startswith(profiling.PREFIX)]
    got = sorted((ev.name[len(profiling.PREFIX):],
                  _ancestor(ev).name[len(profiling.PREFIX):]
                  if _ancestor(ev) else None) for ev in ranges)
    assert got == sorted(tree(call.unit))
    stage = call.unit.named("stage")[0]
    assert call.unit.device_ms("stage") == pytest.approx(stage.ns / 1e6)
    assert call.unit.device_ms("upload") is None
    on = profiling.on_timeline(prof)
    for sp in call.unit.spans:
        ev, = [e for e in ranges
               if e.name == profiling.PREFIX + sp.name]
        assert abs(on(sp.start) - ev.time_range.start) < 50
        assert abs(on(sp.end) - ev.time_range.end) < 50


def test_span_cost_off_is_small():
    """With the profiler off a span is two clock reads and a few list
    operations (~3 us here): far under 200 us even on a loaded host, a
    bound that a span opening a range or CUDA events would not keep."""
    reg = profiling.Registry(profiling=lambda: False)
    n = 2000
    t0 = time.perf_counter()
    with profiling.Span(reg, "unit"):
        for _ in range(n):
            with profiling.Span(reg, "span"):
                pass
    assert (time.perf_counter() - t0) / n < 200e-6


def test_upload_counts_pageable_bytes(registry):
    arr = np.ones((2, 3), np.float32)
    with profiling.span("runner.upload") as sp:
        out = api.upload(arr, "cpu")
    assert torch.equal(out, torch.ones(2, 3))
    assert sp.count("upload.pageable_bytes") == 0   # no copy to a card
    t = torch.ones(4)
    assert api.upload(t, "cpu") is t


def test_runner_spans(registry):
    """DepthRunner.__call__ is one unit: its upload, its forward and the
    model's stages inside it, the refinement iterations counted."""
    trees = {}
    for preset in ("casdiffmvs", "diffmvs"):
        runner = api.DepthRunner.from_random(preset, device="cpu", **SMALL)
        imgs, projs, dv = synthetic_inputs(1, 3, 32, 64, 32)
        runner(imgs, projs, dv)
        unit = profiling.units("runner.call")[-1]
        trees[preset] = tree(unit)
        cfg = runner.cfg
        iters = sum(cfg.stage_iters[s] * cfg.sampling_timesteps[s]
                    for s in (1, 2) if cfg.stage_iters[s])
        stages = unit.named("model.stage2") + unit.named("model.stage3")
        assert sum(s.count("refine.iterations") for s in stages) == iters
        assert unit.count("refine.iterations") == iters
    want = [("runner.call", None), ("runner.upload", "runner.call"),
            ("runner.forward", "runner.call"),
            ("model.features", "runner.forward"),
            ("model.stage1", "runner.forward"),
            ("model.stage2", "runner.forward")]
    assert trees["diffmvs"] == want
    assert trees["casdiffmvs"] == want + [("model.stage3", "runner.forward")]


def counted_warp(src, ref, src_pair, ref_pair, depth, groups, x_off=0):
    """The plain warp, counted as the kernels count their launches: a
    forward launch per call, a backward launch when its gradient runs."""
    profiling.count("warp_corr.k1")
    out = warp_and_correlate_plain(src, ref, src_pair, ref_pair, depth,
                                   groups, x_off)
    if out.requires_grad:
        out.register_hook(lambda g: profiling.count("warp_corr.k2"))
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_spans(registry, remat):
    """Every train_step has the same span tree; the forward launches of
    the warp fall under step.forward (and, recomputed under remat, under
    step.backward), its backward launches under step.backward."""
    model = dataclasses.replace(tconfig.CASDIFFMVS, remat=remat, **SMALL)
    cfg = tconfig.TrainConfig(model=model, batch_size=1)
    state = create_train_state(cfg, steps_per_epoch=10, device="cpu",
                               warp=counted_warp)
    batch = synthetic_train_batch(1, 3, 32, 64, 32)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        train_step(state, cfg, batch, gen)
    steps = profiling.units("step")
    assert len(steps) == 3
    want = [("step", None), ("step.upload", "step"),
            ("step.forward", "step"), ("model.features", "step.forward"),
            ("model.stage1", "step.forward"),
            ("model.stage2", "step.forward"),
            ("model.stage3", "step.forward"), ("step.loss", "step"),
            ("step.backward", "step"), ("step.optimizer", "step")]
    assert all(tree(u) == want for u in steps)
    for u in steps:
        by = {s.name: s for s in u.spans}
        fwd = sum(s.count("warp_corr.k1") for s in u.spans
                  if s.name.startswith("model."))
        assert by["step.forward"].count("warp_corr.k1") == 0
        assert fwd > 0 and by["step.backward"].count("warp_corr.k2") > 0
        assert u.count("warp_corr.k2") == by["step.backward"].count(
            "warp_corr.k2")
        recomputed = by["step.backward"].count("warp_corr.k1")
        assert u.count("warp_corr.k1") == fwd + recomputed
        # remat recomputes the refinement iterations' warps, stage 1's not
        refine = sum(by[s].count("warp_corr.k1")
                     for s in ("model.stage2", "model.stage3"))
        assert recomputed == (refine if remat else 0)


def test_export_timings_are_spans(registry, tmp_path):
    scene = tmp_path / "scene"
    scene.mkdir()
    _make_scene(scene, h=32, w=64)
    args = ["--dataset", "general", "--method", "casdiffmvs",
            "--save_depth", "--testpath", str(scene),
            "--outdir", str(tmp_path / "out"), "--device", "cpu",
            "--workers", "0", "--max_h", "32", "--max_w", "64",
            "--numdepth_initial", "4", "--numdepth", "16",
            "--geo_mask_thres", "1", "--geo_pixel_thres", "8",
            "--geo_depth_thres", "0.5", "--photo_thres", "0", "0", "0"]
    out = tcli.main(args)
    exp = out["export"]
    assert set(exp) == {"views", "load_s", "infer_s", "write_s", "batches"}
    assert exp["views"] == 3 and len(exp["batches"]) == 3
    kept = {n: profiling.units(n) for n in ("export.load", "export.infer",
                                            "export.write",
                                            "export.fusion")}
    # one wait a batch, and one more that finds the loader empty
    assert len(kept["export.load"]) == 4
    assert [b["load_s"] for b in exp["batches"]] == [
        u.spans[0].seconds for u in kept["export.load"][:3]]
    for key, name in (("infer_s", "export.infer"),
                      ("write_s", "export.write")):
        assert exp[key] == pytest.approx(
            sum(u.spans[0].seconds for u in kept[name]))
        assert [b[key] for b in exp["batches"]] == [
            u.spans[0].seconds for u in kept[name]]
    assert out["fusion_s"] == kept["export.fusion"][-1].spans[0].seconds
    # a request inside export.infer is part of that unit
    assert [s.name for s in kept["export.infer"][0].spans[:2]] == [
        "export.infer", "runner.call"]


def test_warp_corr_counters_read_the_registry(registry):
    warp_corr.reset_counts()
    assert warp_corr.launches == warp_corr.bwd_launches == 0
    assert not warp_corr.launches_by_shape
    with profiling.span("runner.call") as call:
        profiling.count("warp_corr.k1", key=(48, 144, 200, 32))
        profiling.count("warp_corr.k1", key=(48, 144, 200, 32))
        profiling.count("warp_corr.k2", key=(8, 64, 80, 16))
        profiling.count("warp_corr.k3", key=(8, 64, 80, 16))
        profiling.count("warp_corr.operands")
        profiling.count("warp_corr.projection")
    assert (warp_corr.launches, warp_corr.bwd_launches,
            warp_corr.pre_launches, warp_corr.operand_launches,
            warp_corr.projection_launches) == (2, 1, 1, 1, 1)
    assert warp_corr.launches_by_shape == {(48, 144, 200, 32): 2}
    assert dict(warp_corr.bwd_launches_by_shape) == {(8, 64, 80, 16): 1}
    assert dict(warp_corr.pre_launches_by_shape) == {(8, 64, 80, 16): 1}
    assert call.count("warp_corr.k1") == 2
    with pytest.raises(AttributeError):
        warp_corr.operand_launches_by_shape
    profiling.count("other")
    warp_corr.reset_counts()
    assert warp_corr.launches == 0 and not warp_corr.launches_by_shape
    assert profiling.counter("other") == 1


def test_profile_main_span_table_and_gaps(registry):
    """profile_main's span rows over profiled units, and its gap labels,
    on the CPU (the tool itself needs the card)."""
    x = torch.randn(32, 32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with profiling.span("runner.call"):
                with profiling.span("model.stage2",
                                    device=torch.device("cpu")):
                    profiling.count("refine.iterations", 4)
                    y = x @ x
    units = [u for u in profiling.units() if u.profiled]
    rows = profile_main.span_rows(units)
    assert rows["runner.call"]["calls"] == 1.0
    assert rows["model.stage2"]["counts"] == {"refine.iterations": 4.0}
    assert rows["runner.call"]["device_ms"] is None
    assert rows["model.stage2"]["device_ms"] == pytest.approx(
        statistics.mean(u.spans[1].ns for u in units) / 1e6)
    del y
    # kernels [0, 10] and [30, 40] and [45, 50] (us): gaps of 20 and 5 us
    spans = [(0, 100, "runner.call"), (5, 35, "model.stage1"),
             (41, 60, "model.stage2")]
    kernels = [(0, 10, "k_a"), (30, 40, "k_b"), (45, 50, "k_c")]
    gaps = profile_main.labelled_gaps(kernels, spans)
    assert gaps == [(0.02, "model.stage1", "k_a"),
                    (0.005, "runner.call", "k_b")]
    assert profile_main.labelled_gaps(kernels, [])[0][1] == (
        "outside the program's spans")
    profile_main.print_spans(prof, "request")


def test_profile_main_op_rows():
    """profile_main --ops credits each kernel to the outermost aten
    operator above the CPU event that launched it (the event itself where
    none is), with its input shapes, a request."""
    from types import SimpleNamespace as NS
    cpu = torch.autograd.DeviceType.CPU
    span = NS(name="diffmvs.model.features", cpu_parent=None)
    conv2d = NS(name="aten::conv2d", input_shapes=[[80, 8, 64, 96]],
                cpu_parent=span)
    cudnn = NS(name="aten::cudnn_convolution", input_shapes=[[80, 8]],
               cpu_parent=conv2d)
    launch = NS(name="cudaLaunchKernel", device_type=cpu, cpu_parent=cudnn,
                kernels=[NS(name="xmma_fprop", duration=3000.0)])
    bare = NS(name="cudaMemcpyAsync", device_type=cpu, cpu_parent=span,
              input_shapes=[], kernels=[NS(name="memcpy", duration=500.0)])
    idle = NS(name="aten::relu", device_type=cpu, cpu_parent=None,
              kernels=[])
    rows = profile_main.op_rows([launch, launch, bare, idle], 2, 10)
    assert rows == [(3.0, 1, "xmma_fprop", "aten::conv2d",
                     "[[80, 8, 64, 96]]"),
                    (0.25, 0, "memcpy", "cudaMemcpyAsync", "[]")]
    assert profile_main.op_rows([launch], 1, 0) == []
