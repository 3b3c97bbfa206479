"""The readers of the program's own spans (mvsbench/spans.py and the
metrics that use it): on synthetic units of a registry with a clock of
its own, against a program without the registry, and in the toy cells'
--trace 1 runs, where each reads a number."""

import pytest
import torch

from mvsbench import manifest, run
from mvsbench.drive import Record
from mvsbench.tests import toy
from mvsbench.tests.test_mvsbench_cells import (CELLS, CPU, KIND_LIMITS,
                                                SEED)

from diffmvs_tpu_torch.utils import profiling

DOC = manifest.load()
NEW = {"features_ms_per_map.infer", "coarse_ms_per_map.infer",
       "refine_ms_per_map.infer", "upload_ms.request",
       "model_issue_ms.request", "backward_issue_ms.train", "gc_ms.train"}
MS = 1_000_000


def read(name, rec):
    cell = manifest.Cell(DOC, DOC["workloads"][0]["name"])
    return cell.reader(name)(rec)


class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


@pytest.fixture
def registry(monkeypatch):
    clock = Clock()
    state = {"profiling": False}
    reg = profiling.Registry(clock=clock,
                             profiling=lambda: state["profiling"])
    monkeypatch.setattr(profiling, "REGISTRY", reg)
    return reg, clock, state


def span(clock, name, ms, device=None, inner=()):
    """A span of `ms` host ms holding the spans `inner` makes."""
    with profiling.span(name, device=device):
        for f in inner:
            f()
        clock.t += int(ms * MS)


def test_inference_readers(registry):
    """Two cascade forwards of 16 maps under the profiler, among seven:
    device ms a map by stage; host medians of the rest."""
    _, clock, state = registry
    cpu = torch.device("cpu")
    with profiling.span("runner.call"):     # before the window: not read
        clock.t += 10 ** 9
    for i in range(7):
        state["profiling"] = i in (2, 3)
        span(clock, "runner.call", 1, inner=[
            lambda i=i: span(clock, "runner.upload", 20 + i),
            lambda: span(clock, "runner.forward", 100, inner=[
                lambda: span(clock, "model.features", 160, cpu),
                lambda: span(clock, "model.stage1", 320, cpu),
                lambda: span(clock, "model.stage2", 48, cpu),
                lambda: span(clock, "model.stage3", 32, cpu)])])
    rec = Record("batch", 16, (1152, 1600), 5, units=7)
    assert read("features_ms_per_map.infer", rec) == pytest.approx(10.0)
    assert read("coarse_ms_per_map.infer", rec) == pytest.approx(20.0)
    assert read("refine_ms_per_map.infer", rec) == pytest.approx(5.0)
    rec = Record("request", 1, (1152, 1600), 5, units=7)
    # the untraced requests' uploads: 20, 21, 24, 25, 26 ms
    assert read("upload_ms.request", rec) == pytest.approx(24.0)
    assert read("model_issue_ms.request", rec) == pytest.approx(660.0)


def test_refine_without_a_stage3(registry):
    """DiffMVS has no model.stage3: the refinement is stage 2 alone."""
    _, clock, state = registry
    state["profiling"] = True
    cpu = torch.device("cpu")
    span(clock, "runner.call", 1, inner=[
        lambda: span(clock, "model.stage1", 3, cpu),
        lambda: span(clock, "model.stage2", 4, cpu)])
    rec = Record("batch", 2, (64, 96), 3, units=1)
    assert read("refine_ms_per_map.infer", rec) == pytest.approx(2.0)


def test_training_readers(registry):
    reg, clock, _ = registry

    def collected(ms):
        def f():
            reg.add("gc.collections", 1, None, reg.innermost())
            reg.add("gc.ns", int(ms * MS), None, reg.innermost())
        return f

    for i in range(5):
        span(clock, "step", 1, inner=[
            lambda i=i: span(clock, "step.forward", 200,
                             inner=[collected(i)]),
            lambda i=i: span(clock, "step.backward", 300 + 10 * i,
                             inner=[collected(2 * i + 100 * (i == 4))])])
    rec = Record("train", 4, (512, 640), 5, units=4)
    assert read("backward_issue_ms.train", rec) == pytest.approx(325.0)
    # the last four steps collect 3, 6, 9 and, in a burst, 112 ms: the
    # mean, not the median (7.5)
    assert read("gc_ms.train", rec) == pytest.approx(32.5)


def test_nothing_to_read(registry, monkeypatch):
    """No unit of the kind, no unit under the profiler, no span, or a
    program without the registry: None, and nothing raises."""
    _, clock, _ = registry
    rec = Record("batch", 16, (1152, 1600), 5, units=3)
    for name in NEW:
        assert read(name, rec) is None, name
    span(clock, "runner.call", 5)
    assert read("features_ms_per_map.infer", rec) is None
    assert read("upload_ms.request", rec) is None
    monkeypatch.delattr(profiling, "units")
    span(clock, "runner.call", 5, inner=[
        lambda: span(clock, "runner.upload", 5)])
    for name in NEW:
        assert read(name, rec) is None, name


def test_entries():
    entries = {m["name"]: m for m in DOC["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (manifest.HERE / "metrics" / f"{name}.py").exists()
        assert m["source"] in ("program_span", "program_counter")
        cells = {w["name"]: w for w in DOC["workloads"]}
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in DOC["end_to_end"]
                                  if w in e.get("workloads", [w])]
            assert cells[w]["traffic"] in ("batch16", "request1", "train4")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("toyspans")
    return root, toy.write(root, KIND_LIMITS)


@pytest.mark.parametrize("name", CELLS)
def test_toy_trace_runs_read_every_new_metric(bench, name):
    root, doc = bench
    cell = toy.cell(root, doc, name)
    res = run.measure(cell, SEED, 0.5, True, CPU)
    want = {m["name"] for m in cell.per_layer} & NEW
    assert want, name
    for metric in want:
        assert res["metrics"][metric]["value"] is not None, metric
        assert res["metrics"][metric]["value"] >= 0, metric


@pytest.mark.chip
def test_backward_on_the_card_counts_under_step_backward(card, monkeypatch):
    """On the card autograd's device thread runs the backward pass: K2's
    launches and remat's recomputed K1 launches still count under
    "step.backward", and every step has the same span tree."""
    import dataclasses

    from diffmvs_tpu_torch import config as tconfig
    from diffmvs_tpu_torch.train.state import create_train_state
    from diffmvs_tpu_torch.train.step import train_step
    from diffmvs_tpu_torch.utils.synthetic import synthetic_train_batch

    monkeypatch.setattr(profiling, "REGISTRY", profiling.Registry())
    model = dataclasses.replace(tconfig.CASDIFFMVS, compute_dtype="bfloat16",
                                remat=True, numdepth_initial=8, numdepth=32)
    cfg = tconfig.TrainConfig(model=model, batch_size=1)
    state = create_train_state(cfg, steps_per_epoch=10, device=card)
    batch = synthetic_train_batch(1, 3, 64, 128, 32)
    gen = torch.Generator(device=card).manual_seed(0)
    for _ in range(3):
        train_step(state, cfg, batch, gen)
    torch.cuda.synchronize()
    steps = profiling.units("step")
    assert len(steps) == 3
    assert {u.name for u in profiling.units()} <= {"step", "warp_corr.build"}
    trees = [[(s.name, s.parent.name if s.parent else None)
              for s in u.spans] for u in steps[1:]]
    assert trees[0] == trees[1]
    for u in steps:
        bwd, = u.named("step.backward")
        assert bwd.count("warp_corr.k2") == u.count("warp_corr.k2") > 0
        assert bwd.count("warp_corr.k1") > 0      # remat's recomputation
    assert profiling.counter("warp_corr.k2") == sum(
        u.count("warp_corr.k2") for u in steps)
