"""Each per-layer metric's reader at toy shapes: a Record as a window
leaves it, with a trace built from known kernels and spans."""

import types

import pytest
import torch

from mvsbench import manifest
from mvsbench.drive import Record
from mvsbench.roofline import counts
from mvsbench.trace import Spans, Trace

DOC = manifest.load()
CAS = manifest.read_json(manifest.HERE / "configs" / "casdiffmvs-dtu.json")
CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def event(name, start, end, device=CUDA):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(
                                     start=start, end=end))


class FakeProf:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def record(kind, batch, hw, units=5, traced=range(1, 3)):
    rec = Record(kind, batch, hw, 5, config=CAS)
    rec.units, rec.first, rec.traced = units, 0, traced
    rec.unit_s = [0.5] * units
    rec.window_s = sum(rec.unit_s)
    # 2 traced units over 1000 us: K1 100 us, K2 50 us, a conv 400 us,
    # idle 450 us, of which a 300 us gap while the host was in "issue"
    rec.trace = Trace(FakeProf([
        event("mvsbench.traced", 0, 1000, CPU),
        event("mvsbench.issue", 100, 700, CPU),
        event("mvsbench.issue", 100, 700),      # its annotation on the card
        event("void warp_geom::corr_kernel<sweepsamples>", 0, 100),
        event("sm90_xmma_fprop_implicit_gemm_bf16", 100, 400),
        event("warp_corr_bwd_kernel", 700, 750),
        event("cudnn::conv_kernel", 750, 850),
    ]), len(traced))
    return rec


def read(name, rec):
    cell = manifest.Cell(DOC, DOC["workloads"][0]["name"])
    return cell.reader(name)(rec)


def test_trace_reduction():
    rec = record("batch", 16, (1152, 1600))
    t = rec.trace
    assert t.window_s == pytest.approx(1000e-6)
    assert t.busy_s == pytest.approx(550e-6)
    assert t.group("convolution") == pytest.approx(0.4)
    longest = max(t.gaps)
    assert longest[0] == pytest.approx(300e-6) and longest[1] == "issue"
    bd = t.breakdown()
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_idle_and_conv():
    rec = record("batch", 16, (1152, 1600))
    for name in ("idle_pct.infer", "idle_pct.request", "idle_pct.train"):
        assert read(name, rec) == pytest.approx(45.0)
    assert read("conv_ms_per_map.infer", rec) == pytest.approx(0.4 / 32)


def test_mfu_and_rooflines():
    rec = record("batch", 16, (1152, 1600))
    rate = 16 * 3 / 1.5                     # 3 untraced units of 0.5 s
    assert read("mfu.infer", rec) == pytest.approx(
        100 * CAS["flops_per_map"] * rate / 989e12)
    bound = counts.k1_bound_ms(CAS["model"], 16, (1152, 1600), 5)
    assert read("k1_roofline", rec) == pytest.approx(100 * bound * 2 / 0.1)
    train = record("train", 4, (512, 640))
    bound = counts.k2_bound_ms(CAS["model"], 4, (512, 640), 5)
    assert read("k2_roofline", train) == pytest.approx(100 * bound * 2 / 0.05)
    flops = CAS["flops_per_map"] * 512 * 640 / (1152 * 1600)
    assert read("mfu.train", train) == pytest.approx(
        100 * 3 * flops * (4 * 3 / 1.5) / 989e12)


def test_entry_spans():
    rec = record("request", 1, (1152, 1600))
    rec.spans = Spans()
    rec.spans.seconds["call"] = [9.0, 9.0] + [0.1, 0.2, 0.2, 0.3, 0.3]
    assert read("issue_ms.request", rec) == pytest.approx(1e3 * 0.7 / 3)
    train = record("train", 4, (512, 640))
    train.spans = Spans()
    train.spans.seconds["step"] = [1.0] * 3 + [0.4] * 5
    assert read("issue_ratio.train", train) == pytest.approx(0.8)


def test_nothing_to_read():
    rec = record("batch", 16, (1152, 1600))
    rec.trace = None
    for m in DOC["per_layer"]:
        if m["name"].startswith(("idle", "conv", "k1", "k2")):
            assert read(m["name"], rec) is None


def test_host_readings_on_the_cpu():
    """The host's readings around a window: positive speeds, and the
    window's own CPU and garbage-collector seconds."""
    import gc

    from mvsbench import host

    got = host.probe(torch.device("cpu"))
    assert got["copy_gbps"] > 0 and got["py_ms"] > 0
    use = host.Usage().start()
    gc.collect()
    out = use.stop()
    assert out["gc_collections"] >= 1 and out["gc_s"] >= 0
    assert out["wall_s"] > 0 and out["cpu_s"] >= 0 and out["cpus"] >= 1
    assert use._on_gc not in gc.callbacks
