"""What decides `correct`: the timed path's answers against the plain
reference (mvsbench/reference/), after the window has closed, the peak
has been read and the program's state is freed.

Inference (batch, request): the sampled answers (inputs.sample: (unit,
row) pairs drawn from the seed), each against the reference's float32
answer to the same view-set and noise. Random weights make the depth
maps more or less sensitive to rounding from seed to seed (by ~7x at the
same precision), so each gap is divided by the gap of the reference's
own bfloat16 computation of the same answer, the precision the
configuration states:
  depth_ratio  mean |d - d32| / d32 over the pixels, over the same of the
               bfloat16 reference; the worst sampled answer;
  conf_ratio   the summed mean |c - c32| of the confidence maps, over the
               same of the bfloat16 reference; the worst sampled answer.
Training: the first `checked_steps` steps against the reference's steps
from the same weights, batches and noise:
  loss_gap     |loss - loss32| / |loss32|, the worst step;
  grad_gap     | |g| - |g32| | / max(|g32|, the median leaf's |g32|) of
               the first step's clipped gradient, the median leaf;
  change_gap   the same of the parameters' change over the steps, the
               median leaf of those whose reference gradient is at least
               1e-3 of the median leaf's.
The worst leaf of both is printed beside them and not compared (small
leaves' rounding noise reads 0.1-0.2 there, for the program and for the
plain reference at bfloat16 alike; PERF.md has the look). `drv.leaves`
names the worst leaves and those left out, for calibrate.py.

The reference's float32 is float32 whatever the program set: TF32 is
switched off for cuDNN and for matmuls before it runs.

`control` puts the reference computed at float8 (reference/model.py) in
the program's place: calibrate.py reads it on the card to set the
limits' upper ends.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

from mvsbench import inputs as I
from mvsbench.drive import norms
from mvsbench.reference import model as R
from mvsbench.reference import train as RT


def ratio(a: float, b: float) -> float:
    if b > 0:
        return a / b
    return 0.0 if a == 0 else math.inf


def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def reference(config, seed, dev, precision):
    no_tf32()
    ref = I.reference_model(config, dev)
    ref.load_state_dict(I.make_weights(config, seed, dev))
    R.set_precision(ref, precision)
    return ref


def infer_inputs(drv, u: int, r: int):
    """The view-set of sampled answer (u, r), made again from the seed."""
    c, t = drv.config, drv.traffic
    if t["kind"] == "request":
        return I.viewsets(c, 1, drv.seed, drv.dev, index=u % t["pool"])
    imgs, projs, dv = I.viewsets(c, t["batch"], drv.seed, drv.dev)
    return (imgs[r:r + 1], {k: v[r:r + 1] for k, v in projs.items()},
            dv[r:r + 1])


def infer_numbers(drv, control: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers of an inference cell; with control, the
    answers are the reference's at that precision instead of the
    program's."""
    c, dev = drv.config, drv.dev
    b, (h, w) = drv.traffic["batch"], drv.rec.hw
    refs = {p: reference(c, drv.seed, dev, p).eval()
            for p in ("float32", "bfloat16") + ((control,) if control else ())}
    worst = {"depth_ratio": 0.0, "conf_ratio": 0.0, "depth_gap": 0.0,
             "conf_gap": 0.0}
    for (u, r) in drv.samples:
        imgs, projs, dv = infer_inputs(drv, u, r)
        gen = torch.Generator(device=dev).manual_seed(I.unit_seed(drv.seed, u))
        noise = {s: [n[r:r + 1] for n in draws] for s, draws in
                 R.draw_eval_noise(c["model"], b, h, w, gen).items()}
        with torch.no_grad():
            outs = {p: ref(imgs, projs, dv, noise) for p, ref in refs.items()}
        d32 = outs["float32"]["depth"][-1][0]
        c32 = [x[0] for x in outs["float32"]["photometric_confidence"]]

        def gaps(depth, confs):
            depth = torch.as_tensor(depth, device=dev).float()
            dg = ((depth - d32).abs() / d32).mean().item()
            cg = sum((torch.as_tensor(x, device=dev).float() - y).abs()
                     .mean().item() for x, y in zip(confs, c32))
            return dg, cg

        if control:
            o = outs[control]
            got = gaps(o["depth"][-1][0],
                       [x[0] for x in o["photometric_confidence"]])
        else:
            got = gaps(*drv.kept[(u, r)])
        o16 = outs["bfloat16"]
        base = gaps(o16["depth"][-1][0],
                    [x[0] for x in o16["photometric_confidence"]])
        worst["depth_ratio"] = max(worst["depth_ratio"], ratio(got[0], base[0]))
        worst["conf_ratio"] = max(worst["conf_ratio"], ratio(got[1], base[1]))
        worst["depth_gap"] = max(worst["depth_gap"], got[0])
        worst["conf_gap"] = max(worst["conf_gap"], got[1])
    return worst


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=None):
    """(median, worst, the worst leaf's name) over the leaves of
    | |got| - |want| | / max(|want|, the median leaf's |want|)."""
    keys = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in keys)
    gaps = {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30)
            for k in keys}
    worst = max(gaps, key=gaps.get)
    return statistics.median(gaps.values()), gaps[worst], worst


def train_numbers(drv, control: Optional[str] = None) -> Dict[str, float]:
    """The compared numbers of a training cell (with control: of the
    reference at that precision in the program's place)."""
    c, t, dev = drv.config, drv.traffic, drv.dev
    n = t["checked_steps"]
    batches = [I.to_device(I.train_batch(c, t, drv.seed, i % t["pool"], dev),
                           dev) for i in range(n)]
    seeds = [I.unit_seed(drv.seed, i) for i in range(n)]
    total = t["steps_per_epoch"] * c["train"]["epochs"] + 100

    def steps(precision):
        ref = reference(c, drv.seed, dev, precision)
        start = {k: p.detach().clone() for k, p in ref.named_parameters()}
        losses, g1, after = RT.train_steps(ref, batches, seeds, c["train"],
                                           total)
        return losses, norms(g1), norms({k: after[k] - start[k]
                                         for k in after})

    want = steps("float32")
    got = (steps(control) if control else
           (drv.losses, drv.first_grads, drv.changes))
    med_g = statistics.median(want[1].values())
    keep = {k for k, v in want[1].items() if v >= 1e-3 * med_g}
    grad_med, grad_worst, grad_leaf = leaf_gaps(got[1], want[1])
    chg_med, chg_worst, chg_leaf = leaf_gaps(got[2], want[2], keep)
    drv.leaves = {"worst_grad": grad_leaf, "worst_change": chg_leaf,
                  "left_out": {k: v / med_g for k, v in want[1].items()
                               if k not in keep}}
    loss_gap = max(ratio(abs(a - b), abs(b)) for a, b in zip(got[0], want[0]))
    if not all(math.isfinite(x) for x in got[0]):
        loss_gap = math.inf
    return {"loss_gap": loss_gap, "grad_gap": grad_med,
            "change_gap": chg_med, "grad_gap_worst_leaf": grad_worst,
            "change_gap_worst_leaf": chg_worst,
            "leaves_left_out": float(len(want[1]) - len(keep))}


COMPARED = {"batch": ("depth_ratio", "conf_ratio"),
            "request": ("depth_ratio", "conf_ratio"),
            "train": ("loss_gap", "grad_gap", "change_gap")}


def numbers(drv, control: Optional[str] = None) -> Dict[str, float]:
    if drv.traffic["kind"] == "train":
        return train_numbers(drv, control)
    return infer_numbers(drv, control)


def judge(kind: str, got: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the compared numbers; a
    number without a limit, or not finite, is not correct."""
    out, ok = {}, True
    for name in COMPARED[kind]:
        v, lim = got[name], limits.get(name)
        out[name] = {"value": v, "limit": lim}
        ok = ok and lim is not None and math.isfinite(v) and v <= lim
    return ok, out
