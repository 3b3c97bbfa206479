"""PyTorch port: the bench entry (diffmvs_tpu_torch/bench.py) against the
JAX package's bench.py, on the CPU.

bench.py's metric names, units, shapes and training batch are read from
its source with ast, not copied; its configurations are built with
diffmvs_tpu.config. The modes run in-process at bench.py's CPU smoke
configurations.
"""

import ast
import dataclasses
import gc
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffmvs_tpu.config import CASDIFFMVS, tpu_optimized, train_optimized
from diffmvs_tpu.config import ModelConfig as JaxModelConfig
from diffmvs_tpu.utils.synthetic import synthetic_inputs as jax_inputs

import diffmvs_tpu_torch.config as tconfig
from diffmvs_tpu_torch import bench
from diffmvs_tpu_torch.api import DepthRunner
from diffmvs_tpu_torch.utils.synthetic import synthetic_inputs

import helpers

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_BENCH = ast.parse((REPO / "bench.py").read_text())


def jax_function(name):
    return next(n for n in JAX_BENCH.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def jax_line_keys(func, **names):
    """{"metric", "unit"} of the JSON line `func` prints, each expression
    evaluated with `names` (the function's arguments it reads)."""
    call = next(n for n in ast.walk(jax_function(func))
                if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
                == "dumps")
    out = {}
    for k, v in zip(call.args[0].keys, call.args[0].values):
        if isinstance(k, ast.Constant) and k.value in ("metric", "unit"):
            code = compile(ast.Expression(v), "bench.py", "eval")
            out[k.value] = eval(code, {}, dict(names))
    return out


def jax_shapes(func):
    """{"cpu": tuple, "tpu": tuple} of the `if platform == "cpu": ... =
    (...) else: ... = (...)` assignment in `func`."""
    node = next(n for n in ast.walk(jax_function(func))
                if isinstance(n, ast.If) and isinstance(n.test, ast.Compare)
                and getattr(n.test.left, "id", "") == "platform")
    return {"cpu": ast.literal_eval(node.body[-1].value),
            "tpu": ast.literal_eval(node.orelse[-1].value)}


def run_line(capsys, fn, *args):
    fn(*args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


MODES = {
    "inference": (bench.main, (0, "", "cpu"), "main", {}),
    "train": (bench.bench_train, ("", "", "cpu"), "bench_train",
              {"bwd": ""}),
    "io": (bench.bench_io, (0, False), "bench_io",
           {"workers": 0, "predecoded": False}),
    "io_predecoded": (bench.bench_io, (0, True), "bench_io",
                      {"workers": 0, "predecoded": True}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prints_bench_py_line(capsys, mode):
    """Each mode prints one JSON line with a finite positive value, under
    bench.py's metric name and unit, and no TPU baseline."""
    fn, args, jax_fn, names = MODES[mode]
    line = run_line(capsys, fn, *args)
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] is None
    want = jax_line_keys(jax_fn, **names)
    assert {k: line[k] for k in want} == want
    if mode in ("inference", "train"):
        assert line["device"] == "cpu" and line["peak_gib"] is None
        unit = "forward" if mode == "inference" else "step"
        assert line[f"card_s_per_{unit}"] is None    # no card clock here
        assert line[f"host_s_per_{unit}"] > 0
        assert line["reps"] == 2 and len(line[f"chain_s_per_{unit}"]) == 1
        assert line["batch"] == 1


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("line", ["main", "bench_train"])
def test_configs_equal_bench_py(line, device):
    """The card's and the CPU's configurations equal bench.py's on every
    ModelConfig field both packages have, and the shapes its source
    names."""
    shapes = jax_shapes(line)["tpu" if device == "cuda" else "cpu"]
    b, h, w, nd, nd_init, reps = shapes
    if line == "main":
        port, shape = bench.infer_config(device)
        jax_cfg = tpu_optimized(dataclasses.replace(
            CASDIFFMVS, numdepth_initial=nd_init, numdepth=nd,
            compute_dtype="bfloat16"),
            backend="tpu" if device == "cuda" else "cpu")
    else:
        port, shape = bench.train_config(device)
        jax_cfg = train_optimized(dataclasses.replace(
            CASDIFFMVS, numdepth_initial=nd_init, numdepth=nd,
            compute_dtype="bfloat16", remat=True))
    assert tuple(shape) == (b, h, w, nd, nd_init, reps)
    shared = [f.name for f in dataclasses.fields(port)
              if f.name in {g.name for g in dataclasses.fields(jax_cfg)}]
    assert {"compute_dtype", "remat", "numdepth", "scale"} <= set(shared)
    for name in shared:
        assert getattr(port, name) == getattr(jax_cfg, name), name


def test_train_batch_equals_bench_py():
    """bench.py's batch construction (its statements, executed with the
    JAX package's synthetic_inputs) against the port's, array for array."""
    body = jax_function("bench_train").body
    first = next(i for i, n in enumerate(body)
                 if "synthetic_inputs(" in ast.unparse(n)
                 and isinstance(n, ast.Assign))
    last = next(i for i, n in enumerate(body)
                if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) == "batch")
    ns = {"np": np, "synthetic_inputs": jax_inputs, "b": 2, "h": 64,
          "w": 96, "nd": 32}
    exec(compile(ast.Module(body[first:last + 1], []), "bench.py", "exec"),
         ns)
    want, got = ns["batch"], bench.train_batch(2, 64, 96, 32)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in leaves(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    want, got = leaves(want), leaves(got)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_chain_equals_separate_runner_calls():
    """A 2-repetition chain is the sum of two DepthRunner calls whose
    generators are seeded 0 and 1, bit for bit; the repetitions differ
    (the DDIM noise)."""
    cfg = dataclasses.replace(tconfig.CASDIFFMVS, numdepth_initial=8,
                              numdepth=32, compute_dtype="bfloat16")
    runner = DepthRunner(cfg, device="cpu", seed=0)
    inputs = synthetic_inputs(1, 3, 32, 64, 32, seed=1)
    acc = bench.infer_chain(runner, inputs, 2)
    means = [runner(*inputs, generator=torch.Generator().manual_seed(i))[0]
             .mean() for i in range(2)]
    assert means[0].item() != means[1].item()
    assert torch.equal(acc, torch.zeros(()) + means[0] + means[1])


def test_timed_chains_run_without_the_collector():
    """Each timed chain runs with Python's garbage collector disabled
    (timeit's convention), and the collector is on again after it, also
    when a chain raises."""
    seen = []

    def chain():
        seen.append(gc.isenabled())
        return torch.ones(())

    times, value = bench.time_chains(chain, torch.device("cpu"))
    assert seen == [False] * bench.TIMED_CHAINS["cpu"] and gc.isenabled()
    assert value == 1.0 and times["card"] == []
    assert len(times["host"]) == len(seen)

    def failing():
        raise RuntimeError("chain failed")

    with pytest.raises(RuntimeError, match="chain failed"):
        bench.time_chains(failing, torch.device("cpu"))
    assert gc.isenabled()


def test_import_leaves_the_environment_alone():
    """Importing the module sets no thread count in the importer's
    environment (the script's run sets one for its loader workers)."""
    code = ("import os\n"
            "os.environ.pop('OMP_NUM_THREADS', None)\n"
            "import diffmvs_tpu_torch.bench\n"
            "print(os.environ.get('OMP_NUM_THREADS'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(REPO), check=True)
    assert proc.stdout.strip() == "None"


def test_chain_spread_runs_on_the_cpu(capsys):
    """tools/chain_spread: a line a chain, one a set (the collector on,
    then off), the correlations over all chains, then the device."""
    from diffmvs_tpu_torch.tools import chain_spread

    chain_spread.main(["--device", "cpu", "--chains", "1", "--gc", "on,off"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "cpu"
    rows = [json.loads(line) for line in out[:-1]]
    chains = [r for r in rows if "chain" in r]
    sets = [r for r in rows if "set" in r and "chain" not in r]
    assert [r["gc"] for r in chains] == ["on", "off"]
    assert chains[1]["gc_s"] == 0 and not chains[1]["gc_collections"]
    assert all(r["host_s"] > 0 and r["cpu_s"] > 0 and r["metronome_s"] > 0
               for r in chains)
    assert [r["gc"] for r in sets] == ["on", "off"]
    assert all(r["samples_per_s"] > 0 for r in sets)
    summary = rows[-1]
    assert summary["chains"] == 2
    assert all(-1 <= summary[k] <= 1 for k in (
        "corr_s_issue_s", "corr_s_cpu_s", "corr_s_metronome_s"))
    lo, hi = summary["issue_share"]
    assert 0 < lo <= hi <= 1                # the chain's read ends it
    assert summary["step_s"][0] <= summary["step_s"][1] <= summary["step_s"][2]
    assert gc.isenabled()


def test_set_parses_tuple_values():
    ov = bench.parse_overrides("scale=(0.0, 0.25, 0.05),remat=True,"
                               "ddim_eta=(0.0, 1.0, 0.5)")
    assert ov == {"scale": (0.0, 0.25, 0.05), "remat": True,
                  "ddim_eta": (0.0, 1.0, 0.5)}
    cfg, _ = bench.infer_config("cpu", "scale=(0.0, 0.25, 0.05),remat=True")
    assert cfg.scale == (0.0, 0.25, 0.05) and cfg.remat
    assert cfg.compute_dtype == "bfloat16"


@pytest.mark.parametrize("field", ["warp_kernel", "warp_bwd",
                                   "feature_phase_opt", "unroll_iters",
                                   "unet_s2d", "encoder_s2d"])
def test_set_refuses_tpu_only_field(field):
    """A field of the JAX package's ModelConfig that the port lacks is
    refused by name, at parse time and through the command line."""
    assert field in {f.name for f in dataclasses.fields(JaxModelConfig)}
    with pytest.raises(ValueError, match=field):
        bench.parse_overrides(f"remat=True,{field}=True")
    with pytest.raises(ValueError, match=field):
        bench.cli(["--device", "cpu", "--set", f"{field}=True"])


@pytest.mark.parametrize("argv", [["--check"], ["--all"]])
def test_parity_gate_refuses_the_cpu(argv):
    with pytest.raises(SystemExit, match="parity gate is the card's"):
        bench.cli(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="parity gate is the card's"):
        bench.check_kernel_parity("cpu")


def test_check_exits_non_zero_on_the_cpu():
    """As a command: --check --device cpu exits 1 with its message and
    prints no line."""
    proc = subprocess.run(
        [sys.executable, "-m", "diffmvs_tpu_torch.bench", "--check",
         "--device", "cpu"], capture_output=True, text=True, cwd=str(REPO))
    assert proc.returncode != 0
    assert "parity gate is the card's" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.cli([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.cli(["--train", "--device", "cuda"])


def test_train_refuses_an_unknown_backward():
    with pytest.raises(ValueError, match="kernel"):
        bench.bench_train("pallas", device="cpu")


@pytest.mark.parametrize("vhw", [(2, 288, 400), (5, 1152, 1600),
                                 (3, 64, 96)])
def test_parity_rig_equals_tests_helpers(vhw):
    """The port's copy of make_cams / stage_projs equals tests/helpers'."""
    want = helpers.make_cams(*vhw)
    got = bench.make_cams(*vhw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ws, gs = helpers.stage_projs(want), bench.stage_projs(got)
    assert sorted(gs) == sorted(ws)
    for k in ws:
        np.testing.assert_array_equal(gs[k], ws[k])
