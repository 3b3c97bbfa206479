"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module name, and the reference imports nothing of
the program either."""

import ast
import subprocess
import sys
from pathlib import Path

from mvsbench import manifest, run

HERE = manifest.HERE


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_whole_name_comparison(monkeypatch):
    fake = dict(sys.modules)
    fake["diffmvs_tpu_torch.fake"] = sys
    monkeypatch.setattr(sys, "modules", fake)
    assert run.jax_modules() == []
    fake["diffmvs_tpu.ops"] = sys
    fake["jaxlib"] = sys
    assert run.jax_modules() == ["diffmvs_tpu.ops", "jaxlib"]


def test_sources():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = set(imported_tops(path))
        assert not tops & run.FORBIDDEN, path
        if "reference" in path.parts or "roofline" in path.parts:
            assert not tops & {"diffmvs_tpu_torch", "diffmvs_tpu"}, path


def test_run_loads_no_jax():
    """The harness, the program and the reference in one process leave
    no JAX module loaded."""
    code = ("import sys; import mvsbench.run, mvsbench.drive, "
            "mvsbench.check, mvsbench.calibrate, diffmvs_tpu_torch.api, "
            "diffmvs_tpu_torch.train.step, diffmvs_tpu_torch.ops.warp_corr; "
            "from mvsbench.run import jax_modules; print(jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a card a run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "mvsbench.run", "--workload",
         "casdiffmvs-dtu.batch16", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=manifest.ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_reads_no_jax_era_files():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("BENCH_r0", "MULTICHIP_r0", "BASELINE.", "hwlogs"):
            assert name not in text, (path, name)
