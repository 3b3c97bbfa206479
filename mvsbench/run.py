"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 -m mvsbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Set-up (the kernels' build or load, the
weights and inputs made on the card from the seed, the warm-up of the
cell's shapes, and for training the steps the check follows) counts as
setup_s, from the process's start to the window's first unit. The window
then runs for --seconds; with --trace 1 a few of its units run under
torch.profiler and the line carries the cell's per-layer metrics instead
of its end-to-end ones. After the window the program's state is freed
and the check compares the sampled answers with the plain reference
(mvsbench/check.py). The last line of standard output is one JSON
object; the numbers compared, each beside its limit, end standard error
and the line. The line also carries the host's readings around the
window (mvsbench/host.py), which no metric reads.

Exits non-zero, printing no result, without a card (or fewer cards than
the cell asks for), and if JAX or the JAX package has been imported.
Reads and writes only inside the checkout (the program's kernel build
directory, build/diffmvs_tpu_torch/) and nothing else on disk.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "diffmvs_tpu"}


def jax_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (diffmvs_tpu_torch is not diffmvs_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def card_line(dev) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure(cell, seed: int, seconds: float, trace: bool, dev, fault=None):
    """Set-up, window, metrics and check of one run. Returns the result
    object (without the device's name) and the compared numbers."""
    import torch

    from mvsbench import check, drive, host

    drv = drive.load_for(cell, seed, dev, fault)
    drv.setup()
    rec = drv.rec
    if dev.type == "cuda":
        rec.peak_setup = torch.cuda.max_memory_allocated(dev)
    rec.setup_s = time.perf_counter() - T0
    rec.host["before"] = host.probe(dev)
    drive.run_window(drv, seconds, trace)
    rec.host["after"] = host.probe(dev)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = (cell.reader(m["name"])(rec) if trace
                 else end_to_end(m["name"], rec))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    got = check.numbers(drv)
    correct, compared = check.judge(rec.kind, got, cell.limits)
    result = {"correct": correct, "attempted": rec.units, "failed": 0,
              "metrics": metrics,
              "device": {"memory_peak_bytes": max(rec.peak_setup,
                                                  rec.peak_window)}}
    if trace and rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s,
                                window_s=rec.trace.window_s)
        result["breakdown"] = rec.trace.breakdown()
        result["groups_ms"] = rec.trace.groups()
    result["setup_parts"] = rec.setup_parts
    result["window"] = {"units": rec.units, "card_s": rec.window_s}
    result["host"] = rec.host
    result["checked"] = {k: v for k, v in got.items()
                         if k not in compared}
    result["compared"] = compared
    return result


def end_to_end(name: str, rec):
    """The end-to-end metrics the harness takes itself."""
    import statistics

    if name == "setup_s":
        return rec.setup_s
    if name == "peak_gib":
        return rec.peak_window / 2 ** 30
    if name in ("maps_per_s", "train_samples_per_s"):
        return rec.batch * rec.units / rec.window_s
    if name == "request_p90_ms":
        return 1e3 * statistics.quantiles(rec.latencies_s, n=10,
                                          method="inclusive")[-1]
    raise KeyError(f"no end-to-end metric {name!r} in the harness")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from mvsbench import manifest

    cell = manifest.Cell(manifest.load(), args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mvsbench: the cell asks for {chips} card(s); CUDA sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), dev)
    found = jax_modules()
    if found:
        print(f"mvsbench: JAX or the JAX package was imported: {found}",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(dev),
                        "count": chips, **result["device"]}
    result["card"] = card_line(dev)
    compared = result.pop("compared")
    result["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


def finite(obj):
    """obj with every float that is not finite written as a string, so
    that the line is JSON."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    return obj


if __name__ == "__main__":
    sys.exit(main())
