"""Read the numbers the check compares, on many seeds in one process,
to set a cell's limits (mvsbench/limits/<cell>.json):

    python3 -m mvsbench.calibrate --workload <name> --seeds 1,2,...
        [--control-seeds 7,8,9] [--faults half_batch,...]
        [--bf16-seeds 4,5,6] [--out FILE]

For each of --seeds, the program's readings: set-up as a run makes it,
the units whose answers the check samples (no timed window: the answers
do not depend on it), then the check. For each of --control-seeds, the
control's: the reference computed at float8, a step below the
configuration's bfloat16, in the program's place. For each fault of
--faults (drive.FAULTS), the program with that fault planted, on the
control seeds. For each of --bf16-seeds, the plain reference computed
at bfloat16, the configuration's own precision, in the program's place:
the witness of what rounding alone reads. A training cell's lines name
its worst leaves and the leaves left out of the change (check.py). One
JSON line each, on standard output and appended to --out. Needs a card;
the runs of the benchmark never call this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from mvsbench import check, drive, manifest


def program_numbers(cell, seed, dev, fault=None):
    drv = drive.load_for(cell, seed, dev, fault)
    t0 = time.perf_counter()
    drv.setup()
    for i in range(1 + max((u for u, _ in getattr(drv, "samples", [])),
                           default=-1)):
        drv.unit(i)
    drive.sync(dev)
    drv.release()
    t1 = time.perf_counter()
    got = check.numbers(drv)
    drive.sync(dev)
    return got, {"program_s": t1 - t0, "check_s": time.perf_counter() - t1,
                 **leaves(drv)}


def leaves(drv):
    return {"leaves": drv.leaves} if hasattr(drv, "leaves") else {}


def control_numbers(cell, seed, dev, precision="float8"):
    from mvsbench import inputs as I

    drv = drive.load_for(cell, seed, dev)
    t = cell.traffic
    if t["kind"] != "train":
        drv.samples = I.sample(seed, t["sample"]["units"],
                               t["sample"]["answers"], t["batch"])
    t0 = time.perf_counter()
    got = check.numbers(drv, control=precision)
    drive.sync(dev)
    return got, {"check_s": time.perf_counter() - t0, **leaves(drv)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--bf16-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = manifest.Cell(manifest.load(), args.workload)

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def emit(row):
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds(args.seeds):
        got, times = program_numbers(cell, seed, dev)
        emit({"seed": seed, "side": "program", "numbers": got, **times,
              "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30})
    for seed in seeds(args.control_seeds):
        got, times = control_numbers(cell, seed, dev)
        emit({"seed": seed, "side": "control float8", "numbers": got,
              **times})
        for fault in [f for f in args.faults.split(",") if f]:
            got, times = program_numbers(cell, seed, dev, fault)
            emit({"seed": seed, "side": f"fault {fault}", "numbers": got,
                  **times})
    for seed in seeds(args.bf16_seeds):
        got, times = control_numbers(cell, seed, dev, "bfloat16")
        emit({"seed": seed, "side": "reference bfloat16", "numbers": got,
              **times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
