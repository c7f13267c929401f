"""The readings that the limits of ``limits/<cell>.json`` are set from (never
part of a benchmark run).

    python portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed, in one process: the program's set-up and a short window,
both observed chunks judged by the reference (the lower readings); the
control (the reference in the program's place, in TF32, through the first
update step) judged by the reference; and each of ``faults.py``'s faults
planted in the program, its set-up judged likewise (the upper readings).
One JSON line per reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from portbench.run import prepare

    prepare()

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402


def readings(cell, device, seed: int, kind: str, seconds: float) -> dict:
    t0 = time.perf_counter()
    if kind == "control":
        numbers = harness.control_numbers(cell, seed, device)
    else:
        setup = harness.set_up(cell, seed, device, faults=[faults.FAULTS[kind]] if kind != "program" else [])
        if kind == "program":
            harness.window(setup, seconds)
        numbers = harness.judge(cell, setup, device)
    return {"cell": cell["name"], "kind": kind, "seed": seed, "numbers": numbers,
            "correct": harness.is_correct(harness.checks(numbers, cell["limits"])),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(faults.FAULTS), help="the faults to plant, by name")
    p.add_argument("--seconds", type=float, default=5.0, help="a sound run's window before its last chunk is judged")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [(s, "program") for s in ints(args.seeds)] + [(s, "control") for s in ints(args.control_seeds)]
    runs += [(s, f) for s in ints(args.fault_seeds) for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    for seed, kind in runs:
        line = json.dumps(readings(cell, device, seed, kind, args.seconds))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.exit(main())
