"""Runs one cell once with the program's spans; see ``portbench/program_trace.py``.

    python portbench/run_program_trace.py --workload <cell> --seed <n>

Prints the card's name, power limit and the host's CPU, then one JSON line:
``correct``, the five readings, the wrapped window's device operations per
call beside them, the host-span window, the program-profiled window, the
set-up's spans and the cost of recording (``span_cost``). Exits 2 where
there is no CUDA device, 3 where the run loaded a package the benchmark
forbids (``main.loaded_forbidden``), as ``run.py`` does.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import torch

    from portbench import harness
    from portbench.main import host_lines, loaded_forbidden
    from portbench.program_trace import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: a CUDA device is needed", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for line in host_lines(device):
        print(line, flush=True)
    result = run(cell, args.seed, device)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, in place of this folder
    from portbench.run import prepare

    prepare()
    import torch

    torch.set_num_threads(1)
    sys.exit(main())
