"""The JAX package's side of the learning-curve seed sweep, on the CPU.

``tools/record_curves.py`` writes under its own parent directory and takes
no seed. This script copies ``pfrl_tpu/`` and ``tools/`` into WORKDIR, a
directory outside the repository, loads the copy's tool with
``_curve_loop`` wrapped (the seed set, no zoo entry, each run named
``<recipe>_s<seed>``) and runs every recipe on every seed, one process a
run, ``--jobs`` at a time. The recipes themselves run unchanged.

It writes ``WORKDIR/sweep_jax.json``, a list of rows ``{"package",
"name", "seed", "best", "solved", "t", "steps", "rows", "seconds",
"host"}`` (``t``: the step of the last evaluation, the solve's where
``solved``; ``steps``: the recipe's cap), after each run. ``python -m
pfrl_tpu_torch.experiments.seed_sweep compare`` holds these rows against
the port's.

Usage (from the repository's root)::

    JAX_PLATFORMS=cpu python tests/jax_seed_sweep.py WORKDIR \\
        [--recipes dqn_cartpole ...] [--seeds 0-9] [--jobs 4]
"""

import argparse
import concurrent.futures
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ("dqn_cartpole", "dqn_cartpole_bf16", "al_cartpole", "rainbow_cartpole")


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def parse_seeds(text: str):
    """``"0-9"`` or ``"1,3,5"`` -> a list of ints."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def copy_reference(workdir: str) -> None:
    """``pfrl_tpu/`` and ``tools/`` into ``workdir``, where the tool's
    ``REPO`` (its parent directory) then points."""
    if os.path.realpath(workdir).startswith(os.path.realpath(REPO) + os.sep):
        raise SystemExit(f"{workdir} lies inside the repository; the tool would write there")
    for sub in ("pfrl_tpu", "tools"):
        dst = os.path.join(workdir, sub)
        if not os.path.exists(dst):
            shutil.copytree(os.path.join(REPO, sub), dst, ignore=shutil.ignore_patterns("__pycache__"))


def run_one(workdir: str, name: str, seed: int) -> dict:
    """One recipe on one seed, in this process, from the copy."""
    spec = importlib.util.spec_from_file_location("record_curves_copy", os.path.join(workdir, "tools", "record_curves.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)  # puts ``workdir`` first on sys.path
    original, seen = tool._curve_loop, {}

    def seeded(run_name, *args, **kwargs):
        kwargs.update(seed=seed, zoo_entry=None)
        seen.update(kwargs, name=f"{run_name}_s{seed}")
        return original(seen["name"], *args, **kwargs)

    tool._curve_loop = seeded
    t0 = time.time()
    best = tool.RUNS[name]()
    with open(os.path.join(workdir, "benchmarks", "curves", seen["name"], "scores.txt")) as f:
        rows = [line.split("\t") for line in f.read().splitlines()[1:]]
    score = seen.get("successful_score")
    solved = score is not None and float(rows[-1][3]) >= score and len(rows) >= seen.get("min_rows", 1)
    return {"package": "jax", "name": name, "seed": seed, "best": float(best), "solved": bool(solved),
            "t": int(rows[-1][0]), "steps": int(seen["steps"]), "rows": len(rows),
            "seconds": time.time() - t0, "host": cpu_model()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir")
    parser.add_argument("--recipes", nargs="+", default=list(RECIPES))
    parser.add_argument("--seeds", default="0-9")
    parser.add_argument("--jobs", type=int, default=4)
    parser.add_argument("--one", nargs=2, metavar=("NAME", "SEED"), help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    workdir = os.path.abspath(args.workdir)
    if args.one:
        print("sweep " + json.dumps(run_one(workdir, args.one[0], int(args.one[1]))), flush=True)
        return
    os.makedirs(workdir, exist_ok=True)
    copy_reference(workdir)
    out_path = os.path.join(workdir, "sweep_jax.json")
    rows, lock = [], threading.Lock()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")

    def launch(job):
        name, seed = job
        log = os.path.join(workdir, f"{name}_s{seed}.log")
        with open(log, "w") as f:
            subprocess.run([sys.executable, os.path.abspath(__file__), workdir, "--one", name, str(seed)],
                           stdout=f, stderr=subprocess.STDOUT, env=env, check=False)
        with open(log) as f:
            lines = [line for line in f if line.startswith("sweep ")]
        if not lines:
            raise RuntimeError(f"{name} seed {seed} printed no result; see {log}")
        row = json.loads(lines[-1][len("sweep "):])
        with lock:
            rows.append(row)
            with open(out_path, "w") as f:
                json.dump(sorted(rows, key=lambda r: (r["name"], r["seed"])), f, indent=1)
        print(f"{name} seed {seed}: best {row['best']:.1f} solved {row['solved']} at {row['t']} "
              f"({row['seconds']:.0f} s)", flush=True)

    jobs = [(name, seed) for name in args.recipes for seed in parse_seeds(args.seeds)]
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for future in [pool.submit(launch, job) for job in jobs]:
            future.result()


if __name__ == "__main__":
    main()
