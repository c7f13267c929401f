"""Seed sweeps of the learning-curve recipes, and their comparison with the
JAX package's.

``python -m pfrl_tpu_torch.experiments.seed_sweep run OUTDIR [--recipes
...] [--seeds 0-9] [--jobs 7]`` trains each recipe of
:mod:`~pfrl_tpu_torch.experiments.record_curves` on each seed, one process
a run (``python -m pfrl_tpu_torch.experiments.record_curves NAME --seed S
--outdir OUTDIR/NAME_sS``), ``--jobs`` at a time on the one card, and
writes ``OUTDIR/sweep_torch.json`` after each run: a list of rows
``{"package", "name", "seed", "best", "solved", "t", "steps", "rows",
"seconds", "host"}`` (``t``: the step of the last evaluation, the solve's
where ``solved``; ``steps``: the recipe's cap; ``host``: the card's name
and power limit). Run again, the same command skips the runs the file
holds and resumes a run that was cut from its last evaluation.

``python -m pfrl_tpu_torch.experiments.seed_sweep compare JAX.json
TORCH.json`` holds the two packages' rows against each other, recipe by
recipe (``tests/jax_seed_sweep.py`` writes the JAX package's, on the CPU):
the solve counts by Fisher's exact test, the best evaluation means by a
two-sided Mann-Whitney U test and, for :data:`STEP_TESTS`, the steps at
the solve by the same test, a run that never solved counted at its cap.
It prints one Markdown table and, as its last line, the JSON of
:func:`compare`. Ten seeds a side find only a large gap.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import threading
from typing import Dict, List, Sequence

RECIPES = ("rainbow_cartpole", "dqn_cartpole", "dqn_cartpole_bf16", "al_cartpole")
STEP_TESTS = ("rainbow_cartpole",)
ALPHA = 0.05


def parse_seeds(text: str) -> List[int]:
    """``"0-9"`` or ``"1,3,5"`` -> a list of ints."""
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_sweep(outdir: str, recipes: Sequence[str], seeds: Sequence[int], jobs: int) -> List[dict]:
    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, "sweep_torch.json")
    rows = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = json.load(f)
    done = {(r["name"], r["seed"]) for r in rows}
    host, lock = card_line(), threading.Lock()
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def launch(name: str, seed: int) -> None:
        run_dir = os.path.join(outdir, f"{name}_s{seed}")
        os.makedirs(run_dir, exist_ok=True)
        log = os.path.join(run_dir, "log.txt")
        with open(log, "a") as f:
            subprocess.run([sys.executable, "-m", "pfrl_tpu_torch.experiments.record_curves", name,
                            "--seed", str(seed), "--outdir", run_dir], stdout=f, stderr=subprocess.STDOUT,
                           env=env, check=False)
        with open(log) as f:
            lines = [line for line in f if line.startswith("curve ")]
        if not lines:
            raise RuntimeError(f"{name} seed {seed} printed no result; see {log}")
        res = json.loads(lines[-1][len("curve "):])
        row = {"package": "torch", "name": name, "seed": seed, "best": res["best"], "solved": res["solved"],
               "t": res["t"], "steps": res["steps"], "rows": res["rows"], "seconds": res["seconds"], "host": host}
        with lock:
            rows.append(row)
            with open(out_path, "w") as f:
                json.dump(sorted(rows, key=lambda r: (r["name"], r["seed"])), f, indent=1)
        print(f"{name} seed {seed}: best {row['best']:.1f} solved {row['solved']} at {row['t']} "
              f"({row['seconds']:.0f} s)", flush=True)

    todo = [(n, s) for n in recipes for s in seeds if (n, s) not in done]
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        for future in [pool.submit(launch, n, s) for n, s in todo]:
            future.result()
    return rows


def compare(jax_rows: Sequence[dict], torch_rows: Sequence[dict]) -> Dict[str, dict]:
    """Per recipe found on both sides: each side's seeds, solve count and
    best means, and the p-values of the tests in the module's note
    (``"p_steps"`` only for :data:`STEP_TESTS`); ``"rejects"`` is whether
    any of them falls below :data:`ALPHA`."""
    from scipy import stats

    out = {}
    for name in sorted({r["name"] for r in jax_rows} & {r["name"] for r in torch_rows}):
        sides = [sorted((r for r in rows if r["name"] == name), key=lambda r: r["seed"])
                 for rows in (jax_rows, torch_rows)]
        solved = [sum(r["solved"] for r in side) for side in sides]
        table = [[s, len(side) - s] for s, side in zip(solved, sides)]
        res = {
            "seeds": [[r["seed"] for r in side] for side in sides],
            "solved": solved,
            "best": [[r["best"] for r in side] for side in sides],
            "p_solved": float(stats.fisher_exact(table)[1]),
            "p_best": float(stats.mannwhitneyu(*([r["best"] for r in side] for side in sides),
                                               alternative="two-sided").pvalue),
        }
        if name in STEP_TESTS:
            res["steps_at_solve"] = [[r["t"] if r["solved"] else r["steps"] for r in side] for side in sides]
            res["p_steps"] = float(stats.mannwhitneyu(*res["steps_at_solve"], alternative="two-sided").pvalue)
        res["rejects"] = any(res[k] < ALPHA for k in ("p_solved", "p_best", "p_steps") if k in res)
        out[name] = res
    return out


def markdown(result: Dict[str, dict]) -> str:
    lines = ["| recipe | solved JAX | solved port | Fisher p | best MWU p | steps MWU p | rejects at 0.05 |",
             "|---|---|---|---|---|---|---|"]
    for name, r in result.items():
        (nj, nt), (sj, st) = [len(s) for s in r["seeds"]], r["solved"]
        steps = f"{r['p_steps']:.4g}" if "p_steps" in r else "-"
        lines.append(f"| {name} | {sj}/{nj} | {st}/{nt} | {r['p_solved']:.4g} | {r['p_best']:.4g} | {steps} | "
                     f"{'yes' if r['rejects'] else 'no'} |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="train the recipes on the seeds, on the card")
    p_run.add_argument("outdir")
    p_run.add_argument("--recipes", nargs="+", default=list(RECIPES))
    p_run.add_argument("--seeds", default="0-9")
    p_run.add_argument("--jobs", type=int, default=7)
    p_cmp = sub.add_parser("compare", help="hold the JAX package's rows against the port's")
    p_cmp.add_argument("jax_json")
    p_cmp.add_argument("torch_json")
    args = parser.parse_args(argv)
    if args.cmd == "run":
        run_sweep(args.outdir, args.recipes, parse_seeds(args.seeds), args.jobs)
        return
    with open(args.jax_json) as f:
        jax_rows = json.load(f)
    with open(args.torch_json) as f:
        torch_rows = json.load(f)
    result = compare(jax_rows, torch_rows)
    print(markdown(result))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
