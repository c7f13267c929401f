"""``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell of ``BENCHMARK.json`` once on the CUDA device and prints, as
the last line of standard output, the JSON result: ``correct``,
``attempted`` (scan steps in the window), ``failed`` (those whose loss was
not finite), ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` the ``breakdown``, and
last ``checks``: each number compared with the reference beside its limit.
Exits 2 with no result where there is no CUDA device, or fewer than the cell
asks for, and 3 where JAX or the JAX package was loaded.
"""

import argparse
import json
import math
import os
import platform
import subprocess
import sys
import time

import torch

from portbench import harness
from portbench.flops import flops_per_transition
from portbench.reference.follow import updates_per_step

FORBIDDEN = ("jax", "jaxlib", "flax", "pfrl_tpu")


def host_lines(device) -> list:
    """The card's name and power limit, and the host's CPU."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi not read: {e}"
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    cpu = (f"{fields.get('model name', platform.processor() or 'unknown')} (vendor {fields.get('vendor_id', '?')}, "
           f"family {fields.get('cpu family', '?')}, model {fields.get('model', '?')}, {fields.get('cpu MHz', '?')} MHz)")
    return [
        f"card: {torch.cuda.get_device_name(device)} | nvidia-smi: {smi}",
        f"host: {cpu}, {os.cpu_count()} CPUs; python {platform.python_version()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}",
    ]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, peak: dict, started: float,
             faults=()):
    """One run of ``cell`` on ``device``: the result's dict and notes for
    standard error. ``faults`` break the program (the faults' checks)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg, traffic = cell["config"], cell["traffic"]
    setup = harness.set_up(cell, seed, device, faults)
    harness.synchronize(device)
    setup_s = time.time() - started
    flops_tr = flops_per_transition(cfg, traffic)
    peak_flops = peak["flops_per_s"][cfg["precision"]]
    L = traffic["num_envs"]
    device_block = {"platform": "gpu" if cuda else device.type,
                    "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": cell["chips"]}
    notes, breakdown = [], None
    if trace:
        traced = harness.profile_window(setup, traffic["profile_steps"])
        spans = harness.span_window(setup, seconds)
        attempted, failed = spans["scan_steps"], spans["failed"]
        records = {
            "trace": traced, "spans": spans, "num_envs": L, "minibatch": traffic["minibatch_size"],
            "updates_per_step": updates_per_step(traffic), "flops_per_transition": flops_tr,
            "peak": peak, "peak_flops_per_s": peak_flops,
            "frame_bytes": math.prod(cfg["build"]["frame_shape"]),
            "tree_leaves": getattr(setup.runner.buffer, "tree_capacity", None),
        }
        metrics = {}
        for m in cell["per_layer"]:
            value = harness.metric_reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_block.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        breakdown = traced["breakdown"]
        notes.append(f"traced: {traced['device_ops']} device ops, {traced['unattributed']} with no launch on "
                     f"record; under ranges {json.dumps(traced['under'])}; spans {json.dumps(spans)}")
    else:
        w = harness.window(setup, seconds)
        attempted, failed = w["scan_steps"], w["failed"]
        rate = w["scan_steps"] * L / w["seconds"]
        values = {
            "env_steps_per_s": (rate, "steps/s"),
            "step_mfu": (100.0 * rate * flops_tr / peak_flops, "%"),
            "setup_s": (setup_s, "s"),
        }
        metrics = {m["name"]: {"value": values[m["name"]][0], "unit": m["unit"]} for m in cell["end_to_end"]}
        thirds = [sum(1 for t in w["issued_s"] if t <= seconds * k / 3) for k in (1, 2, 3)]
        notes.append(f"window: {w['scan_steps']} scan steps in {w['seconds']!r} s; chunks issued by each third "
                     f"of the window: {thirds}")
    device_block["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0

    t0 = time.perf_counter()
    numbers = harness.judge(cell, setup, device)
    notes.append(f"reference: {time.perf_counter() - t0:.2f} s")
    if "error" in numbers:
        notes.append(f"reference: {numbers['error']}")
    checked = harness.checks(numbers, cell["limits"])
    result = {"correct": harness.is_correct(checked) and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_block}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checked
    return result, notes


def main(argv=None, started: float = None) -> int:
    started = time.time() if started is None else started
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    peaks = harness.load_json(harness.HERE / "peaks.json")
    kind = torch.cuda.get_device_name(device)
    if kind not in peaks:
        print(f"portbench: no peak is known for {kind!r} (peaks.json)", file=sys.stderr)
        return 2
    for line in host_lines(device):
        print(line, flush=True)
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, peaks[kind], started)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
