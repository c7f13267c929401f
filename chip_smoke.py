#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pfrl_tpu_torch``) on one card.

Run it from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``, and exits non-zero, printing no
result, without them. Its phases, each raising on failure:

1. build every hand-written kernel from ``pfrl_tpu_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time the kernel, the plain version and a
   one-call PyTorch yardstick;
3. check the slice on a small input: the same run on the card (through the
   kernel) and on the CPU (through the plain version), from the same draws
   and weights, must agree;
4. drive the slice at full width (prioritized-replay Nature DQN: 64 lanes
   of 84x84x4 uint8 AtariSim frames, a 100,000-slot ring on the card,
   batch-32 updates every 4 transitions from 2,000 on) past replay start
   and through a target sync, counting the kernel's launches.

The last lines of its output are the kernels' JSON line, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. The full record
goes to ``chiprun_out/chip_smoke.json``.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "chiprun_out"

# H100 SXM, dense, from NVIDIA's data sheet: HBM rate and fp32 (non-tensor) rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

FULL_STEPS_WARM = 32    # t = 2,048 at the end: the first updates run
FULL_STEPS_TIMED = 128  # t = 10,240 at the end: one target sync crossed


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    A sleep kernel first holds the stream, so the host enqueues all the
    calls before the device reaches them: the events then time the device
    work, not the host's cost of issuing it (see ``host_us``).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # tens of ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one call of ``fn``, device work included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


class SeededDraws:
    """Draws from a seeded numpy stream, put on ``device``: two runs on two
    devices with one seed see the very same numbers."""

    def __init__(self, seed: int, device):
        self.rs = np.random.RandomState(seed)
        self.device = torch.device(device)

    def uniform(self, n: int) -> torch.Tensor:
        u = self.rs.randint(0, 1 << 24, n) / float(1 << 24)  # exact in float32
        return torch.from_numpy(u.astype(np.float32)).to(self.device)

    def randint(self, high: int, n: int) -> torch.Tensor:
        return torch.from_numpy(self.rs.randint(0, high, n).astype(np.int32)).to(self.device)


# --------------------------------------------------------------------- phase 1
def build_kernels() -> dict:
    from pfrl_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build()
    seconds = time.perf_counter() - t0
    logs = {}
    for name in paths:
        log = (cuda_build.BUILD_DIR / f"{name}.log")
        logs[name] = log.read_text() if log.exists() else "(cached build)"
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    print(f"build: {len(paths)} kernel(s) in {seconds:.1f} s")
    return {"seconds": seconds, "logs": logs}


# --------------------------------------------------------------------- phase 2
def _integer_case(rs, c, b, device):
    prio = rs.randint(0, 5, c).astype(np.float32)
    prio[-max(c // 7, 1):] = 0.0  # an all-zero tail, counted past
    cs = np.cumsum(prio)
    total = float(cs[-1])
    targets = np.concatenate([
        rs.uniform(0.0, total, b - 4), [cs[c // 3], 0.0, total, total + 3.0]
    ]).astype(np.float32)
    return torch.from_numpy(prio).to(device), torch.from_numpy(targets).to(device)


def check_prefix_sample(device, tree_leaves: int, batch: int) -> dict:
    """The kernel against ``prefix_sample_reference`` on the card.

    Integer-valued priorities sum exactly in any order: the counts must be
    equal. Real-valued ones may differ only where a target lies within
    ``1e-6 * total`` of a cumulative boundary (float64 cumsum as judge).
    """
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample, prefix_sample_reference

    rs = np.random.RandomState(0)
    max_err = 0
    for c, b in ((tree_leaves, batch), (3 * 1024 + 517, 5), (200_001, 200)):
        p, t = _integer_case(rs, c, b, device)
        got, want = prefix_sample(p, t), prefix_sample_reference(p, t)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if got.dtype != torch.int32 or got.shape != (b,) or err != 0:
            raise AssertionError(f"prefix_sample C={c} B={b}: max |kernel - plain| = {err}")
        if (c, b) == (tree_leaves, batch):
            max_err = err

    # The main path's leaves: 100,000 live real-valued priorities, then zeros.
    prio = np.zeros(tree_leaves, np.float32)
    prio[:100_000] = (rs.uniform(0.0, 1.0, 100_000) + 0.01) ** 0.6
    total = float(prio.astype(np.float64).sum())
    targets = ((np.arange(batch) + rs.uniform(size=batch)) / batch * total).astype(np.float32)
    p = torch.from_numpy(prio).to(device)
    t = torch.from_numpy(targets).to(device)
    got = prefix_sample(p, t).cpu().numpy()
    want = prefix_sample_reference(p, t).cpu().numpy()
    cs64 = np.cumsum(prio.astype(np.float64))
    real_mismatches = 0
    for g, w, tb in zip(got, want, targets):
        if g != w:
            real_mismatches += 1
            lo, hi = sorted((int(g), int(w)))
            if np.max(np.abs(cs64[lo:hi] - tb)) > 1e-6 * total:
                raise AssertionError(f"prefix_sample real-valued: {g} vs {w} at target {tb}")

    kernel_fn = lambda: prefix_sample(p, t)  # noqa: E731
    plain_fn = lambda: prefix_sample_reference(p, t)  # noqa: E731
    library_fn = lambda: torch.searchsorted(torch.cumsum(p, 0), t, right=True)  # noqa: E731
    ms, plain_ms, library_ms = (time_ms(f) for f in (kernel_fn, plain_fn, library_fn))
    host = {k: host_us(f) for k, f in (("kernel", kernel_fn), ("plain", plain_fn), ("library", library_fn))}
    # Least work: read the leaves and targets once, write the counts once;
    # one add per leaf for the prefix and a binary search per target.
    bytes_moved = 4 * tree_leaves + 4 * batch + 4 * batch
    ops = tree_leaves + batch * math.ceil(math.log2(tree_leaves))
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {
        "name": "prefix_sample",
        "route": "cuda",
        "source": "pfrl_tpu_torch/csrc/prefix_sample.cu",
        "replaces": "pfrl_tpu/ops/pallas_kernels.py:162",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "real_valued_mismatches_within_rounding": real_mismatches,
        "host_us_per_call": host,
        "shape": {"C": tree_leaves, "B": batch},
    }


# --------------------------------------------------------------------- phase 3
def check_small_slice(device) -> dict:
    """A 4-lane, 20-step run of the slice on the card and on the CPU."""
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_per_dqn_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    def run(dev):
        runner = make_per_dqn_runner(
            num_envs=4, capacity=8196, replay_start_size=32,
            target_update_interval=48, minibatch_size=8, device=dev,
        )
        state = runner.init(0, draws=SeededDraws(0, dev))
        state, metrics = runner.run_chunk(state, 20)
        return state, metrics

    before = prefix_sample.launches
    gpu, gpu_m = run(device)
    torch.cuda.synchronize()
    launches = prefix_sample.launches - before
    cpu, cpu_m = run("cpu")
    if launches != gpu.train_state.n_updates or launches != 13:
        raise AssertionError(f"small slice: {launches} kernel launches, {gpu.train_state.n_updates} updates")
    if gpu.t != cpu.t or int(gpu.replay_state.cursor) != int(cpu.replay_state.cursor):
        raise AssertionError("small slice: step counters differ")
    if not torch.equal(gpu.replay_state.base.storage["obs"].cpu(), cpu.replay_state.base.storage["obs"]):
        raise AssertionError("small slice: replay rings differ")
    diffs = {}

    def close(name, a, b, rtol, atol):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        diffs[name] = float((a - b).abs().max())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"small slice: {name} differs by {diffs[name]}")

    # fp32 on both sides (no TF32); convolutions reduce in other orders.
    close("loss", gpu_m["loss"], cpu_m["loss"], 1e-3, 1e-5)
    close("tree", gpu.replay_state.tree, cpu.replay_state.tree, 1e-4, 1e-5)
    for (name, a), b in zip(gpu.train_state.model.named_parameters(), cpu.train_state.model.parameters()):
        close(name, a, b, 1e-4, 1e-6)
    print(f"small slice: card vs CPU agree, largest differences {json.dumps(diffs)}")
    return {"kernel_launches": launches, "max_abs_diff": diffs}


# --------------------------------------------------------------------- phase 4
def run_full_slice(card: str) -> dict:
    from pfrl_tpu_torch.experiments.atari_per_dqn import make_per_dqn_runner
    from pfrl_tpu_torch.ops.prefix_sample import prefix_sample

    runner = make_per_dqn_runner()  # the CUDA device, at full width
    cfg = runner.config
    state = runner.init(0)
    torch.cuda.synchronize()
    beta0 = float(state.replay_state.beta)
    target0 = [p.detach().clone() for p in state.train_state.target_model.parameters()]

    prefix_sample.launches = 0
    t0 = time.perf_counter()
    state, warm = runner.run_chunk(state, FULL_STEPS_WARM)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, timed = runner.run_chunk(state, FULL_STEPS_TIMED)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = prefix_sample.launches

    steps = FULL_STEPS_WARM + FULL_STEPS_TIMED
    samples = sum(
        cfg.updates_per_step for k in range(1, steps + 1) if k * cfg.num_envs >= cfg.replay_start_size
    )
    timed_updates = sum(
        cfg.updates_per_step for k in range(FULL_STEPS_WARM + 1, steps + 1)
        if k * cfg.num_envs >= cfg.replay_start_size
    )
    loss = torch.cat([warm["loss"], timed["loss"]])
    leaves = state.replay_state.tree[runner.buffer.tree_capacity:][: runner.buffer.capacity]
    distinct = int(torch.unique(leaves[leaves > 0]).numel())
    beta = float(state.replay_state.beta)
    synced = any(not torch.equal(a, b) for a, b in zip(target0, state.train_state.target_model.parameters()))
    crossed = state.t // cfg.target_update_interval > 0

    checks = {
        "t advanced": state.t == steps * cfg.num_envs,
        "loss finite": bool(torch.isfinite(loss).all()) and float(loss[-1]) > 0,
        "kernel launches == PER samples": launches == samples == state.train_state.n_updates,
        "priorities changed": distinct > 2,
        "beta annealed": beta > beta0 and math.isclose(
            beta, min(1.0, beta0 + samples * runner.buffer.beta_add), rel_tol=1e-4
        ),
        "target synced on crossing": synced == crossed,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"full slice: failed checks {failed}")
    timed_s = t2 - t1
    result = {
        "steps": steps,
        "t": state.t,
        "kernel_launches": launches,
        "per_samples": samples,
        "launches_per_scan_step": cfg.updates_per_step,
        "env_steps_per_s": FULL_STEPS_TIMED * cfg.num_envs / timed_s,
        "updates_per_s": timed_updates / timed_s,
        "warm_chunk_s": t1 - t0,
        "timed_chunk_s": timed_s,
        "last_loss": float(loss[-1]),
        "beta": beta,
        "distinct_priorities": distinct,
        "target_synced": synced,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(
        f"slice: env-steps/s {result['env_steps_per_s']:.1f} updates/s "
        f"{result['updates_per_s']:.1f} over {FULL_STEPS_TIMED} scan steps "
        f"(64 lanes, fp32, no TF32) on {card}"
    )
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (HERE / "pfrl_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from pfrl_tpu_torch import resolve_device
    from pfrl_tpu_torch.replay.sum_tree import tree_capacity

    device = resolve_device()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    record = {"card": card, "build": build_kernels()}

    kernel = check_prefix_sample(device, tree_capacity(100_000), 32)
    print(
        f"prefix_sample C={kernel['shape']['C']} B={kernel['shape']['B']}: kernel "
        f"{kernel['ms'] * 1e3:.2f} us, plain {kernel['plain_ms'] * 1e3:.2f} us, "
        f"cumsum+searchsorted {kernel['library_ms'] * 1e3:.2f} us, bound "
        f"{kernel['bound_ms'] * 1e3:.3f} us ({kernel['bound_by']}) on {card}; "
        f"host us per call {json.dumps(kernel['host_us_per_call'])}"
    )
    record["small_slice"] = check_small_slice(device)
    record["full_slice"] = run_full_slice(card)
    kernel["launches"] = record["full_slice"]["kernel_launches"]
    record["kernels"] = [kernel]

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in record["kernels"]]}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
