"""Where a full-width configuration's time goes on the card.

    python -m pfrl_tpu_torch.experiments.profile_slice
        [--config per-dqn|dqn|rainbow|sac|td3|ddpg] [--steps 8] [--out PATH]

Runs one configuration at full width on the CUDA device. On 64 lanes of
84x84x4 uint8 AtariSim frames, 16 batch-32 updates per scan step:
``per-dqn`` (``make_per_dqn_runner()``, prioritized-replay Nature DQN),
``dqn`` (``make_dqn_runner()``, the same over the uniform ring) and
``rainbow`` (``make_rainbow_runner()``). For continuous control: ``sac``
and ``td3`` (``make_sac_runner()``, ``make_td3_runner()``: 32 lanes of
MujocoSim, 32 batch-256 updates per scan step) and ``ddpg``
(``make_ddpg_runner()``: 16 lanes of the time-limited Pendulum, 4 batch-128
updates per scan step). The replay start is cut to 2,048 transitions where
the recipe's is later (Rainbow: 20,000), which changes no phase's work: the
ring's size and every shape stay. Past replay start it:

1. times ``--steps`` scan steps as they run (host clock, synchronized);
2. times the same number of steps again with each phase of the scan step
   wrapped in a synchronizing host timer: act, env step, replay add, and
   per update the sample (prioritized: with the prefix-sample kernel and the
   row gather inside it; uniform: one id draw per scan step and a row
   gather per update), the gradient step and the priority feedback, and
   the target sync. The gradient step is split: for the DQN family into its
   forwards (the loss), the backward pass and the optimizer; for the
   actor-critic cores into the critic step, the actor (and temperature)
   step and the soft copies of the targets, which there include the
   runner's own sync every 1,000 transitions;
3. records ``--steps`` more steps with ``torch.profiler``: kernels
   launched per scan step, the device's busy time, and the kernels that
   take the most of it. The busy share is taken against the unprofiled
   time of step 1, since the profiler slows the host.

Prints a summary and writes the record as JSON to ``--out``.
"""

import argparse
import collections
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner, make_per_dqn_runner
from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_runner
from pfrl_tpu_torch.experiments.mujoco_actor_critic import (
    make_ddpg_runner,
    make_sac_runner,
    make_td3_runner,
)

CONFIGS = {
    "per-dqn": make_per_dqn_runner,
    "dqn": make_dqn_runner,
    "rainbow": lambda: make_rainbow_runner(replay_start_size=2_048),
    "sac": make_sac_runner,
    "td3": make_td3_runner,
    "ddpg": make_ddpg_runner,
}

# Labels that start with two spaces are parts of the phase above them.
COMMON_PHASES = (
    ("core", "select_action", "act"),
    ("env", "step", "env step"),
    ("buffer", "add", "replay add"),
    ("core", "update", "gradient step"),
)
DQN_PHASES = (
    ("core", "loss_and_errors", "  of which forwards (loss)"),
    ("autograd", "grad", "  of which backward"),
    ("optimizer", "update", "  of which optimizer"),
    ("core", "sync_target", "target sync"),
)
ACTOR_CRITIC_PHASES = (
    ("core", "critic_step", "  of which critic step"),
    ("core", "actor_step", "  of which actor (and temperature) step"),
    ("core", "sync_target", "  of which soft copies"),
)
PRIORITIZED_PHASES = (
    ("buffer", "sample", "PER sample"),
    ("buffer", "_find_slots", "  of which prefix_sample + clamp"),
    ("buffer", "gather", "  of which row gather"),
    ("buffer", "update_priorities", "priority feedback"),
)
UNIFORM_PHASES = (
    ("buffer", "sample_indices", "id draw"),
    ("buffer", "gather", "row gather"),
)


def _synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _wrap(acc, label, fn):
    def timed(*args, **kwargs):
        out, seconds = _synced(lambda: fn(*args, **kwargs))
        acc[label] += seconds
        return out

    return timed


def profile_slice(config: str, steps: int) -> dict:
    runner = CONFIGS[config]()
    cfg = runner.config
    actor_critic = hasattr(runner.core, "critic_step")
    phases = (
        COMMON_PHASES
        + (ACTOR_CRITIC_PHASES if actor_critic else DQN_PHASES)
        + (UNIFORM_PHASES if runner.buffer.iid_samples else PRIORITIZED_PHASES)
    )
    state = runner.init(0)
    warm = -(-cfg.replay_start_size // cfg.num_envs) + 2  # past replay start
    state, _ = runner.run_chunk(state, warm)

    (state, _), plain_s = _synced(lambda: runner.run_chunk(state, steps))

    acc = collections.defaultdict(float)
    owners = {
        "core": runner.core, "env": runner.env, "buffer": runner.buffer,
        "autograd": torch.autograd, "optimizer": getattr(runner.core, "optimizer", None),
    }
    originals = []
    for owner, attr, label in phases:
        obj = owners[owner]
        originals.append((obj, attr, vars(obj).get(attr)))
        setattr(obj, attr, _wrap(acc, label, getattr(obj, attr)))
    try:
        (state, _), phased_s = _synced(lambda: runner.run_chunk(state, steps))
    finally:
        for obj, attr, own in originals:
            if own is None:
                delattr(obj, attr)  # back to the class's method
            else:
                setattr(obj, attr, own)  # a module's function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, _), profiled_s = _synced(lambda: runner.run_chunk(state, steps))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]

    accounted = sum(v for k, v in acc.items() if not k.startswith("  "))
    per_step_ms = {k: v / steps * 1e3 for k, v in acc.items()}
    per_step_ms["other (runner bookkeeping, timers)"] = (phased_s - accounted) / steps * 1e3
    return {
        "device": torch.cuda.get_device_name(0),
        "config": config,
        "steps": steps,
        "updates_per_step": cfg.updates_per_step,
        "scan_step_ms": plain_s / steps * 1e3,
        "env_steps_per_s": steps * cfg.num_envs / plain_s,
        "phase_ms_per_step_synchronized": per_step_ms,
        "phased_scan_step_ms": phased_s / steps * 1e3,
        "profiled_scan_step_ms": profiled_s / steps * 1e3,
        "device_launches_per_step": len(kernels) / steps,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_busy_share": busy_us / 1e6 / plain_s,
        "top_device_ops": [
            {"name": name, "ms_per_step": us / steps / 1e3, "launches_per_step": n / steps}
            for name, (us, n) in top
        ],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="per-dqn")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--out", default=None, help="default: chiprun_out/profile_<config>.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    record = profile_slice(args.config, args.steps)
    out = Path(args.out or f"chiprun_out/profile_{args.config}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps({k: v for k, v in record.items() if k != "top_device_ops"}, indent=1))
    for op in record["top_device_ops"]:
        print(f"{op['ms_per_step']:9.3f} ms/step {op['launches_per_step']:8.1f} launches/step  {op['name'][:90]}")


if __name__ == "__main__":
    main()
