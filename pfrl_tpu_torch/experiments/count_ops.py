"""Aten ops per scan step (or on-policy iteration) of a configuration,
counted on the host.

    python -m pfrl_tpu_torch.experiments.count_ops [--config dqn-cartpole] [--steps 4]
        [--bf16] [--capacity N] [--device cpu]

Runs a configuration of ``experiments/profile_slice.py`` (default: each
CartPole recipe of ``experiments/cartpole_value.py``) at full width past
replay start, then counts, under a ``TorchDispatchMode``, every aten op
the next ``--steps`` scan steps dispatch (views, which launch nothing, are
left out). The count is a property of the program, not of a device: it is
what a prediction of kernels per scan step starts from. It times nothing.
The on-policy configurations (``ppo``, ``ppo-pendulum``, ``trpo``,
``a2c``) count per iteration, after one warm iteration; ``--steps`` counts
iterations there.
The recurrent family's configurations count the same way
(``rppo-delayedcue-16`` and ``rtrpo-delayedcue-16`` per iteration), and so
do ACER's (``acer-atarisim-16``, ``acer-abc-16``,
``acer-continuous-abc-16``) and the Atari on-policy examples'
(``a2c-atarisim-16``, ``ppo-atarisim-8``, per iteration).
``--bf16`` builds the configuration at ``compute_dtype=torch.bfloat16``.
``--capacity`` shrinks the replay ring, which changes no op of a scan step
(the AtariSim configurations' 100,000 frame slots need 2.8 GB otherwise);
for the episodic buffers it is the number of rows (``drqn-atarisim-32``'s
2,048 rows of 128 frames and carries need 5.9 GB, ``acer-atarisim-16``'s
2,048 rows of 50 frame pairs 5.8 GB); the on-policy
configurations keep no replay, and it does not apply to them.
"""

import argparse
import collections
import json
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pfrl_tpu_torch.experiments.cartpole_value import RECIPES
from pfrl_tpu_torch.experiments.profile_slice import CONFIGS


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def count_ops(config: str, steps: int, device=None, compute_dtype=None, capacity=None) -> dict:
    runner = CONFIGS[config](device=device, compute_dtype=compute_dtype, capacity=capacity)
    if hasattr(runner, "run_iterations"):
        state, _ = runner.run_iterations(runner.init(0), 1)
        with OpCounter() as counter:
            runner.run_iterations(state, steps)
        lanes, unit, per = runner.num_envs, "iteration", {}
    else:
        cfg = runner.config
        state = runner.init(0)
        state, _ = runner.run_chunk(state, math.ceil(cfg.replay_start_size / cfg.num_envs) + 1)
        with OpCounter() as counter:
            runner.run_chunk(state, steps)
        lanes, unit, per = cfg.num_envs, "scan_step", {"updates_per_step": cfg.updates_per_step}
    return {
        "config": config,
        "compute_dtype": str(compute_dtype),
        "lanes": lanes,
        **per,
        f"ops_per_{unit}": sum(counter.counts.values()) / steps,
        f"top_ops_per_{unit}": {k: v / steps for k, v in counter.counts.most_common(10)},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default=None,
                        help="default: each CartPole recipe")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--bf16", action="store_true", help="bf16 compute over float32 masters")
    parser.add_argument("--capacity", type=int, default=None, help="replay slots, or an episodic buffer's rows (default: the recipe's)")
    parser.add_argument("--device", default=None, help="default: the CUDA device (cpu counts the same ops)")
    args = parser.parse_args()
    dtype = torch.bfloat16 if args.bf16 else None
    for config in [args.config] if args.config else list(RECIPES):
        print(json.dumps(count_ops(config, args.steps, args.device, dtype, args.capacity)))


if __name__ == "__main__":
    main()
