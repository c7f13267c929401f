"""Aten ops per scan step of a CartPole value recipe, counted on the host.

    python -m pfrl_tpu_torch.experiments.count_ops [--config dqn-cartpole] [--steps 4] [--device cpu]

Runs the recipe of ``experiments/cartpole_value.py`` at full width past
replay start, then counts, under a ``TorchDispatchMode``, every aten op
the next ``--steps`` scan steps dispatch (views, which launch nothing, are
left out). The count is a property of the program, not of a device: it is
what a prediction of kernels per scan step starts from. It times nothing.
Configs: ``dqn-cartpole``, ``c51-cartpole``, ``rainbow-cartpole``,
``al-cartpole``, ``iqn-cartpole``, ``dqn-cartpole-example``.
"""

import argparse
import collections
import json
import math

from torch.utils._python_dispatch import TorchDispatchMode

from pfrl_tpu_torch.experiments.cartpole_value import RECIPES


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def count_ops(config: str, steps: int, device=None) -> dict:
    runner, _ = RECIPES[config](device=device)
    cfg = runner.config
    state = runner.init(0)
    state, _ = runner.run_chunk(state, math.ceil(cfg.replay_start_size / cfg.num_envs) + 1)
    with OpCounter() as counter:
        runner.run_chunk(state, steps)
    total = sum(counter.counts.values())
    return {
        "config": config,
        "lanes": cfg.num_envs,
        "updates_per_step": cfg.updates_per_step,
        "ops_per_scan_step": total / steps,
        "top_ops_per_scan_step": {k: v / steps for k, v in counter.counts.most_common(10)},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=sorted(RECIPES), default=None, help="default: all")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--device", default=None, help="default: the CUDA device (cpu counts the same ops)")
    args = parser.parse_args()
    for config in [args.config] if args.config else list(RECIPES):
        print(json.dumps(count_ops(config, args.steps, args.device)))


if __name__ == "__main__":
    main()
