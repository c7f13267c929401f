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
(``a2c-atarisim-16``, ``a3c-atarisim-16``, ``ppo-atarisim-8``, per
iteration).
The Atari examples' configurations (``dqn-ale-*-64``, ``per-dqn-ale-64``,
``c51-atarisim-64``) count per scan step; ``dqn-pipeline-288``, which is
no runner, counts its device functions on a ring that is filled by
commits, without spawning its actors: one act stage (96 lanes), one
commit (288 lanes) and one burst of 64 updates, and from them the ops per
env step at its cadence (3 act stages and a commit per 288 transitions,
a burst per 256 of them).
``dqn-batch-ale-8``, the ``DQN`` shell of ``experiments/atari_dqn_batch.py``,
counts one ``batch_act`` (8 lanes), one ``batch_observe`` without an update
and one update on frames made on the host, spawning no worker, and from
them the ops per env step (an update per 4 transitions). The host paths of
``profile_host.HOST_PATHS`` (``sac-halfcheetah-host-1``, ...,
``rainbow-slimevolley-cartpole-1``) count the same three calls of their
shells on observations drawn from a normal, at their rings' own sizes
unless ``--capacity`` cuts them; an on-policy shell's update is one whole
update over its rollout. ``dqn-actor-learner-ale-8`` counts one server act
of the padded batch of 8 rows, one poller add of a ring row of 8 frames
and one update, starting no thread. ``grasping-dqn-batch-1`` counts its
shell's three calls on ``(image, steps)`` observations (its ring at
400,000 slots unless ``--capacity`` cuts it); ``naf-pendulum-32``,
``naf-mountaincar-32`` and ``dqn-gym-cartpole-32`` per scan step.
``--bf16`` builds the configuration at ``compute_dtype=torch.bfloat16``.
``--capacity`` shrinks the replay ring, which changes no op of a scan step
(the AtariSim configurations' 100,000 frame slots need 2.8 GB otherwise,
the Atari examples' 10^6 28.3 GB, the pipeline's 999,936 planes 7.1 GB);
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
from pfrl_tpu_torch.experiments.profile_slice import CONFIGS, HOST_OBS, HOST_PATHS, HOSTS, PIPELINES
from pfrl_tpu_torch.utils.draws import Draws


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.counts[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def count_pipeline_ops(config: str, device=None, compute_dtype=None, capacity=None) -> dict:
    """Ops of a pipeline's device functions (see the module docstring)."""
    p = PIPELINES[config](device=device, compute_dtype=compute_dtype, capacity=capacity)
    p._init_device_state(0)
    dev, L, K = p.device, p.L, p.K
    draws = Draws(torch.Generator(device=dev).manual_seed(0))
    flags = lambda: torch.zeros(L, dtype=torch.bool, device=dev)  # noqa: E731
    while p.ring.commit_cursor < p.capacity:  # every row committed: the window is as wide as it gets
        p.commit(p.ring, torch.zeros(L, device=dev), flags(), flags())
    planes = torch.zeros((K, p.hw[0] * p.hw[1]), dtype=torch.uint8, device=dev)
    prev_done = torch.zeros(K, dtype=torch.bool, device=dev)
    counts = {}
    for name, fn in (
        ("act_stage", lambda: p.act_stage(p._acting, p.stack, p.ring, planes, prev_done, 0, p.ring.commit_cursor,
                                          p.replay_start_size, draws)),
        ("commit", lambda: p.commit(p.ring, torch.zeros(L, device=dev), flags(), flags())),
        ("burst", lambda: p.learner_burst(p.train_state, p.ring, draws, p.burst)),
    ):
        with OpCounter() as counter:
            fn()
        counts[name] = counter.counts
    per_env_step = (p.n_workers * sum(counts["act_stage"].values()) + sum(counts["commit"].values())
                    + sum(counts["burst"].values()) * L / (p.update_interval * p.burst)) / L
    return {
        "config": config,
        "compute_dtype": str(compute_dtype),
        "lanes": L,
        **{f"ops_per_{name}": sum(c.values()) for name, c in counts.items()},
        "ops_per_update": sum(counts["burst"].values()) / p.burst,
        "ops_per_env_step": per_env_step,
        "top_ops_per_burst": dict(counts["burst"].most_common(10)),
    }


def count_ops(config: str, steps: int, device=None, compute_dtype=None, capacity=None) -> dict:
    if config in PIPELINES:
        return count_pipeline_ops(config, device, compute_dtype, capacity)
    if config in HOST_PATHS:
        from pfrl_tpu_torch.experiments.profile_host import count_host_path_ops

        return {"config": config, "compute_dtype": str(compute_dtype),
                **count_host_path_ops(config, device, compute_dtype, capacity)}
    if config in HOSTS:
        from pfrl_tpu_torch.experiments.profile_host import count_host_ops

        kw = {} if capacity is None else {"capacity": capacity}
        agent = HOSTS[config](device=device, compute_dtype=compute_dtype, **kw)
        obs = {"obs": HOST_OBS[config]} if config in HOST_OBS else {}
        return {"config": config, "compute_dtype": str(compute_dtype), **count_host_ops(agent, **obs)}
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
    parser.add_argument("--config", choices=sorted([*CONFIGS, *PIPELINES, *HOSTS, *HOST_PATHS]), default=None,
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
