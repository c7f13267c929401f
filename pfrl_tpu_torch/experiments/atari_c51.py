"""``examples/atari/train_categorical_dqn_ale.py --sim``: C51 on the Nature
CNN at the example's own settings.

:func:`make_c51_atarisim_runner` returns ``(runner, eval_loop)``: 64 lanes
of AtariSim (84x84x4 uint8 frames, 6 actions); :class:`C51Q`
(``LargeAtariCNN`` -> Dense(n_actions * 51) -> a softmax over 51 atoms on
``linspace(-10, 10)``); ``CategoricalDQNCore`` with optax-semantics
Adam(2.5e-4, eps 1e-2 / 32) and the ``"mean"`` accumulator;
``LinearDecayEpsilonGreedy`` 1.0 -> 0.01 over 10^6 transitions; a ring of
10^6 slots read by adjacency (``store_next_obs=False``, 1-step) that does
**not** dequantize: the example's ``phi`` divides the uint8 frames by 255.0
on the act path and after the gather alike (ROADMAP C3: each path keeps its
own op, here the same one); one batch-32 update per 4 transitions from
50,000 on, hard target syncs every 10^4; ``EvalLoop`` 5 x 500. The support
is ``support()``, ``jnp.linspace`` to the bit (C8, C24), and below float32
the softmax is ``utils/precision.softmax``, op by op as ``jax.nn.softmax``
rounds (C31). Sizes are arguments; the example's values are the defaults.
:func:`run` is the example's ``main``.
"""

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.action_value import DistributionalDiscreteActionValue
from pfrl_tpu_torch.agents.categorical_dqn import CategoricalDQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.atari_per_dqn import Dense
from pfrl_tpu_torch.experiments.atari_rainbow import phi
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions.dueling_dqn import support
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.precision import softmax


class C51Q(nn.Module):
    """``train_categorical_dqn_ale.py:35-50``: flax scopes ``LargeAtariCNN_0``
    and ``Dense_0`` (flax ``nn.Dense``'s default init)."""

    def __init__(self, n_actions: int = 6, n_atoms: int = 51, v_min: float = -10.0, v_max: float = 10.0,
                 frame_shape: Tuple[int, int, int] = (84, 84, 4)):
        super().__init__()
        h, w, c = frame_shape
        self.n_actions, self.n_atoms = n_actions, n_atoms
        self.torso = LargeAtariCNN(n_input_channels=c, input_hw=(h, w))
        self.head = Dense(self.torso.dense.out_features, n_actions * n_atoms)
        self.register_buffer("z_values", support(v_min, v_max, n_atoms))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.torso.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        names = {f"torso.{k}": f"LargeAtariCNN_0/{v}" for k, v in self.torso.flax_names().items()}
        names["head"] = "Dense_0"
        return names

    def forward(self, x: torch.Tensor, draws=None) -> DistributionalDiscreteActionValue:
        logits = self.head(self.torso(x)).reshape(x.shape[0], self.n_actions, self.n_atoms)
        return DistributionalDiscreteActionValue(q_dist=softmax(logits, dim=-1), z_values=self.z_values)


def make_c51_core(n_actions: int = 6, minibatch_size: int = 32, final_exploration_frames: int = 10**6,
                  compute_dtype: Optional[torch.dtype] = None, n_atoms: int = 51,
                  lr: float = 2.5e-4) -> CategoricalDQNCore:
    """The example's core; Adam's eps is ``1e-2 / minibatch_size``."""
    return CategoricalDQNCore(
        model=C51Q(n_actions, n_atoms),
        optimizer=Adam(lr, eps=1e-2 / minibatch_size),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.01, final_exploration_frames, n_actions),
        gamma=0.99,
        phi=phi,
        compute_dtype=compute_dtype,
    )


def make_c51_atarisim_runner(
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    num_envs: int = 64,
    capacity: int = 10**6,
    replay_start_size: int = 5 * 10**4,
    target_update_interval: int = 10**4,
    minibatch_size: int = 32,
    final_exploration_frames: int = 10**6,
    n_actions: int = 6,
    n_atoms: int = 51,
    lr: float = 2.5e-4,
) -> Tuple[OffPolicyRunner, EvalLoop]:
    """``train_categorical_dqn_ale.py --sim [--bf16]`` on ``device``
    (default: the CUDA device)."""
    env = AtariSim(n_actions=n_actions, device=device)
    core = make_c51_core(n_actions, minibatch_size, final_exploration_frames, compute_dtype, n_atoms, lr)
    buffer = ReplayBuffer(capacity, gamma=0.99, num_lanes=num_envs, store_next_obs=False, device=env.device)
    config = RunnerConfig(
        num_envs=num_envs,
        replay_start_size=replay_start_size,
        update_interval=4,
        target_update_interval=target_update_interval,
        minibatch_size=minibatch_size,
    )
    runner = OffPolicyRunner(env, core, buffer, config, device=env.device)
    return runner, EvalLoop(AtariSim(n_actions=n_actions, device=env.device), core, 5, 500, device=env.device)


# The example's refusal without ``--sim`` (``:116-120``), as it is.
ALE_REFUSAL = ("host ALE requires gym[atari]+cv2 (not in this container); "
               "use --sim, or see train_dqn_ale.py:run_ale for the host path")


def build_parser() -> argparse.ArgumentParser:
    """``train_categorical_dqn_ale.py``'s flags (``:100-114``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--chunk", type=int, default=200, help="scan steps per device dispatch")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--n-atoms", type=int, default=51)
    parser.add_argument("--lr", type=float, default=2.5e-4)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--replay-capacity", type=int, default=10**6)
    parser.add_argument("--replay-start-size", type=int, default=5 * 10**4)
    parser.add_argument("--target-update-interval", type=int, default=10**4)
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """The example's ``main`` with ``argv``'s flags on ``device`` (default:
    the CUDA device): without ``--sim`` its ``SystemExit``; with it
    :func:`make_c51_atarisim_runner` in turns of ``--chunk`` scan steps.
    Returns :func:`~.demo_cli.run_device_example`'s dict."""
    from pfrl_tpu_torch.experiments.demo_cli import run_device_example

    args = build_parser().parse_args(argv)
    if not args.sim:
        raise SystemExit(ALE_REFUSAL)
    runner, eval_loop = make_c51_atarisim_runner(
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=device, num_envs=args.num_envs,
        capacity=args.replay_capacity, replay_start_size=args.replay_start_size,
        target_update_interval=args.target_update_interval, minibatch_size=args.batch_size, n_atoms=args.n_atoms,
        lr=args.lr)
    return run_device_example(args, runner, eval_loop, lambda state: runner.run_chunk(state, args.chunk)[0])


if __name__ == "__main__":
    run()
