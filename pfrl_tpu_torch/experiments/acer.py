"""ACER's recipes, each returning ``(runner, eval_loop)`` at the JAX
package's widths, on the CUDA device unless given ``device="cpu"``:

- :func:`make_acer_abc_runner` is ``tools/record_curves.py``'s
  ``run_acer_abc``: 16 lanes of the deterministic ``ABC(size=3)``,
  :class:`DensePiQ` (Dense 5 -> 64, ReLU, a logits head and a Q head of 3),
  ``ACERCore`` with Adam(5e-3), gamma 0.9, entropy bonus 1e-2 and the trust
  region, an episodic buffer of 512 rows x 5 steps, one batch-16 update of
  whole rows per 16 transitions from 128 on; ``EvalLoop`` 10 x 5;
- :func:`make_acer_continuous_abc_runner` is ``run_acer_continuous_abc``:
  16 lanes of the deterministic continuous ``ABC(size=2)``, an
  :class:`~pfrl_tpu_torch.agents.acer.ACERSDNModel` of :class:`GaussianPi`
  (Dense 4 -> 32, ReLU, Dense 2, a state-independent Gaussian head),
  :class:`DenseV` (Dense 4 -> 32, ReLU, Dense 1) and ``FCSAQFunction`` (one
  hidden layer of 32), ``ACERContinuousCore`` with Adam(5e-3), gamma 0.9,
  entropy bonus 1e-3, the trust region and ``Q_opc``, 512 rows x 4 steps,
  the same cadence; ``EvalLoop`` 10 x 4;
- :func:`make_acer_atarisim_runner` is ``examples/atari/train_acer_ale.py
  --sim`` at its defaults: 16 lanes of AtariSim (84x84x4 uint8 frames, 6
  actions, episodes of mean length 50), :class:`AtariPiQ`
  (``SmallAtariCNN`` -> 256, a logits head and a Q head), ``ACERCore``
  with RMSprop(7e-4, decay 0.99, eps 1e-2), gamma 0.99, entropy bonus
  1e-2, truncation 10, the trust region (delta 0.1, alpha 0.99), an
  episodic buffer of 2,048 rows x 50 steps on the card (obs and next_obs,
  5.78 GB, and the behaviour's log-probs), one batch-16 update of whole
  rows per 16 transitions from 10^4 on, and ``compute_dtype`` for the
  example's ``--bf16``; ``EvalLoop`` 5 x 500.

ACER has no target network: the runners' target interval is 10^9, as the
JAX recipes set it. Every Dense layer has flax ``nn.Dense``'s default init
(the CNN Chainer's, ``FCSAQFunction``'s ``MLP`` too) and each model names its
flax scopes, so ``convert.acer_state_from_flax`` loads the JAX package's
states. Widths, buffers and cadences are arguments, so that tests run the
recipes small; the recipes' values are the defaults. :func:`run` is
``train_acer_ale.py``'s ``main``.
"""

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.action_value import DiscreteActionValue
from pfrl_tpu_torch.agents.acer import ACERContinuousCore, ACERCore, ACERSDNModel
from pfrl_tpu_torch.distributions import Categorical
from pfrl_tpu_torch.envs.abc import ABC
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.onpolicy import Dense
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.models.atari_cnn import SmallAtariCNN
from pfrl_tpu_torch.models.mlp import scoped_names
from pfrl_tpu_torch.optimizers import Adam, RMSprop
from pfrl_tpu_torch.policies import GaussianHeadWithStateIndependentCovariance
from pfrl_tpu_torch.q_functions import FCSAQFunction
from pfrl_tpu_torch.replay.episodic import EpisodicReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi

Recipe = Tuple[OffPolicyRunner, EvalLoop]
_GAUSSIAN_HEAD = "GaussianHeadWithStateIndependentCovariance_0"


class _Reset(nn.Module):
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for module in self.children():
            module.reset_parameters(generator)


class DensePiQ(_Reset):
    """``run_acer_abc``'s ``PiQ``: ``Dense_0`` (``obs_size -> hidden``),
    ReLU, then the logits ``Dense_1`` and the Q-values ``Dense_2``."""

    def __init__(self, obs_size: int, n_actions: int, hidden: int = 64):
        super().__init__()
        self.hidden = Dense(obs_size, hidden)
        self.logits = Dense(hidden, n_actions)
        self.q = Dense(hidden, n_actions)

    def flax_names(self) -> Dict[str, str]:
        return {"hidden": "Dense_0", "logits": "Dense_1", "q": "Dense_2"}

    def forward(self, x: torch.Tensor):
        h = torch.relu(self.hidden(x))
        return Categorical(logits=self.logits(h)), DiscreteActionValue(q_values=self.q(h))


class AtariPiQ(_Reset):
    """``train_acer_ale.py``'s ``PiQ``: ``SmallAtariCNN_0``, then the logits
    ``Dense_0`` and the Q-values ``Dense_1``."""

    def __init__(self, n_actions: int = 6, n_input_channels: int = 4):
        super().__init__()
        self.torso = SmallAtariCNN(n_input_channels=n_input_channels)
        self.logits = Dense(256, n_actions)
        self.q = Dense(256, n_actions)

    def flax_names(self) -> Dict[str, object]:
        return {**scoped_names("torso", "SmallAtariCNN_0", self.torso), "logits": "Dense_0", "q": "Dense_1"}

    def forward(self, x: torch.Tensor):
        h = self.torso(x)
        return Categorical(logits=self.logits(h)), DiscreteActionValue(q_values=self.q(h))


class GaussianPi(_Reset):
    """``run_acer_continuous_abc``'s ``Pi``: ``Dense_0``, ReLU, the mean
    ``Dense_1`` and a state-independent log-std."""

    def __init__(self, obs_size: int, action_size: int, hidden: int = 32):
        super().__init__()
        self.hidden = Dense(obs_size, hidden)
        self.mean = Dense(hidden, action_size)
        self.head = GaussianHeadWithStateIndependentCovariance(action_size)

    def flax_names(self) -> Dict[str, str]:
        return {"hidden": "Dense_0", "mean": "Dense_1", "head.log_std": f"{_GAUSSIAN_HEAD}/log_std"}

    def forward(self, x: torch.Tensor):
        return self.head(self.mean(torch.relu(self.hidden(x))))


class DenseV(_Reset):
    """``run_acer_continuous_abc``'s ``V``, ``nn.Dense(1)(relu(nn.Dense(32)(x)))``:
    flax numbers its layers as they are built, so the outer ``Dense_0`` is
    the output and the inner ``Dense_1`` the hidden layer."""

    def __init__(self, obs_size: int, hidden: int = 32):
        super().__init__()
        self.hidden = Dense(obs_size, hidden)
        self.out = Dense(hidden, 1)

    def flax_names(self) -> Dict[str, str]:
        return {"hidden": "Dense_1", "out": "Dense_0"}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.hidden(x)))


def _episodic(env, core, eval_env, eval_loop, num_envs, max_episodes, max_episode_len, replay_start_size,
              update_interval, minibatch_size) -> Recipe:
    buffer = EpisodicReplayBuffer(max_episodes, max_episode_len, num_lanes=num_envs, device=env.device)
    config = RunnerConfig(num_envs=num_envs, replay_start_size=replay_start_size, update_interval=update_interval,
                          target_update_interval=10**9, minibatch_size=minibatch_size)  # ACER has no target
    runner = OffPolicyRunner(env, core, buffer, config, device=env.device)
    return runner, EvalLoop(eval_env, core, *eval_loop, device=env.device)


ABC_SIZES = dict(num_envs=16, max_episodes=512, replay_start_size=128, update_interval=16, minibatch_size=16)


def make_acer_abc_runner(hidden: int = 64, device=None, compute_dtype: Optional[torch.dtype] = None,
                         **sizes) -> Recipe:
    env = ABC(size=3, deterministic=True, device=device)
    core = ACERCore(model=DensePiQ(env.n_dim_obs, 3, hidden), optimizer=Adam(5e-3), gamma=0.9, beta=1e-2,
                    use_trust_region=True, compute_dtype=compute_dtype)
    return _episodic(env, core, env, (10, 5), **{**ABC_SIZES, "max_episode_len": 5, **sizes})


def make_acer_continuous_abc_runner(hidden: int = 32, device=None, compute_dtype: Optional[torch.dtype] = None,
                                    **sizes) -> Recipe:
    env = ABC(size=2, discrete=False, episodic=True, deterministic=True, device=device)
    obs, act = env.n_dim_obs, env.action_space.shape[0]
    model = ACERSDNModel(pi=GaussianPi(obs, act, hidden), vf=DenseV(obs, hidden),
                         adv=FCSAQFunction(obs, act, n_hidden_channels=hidden, n_hidden_layers=1))
    core = ACERContinuousCore(model=model, optimizer=Adam(5e-3), gamma=0.9, beta=1e-3, use_trust_region=True,
                              compute_dtype=compute_dtype)
    return _episodic(env, core, env, (10, 4), **{**ABC_SIZES, "max_episode_len": 4, **sizes})


ATARI_SIZES = dict(num_envs=16, max_episodes=2048, max_episode_len=50, replay_start_size=10_000, update_interval=16,
                   minibatch_size=16)


def make_acer_atarisim_runner(n_actions: int = 6, device=None, compute_dtype: Optional[torch.dtype] = None,
                              lr: float = 7e-4, beta: float = 1e-2, mean_episode_len: int = 50,
                              **sizes) -> Recipe:
    """The example gives AtariSim episodes of mean length ``--t-max``, its
    rows' length."""
    sizes = {**ATARI_SIZES, **sizes}
    env = AtariSim(n_actions=n_actions, mean_episode_len=mean_episode_len, device=device)
    core = ACERCore(
        model=AtariPiQ(n_actions),
        optimizer=RMSprop(lr, decay=0.99, eps=1e-2),
        gamma=0.99,
        beta=beta,
        truncation_threshold=10.0,
        use_trust_region=True,
        trust_region_delta=0.1,
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )
    eval_env = AtariSim(n_actions=n_actions, mean_episode_len=mean_episode_len, device=device)
    return _episodic(env, core, eval_env, (5, 500), **sizes)


# ``--config`` name -> recipe, for the tools that run them by name.
RECIPES = {
    "acer-atarisim-16": make_acer_atarisim_runner,
    "acer-abc-16": make_acer_abc_runner,
    "acer-continuous-abc-16": make_acer_continuous_abc_runner,
}


# ``train_acer_ale.py``'s refusal without ``--sim`` (``:120-124``), as it is.
ALE_REFUSAL = ("host ALE requires gym[atari]+cv2 (not in this container); "
               "use --sim, or see train_dqn_ale.py:run_ale for the host path")


def build_parser() -> argparse.ArgumentParser:
    """``train_acer_ale.py``'s flags (``:104-118``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="BreakoutNoFrameskip-v4")
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--chunk", type=int, default=200, help="scan steps per device dispatch")
    parser.add_argument("--steps", type=int, default=10**7)
    parser.add_argument("--lr", type=float, default=7e-4)
    parser.add_argument("--beta", type=float, default=1e-2)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--num-envs", type=int, default=16)
    parser.add_argument("--t-max", type=int, default=50, help="episode chunk length for episodic replay")
    parser.add_argument("--max-episodes", type=int, default=2048)
    parser.add_argument("--replay-start-size", type=int, default=10**4)
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None) -> dict:
    """``train_acer_ale.py``'s ``main`` with ``argv``'s flags on ``device``
    (default: the CUDA device): without ``--sim`` the example's
    ``SystemExit``; with it :func:`make_acer_atarisim_runner` in turns of
    ``--chunk`` scan steps (one update of ``--batch-size`` rows per
    ``--num-envs`` transitions). Returns
    :func:`~.demo_cli.run_device_example`'s dict."""
    from pfrl_tpu_torch.experiments.demo_cli import run_device_example

    args = build_parser().parse_args(argv)
    if not args.sim:
        raise SystemExit(ALE_REFUSAL)
    runner, eval_loop = make_acer_atarisim_runner(
        device=device, compute_dtype=torch.bfloat16 if args.bf16 else None, lr=args.lr, beta=args.beta,
        mean_episode_len=args.t_max, num_envs=args.num_envs, max_episodes=args.max_episodes,
        max_episode_len=args.t_max,
        replay_start_size=args.replay_start_size, update_interval=args.num_envs, minibatch_size=args.batch_size)
    return run_device_example(args, runner, eval_loop, lambda state: runner.run_chunk(state, args.chunk)[0])


if __name__ == "__main__":
    run()
