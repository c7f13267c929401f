"""The Nature-DQN configurations on AtariSim frames.

:func:`make_dqn_runner` is ``bench.py``'s ``bench_dqn`` workload: 64 lanes
of 84x84x4 uint8 frames, Nature CNN + linear head, linear-decay
epsilon-greedy, DQN with a summed Huber loss and hard target syncs every
10,000 transitions, optax-semantics RMSprop(2.5e-4, decay 0.95, eps 1e-2),
a 100,000-slot uint8 ring read by adjacency and dequantized in the gather,
one batch-32 update per 4 transitions after 2,000. Its ``double`` and
``prioritized`` switches are those of
``examples/atari/train_dqn_ale.py --sim [--double] [--prioritized]``: the
Double-DQN target, and proportional prioritized replay (alpha 0.6, beta
0.4) in place of the uniform ring. :func:`make_per_dqn_runner` is the
prioritized one, the first slice that was ported. ``noisy_net_sigma`` is
``--noisy-net-sigma``: the Q head becomes a factorized noisy layer at that
sigma scale (``to_factorized_noisy``) and the explorer ``Greedy``.
``compute_dtype`` is ``--bf16`` and ``bench_dqn``'s A/B: ``torch.bfloat16``
runs the network in bf16 over float32 masters.
"""

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.agents.double_dqn import DoubleDQNCore
from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.runner import OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers.epsilon_greedy import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.explorers.greedy import Greedy
from pfrl_tpu_torch.models.atari_cnn import LargeAtariCNN
from pfrl_tpu_torch.models.layers import Linear
from pfrl_tpu_torch.models.noisy_linear import to_factorized_noisy
from pfrl_tpu_torch.optimizers.rmsprop import RMSprop
from pfrl_tpu_torch.q_functions.state_q_functions import DiscreteActionValueHead
from pfrl_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from pfrl_tpu_torch.replay.uniform import ReplayBuffer
from pfrl_tpu_torch.utils.batch_states import atari_phi


class Dense(Linear):
    """flax ``nn.Dense`` with its default init (truncated LeCun normal, zero
    bias); it takes and ignores the draw source."""

    flax_scope = "Dense"

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        initializers.truncated_lecun_normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        return super().forward(x)


class NatureQ(nn.Module):
    """LargeAtariCNN -> Dense(512, n_actions) -> DiscreteActionValueHead,
    the ``NatureQ`` that ``bench.py`` defines in flax and the ``ConvQ`` of
    ``train_dqn_ale.py``. ``dense_cls`` ``(in, out) -> layer`` replaces the
    head (``to_factorized_noisy``); the draw source reaches it.
    ``torso_cls`` swaps the torso (``SmallAtariCNN`` for ``--arch nips``,
    :class:`~pfrl_tpu_torch.experiments.atari_dqn_ale.ConvQ`)."""

    def __init__(
        self,
        n_actions: int = 6,
        frame_shape: Tuple[int, int, int] = (84, 84, 4),
        dense_cls: Optional[Callable[[int, int], nn.Module]] = None,
        torso_cls: type = LargeAtariCNN,
    ):
        super().__init__()
        h, w, c = frame_shape
        self.torso = torso_cls(n_input_channels=c, input_hw=(h, w))
        self.head = (dense_cls or Dense)(self.torso.dense.out_features, n_actions)
        self.q = DiscreteActionValueHead()
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.torso.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        torso = type(self.torso).__name__
        names = {f"torso.{k}": f"{torso}_0/{v}" for k, v in self.torso.flax_names().items()}
        names["head"] = f"{self.head.flax_scope}_0"
        return names

    def forward(self, x: torch.Tensor, draws=None):
        return self.q(self.head(self.torso(x), draws))


def make_dqn_runner(
    num_envs: int = 64,
    capacity: int = 100_000,
    replay_start_size: int = 2_000,
    update_interval: int = 4,
    target_update_interval: int = 10_000,
    minibatch_size: int = 32,
    n_actions: int = 6,
    frame_shape: Tuple[int, int, int] = (84, 84, 4),
    double: bool = False,
    prioritized: bool = False,
    noisy_net_sigma: Optional[float] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
    final_epsilon: float = 0.1,
    final_exploration_frames: int = 1_000_000,
) -> OffPolicyRunner:
    """Nature DQN at the given sizes (defaults: the full configuration) on
    ``device`` (default: the CUDA device); epsilon decays from 1 to
    ``final_epsilon`` over ``final_exploration_frames`` transitions."""
    env = AtariSim(n_actions=n_actions, frame_shape=frame_shape, device=device)
    noisy = noisy_net_sigma is not None
    dense_cls = to_factorized_noisy(nn.Linear, sigma_scale=noisy_net_sigma) if noisy else None
    core = (DoubleDQNCore if double else DQNCore)(
        model=NatureQ(n_actions, frame_shape, dense_cls),
        optimizer=RMSprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=Greedy() if noisy else LinearDecayEpsilonGreedy(
            1.0, final_epsilon, final_exploration_frames, n_actions),
        gamma=0.99,
        batch_accumulator="sum",
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )
    ring = dict(
        gamma=0.99,
        num_lanes=num_envs,
        store_next_obs=False,
        fused_dequant_scale=1.0 / 255.0,
        device=env.device,
    )
    if prioritized:
        buffer = PrioritizedReplayBuffer(capacity, alpha=0.6, beta0=0.4, **ring)
    else:
        buffer = ReplayBuffer(capacity, **ring)
    config = RunnerConfig(
        num_envs=num_envs,
        replay_start_size=replay_start_size,
        update_interval=update_interval,
        target_update_interval=target_update_interval,
        minibatch_size=minibatch_size,
    )
    return OffPolicyRunner(env, core, buffer, config, device=env.device)


def make_per_dqn_runner(**sizes) -> OffPolicyRunner:
    """:func:`make_dqn_runner` with prioritized replay."""
    return make_dqn_runner(prioritized=True, **sizes)
