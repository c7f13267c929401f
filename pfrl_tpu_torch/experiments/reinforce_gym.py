"""``examples/gym/train_reinforce_gym.py`` at the example's own settings.

:class:`ReinforcePolicy` is the example's ``Policy`` (Dense(128) -> ReLU ->
Dense(n_actions) -> ``SoftmaxCategoricalHead``; flax scopes ``Dense_0`` and
``Dense_1``), the network of ``zoo/reinforce/cartpole`` and
``zoo/reinforce/cartpole_real``. :func:`make_reinforce_agent` is the
example's ``REINFORCE`` (Adam(1e-3), gamma 0.99, beta 1e-4, 10 episodes per
update, episodes padded to 500 steps, the mean-return baseline), and
:func:`make_cartpole_env` its default env, the port's CartPole limited to
500 steps behind the host protocol (``HostTorchEnv``). The example trains
them with ``train_agent_with_evaluation``.
"""

from typing import Dict, Optional

import torch
from torch import nn

from pfrl_tpu_torch.agents.reinforce import REINFORCE
from pfrl_tpu_torch.envs.cartpole import CartPole
from pfrl_tpu_torch.envs.host_adapter import HostTorchEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.onpolicy import Dense
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.policies import SoftmaxCategoricalHead


class ReinforcePolicy(nn.Module):
    def __init__(self, obs_size: int = 4, n_actions: int = 2, hidden: int = 128):
        super().__init__()
        self.hidden = Dense(obs_size, hidden)
        self.logits = Dense(hidden, n_actions)
        self.head = SoftmaxCategoricalHead()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.hidden.reset_parameters(generator)
        self.logits.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return {"hidden": "Dense_0", "logits": "Dense_1"}

    def forward(self, x: torch.Tensor):
        return self.head(self.logits(torch.relu(self.hidden(x))))


def make_reinforce_agent(
    obs_size: int = 4,
    n_actions: int = 2,
    lr: float = 1e-3,
    beta: float = 1e-4,
    batchsize: int = 10,
    compute_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    device=None,
    draws=None,
) -> REINFORCE:
    """The example's agent on ``device`` (default: the CUDA device)."""
    return REINFORCE(
        ReinforcePolicy(obs_size, n_actions),
        Adam(lr),
        gamma=0.99,
        beta=beta,
        batchsize=batchsize,
        max_episode_len=500,
        baseline=True,
        compute_dtype=compute_dtype,
        seed=seed,
        device=device,
        draws=draws,
    )


def make_cartpole_env(seed: int = 0, device=None, draws=None) -> HostTorchEnv:
    """``HostJaxEnv(TimeLimit(CartPole(), 500), seed=seed)`` of the example,
    on the port's CartPole."""
    return HostTorchEnv(TimeLimit(CartPole(device=device), 500), seed=seed, draws=draws)
