"""On-policy recipes through ``OnPolicyRunner``: PPO on MujocoSim, on
Pendulum and on AtariSim, TRPO on Pendulum, and A2C on CartPole and on
AtariSim.

- :func:`make_ppo_runner` is ``bench.py``'s ``bench_ppo``: 8 lanes of
  ``MujocoSim()`` (obs 17, action 6, truncation at 1,000), rollout 256 (2,048
  transitions per iteration), :class:`GaussianPiV` (policy tower 64 -> 64 ->
  6 with tanh and a state-independent Gaussian head; value tower 64 -> 64 ->
  1), Adam(3e-4), 10 epochs of batch-64 minibatches (320 steps per
  iteration), no entropy bonus, standardized advantages.
- :func:`make_ppo_pendulum_runner` is ``tools/record_curves.py``'s
  ``run_ppo_pendulum``: 16 lanes of ``TimeLimit(Pendulum(), 200)``, rollout
  128, the same PiV with one action whose mean layer is initialized by
  ``variance_scaling(1e-4, "fan_in", "normal")``, the same PPO settings.
- :func:`make_trpo_pendulum_runner` is ``run_trpo_pendulum``: the same env
  and lanes, policy 64 -> 64 -> 1 with tanh and the Gaussian head, value
  function ``MLP(3 -> 64 -> 64 -> 1)`` (ReLU, Chainer-default init) fit by
  Adam(1e-3) for 5 epochs, max KL 0.01.
- :func:`make_a2c_cartpole_runner` is ``run_a2c_cartpole``: 32 lanes of
  ``TimeLimit(CartPole(), 500)``, rollout 8, a shared tanh trunk 64 -> 64
  with a softmax head over ``Dense(2)`` and a ``Dense(1)`` value,
  RMSprop(7e-4, decay 0.99, eps 1e-5) after clipping the gradients' global
  norm at 40, entropy bonus 0.01, value loss weight 0.5.
- :func:`make_a2c_atarisim_runner` is ``examples/atari/train_a2c_ale.py
  --sim``: 16 lanes of AtariSim (84x84x4 uint8 frames, 6 actions), rollout
  5, :class:`AtariPiV` (``SmallAtariCNN`` -> 256, a softmax head over
  ``Dense(6)`` and a ``Dense(1)`` value), RMSprop(7e-4, decay 0.99, eps
  1e-5) after clipping the gradients' global norm at 40, entropy bonus
  0.01, value loss weight 0.5, n-step returns or, with ``use_gae``, GAE
  with tau 0.95.
- :func:`make_ppo_atarisim_runner` is ``examples/atari/train_ppo_ale.py
  --sim``: 8 lanes of AtariSim, rollout 128 (1,024 transitions per
  iteration), the same :class:`AtariPiV`, Adam(2.5e-4, eps 1e-5), 4 epochs
  of batch-256 minibatches, clip 0.1, entropy bonus 0.01, standardized
  advantages.

Their evaluation is ``EvalLoop(env, runner.core, 10, 201)`` (Pendulum),
``EvalLoop(env, runner.core, 10, 501)`` (CartPole) or
``EvalLoop(env, runner.core, 5, 500)`` (AtariSim, the examples'). Every layer outside the
value-function MLP has flax ``nn.Dense``'s default init (truncated LeCun
normal, zero bias), and each module names its flax scopes
(``flax_names``) so that ``convert.py`` loads the JAX package's parameters.

The PPO and A2C recipes take ``compute_dtype`` (the examples' ``--bf16``;
``None``: float32). The TRPO recipe refuses any but ``None`` by name, as
``train_trpo.py --bf16`` does: its Fisher-vector products, conjugate
gradient and KL line search are float32 by design.
"""

from typing import Dict, Optional

import torch
from torch import nn

from pfrl_tpu_torch import initializers
from pfrl_tpu_torch.agents.a2c import A2CCore
from pfrl_tpu_torch.agents.ppo import PPOCore
from pfrl_tpu_torch.agents.trpo import TRPOCore
from pfrl_tpu_torch.env import TorchEnv
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.envs.cartpole import CartPole
from pfrl_tpu_torch.envs.mujoco_sim import MujocoSim
from pfrl_tpu_torch.envs.pendulum import Pendulum
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner
from pfrl_tpu_torch.models.atari_cnn import SmallAtariCNN
from pfrl_tpu_torch.models.layers import Linear
from pfrl_tpu_torch.models.mlp import MLP, scoped_names
from pfrl_tpu_torch.optimizers import Adam, RMSprop
from pfrl_tpu_torch.policies import GaussianHeadWithStateIndependentCovariance, SoftmaxCategoricalHead
from pfrl_tpu_torch.utils.batch_states import atari_phi

_GAUSSIAN_HEAD = "GaussianHeadWithStateIndependentCovariance_0"


class Dense(Linear):
    """flax ``nn.Dense``: a truncated LeCun-normal kernel, or, given
    ``scale``, ``variance_scaling(scale, "fan_in", "normal")`` (untruncated);
    a zero bias."""

    def __init__(self, in_size: int, out_size: int, scale: Optional[float] = None):
        self.scale = scale
        super().__init__(in_size, out_size)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.scale is None:
            initializers.truncated_lecun_normal_(self.weight, generator=generator)
        else:
            initializers.lecun_normal_(self.weight, scale=self.scale, generator=generator)
        self.bias.zero_()


def _tower(in_size: int, hidden: int, out_size: int, out_scale: Optional[float] = None) -> nn.ModuleList:
    return nn.ModuleList([Dense(in_size, hidden), Dense(hidden, hidden), Dense(hidden, out_size, out_scale)])


def _tanh_tower(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers[:-1]:
        x = torch.tanh(layer(x))
    return layers[-1](x)


class _FlaxCompact(nn.Module):
    """Re-initializes every Dense and head in definition order; names the
    Dense layers ``Dense_<i>`` in the order the flax module calls them."""

    dense_order = ()  # attribute names of the towers, in flax's call order

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        names, i = {}, 0
        for attr in self.dense_order:
            for k in range(len(getattr(self, attr))):
                names[f"{attr}.{k}"] = f"Dense_{i}"
                i += 1
        if hasattr(self, "head") and list(self.head.parameters()):
            names["head.log_std"] = f"{_GAUSSIAN_HEAD}/log_std"
        return names


class GaussianPiV(_FlaxCompact):
    """``bench_ppo``'s ``PiV``: separate policy and value towers; the policy
    tower's last layer gives the Gaussian's mean (``mean_scale``: its
    variance-scaling init, else flax's default)."""

    dense_order = ("pi", "v")

    def __init__(self, obs_size: int, action_size: int, hidden: int = 64, mean_scale: Optional[float] = None):
        super().__init__()
        self.pi = _tower(obs_size, hidden, action_size, mean_scale)
        self.head = GaussianHeadWithStateIndependentCovariance(action_size)
        self.v = _tower(obs_size, hidden, 1)

    def forward(self, x: torch.Tensor):
        return self.head(_tanh_tower(self.pi, x)), _tanh_tower(self.v, x)


class GaussianPolicy(_FlaxCompact):
    """``run_trpo_pendulum``'s ``Pi``."""

    dense_order = ("pi",)

    def __init__(self, obs_size: int, action_size: int, hidden: int = 64, mean_scale: Optional[float] = None):
        super().__init__()
        self.pi = _tower(obs_size, hidden, action_size, mean_scale)
        self.head = GaussianHeadWithStateIndependentCovariance(action_size)

    def forward(self, x: torch.Tensor):
        return self.head(_tanh_tower(self.pi, x))


class SoftmaxPiV(_FlaxCompact):
    """``run_a2c_cartpole``'s ``PiV``: a shared tanh trunk, then the logits
    (``Dense_2``) and the value (``Dense_3``)."""

    dense_order = ("trunk", "out")

    def __init__(self, obs_size: int, n_actions: int, hidden: int = 64):
        super().__init__()
        self.trunk = nn.ModuleList([Dense(obs_size, hidden), Dense(hidden, hidden)])
        self.out = nn.ModuleList([Dense(hidden, n_actions), Dense(hidden, 1)])
        self.head = SoftmaxCategoricalHead()

    def forward(self, x: torch.Tensor):
        h = x
        for layer in self.trunk:
            h = torch.tanh(layer(h))
        return self.head(self.out[0](h)), self.out[1](h)


class AtariPiV(nn.Module):
    """The Atari examples' ``PiV``: ``SmallAtariCNN_0``, then the logits
    ``Dense_0`` under a softmax head and the value ``Dense_1``."""

    def __init__(self, n_actions: int = 6, n_input_channels: int = 4):
        super().__init__()
        self.torso = SmallAtariCNN(n_input_channels=n_input_channels)
        self.logits = Dense(256, n_actions)
        self.v = Dense(256, 1)
        self.head = SoftmaxCategoricalHead()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for module in (self.torso, self.logits, self.v):
            module.reset_parameters(generator)

    def flax_names(self) -> Dict[str, str]:
        return {**scoped_names("torso", "SmallAtariCNN_0", self.torso), "logits": "Dense_0", "v": "Dense_1"}

    def forward(self, x: torch.Tensor):
        h = self.torso(x)
        return self.head(self.logits(h)), self.v(h)


def time_limited_pendulum(device=None) -> TorchEnv:
    return TimeLimit(Pendulum(device=device), 200)


def time_limited_cartpole(device=None) -> TorchEnv:
    return TimeLimit(CartPole(device=device), 500)


def _ppo_core(model: nn.Module, epochs: int, minibatch_size: int, compute_dtype) -> PPOCore:
    return PPOCore(
        model, Adam(3e-4), epochs=epochs, minibatch_size=minibatch_size,
        entropy_coef=0.0, standardize_advantages=True, compute_dtype=compute_dtype,
    )


def make_ppo_runner(
    num_envs: int = 8,
    rollout_len: int = 256,
    epochs: int = 10,
    minibatch_size: int = 64,
    hidden: int = 64,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """PPO at the given sizes (defaults: ``bench_ppo``'s) on ``device``
    (default: the CUDA device); ``env`` defaults to ``MujocoSim()``."""
    env = MujocoSim(device=device) if env is None else env
    obs_size, action_size = env.observation_space.shape[0], env.action_space.shape[0]
    core = _ppo_core(GaussianPiV(obs_size, action_size, hidden), epochs, minibatch_size, compute_dtype)
    return OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)


def make_ppo_pendulum_runner(
    num_envs: int = 16,
    rollout_len: int = 128,
    epochs: int = 10,
    minibatch_size: int = 64,
    hidden: int = 64,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """PPO at the given sizes (defaults: ``run_ppo_pendulum``'s); ``env``
    defaults to :func:`time_limited_pendulum`."""
    env = time_limited_pendulum(device) if env is None else env
    core = _ppo_core(GaussianPiV(3, 1, hidden, mean_scale=1e-4), epochs, minibatch_size, compute_dtype)
    return OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)


def make_trpo_pendulum_runner(
    num_envs: int = 16,
    rollout_len: int = 128,
    vf_epochs: int = 5,
    vf_batch_size: int = 64,
    hidden: int = 64,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """TRPO at the given sizes (defaults: ``run_trpo_pendulum``'s).
    ``compute_dtype`` other than ``None`` raises."""
    if compute_dtype is not None:
        raise ValueError(
            f"TRPO runs float32 by design, not compute_dtype={compute_dtype}: its Fisher-vector products, "
            "conjugate gradient and KL line search are delicate second-order quantities"
        )
    env = time_limited_pendulum(device) if env is None else env
    core = TRPOCore(
        policy=GaussianPolicy(3, 1, hidden, mean_scale=1e-4),
        vf=MLP(3, 1, (hidden, hidden)),
        vf_optimizer=Adam(1e-3),
        gamma=0.99,
        lambd=0.95,
        max_kl=0.01,
        vf_epochs=vf_epochs,
        vf_batch_size=vf_batch_size,
        entropy_coef=0.0,
    )
    return OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)


def make_a2c_cartpole_runner(
    num_envs: int = 32,
    rollout_len: int = 8,
    hidden: int = 64,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """A2C at the given sizes (defaults: ``run_a2c_cartpole``'s); ``env``
    defaults to :func:`time_limited_cartpole`."""
    env = time_limited_cartpole(device) if env is None else env
    core = A2CCore(
        SoftmaxPiV(4, 2, hidden),
        RMSprop(7e-4, decay=0.99, eps=1e-5),
        gamma=0.99,
        entropy_coeff=0.01,
        v_loss_coef=0.5,
        max_grad_norm=40.0,
        compute_dtype=compute_dtype,
    )
    return OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)


def make_a2c_atarisim_runner(
    num_envs: int = 16,
    rollout_len: int = 5,
    n_actions: int = 6,
    use_gae: bool = False,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """A2C at the given sizes (defaults: ``train_a2c_ale.py --sim``'s);
    ``env`` defaults to ``AtariSim(n_actions)``."""
    env = AtariSim(n_actions=n_actions, device=device) if env is None else env
    core = A2CCore(
        AtariPiV(n_actions),
        RMSprop(7e-4, decay=0.99, eps=1e-5),
        gamma=0.99,
        use_gae=use_gae,
        tau=0.95,
        entropy_coeff=0.01,
        v_loss_coef=0.5,
        max_grad_norm=40.0,
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )
    return OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)


def make_ppo_atarisim_runner(
    num_envs: int = 8,
    rollout_len: int = 128,
    epochs: int = 4,
    minibatch_size: int = 256,
    n_actions: int = 6,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """PPO at the given sizes (defaults: ``train_ppo_ale.py --sim``'s);
    ``env`` defaults to ``AtariSim(n_actions)``."""
    env = AtariSim(n_actions=n_actions, device=device) if env is None else env
    core = PPOCore(
        AtariPiV(n_actions),
        Adam(2.5e-4, eps=1e-5),
        gamma=0.99,
        lambd=0.95,
        clip_eps=0.1,
        entropy_coef=0.01,
        epochs=epochs,
        minibatch_size=minibatch_size,
        standardize_advantages=True,
        phi=atari_phi,
        compute_dtype=compute_dtype,
    )
    return OnPolicyRunner(env, core, num_envs, rollout_len, device=env.device)
