"""The five MuJoCo reproduction examples at their own settings, on the
host-env object path (``examples/mujoco/reproduction/{soft_actor_critic,
td3,ddpg,ppo,trpo}/train_*.py``).

Each ``make_*_agent`` is its script's agent, on ``device`` (default: the
CUDA device), and each ``run_*`` its ``main``: the script's flags (parsed
from ``argv``), the envs through :func:`~.env_cli.make_backend_env`, the
``--load`` and ``--demo`` branches through the shell's ``load`` and
``eval_performance``, and the driver, ``train_agent_with_evaluation`` or,
with ``--num-envs > 1`` where the script has that flag,
``train_agent_batch_with_evaluation`` over a ``SerialVectorEnv``.
``--bf16`` reaches ``compute_dtype``; TRPO refuses it by name.

- SAC (``train_soft_actor_critic.py:101-121``): the policy an ``MLP`` of
  (256, 256) into ``SquashedGaussianHead``; twin ``FCSAQFunction(256, 2)``;
  Adam(3e-4) for the policy, both critics and the temperature; batch 256;
  tau 5e-3; entropy target -|A|; a 10^6-slot ring; replay start and
  uniform burn-in actions until 10,000.
- TD3 (``train_td3.py:97-117``): the policy an ``MLP`` of (400, 300) into
  tanh and ``DeterministicHead``; twin ``FCSAQFunction(400, 2)``; Adam(3e-4)
  x3; ``AdditiveGaussian(0.1)``; batch 100; the policy every 2nd update.
- DDPG (``train_ddpg.py:96-113``): the (400, 300) policy;
  ``FCSAQFunction(400, 2)``; Adam(1e-3) x2; ``AdditiveGaussian(0.1)``;
  batch 100; soft targets at tau 5e-3.
- PPO (``train_ppo.py:27-46``, ``:128-141``): :class:`~.onpolicy.GaussianPiV`
  (independent 64 x 64 tanh towers, the mean layer at variance scaling
  1e-4); Adam(3e-4); gamma 0.995, lambda 0.97; 2,048 transitions per
  update; 10 epochs of batch-64 minibatches; no entropy bonus.
- TRPO (``train_trpo.py:18-32``, ``:75-88``): a 64 x 64 tanh policy with the
  mean at variance scaling 1e-2; V an ``MLP`` of (64, 64) fit by Adam(1e-3)
  for 5 epochs; 5,000 transitions per update; max KL 0.01; conjugate
  gradient for 20 iterations at damping 0.1.

The scripts' ``--jax-env`` backend, the JAX package's Pendulum, has its
counterpart in ``--torch-env`` (also spelt ``--jax-env``, but in the PPO
script): the port's Pendulum limited to 200 steps on the CPU behind
``HostTorchEnv``. ``torch_env_factory`` replaces it, as
:func:`mujoco_sim_env` does with a ``MujocoSim`` at an env's own
observation and action sizes (``HALFCHEETAH`` 17 and 6, ``HOPPER`` 11 and
3) and its 1,000-step episodes. In the PPO script ``--jax-env pendulum``
is the device runner: :func:`run_ppo` hands it to
``ppo_pendulum.run_device_args`` (``--num-envs`` lanes,
``--load``/``--demo``/``--save-to`` through ``demo_cli``).

Run one as ``python -m pfrl_tpu_torch.experiments.mujoco_host
{sac,td3,ddpg,ppo,trpo} <the script's flags>``.
"""

import argparse
from typing import Callable, Optional, Sequence

import torch

from pfrl_tpu_torch import spaces
from pfrl_tpu_torch.agents.ddpg import DDPG
from pfrl_tpu_torch.agents.ppo import PPO
from pfrl_tpu_torch.agents.soft_actor_critic import SoftActorCritic
from pfrl_tpu_torch.agents.td3 import TD3
from pfrl_tpu_torch.agents.trpo import TRPO
from pfrl_tpu_torch.envs.host_adapter import HostTorchEnv
from pfrl_tpu_torch.envs.mujoco_sim import MujocoSim
from pfrl_tpu_torch.envs.pendulum import Pendulum
from pfrl_tpu_torch.envs.serial_vector_env import SerialVectorEnv
from pfrl_tpu_torch.envs.wrappers import TimeLimit
from pfrl_tpu_torch.experiments.env_cli import add_env_backend_args, make_backend_env
from pfrl_tpu_torch.experiments.evaluator import eval_performance
from pfrl_tpu_torch.experiments.mujoco_actor_critic import MLPPolicy, uniform_burnin
from pfrl_tpu_torch.experiments.onpolicy import GaussianPiV, GaussianPolicy
from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation
from pfrl_tpu_torch.experiments.train_agent_batch import train_agent_batch_with_evaluation
from pfrl_tpu_torch.explorers.additive_gaussian import AdditiveGaussian
from pfrl_tpu_torch.models.mlp import MLP
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.policies import DeterministicHead, SquashedGaussianHead
from pfrl_tpu_torch.q_functions.state_action_q_functions import FCSAQFunction
from pfrl_tpu_torch.replay.uniform import ReplayBuffer

HALFCHEETAH = (17, 6)
HOPPER = (11, 3)


def pendulum_env(seed: int) -> HostTorchEnv:
    """``--torch-env``'s default: the scripts' ``HostJaxEnv(TimeLimit(Pendulum()), seed=s)``."""
    return HostTorchEnv(TimeLimit(Pendulum(device="cpu")), seed=seed)


def mujoco_sim_env(obs_dim: int, action_dim: int) -> Callable[[int], HostTorchEnv]:
    """A factory of ``MujocoSim(obs_dim, action_dim)`` on the CPU, where a
    host simulator runs, behind ``HostTorchEnv``."""
    return lambda seed: HostTorchEnv(MujocoSim(obs_dim, action_dim, device="cpu"), seed=seed)


def _box(action_size: int):
    return spaces.box(-1.0, 1.0, (action_size,))


def _deterministic_policy(obs_size: int, action_size: int) -> MLPPolicy:
    return MLPPolicy(obs_size, action_size, (400, 300), DeterministicHead(), squash=torch.tanh)


def make_sac_agent(obs_size: int, action_size: int, replay_start_size: int = 10_000, capacity: int = 10**6,
                   update_burst: bool = False, compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                   device=None, draws=None) -> SoftActorCritic:
    qf = lambda: FCSAQFunction(obs_size, action_size, 256, 2)  # noqa: E731
    return SoftActorCritic(
        MLPPolicy(obs_size, 2 * action_size, (256, 256), SquashedGaussianHead(action_size)),
        qf(), qf(), Adam(3e-4), Adam(3e-4), Adam(3e-4),
        ReplayBuffer(capacity, gamma=0.99, device=device), 0.99,
        action_space=_box(action_size), replay_start_size=replay_start_size, minibatch_size=256,
        soft_update_tau=5e-3, entropy_target=-float(action_size), temperature_optimizer_lr=3e-4,
        burnin_action_func=uniform_burnin(action_size), burnin_steps=replay_start_size,
        update_burst=update_burst, compute_dtype=compute_dtype, seed=seed, device=device, draws=draws,
    )


def make_td3_agent(obs_size: int, action_size: int, replay_start_size: int = 10_000, capacity: int = 10**6,
                   update_burst: bool = False, compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                   device=None, draws=None) -> TD3:
    qf = lambda: FCSAQFunction(obs_size, action_size, 400, 2)  # noqa: E731
    return TD3(
        _deterministic_policy(obs_size, action_size), qf(), qf(), Adam(3e-4), Adam(3e-4), Adam(3e-4),
        ReplayBuffer(capacity, gamma=0.99, device=device), 0.99, AdditiveGaussian(0.1, low=-1.0, high=1.0),
        action_space=_box(action_size), replay_start_size=replay_start_size, minibatch_size=100,
        soft_update_tau=5e-3, policy_update_delay=2,
        burnin_action_func=uniform_burnin(action_size), burnin_steps=replay_start_size,
        update_burst=update_burst, compute_dtype=compute_dtype, seed=seed, device=device, draws=draws,
    )


def make_ddpg_agent(obs_size: int, action_size: int, replay_start_size: int = 10_000, capacity: int = 10**6,
                    update_burst: bool = False, compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                    device=None, draws=None) -> DDPG:
    return DDPG(
        _deterministic_policy(obs_size, action_size), FCSAQFunction(obs_size, action_size, 400, 2),
        Adam(1e-3), Adam(1e-3), ReplayBuffer(capacity, gamma=0.99, device=device), 0.99,
        AdditiveGaussian(0.1, low=-1.0, high=1.0),
        action_space=_box(action_size), replay_start_size=replay_start_size, minibatch_size=100,
        target_update_method="soft", soft_update_tau=5e-3,
        burnin_action_func=uniform_burnin(action_size), burnin_steps=replay_start_size,
        update_burst=update_burst, compute_dtype=compute_dtype, seed=seed, device=device, draws=draws,
    )


def make_ppo_agent(obs_size: int, action_size: int, compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                   device=None, draws=None) -> PPO:
    return PPO(
        GaussianPiV(obs_size, action_size, 64, mean_scale=1e-4), Adam(3e-4),
        gamma=0.995, lambd=0.97, update_interval=2048, minibatch_size=64, epochs=10, clip_eps=0.2,
        entropy_coef=0.0, standardize_advantages=True, compute_dtype=compute_dtype, seed=seed,
        device=device, draws=draws,
    )


TRPO_BF16 = (
    "TRPO is fp32 by design: Fisher-vector products and the KL line search are numerically delicate "
    "second-order quantities (see pfrl_tpu_torch/agents/trpo.py). Remove --bf16."
)


def make_trpo_agent(obs_size: int, action_size: int, compute_dtype: Optional[torch.dtype] = None, seed: int = 0,
                    device=None, draws=None) -> TRPO:
    """``compute_dtype`` other than ``None`` raises."""
    if compute_dtype is not None:
        raise ValueError(f"{TRPO_BF16} (compute_dtype={compute_dtype})")
    return TRPO(
        GaussianPolicy(obs_size, action_size, 64, mean_scale=1e-2), MLP(obs_size, 1, (64, 64)), Adam(1e-3),
        gamma=0.995, lambd=0.97, update_interval=5000, max_kl=0.01, conjugate_gradient_max_iter=20,
        conjugate_gradient_damping=1e-1, vf_epochs=5, entropy_coef=0.0, seed=seed, device=device, draws=draws,
    )


# ---------------------------------------------------------------- the CLIs
def _parser(env: str, outdir: str, off_policy: bool, device_ppo: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default=env)
    add_env_backend_args(parser, jax_alias=not device_ppo)
    if device_ppo:
        parser.add_argument("--jax-env", choices=["pendulum"], default=None,
                            help="run fully on the device against the port's Pendulum")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=10**6 if off_policy else 2 * 10**6)
    if device_ppo:
        parser.add_argument("--num-envs", type=int, default=64)
    parser.add_argument("--eval-interval", type=int, default=5000 if off_policy else 100_000)
    if off_policy:
        parser.add_argument("--eval-n-envs", type=int, default=1)
        parser.add_argument("--num-envs", type=int, default=1)
        parser.add_argument("--update-burst", action="store_true")
        parser.add_argument("--replay-start-size", type=int, default=10_000)
        parser.add_argument("--checkpoint-freq", type=int, default=None)
    parser.add_argument("--outdir", default=outdir)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    if device_ppo:
        from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

        return add_demo_args(parser)
    parser.add_argument("--load", metavar="PATH", default=None, help="a directory the shell's save wrote")
    parser.add_argument("--demo", action="store_true", help="evaluate the (loaded) agent and exit")
    return parser


def ppo_parser() -> argparse.ArgumentParser:
    """``train_ppo.py``'s flags (``:105-118``), with ``--torch-env`` for the
    host Pendulum."""
    return _parser("Hopper-v5", "results/ppo", off_policy=False, device_ppo=True)


def _envs(args, factory, lanes: int, seed: int):
    if lanes > 1:
        return SerialVectorEnv([make_backend_env(args, seed + i, factory) for i in range(lanes)])
    return make_backend_env(args, seed, factory)


def _load_demo_or_train(args, agent, env, eval_env, batch: bool, **driver_kwargs):
    """The scripts' tail: ``--load``, then ``--demo`` (10 evaluation
    episodes, the statistics returned) or the driver (``(agent, history)``)."""
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=eval_env, agent=agent, n_steps=None, n_episodes=10)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} median: {stats['median']} "
              f"stdev: {stats['stdev']}")
        return stats
    driver = train_agent_batch_with_evaluation if batch else train_agent_with_evaluation
    return driver(agent, env, steps=args.steps, eval_n_steps=None, eval_n_episodes=10,
                  eval_interval=args.eval_interval, outdir=args.outdir, eval_env=eval_env, **driver_kwargs)


def _run_off_policy(make_agent, outdir: str, argv: Optional[Sequence[str]], torch_env_factory, device):
    args = _parser("HalfCheetah-v5", outdir, off_policy=True).parse_args(argv)
    factory = torch_env_factory or pendulum_env
    env = _envs(args, factory, args.num_envs, args.seed * args.num_envs if args.num_envs > 1 else args.seed)
    eval_env = _envs(args, factory, args.eval_n_envs, args.seed + 100)
    obs_size, action_size = env.observation_space.shape[0], env.action_space.shape[0]
    agent = make_agent(obs_size, action_size, replay_start_size=args.replay_start_size,
                       update_burst=args.update_burst, compute_dtype=torch.bfloat16 if args.bf16 else None,
                       seed=args.seed, device=device)
    return agent, _load_demo_or_train(args, agent, env, eval_env, args.num_envs > 1,
                                      checkpoint_freq=args.checkpoint_freq)


def run_sac(argv=None, torch_env_factory: Optional[Callable] = None, device=None):
    """``train_soft_actor_critic.py``'s ``main``: returns ``(agent,
    (agent, history))`` after training, or ``(agent, stats)`` with ``--demo``."""
    return _run_off_policy(make_sac_agent, "results/sac", argv, torch_env_factory, device)


def run_td3(argv=None, torch_env_factory: Optional[Callable] = None, device=None):
    """``train_td3.py``'s ``main``, as :func:`run_sac`."""
    return _run_off_policy(make_td3_agent, "results/td3", argv, torch_env_factory, device)


def run_ddpg(argv=None, torch_env_factory: Optional[Callable] = None, device=None):
    """``train_ddpg.py``'s ``main``, as :func:`run_sac`."""
    return _run_off_policy(make_ddpg_agent, "results/ddpg", argv, torch_env_factory, device)


def _run_on_policy(make_agent, parser, argv, torch_env_factory, device, refuse_bf16: bool, chunk: int = 10):
    args = parser.parse_args(argv)
    if refuse_bf16 and args.bf16:
        parser.error(TRPO_BF16)
    if getattr(args, "jax_env", None):
        from pfrl_tpu_torch.experiments.ppo_pendulum import run_device_args

        return run_device_args(args, device, chunk)
    factory = torch_env_factory or pendulum_env
    env = make_backend_env(args, args.seed, factory)
    eval_env = make_backend_env(args, args.seed + 100, factory)
    obs_size, action_size = env.observation_space.shape[0], env.action_space.shape[0]
    kw = {} if refuse_bf16 else {"compute_dtype": torch.bfloat16 if args.bf16 else None}
    agent = make_agent(obs_size, action_size, seed=args.seed, device=device, **kw)
    return agent, _load_demo_or_train(args, agent, env, eval_env, batch=False)


def run_ppo(argv=None, torch_env_factory: Optional[Callable] = None, device=None, chunk: int = 10):
    """``train_ppo.py``'s ``main``: with ``--jax-env pendulum`` the device
    runner in turns of ``chunk`` iterations (``ppo_pendulum.run_device_args``'s
    dict), else the host path as :func:`run_sac` (which reads no
    ``--num-envs`` and no ``--save-to``, as the script's)."""
    return _run_on_policy(make_ppo_agent, ppo_parser(), argv, torch_env_factory, device, refuse_bf16=False,
                          chunk=chunk)


def run_trpo(argv=None, torch_env_factory: Optional[Callable] = None, device=None):
    """``train_trpo.py``'s ``main``; ``--bf16`` is a usage error naming TRPO."""
    parser = _parser("Hopper-v5", "results/trpo", off_policy=False)
    return _run_on_policy(make_trpo_agent, parser, argv, torch_env_factory, device, refuse_bf16=True)


COMMANDS = {"sac": run_sac, "td3": run_td3, "ddpg": run_ddpg, "ppo": run_ppo, "trpo": run_trpo}


if __name__ == "__main__":
    from pfrl_tpu_torch.experiments.demo_cli import run_command

    run_command(COMMANDS)
