"""``examples/gym/train_reinforce_gym.py`` at the example's own settings.

:class:`ReinforcePolicy` is the example's ``Policy`` (Dense(128) -> ReLU ->
Dense(n_actions) -> ``SoftmaxCategoricalHead``; flax scopes ``Dense_0`` and
``Dense_1``), the network of ``zoo/reinforce/cartpole`` and
``zoo/reinforce/cartpole_real``. :func:`make_reinforce_agent` is the
example's ``REINFORCE`` (Adam(1e-3), gamma 0.99, beta 1e-4, 10 episodes per
update, episodes padded to 500 steps, the mean-return baseline), and
:func:`make_cartpole_env` its default env, the port's CartPole limited to
500 steps behind the host protocol (``HostTorchEnv``). :func:`run` is the
example's ``main``: ``--env cartpole`` is that env on the CPU, any other id
a gymnasium env (``envs/gymnasium_env.py``) cast to float32; it trains
through ``train_agent_with_evaluation`` (episodes cut at 500 steps) or,
with ``--demo``, evaluates ``--eval-n-runs`` episodes.
"""

import argparse
from typing import Dict, Optional, Sequence

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


def build_parser() -> argparse.ArgumentParser:
    """``train_reinforce_gym.py``'s flags (``:35-52``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="cartpole",
                        help="'cartpole' for the port's CartPole stepped on the host, or any gymnasium env id "
                        "with a discrete action space (an error where it is unavailable)")
    parser.add_argument("--steps", type=int, default=100_000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batchsize", type=int, default=10, help="episodes per policy update")
    parser.add_argument("--beta", type=float, default=1e-4)
    parser.add_argument("--eval-interval", type=int, default=10_000)
    parser.add_argument("--eval-n-runs", type=int, default=10)
    parser.add_argument("--outdir", type=str, default="results/reinforce_cartpole")
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    add_demo_args(parser, save=False)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None):
    """``train_reinforce_gym.py``'s ``main`` with ``argv``'s flags on
    ``device`` (default: the CUDA device). Returns ``(agent, history)``
    after training, or ``(agent, stats)`` with ``--demo``."""
    from pfrl_tpu_torch.experiments.evaluator import eval_performance
    from pfrl_tpu_torch.experiments.prepare_output_dir import prepare_output_dir
    from pfrl_tpu_torch.experiments.train_agent import train_agent_with_evaluation

    args = build_parser().parse_args(argv)
    if args.env == "cartpole":
        def make_env(seed):
            return make_cartpole_env(seed, device="cpu")
    else:
        from pfrl_tpu_torch.envs.gymnasium_env import make_gymnasium_env
        from pfrl_tpu_torch.wrappers import CastObservationToFloat32

        def make_env(seed):
            return CastObservationToFloat32(make_gymnasium_env(args.env, seed=seed))

    env = make_env(args.seed)
    outdir = prepare_output_dir(args, args.outdir)
    agent = make_reinforce_agent(env.observation_space.shape[0], env.action_space.n, args.lr, args.beta,
                                 args.batchsize, torch.bfloat16 if args.bf16 else None, args.seed, device)
    eval_env = make_env(args.seed + 10**6)
    if args.load:
        agent.load(args.load)
    if args.demo:
        stats = eval_performance(env=eval_env, agent=agent, n_steps=None, n_episodes=args.eval_n_runs)
        print(f"n_episodes: {stats['episodes']} mean: {stats['mean']} "
              f"median: {stats['median']} stdev: {stats['stdev']}")
        return agent, stats
    return train_agent_with_evaluation(
        agent=agent, env=env, eval_env=eval_env, steps=args.steps, eval_n_steps=None,
        eval_n_episodes=args.eval_n_runs, eval_interval=args.eval_interval, outdir=outdir,
        train_max_episode_len=500)


if __name__ == "__main__":
    run()
