"""``examples/atari/reproduction/a3c/train_a3c.py --sim`` at its own
settings: A3C, the synchronous stand-in for the reference's 16 async
workers, as 16 AtariSim lanes with ``t_max`` 5 through ``OnPolicyRunner``.

``A3CNet`` (``train_a3c.py:31-41``) is ``SmallAtariCNN`` on ``x / 255``
(the division inside the network, where the A2C example's ``AtariPiV``
leaves it to ``atari_phi``), a softmax head over ``Dense(n_actions)`` and
a ``Dense(1)`` value; its flax scopes are ``AtariPiV``'s, so a flax
``A3CNet`` state converts with ``convert.ppo_state_from_flax``, whose
optimizer loader reads the ``clip_by_global_norm`` chain's inner state.
The core is ``A3CCore`` with ``ClipByGlobalNorm(40, RMSprop(7e-4, decay
0.99, eps 0.1))`` (optax's order: the clip, then RMSprop with eps inside
the square root), gamma 0.99, entropy 1e-2 and a value coefficient of 0.5;
its evaluation is ``EvalLoop(env, core, 5, 500)``. :func:`run` is the
script's ``main``, which runs AtariSim with or without ``--sim``.
"""

import argparse
from typing import Optional, Sequence

import torch

from pfrl_tpu_torch.agents.a3c import A3CCore
from pfrl_tpu_torch.env import TorchEnv
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.onpolicy import AtariPiV
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.optimizers import ClipByGlobalNorm, RMSprop

EVAL_EPISODES, EVAL_STEPS = 5, 500
CHUNK = 200  # iterations per turn of the script's loop


class A3CNet(AtariPiV):
    """``train_a3c.py``'s ``A3CNet``: ``AtariPiV`` on ``x.float() / 255``."""

    def forward(self, x: torch.Tensor):
        return super().forward(x.to(torch.float32) / 255.0)


def make_a3c_core(n_actions: int = 6, compute_dtype: Optional[torch.dtype] = None) -> A3CCore:
    return A3CCore(
        A3CNet(n_actions),
        ClipByGlobalNorm(40.0, RMSprop(7e-4, decay=0.99, eps=1e-1)),
        gamma=0.99,
        entropy_coeff=1e-2,
        v_loss_coef=0.5,
        compute_dtype=compute_dtype,
    )


def make_a3c_atarisim_runner(
    num_envs: int = 16,
    rollout_len: int = 5,
    n_actions: int = 6,
    env: Optional[TorchEnv] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> OnPolicyRunner:
    """``train_a3c.py --sim`` (defaults: ``--processes 16 --t-max 5``);
    ``env`` defaults to ``AtariSim(n_actions)`` on ``device`` (default: the
    CUDA device)."""
    env = AtariSim(n_actions=n_actions, device=device) if env is None else env
    return OnPolicyRunner(env, make_a3c_core(n_actions, compute_dtype), num_envs, rollout_len, device=env.device)


def build_parser() -> argparse.ArgumentParser:
    """``train_a3c.py``'s flags (``:45-53``)."""
    from pfrl_tpu_torch.experiments.demo_cli import add_demo_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--sim", action="store_true")
    parser.add_argument("--processes", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bf16", action="store_true", help="bf16 network compute over fp32 master params")
    parser.add_argument("--steps", type=int, default=5 * 10**7)
    parser.add_argument("--t-max", type=int, default=5)
    parser.add_argument("--outdir", default="results/a3c")
    add_demo_args(parser)
    return parser


def run(argv: Optional[Sequence[str]] = None, device=None, chunk: int = CHUNK) -> dict:
    """``train_a3c.py``'s ``main`` with ``argv``'s flags on ``device``
    (default: the CUDA device): ``--processes`` lanes x ``--t-max`` in turns
    of ``chunk`` iterations (the script's 200). Returns
    :func:`~.demo_cli.run_device_example`'s dict."""
    from pfrl_tpu_torch.experiments.demo_cli import run_device_example

    args = build_parser().parse_args(argv)
    runner = make_a3c_atarisim_runner(args.processes, args.t_max,
                                      compute_dtype=torch.bfloat16 if args.bf16 else None, device=device)
    eval_loop = EvalLoop(AtariSim(n_actions=6, device=runner.device), runner.core, EVAL_EPISODES, EVAL_STEPS,
                         device=runner.device)
    return run_device_example(args, runner, eval_loop, lambda state: runner.run_iterations(state, chunk)[0])


if __name__ == "__main__":
    run()
