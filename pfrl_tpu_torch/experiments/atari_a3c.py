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
its evaluation is ``EvalLoop(env, core, 5, 500)``.
"""

from typing import Optional

import torch

from pfrl_tpu_torch.agents.a3c import A3CCore
from pfrl_tpu_torch.env import TorchEnv
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.onpolicy import AtariPiV
from pfrl_tpu_torch.experiments.onpolicy_runner import OnPolicyRunner
from pfrl_tpu_torch.optimizers import ClipByGlobalNorm, RMSprop

EVAL_EPISODES, EVAL_STEPS = 5, 500


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
