"""Auto-resetting lanes (counterpart of ``pfrl_tpu/envs/vector_jax_env.py``).

When an episode ends the lane restarts at once; the pre-reset observation
is still surfaced as ``ts.obs`` for correct bootstrapping.
"""

import dataclasses
from typing import Any, Tuple

import torch

from pfrl_tpu_torch.env import TimeStep, TorchEnv


@dataclasses.dataclass
class VecStep:
    """``ts.obs`` is the true next observation, what goes into replay;
    ``obs`` is the post-auto-reset observation the agent acts on next."""

    ts: TimeStep
    obs: torch.Tensor


def _lane_where(done: torch.Tensor, a: Any, b: Any) -> Any:
    """Per lane ``a`` where ``done`` else ``b``, over tensors and over
    (nested) dataclasses of tensors, as a wrapped env's state is."""
    if dataclasses.is_dataclass(a):
        return type(a)(
            **{
                f.name: _lane_where(done, getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)
            }
        )
    return torch.where(done.view(-1, *([1] * (a.dim() - 1))), a, b)


class VectorTorchEnv:
    def __init__(self, env: TorchEnv, num_envs: int):
        self.env = env
        self.num_envs = num_envs
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.device = env.device

    def reset(self, draws) -> Tuple[Any, torch.Tensor]:
        return self.env.reset(draws, self.num_envs)

    def step(self, draws, states: Any, actions: torch.Tensor) -> Tuple[Any, VecStep]:
        """Steps every lane, and draws a reset for every lane as the JAX env
        does, keeping it only where the episode ended. An env that draws on
        its step (``draws_on_step``) is handed ``draws`` first: the JAX env
        splits its step keys before its reset keys."""
        if getattr(self.env, "draws_on_step", False):
            new_states, ts = self.env.step(states, actions, draws)
        else:
            new_states, ts = self.env.step(states, actions)
        reset_states, reset_obs = self.env.reset(draws, self.num_envs)
        done = ts.done
        out_states = _lane_where(done, reset_states, new_states)
        next_obs = _lane_where(done, reset_obs, ts.obs)
        return out_states, VecStep(ts=ts, obs=next_obs)
