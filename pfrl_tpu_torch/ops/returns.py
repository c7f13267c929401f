"""Returns and advantages over time-major rollouts (counterpart of
``pfrl_tpu/ops/returns.py``).

Arrays are ``[T, B]``: ``terminated`` cuts the bootstrap (a true episode
end), ``done`` (terminated or truncated) stops the accumulation at an episode
boundary, so one pass covers many concatenated episodes. Each backward
``lax.scan`` of the JAX module is a reverse Python loop over ``T`` of tensor
ops on the device (two to four per step), stacked once at the end; nothing
is read on the host.
"""

from typing import Tuple

import torch
import torch.nn.functional as F


def _stack_reversed(steps) -> torch.Tensor:
    return torch.stack(steps[::-1])


def discounted_returns(
    rewards: torch.Tensor,
    terminated: torch.Tensor,
    bootstrap: torch.Tensor,
    gamma: float,
    done: torch.Tensor = None,
) -> torch.Tensor:
    """``G_t = r_t + gamma * G_{t+1}``, restarting from ``bootstrap`` (broadcast
    to ``[T, B]``: per-step values, or the rollout end's ``[B]``) where
    ``done``, and with no bootstrap where ``terminated``."""
    if done is None:
        done = terminated
    boots = torch.broadcast_to(bootstrap, rewards.shape)
    carry = boots[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        nxt = torch.where(done[t], boots[t], carry)
        carry = rewards[t] + gamma * torch.where(terminated[t], 0.0, nxt)
        out.append(carry)
    return _stack_reversed(out)


def gae_advantages(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    lambd: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation; returns ``(advantages, v_targets =
    advantages + values)``.

    ``next_values`` are V(s_{t+1}) on the pre-reset observations, so the TD
    error is exact through truncations. The decay ``gamma * lambd * (1 -
    done)`` is formed once for all steps, as the JAX body's left-to-right
    product forms it per step, so each step is one multiply and one add.
    """
    nonterminal = 1.0 - terminated.to(rewards.dtype)
    deltas = rewards + gamma * nonterminal * next_values - values
    decay = gamma * lambd * (1.0 - done.to(rewards.dtype))
    carry = torch.zeros_like(deltas[-1])
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = deltas[t] + decay[t] * carry
        out.append(carry)
    advs = _stack_reversed(out)
    return advs, advs + values


def lambda_returns(
    rewards: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    lambd: float,
) -> torch.Tensor:
    """TD(lambda) targets ``G_t = r + gamma * ((1 - l) V' + l G_{t+1})``; at an
    episode boundary ``G_{t+1}`` is replaced by ``V'``."""
    nonterminal = 1.0 - terminated.to(rewards.dtype)
    continues = 1.0 - done.to(rewards.dtype)
    carry = next_values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        v_next = next_values[t]
        mixed = (1.0 - lambd) * v_next + lambd * torch.where(continues[t] > 0, carry, v_next)
        carry = rewards[t] + gamma * nonterminal[t] * mixed
        out.append(carry)
    return _stack_reversed(out)


def n_step_returns_from_window(
    rewards: torch.Tensor,
    terminals: torch.Tensor,
    gamma: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold ``[B, n]`` windows of rewards and terminated flags: returns
    ``(folded reward [B], gamma**k for the k steps used [B], whether the
    window hit a termination [B])``. Step ``i`` counts while no termination
    came strictly before it."""
    n = rewards.shape[1]
    term_before = torch.cumsum(F.pad(terminals[:, : n - 1].to(torch.int32), (1, 0)), dim=1)
    valid = term_before == 0
    discounts = gamma ** torch.arange(n, dtype=rewards.dtype, device=rewards.device)
    folded = torch.sum(rewards * valid * discounts, dim=1)
    steps = torch.sum(valid, dim=1)
    is_terminal = torch.any(terminals & valid, dim=1)
    return folded, gamma ** steps.to(rewards.dtype), is_terminal
