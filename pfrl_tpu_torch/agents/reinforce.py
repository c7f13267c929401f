"""REINFORCE, episodic Monte-Carlo policy gradient (counterpart of
``pfrl_tpu/agents/reinforce.py``; reference parity:
pfrl/agents/reinforce.py:14-219).

:class:`ReinforceCore` updates on ``batchsize`` whole episodes, padded to
``[E, L]`` and masked: discounted returns-to-go within each episode, the
mean return over the batch's valid steps subtracted with ``baseline``, the
policy-gradient loss and an entropy bonus ``beta``, normalised by the
number of episodes. :class:`REINFORCE` is the host shell: it stages each
lane's steps on the host and updates once ``batchsize`` episodes have
ended. Acting samples from the policy's distribution with the shell's draw
source (``categorical`` for a softmax head); evaluation takes its mode.
"""

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from pfrl_tpu_torch._device import resolve_device, use_full_fp32
from pfrl_tpu_torch.agent import AttributeSavingMixin, BatchAgent
from pfrl_tpu_torch.utils.batch_states import to_device_like_jax
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype
from pfrl_tpu_torch.utils.stats import RunningStats


def _identity(x):
    return x


@dataclasses.dataclass
class ReinforceState:
    model: nn.Module  # the JAX ReinforceState.params
    opt_state: Any
    n_updates: int = 0


class ReinforceCore:
    """``model`` maps observations to a distribution; it is a template that
    ``init`` copies and re-initializes."""

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        gamma: float = 0.99,
        beta: float = 0.0,
        baseline: bool = False,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.gamma = gamma
        self.beta = beta
        self.baseline = baseline
        self.phi = phi
        self.compute_dtype = check_compute_dtype(compute_dtype)

    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> ReinforceState:
        model = copy.deepcopy(self.model)
        model.reset_parameters(generator)
        model.to(example_obs.device)
        return self.state_from_model(model)

    def state_from_model(self, model: nn.Module) -> ReinforceState:
        return ReinforceState(model=model, opt_state=self.optimizer.init(list(model.parameters())))

    def policy(self, model: nn.Module, obs: torch.Tensor):
        return apply_cast(model, self.compute_dtype, self.phi(obs))

    @torch.no_grad()
    def select_action(self, state: ReinforceState, draws, obs: torch.Tensor, t: int, training: bool):
        dist = self.policy(state.model, obs)
        return dist.sample(draws) if training else dist.mode()

    def returns_to_go(self, rewards: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``g_t = r_t + gamma * g_{t+1} * m_t`` within each episode: the JAX
        core's reverse scan, one step of ``[E]`` ops per padded step."""
        carry = torch.zeros(rewards.shape[0], dtype=torch.float32, device=rewards.device)
        out = []
        for t in range(rewards.shape[1] - 1, -1, -1):
            carry = rewards[:, t] + self.gamma * carry * mask[:, t]
            out.append(carry)
        return torch.stack(out[::-1], dim=1)

    def update(self, state: ReinforceState, obs, actions, rewards, mask):
        """One step on ``[E, L, ...]`` padded episodes, in place. Returns
        ``(state, {"loss": loss})``."""
        E, L = rewards.shape
        returns = self.returns_to_go(rewards, mask)
        if self.baseline:
            total = torch.sum(mask)
            mean_g = torch.sum(returns * mask) / torch.clamp_min(total, 1.0)
            returns = returns - mean_g
        params = list(state.model.parameters())
        dist = self.policy(state.model, obs.reshape((E * L,) + obs.shape[2:]))
        lp = dist.log_prob(actions.reshape((E * L,) + actions.shape[2:]))
        m = mask.reshape(E * L)
        pg = -torch.sum(lp * returns.reshape(E * L) * m)
        ent = torch.sum(dist.entropy() * m)
        # The reference normalises by the number of episodes (reinforce.py:176).
        loss = (pg - self.beta * ent) / E
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        state.n_updates += 1
        return state, {"loss": loss.detach()}


class REINFORCE(AttributeSavingMixin, BatchAgent):
    """The reference's REINFORCE agent (``reinforce.py:120-235``). ``gpu``,
    ``backward_separately`` and ``average_entropy_decay`` are accepted for
    the reference's signature and unused, as in JAX. ``draws`` samples the
    acts (default: a generator on ``device`` seeded with ``seed``)."""

    saved_attributes = ("train_state",)

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        *,
        gpu=None,
        gamma: float = 0.99,
        beta: float = 0.0,
        phi: Callable = _identity,
        batchsize: int = 10,
        max_episode_len: int = 1000,
        backward_separately: bool = False,
        average_entropy_decay=0.999,
        baseline: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu, backward_separately, average_entropy_decay
        self.core = ReinforceCore(
            model, optimizer, gamma=gamma, beta=beta, baseline=baseline, phi=phi, compute_dtype=compute_dtype,
        )
        self.batchsize = batchsize
        self.max_episode_len = max_episode_len
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_full_fp32()
        self.draws = draws if draws is not None else Draws(torch.Generator(device=self.device).manual_seed(seed))
        self.t = 0
        self.train_state: Optional[ReinforceState] = None
        self._current = None  # per lane: the current episode's (obs, action, reward) so far
        self._episodes = []
        self._loss_stats = RunningStats(100)

    def batch_act(self, batch_obs) -> np.ndarray:
        batch_obs = np.asarray(batch_obs)
        obs = to_device_like_jax(batch_obs, self.device)
        if self.train_state is None:
            self.train_state = self.core.init(torch.Generator().manual_seed(self.seed), obs)
            self._restore_pending()
        actions = self.core.select_action(self.train_state, self.draws, obs, self.t, self.training).cpu().numpy()
        if self.training:
            self._last_obs = batch_obs
            self._last_action = actions
        return actions

    def batch_observe(self, batch_obs, batch_reward, batch_done, batch_reset) -> None:
        if not self.training:
            return
        b = len(batch_reward)
        if self._current is None:
            self._current = [[] for _ in range(b)]
        for i in range(b):
            self._current[i].append((self._last_obs[i], self._last_action[i], float(batch_reward[i])))
            if batch_done[i] or batch_reset[i]:
                if self._current[i]:
                    self._episodes.append(self._current[i])
                self._current[i] = []
        self.t += b
        while len(self._episodes) >= self.batchsize:
            self._update_batch(self._episodes[: self.batchsize])
            self._episodes = self._episodes[self.batchsize:]

    def _update_batch(self, episodes) -> None:
        """Pads the episodes to ``[E, max_episode_len]`` on the host (a
        longer episode is cut), then one update on the device."""
        E, L = len(episodes), self.max_episode_len
        obs_shape = episodes[0][0][0].shape
        a0 = np.asarray(episodes[0][0][1])
        obs = np.zeros((E, L) + obs_shape, np.float32)
        actions = np.zeros((E, L) + a0.shape, a0.dtype)
        rewards = np.zeros((E, L), np.float32)
        mask = np.zeros((E, L), np.float32)
        for e, ep in enumerate(episodes):
            for t, (o, a, r) in enumerate(ep[:L]):
                obs[e, t] = o
                actions[e, t] = a
                rewards[e, t] = r
                mask[e, t] = 1.0
        _, aux = self.core.update(self.train_state, *to_device_like_jax((obs, actions, rewards, mask), self.device))
        self._loss_stats.append(float(aux["loss"]))

    def get_statistics(self):
        return [
            ("average_loss", self._loss_stats.mean()),
            ("n_updates", self.train_state.n_updates if self.train_state is not None else 0),
        ]
