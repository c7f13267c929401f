"""DQN algorithm core (counterpart of ``pfrl_tpu/agents/dqn.py::DQNCore``).

The JAX core is a set of pure functions over an immutable ``DQNState`` of
parameter trees. Here :class:`DQNState` holds the online and target
``nn.Module``s and the optimizer's state, and ``update`` and ``sync_target``
change them **in place** (and return the same state).

Where the JAX core threads a PRNG key (``rngs={"noise": rng}``), the port
hands the model a draw source (:mod:`pfrl_tpu_torch.utils.draws`): noisy
layers draw from it on every forward, models without noise ignore it.

Ported subclasses: ``double_dqn.DoubleDQNCore``,
``categorical_dqn.CategoricalDQNCore`` and ``CategoricalDoubleDQNCore``,
``al.ALCore``, ``pal.PALCore`` and ``DoublePALCore``, ``dpp.DPPCore``, and
``iqn.IQNCore`` and ``DoubleIQNCore``. The actor-critic cores for
continuous actions are in :mod:`.ddpg`, :mod:`.td3` and
:mod:`.soft_actor_critic`.

``compute_dtype`` (e.g. ``torch.bfloat16``) runs every forward of the
network, and so its backward, in that dtype over the float32 parameters
(:func:`~pfrl_tpu_torch.utils.precision.apply_cast`): the observation
features and the parameters are cast at the apply boundary and the action
value comes back float32, so the targets, losses and the optimizer stay
float32. ``None`` is plain float32.

Not ported yet: the host shell ``DQN`` (``batch_act`` / ``batch_observe``)
and the recurrent cores.
"""

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from pfrl_tpu_torch.ops.value_loss import compute_weighted_value_loss
from pfrl_tpu_torch.replay.transition import TransitionBatch
from pfrl_tpu_torch.utils.copy_param import copy_param, soft_copy_param
from pfrl_tpu_torch.utils.draws import Draws
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype


@dataclasses.dataclass
class DQNState:
    model: nn.Module         # the JAX DQNState.params
    target_model: nn.Module  # ... .target_params
    opt_state: Any           # whatever the optimizer's ``init`` returns
    n_updates: int = 0


def _identity(x):
    return x


class DQNCore:
    """``model`` is a template: ``init`` copies it, re-initializes the copy
    from a generator (``model.reset_parameters(generator)``) and moves it to
    the observations' device."""

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        explorer,
        gamma: float = 0.99,
        clip_delta: bool = True,
        batch_accumulator: str = "mean",
        target_update_method: str = "hard",
        soft_update_tau: float = 1e-2,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        if target_update_method not in ("hard", "soft"):
            raise ValueError(f"target_update_method: {target_update_method!r}")
        self.model = model
        self.optimizer = optimizer
        self.explorer = explorer
        self.gamma = gamma
        self.clip_delta = clip_delta
        self.batch_accumulator = batch_accumulator
        self.target_update_method = target_update_method
        self.soft_update_tau = soft_update_tau
        self.phi = phi
        self.compute_dtype = check_compute_dtype(compute_dtype)

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> DQNState:
        """``generator`` (on the CPU) draws the initial weights;
        ``example_obs`` is a batched observation on the target device.
        ``example_action`` is what the runner hands every core; only the
        (state, action) Q-functions of the actor-critic cores need it."""
        model = copy.deepcopy(self.model)
        model.reset_parameters(generator)
        model.to(example_obs.device)
        # Shape check; a noisy model draws noise for it from a source of its
        # own, as the JAX core's init does, never from the run's stream.
        noise = torch.Generator(device=example_obs.device)
        noise.manual_seed(generator.initial_seed())
        with torch.no_grad():
            self.action_value(model, example_obs, Draws(noise))
        return self.state_from_model(model)

    def state_from_model(self, model: nn.Module) -> DQNState:
        """A fresh state around ``model``: target = a copy, zero moments."""
        target = copy.deepcopy(model)
        target.requires_grad_(False)
        return DQNState(
            model=model,
            target_model=target,
            opt_state=self.optimizer.init(list(model.parameters())),
        )

    # ------------------------------------------------------------------- act
    def action_value(self, model: nn.Module, obs: torch.Tensor, draws=None):
        return apply_cast(model, self.compute_dtype, self.phi(obs), draws)

    @torch.no_grad()
    def select_action(self, state: DQNState, draws, obs, t: int, training: bool):
        """The model's noise is drawn first, then the explorer's draws; a
        noisy model draws its noise when evaluating too, as in the JAX core."""
        av = self.action_value(state.model, obs, draws)
        greedy = av.greedy_actions()
        if not training:
            return greedy
        return self.explorer.select_action(draws, t, greedy, av)

    # ---------------------------------------------------------------- update
    @staticmethod
    def bootstrap(batch: TransitionBatch, next_q: torch.Tensor) -> torch.Tensor:
        return batch.reward + batch.discount * (
            1.0 - batch.is_terminal.to(torch.float32)
        ) * next_q

    def compute_y_and_t(self, model, target_model, batch: TransitionBatch, draws=None):
        """Forwards in the JAX core's order: online on obs, target on
        next_obs."""
        y = self.action_value(model, batch.obs, draws).evaluate_actions(batch.action)
        with torch.no_grad():
            max_next_q = self.action_value(target_model, batch.next_obs, draws).max()
            t = self.bootstrap(batch, max_next_q)
        return y, t

    def loss_and_errors(self, model, target_model, batch: TransitionBatch, draws=None):
        y, t = self.compute_y_and_t(model, target_model, batch, draws)
        loss = compute_weighted_value_loss(
            y,
            t,
            batch.weight,
            clip_delta=self.clip_delta,
            batch_accumulator=self.batch_accumulator,
        )
        return loss, (torch.abs(y - t).detach(), y.detach().mean())

    def update(self, state: DQNState, batch: TransitionBatch, draws=None):
        """One gradient step, in place. Returns ``(state, aux)``; ``aux``
        carries the per-sample ``errors`` for PER feedback. ``draws`` is the
        noise source of a noisy model."""
        params = list(state.model.parameters())
        loss, (errors, q_mean) = self.loss_and_errors(
            state.model, state.target_model, batch, draws
        )
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        state.n_updates += 1
        return state, {"loss": loss.detach(), "average_q": q_mean, "errors": errors}

    def sync_target(self, state: DQNState) -> DQNState:
        """Hard copy, or Polyak ``(1 - tau) * target + tau * online``."""
        if self.target_update_method == "hard":
            copy_param(state.target_model, state.model)
        else:
            soft_copy_param(state.target_model, state.model, self.soft_update_tau)
        return state
