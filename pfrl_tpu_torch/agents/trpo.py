"""TRPO, trust-region policy optimization (counterpart of
``pfrl_tpu/agents/trpo.py``: ``TRPOState``, ``TRPOCore``).

A policy (obs -> distribution) and a separate value function (obs -> value).
:class:`TRPOState` holds both modules and the value function's optimizer
state; ``update`` changes them **in place** (and returns the same state).

One update: GAE from the value function over the rollout, advantages
standardized with the population standard deviation, then

- the policy step on the flat parameter vector (the policy's parameters in
  ``named_parameters`` order, concatenated): the surrogate's gradient ``g``;
  Fisher-vector products as the Hessian-vector product of the mean
  ``KL(old || new)`` at the current parameters plus ``damping * v``, by
  double backward (``torch.autograd.grad`` of the KL's gradient, built once
  with ``create_graph``, against ``v``), where the JAX core takes the
  forward-mode ``jvp`` of ``grad``; conjugate gradient for ``F x = g`` with a
  fixed budget; the step ``x * sqrt(2 max_kl / max(x.Fx, 1e-12))``; then a
  backtracking line search that evaluates all ``max_backtrack`` candidates
  ``0.5**i`` of the step and keeps the first whose surrogate rises and whose
  KL is within ``max_kl``, with ``torch.where`` and no host read (no
  candidate accepted: the parameters stay). The surrogate and the KL at a
  candidate come from one forward (``torch.func.functional_call``);
- the value function's fit: ``vf_epochs`` epochs of one
  ``draws.permutation(n)`` each, cut to whole minibatches.

Draws, in order: the distribution's sample while acting; ``update`` takes
one ``permutation(n)`` per value-function epoch and nothing else.

**Under a mesh** the on-policy runner all-gathers the rollout and runs
this update *whole on every rank*: the conjugate gradient, the line search
with its float32 accept test, and the value fit, on the whole rollout and
the shared draws. The replicated weights then equal the single-process
run's to the bit. Splitting the batch would need every CG dot product
all-reduced, and ten CG iterations over reduced dot products round apart
from the single-process step (ROADMAP C21, C44), so the core does not
split (no ``splits_over_mesh``).

:class:`TRPO` is the host shell (``trpo.py:251-292``) over
:class:`~.ppo.OnPolicyShellAgent`. It takes no ``compute_dtype``, as the
JAX shell takes none.
"""

import dataclasses
from typing import Any, Callable

import torch
from torch import nn
from torch.func import functional_call

from pfrl_tpu_torch.agents.ddpg import _identity, fresh_module
from pfrl_tpu_torch.agents.ppo import OnPolicyShellAgent, Rollout, flat, standardize
from pfrl_tpu_torch.ops.returns import gae_advantages
from pfrl_tpu_torch.utils.conjugate_gradient import conjugate_gradient


@dataclasses.dataclass
class TRPOState:
    policy: nn.Module  # the JAX state's policy_params
    vf: nn.Module      # ... vf_params
    vf_opt_state: Any
    n_updates: int = 0


class _FlatPolicy:
    """The policy as a function of one flat parameter vector, on fixed
    observations."""

    def __init__(self, policy: nn.Module, obs: torch.Tensor):
        named = list(policy.named_parameters())
        self.policy, self.obs = policy, obs
        self.names = [name for name, _ in named]
        self.params = [p for _, p in named]
        self.sizes = [p.numel() for p in self.params]

    def vector(self) -> torch.Tensor:
        return torch.cat([p.detach().reshape(-1) for p in self.params])

    def dist(self, v: torch.Tensor):
        chunks = torch.split(v, self.sizes)
        tensors = {n: c.view_as(p) for n, c, p in zip(self.names, chunks, self.params)}
        return functional_call(self.policy, tensors, (self.obs,))

    @torch.no_grad()
    def assign(self, v: torch.Tensor) -> None:
        for p, c in zip(self.params, torch.split(v, self.sizes)):
            p.copy_(c.view_as(p))


class TRPOCore:
    def __init__(
        self,
        policy: nn.Module,
        vf: nn.Module,
        vf_optimizer,
        gamma: float = 0.99,
        lambd: float = 0.95,
        entropy_coef: float = 0.0,
        max_kl: float = 0.01,
        vf_epochs: int = 3,
        vf_batch_size: int = 64,
        conjugate_gradient_max_iter: int = 10,
        conjugate_gradient_damping: float = 1e-1,
        line_search_max_backtrack: int = 10,
        standardize_advantages: bool = True,
        phi: Callable = _identity,
    ):
        self.policy = policy
        self.vf = vf
        self.vf_optimizer = vf_optimizer
        self.gamma = gamma
        self.lambd = lambd
        self.entropy_coef = entropy_coef
        self.max_kl = max_kl
        self.vf_epochs = vf_epochs
        self.vf_batch_size = vf_batch_size
        self.cg_max_iter = conjugate_gradient_max_iter
        self.cg_damping = conjugate_gradient_damping
        self.max_backtrack = line_search_max_backtrack
        self.standardize_advantages = standardize_advantages
        self.phi = phi

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> TRPOState:
        """``generator`` (on the CPU) draws the policy's weights, then the
        value function's."""
        device = example_obs.device
        policy = fresh_module(self.policy, generator, device)
        vf = fresh_module(self.vf, generator, device)
        with torch.no_grad():  # shape check
            policy(self.phi(example_obs))
            vf(self.phi(example_obs))
        return self.state_from_modules(policy, vf)

    def state_from_modules(self, policy: nn.Module, vf: nn.Module) -> TRPOState:
        return TRPOState(policy=policy, vf=vf, vf_opt_state=self.vf_optimizer.init(list(vf.parameters())))

    # ------------------------------------------------------------------- act
    def forward(self, state_or_policy, obs: torch.Tensor):
        """The policy's distribution at ``obs``; ``state_or_policy`` is a
        :class:`TRPOState` or the policy module."""
        policy = state_or_policy.policy if isinstance(state_or_policy, TRPOState) else state_or_policy
        return policy(self.phi(obs))

    def value(self, vf: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        v = vf(self.phi(obs))
        return v[..., 0] if v.dim() > 1 else v

    @torch.no_grad()
    def select_action(self, state: TRPOState, draws, obs, t: int, training: bool):
        dist = self.forward(state, obs)
        return dist.sample(draws) if training else dist.mode()

    @torch.no_grad()
    def act_with_aux(self, state: TRPOState, draws, obs, training: bool = True):
        dist = self.forward(state, obs)
        action = dist.sample(draws) if training else dist.mode()
        return action, {"log_prob": dist.log_prob(action), "value": self.value(state.vf, obs)}

    # ---------------------------------------------------------------- update
    def update(self, state: TRPOState, draws, rollout: Rollout):
        with torch.no_grad():
            next_values = self.value(state.vf, flat(rollout.next_obs)).reshape(rollout.reward.shape)
            advs, v_targets = gae_advantages(
                rollout.reward, rollout.value, next_values,
                rollout.terminated, rollout.done, self.gamma, self.lambd,
            )
            adv = flat(advs)
            if self.standardize_advantages:
                adv = standardize(adv)
        obs = flat(rollout.obs)
        aux = self._policy_step(state.policy, obs, flat(rollout.action), flat(rollout.log_prob), adv)
        vf_loss = self._vf_fit(state, draws, obs, flat(v_targets))
        state.n_updates += 1
        aux.update({"value_loss": vf_loss, "loss": aux["policy_loss"], "errors": torch.zeros(1, device=adv.device)})
        return state, aux

    # -------------------------------------------------- policy (CG + search)
    def _gain(self, dist, actions, old_lp, adv) -> torch.Tensor:
        gain = torch.mean(torch.exp(dist.log_prob(actions) - old_lp) * adv)
        if self.entropy_coef:
            gain = gain + self.entropy_coef * torch.mean(dist.entropy())
        return gain

    def _policy_step(self, policy, obs, actions, old_lp, adv):
        fp = _FlatPolicy(policy, self.phi(obs))
        flat0 = fp.vector()
        with torch.no_grad():
            old_dist = policy(fp.obs)
        x = flat0.clone().requires_grad_(True)
        gain0 = self._gain(fp.dist(x), actions, old_lp, adv)
        (g,) = torch.autograd.grad(gain0, x)
        (kl_grad,) = torch.autograd.grad(torch.mean(old_dist.kl(fp.dist(x))), x, create_graph=True)

        def fvp(v):
            (hv,) = torch.autograd.grad(kl_grad, x, grad_outputs=v, retain_graph=True)
            return hv + self.cg_damping * v

        step_dir = conjugate_gradient(fvp, g, max_iter=self.cg_max_iter)
        shs = torch.dot(step_dir, fvp(step_dir))
        full_step = torch.sqrt(2.0 * self.max_kl / torch.clamp_min(shs, 1e-12)) * step_dir
        accepted, best, kl = self._line_search(fp, old_dist, flat0, full_step, gain0.detach(), actions, old_lp, adv)
        fp.assign(best)
        return {
            "policy_loss": -gain0.detach(),
            "kl": kl,
            "step_accepted": accepted.to(torch.float32),
            "entropy": torch.mean(old_dist.entropy()),
        }

    @torch.no_grad()
    def _line_search(self, fp, old_dist, flat0, full_step, gain0, actions, old_lp, adv):
        """``(accepted, best, mean KL at best)``: every candidate is evaluated,
        the first acceptable one is kept."""
        accepted = torch.zeros((), dtype=torch.bool, device=flat0.device)
        best, kl_best = flat0, torch.zeros((), device=flat0.device)
        for i in range(self.max_backtrack):
            candidate = flat0 + full_step * (0.5**i)
            dist = fp.dist(candidate)
            kl = torch.mean(old_dist.kl(dist))
            ok = (self._gain(dist, actions, old_lp, adv) > gain0) & (kl <= self.max_kl) & ~accepted
            best = torch.where(ok, candidate, best)
            kl_best = torch.where(ok, kl, kl_best)
            accepted = accepted | ok
        return accepted, best, kl_best

    # -------------------------------------------------------------- vf fit
    def _vf_fit(self, state: TRPOState, draws, obs, v_targets) -> torch.Tensor:
        n = v_targets.shape[0]
        mb = min(self.vf_batch_size, n)
        n_mb = max(1, n // mb)
        params = list(state.vf.parameters())
        epoch_losses = []
        for _ in range(self.vf_epochs):
            losses = []
            for idx in draws.permutation(n)[: n_mb * mb].reshape(n_mb, mb):
                loss = torch.mean((self.value(state.vf, obs[idx]) - v_targets[idx]) ** 2)
                grads = torch.autograd.grad(loss, params)
                self.vf_optimizer.update(params, grads, state.vf_opt_state)
                losses.append(loss.detach())
            epoch_losses.append(torch.mean(torch.stack(losses)))
        return torch.mean(torch.stack(epoch_losses))


class TRPO(OnPolicyShellAgent):
    """The reference's TRPO agent (``trpo.py:251-292``)."""

    def __init__(
        self,
        policy: nn.Module,
        vf: nn.Module,
        vf_optimizer,
        *,
        gpu=None,
        gamma: float = 0.99,
        lambd: float = 0.95,
        phi: Callable = _identity,
        entropy_coef: float = 0.0,
        update_interval: int = 2048,
        max_kl: float = 0.01,
        vf_epochs: int = 3,
        vf_batch_size: int = 64,
        standardize_advantages: bool = True,
        line_search_max_backtrack: int = 10,
        conjugate_gradient_max_iter: int = 10,
        conjugate_gradient_damping: float = 1e-1,
        seed: int = 0,
        device=None,
        draws=None,
    ):
        del gpu
        core = TRPOCore(
            policy=policy,
            vf=vf,
            vf_optimizer=vf_optimizer,
            gamma=gamma,
            lambd=lambd,
            entropy_coef=entropy_coef,
            max_kl=max_kl,
            vf_epochs=vf_epochs,
            vf_batch_size=vf_batch_size,
            conjugate_gradient_max_iter=conjugate_gradient_max_iter,
            conjugate_gradient_damping=conjugate_gradient_damping,
            line_search_max_backtrack=line_search_max_backtrack,
            standardize_advantages=standardize_advantages,
            phi=phi,
        )
        super().__init__(core, update_interval=update_interval, seed=seed, device=device, draws=draws)
