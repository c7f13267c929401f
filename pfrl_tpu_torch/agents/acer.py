"""ACER, actor-critic with experience replay (counterpart of
``pfrl_tpu/agents/acer.py``): :class:`ACERCore` for discrete actions,
:class:`ACERSDNModel` and :class:`ACERContinuousCore` for continuous ones.

Both are synchronous batched learners over the episodic buffer: each update
takes a batch of padded rows ``[B, T]``
(:class:`~pfrl_tpu_torch.replay.episodic.EpisodeBatch`) whose transitions
carry the behaviour distribution in ``extras`` (``mu_logits``, or
``mu_mean`` and ``mu_std``), stored by the runner from
``select_action_with_extras``. The state (:class:`ACERState`) is the model,
a Polyak average of it (``avg_model``, the trust region's anchor, moved by
``soft_copy_param(avg, model, 1 - alpha)`` after every step), the
optimizer's state and ``n_updates``; ``update_episodic`` changes it **in
place**.

One update, in the JAX core's order: the forward on ``obs`` (with
gradient), one forward on ``next_obs`` under no gradient for the
bootstrap (the JAX loss calls it twice, once for each output, which
gives the same numbers), importance weights against the stored behaviour,
the Retrace recursion as a reverse loop over T that restarts from ``(1 -
terminated) * V(next_obs)`` at each row's last valid step and runs
through the padded steps before it (the mask removes them only at the
end), the truncated policy gradient with its bias correction, and the
trust region in the policy's statistics against the average model. The
loss is the masked mean over ``max(sum(mask), 1)``; ``aux["errors"]`` is
``zeros(1)``: ACER feeds no priorities back. In a data-parallel update each
rank takes its share of the rows and divides by the whole batch's
``sum(mask)`` (``EpisodeBatch.whole_mask``), and the ranks' gradients and
masked-mean metrics are summed (``global_denominator``); the trust
region's ``g`` and ``k`` are per step and need no collective.

Discrete trust region: ``g`` is minus the gradient of the masked policy
loss with respect to the normalised log-probabilities taken as free
variables (not through ``log_softmax``); that loss is linear in them, so
``g`` has a closed form (:func:`policy_loss_grad`, the JAX ``jax.grad``'s
products in its order). ``k = exp(logits) - exp(avg_logits)``; the step is
``g - relu((k.g - delta) / max(k.k, 1e-10)) k``, and the surrogate ``-sum
logits * sg(g_adj)`` backpropagates through ``log_softmax`` into the
network.

Continuous (SDN): ``Q(s, a) = V(s) + A(s, a) - mean_i A(s, a_i)`` with
``a_i ~ pi``; the Retrace coefficient is ``min(1, rho ** (1 / d))``; the
bias correction samples one action; the trust region acts on the
Gaussian's ``(mean, std)``, with ``g`` and ``k`` from two
``torch.autograd.grad`` calls on the detached statistics; a V loss toward
``min(1, rho) (Q_ret - Q) + V`` joins the Q loss. Padded steps carry
zero-filled behaviour statistics and are patched to a standard normal
before ``log_prob``, else ``NaN * 0`` poisons the loss.

Draws, in order: acting takes the policy's sample (a categorical draw of
the logits' element count, or one normal of the mean's); the continuous
update takes one normal of ``[n_sdn, B, T, d]`` for the SDN expectation,
then one of ``[B, T, d]`` for the correction's action. The discrete update
draws nothing.

``compute_dtype`` casts the network's weights and inputs at the apply
boundary (:func:`~pfrl_tpu_torch.utils.precision.apply_cast`); the outputs
come back float32, so the Retrace recursion, the trust region and the
optimizer stay float32, as in the JAX core.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pfrl_tpu_torch.agents.ddpg import _identity, fresh_module, frozen_copy
from pfrl_tpu_torch.distributions import Normal
from pfrl_tpu_torch.models.mlp import scoped_names
from pfrl_tpu_torch.replay.episodic import EpisodeBatch
from pfrl_tpu_torch.utils.copy_param import soft_copy_param
from pfrl_tpu_torch.utils.draws import normal
from pfrl_tpu_torch.utils.precision import apply_cast, check_compute_dtype


@dataclasses.dataclass
class ACERState:
    model: nn.Module      # the JAX state's params
    avg_model: nn.Module  # avg_params: the Polyak average, the trust region's anchor
    opt_state: Any
    n_updates: int = 0


def _mean_over(x: torch.Tensor, mask: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / denom


def retrace(reward, terminated, next_v, c, v, q_a, lengths, gamma: float, with_opc: bool = False):
    """``(Q_ret, Q_opc)``, ``[B, T]`` each, of the reverse recursion (``Q_opc``,
    the recursion with ``c = 1``, only ``with_opc``, else None). At each
    row's last valid step both restart from ``(1 - terminated) * next_v``;
    the padded steps after it are computed and left for the mask. Inputs
    carry no gradient."""
    B, T = reward.shape
    is_last = torch.arange(T, device=reward.device)[None, :] == (lengths - 1)[:, None]
    boot = (1.0 - terminated.to(torch.float32)) * next_v  # each step's restart value, elementwise as JAX's
    ret = opc = torch.zeros(B, dtype=torch.float32, device=reward.device)
    q_ret, q_opc = [None] * T, [None] * T
    for t in reversed(range(T)):
        ret = torch.where(is_last[:, t], boot[:, t], ret)
        q_ret[t] = reward[:, t] + gamma * ret
        ret = c[:, t] * (q_ret[t] - q_a[:, t]) + v[:, t]
        if with_opc:
            opc = torch.where(is_last[:, t], boot[:, t], opc)
            q_opc[t] = reward[:, t] + gamma * opc
            opc = q_opc[t] - q_a[:, t] + v[:, t]
    return torch.stack(q_ret, dim=1), (torch.stack(q_opc, dim=1) if with_opc else None)


def policy_loss_grad(actions, trunc_rho, adv, corr_w, corr_adv, mask) -> torch.Tensor:
    """The gradient ``[B, T, A]`` of ``sum(mask * (-trunc_rho * lg[a] * adv
    + sum(corr_w * lg * corr_adv) * -1))`` with respect to the log-probs
    ``lg`` as free variables; the loss is linear in them. The products are
    the transposes ``jax.grad`` takes, in its order."""
    ct = (-mask)[..., None] * corr_adv * corr_w
    chosen = (mask * adv) * (-trunc_rho)
    return ct.scatter_add(-1, actions.to(torch.int64)[..., None], chosen[..., None])


class ACERCore:
    """``model``: obs -> ``(Categorical, DiscreteActionValue)``; V = E_pi[Q].
    ``model`` is a template: ``init`` copies it and draws the copy's
    weights (``model.reset_parameters(generator)``)."""

    #: A rank's share of the masked means divides by the whole batch's count.
    global_denominator = True
    summed_metrics = ("loss", "pi_loss", "q_loss", "kl", "entropy")

    def __init__(
        self,
        model: nn.Module,
        optimizer,
        gamma: float = 0.99,
        beta: float = 1e-2,
        truncation_threshold: float = 10.0,
        use_trust_region: bool = True,
        trust_region_delta: float = 0.1,
        trust_region_alpha: float = 0.99,
        use_Q_opc: bool = False,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.gamma = gamma
        self.beta = beta
        self.c = truncation_threshold
        self.use_trust_region = use_trust_region
        self.delta = trust_region_delta
        self.alpha = trust_region_alpha
        self.use_Q_opc = use_Q_opc
        self.phi = phi
        self.compute_dtype = check_compute_dtype(compute_dtype)

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action=None) -> ACERState:
        """``generator`` (on the CPU) draws the weights; ``example_obs`` is a
        batched observation on the target device."""
        model = fresh_module(self.model, generator, example_obs.device)
        with torch.no_grad():  # shape check
            self.forward(model, example_obs)
        return self.state_from_model(model)

    def state_from_model(self, model: nn.Module) -> ACERState:
        """The average model starts as a copy of ``model``."""
        return ACERState(model=model, avg_model=frozen_copy(model),
                         opt_state=self.optimizer.init(list(model.parameters())))

    # ------------------------------------------------------------------- act
    def forward(self, model: nn.Module, obs: torch.Tensor):
        return apply_cast(model, self.compute_dtype, self.phi(obs))

    @torch.no_grad()
    def select_action(self, state: ACERState, draws, obs, t: int, training: bool):
        pi, _ = self.forward(state.model, obs)
        return pi.sample(draws) if training else pi.mode()

    @torch.no_grad()
    def select_action_with_extras(self, state: ACERState, draws, obs, t: int, training: bool):
        """The action and the behaviour distribution's normalised
        log-probabilities, ``{"mu_logits": [L, A]}``, for replay."""
        pi, _ = self.forward(state.model, obs)
        a = pi.sample(draws) if training else pi.mode()
        return a, {"mu_logits": pi.log_probs}

    # ---------------------------------------------------------------- update
    def update_episodic(self, state: ACERState, batch: EpisodeBatch, draws=None):
        """One gradient step on a batch of rows, in place; draws nothing."""
        tr = batch.transitions
        B, T = batch.mask.shape
        pi, av = self.forward(state.model, _flat(tr.obs))
        A = av.q_values.shape[-1]
        logits = pi.log_probs.reshape(B, T, A)  # normalised log-probs
        q = av.q_values.reshape(B, T, A)
        loss, aux = self._loss_from_stats(state, logits, q, batch)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        soft_copy_param(state.avg_model, state.model, 1.0 - self.alpha)
        state.n_updates += 1
        aux["loss"] = loss.detach()
        aux["errors"] = torch.zeros(1, device=loss.device)
        return state, aux

    def _loss_from_stats(self, state: ACERState, logits, q, batch: EpisodeBatch) -> Tuple[torch.Tensor, Dict]:
        tr = batch.transitions
        B, T, A = logits.shape
        mask = batch.mask
        actions = tr.action.to(torch.int64)[..., None]
        mu_logits = tr.extras["mu_logits"]
        with torch.no_grad():
            lg, q_sg = logits.detach(), q.detach()
            v_sg = torch.sum(torch.exp(lg) * q_sg, dim=-1)
            q_a_sg = torch.gather(q_sg, -1, actions)[..., 0]
            rho_a = torch.exp(torch.gather(lg, -1, actions)[..., 0] - torch.gather(mu_logits, -1, actions)[..., 0])
            rho_all = torch.exp(lg - mu_logits)
            # The bootstrap: V(next_obs) of the current weights.
            next_pi, next_av = self.forward(state.model, _flat(tr.next_obs))
            next_v = torch.sum(torch.exp(next_pi.log_probs) * next_av.q_values, dim=-1).reshape(B, T)
            q_ret, q_opc = retrace(tr.reward, tr.terminated, next_v, torch.clamp_max(rho_a, 1.0), v_sg, q_a_sg,
                                   batch.lengths, self.gamma, self.use_Q_opc)
            adv = (q_opc if self.use_Q_opc else q_ret) - v_sg
            trunc_rho = torch.clamp_max(rho_a, self.c)
            corr_w = torch.relu(1.0 - self.c / torch.clamp_min(rho_all, 1e-10)) * torch.exp(lg)
            corr_adv = q_sg - v_sg[..., None]
            denom = torch.clamp_min(batch.valid_steps(), 1.0)

        if self.use_trust_region:
            with torch.no_grad():
                avg_pi, _ = self.forward(state.avg_model, _flat(tr.obs))
                avg_logits = avg_pi.log_probs.reshape(B, T, A)
                g = -policy_loss_grad(tr.action, trunc_rho, adv, corr_w, corr_adv, mask)
                k = torch.exp(lg) - torch.exp(avg_logits)  # the gradient of KL(avg || pi) in the logits
                kg = torch.sum(k * g, dim=-1)
                k2 = torch.sum(k * k, dim=-1)
                factor = torch.relu((kg - self.delta) / torch.clamp_min(k2, 1e-10))
                g_adj = g - factor[..., None] * k
                kl = _mean_over(torch.sum(torch.exp(avg_logits) * (avg_logits - lg), dim=-1), mask, denom)
            # The linearised surrogate: its gradient in the logits is -g_adj.
            pi_loss = -torch.sum(logits * g_adj, dim=-1)
        else:
            logpi_a = torch.gather(logits, -1, actions)[..., 0]
            pi_loss = -trunc_rho * logpi_a * adv
            pi_loss = pi_loss - torch.sum(-corr_w * logits * corr_adv, dim=-1) * (-1.0)
            kl = torch.zeros((), device=logits.device)

        entropy = -torch.sum(torch.exp(logits) * logits, dim=-1)
        pi_loss = pi_loss - self.beta * entropy
        q_a = torch.gather(q, -1, actions)[..., 0]
        q_loss = 0.5 * (q_ret - q_a) ** 2
        total = torch.sum((pi_loss + q_loss) * mask) / denom
        with torch.no_grad():
            aux = {"pi_loss": _mean_over(pi_loss, mask, denom), "q_loss": _mean_over(q_loss, mask, denom), "kl": kl,
                   "entropy": _mean_over(entropy, mask, denom)}
        return total, aux


def _flat(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, ...]`` -> ``[B * T, ...]``."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


# ============================================================== continuous
class ACERSDNModel(nn.Module):
    """The stochastic dueling head: submodules ``pi`` (obs -> ``Normal``),
    ``vf`` (obs -> ``[B, 1]``) and ``adv`` ((obs, action) -> ``[B]`` or
    ``[B, 1]``, an ``FCSAQFunction``), the flax scopes ``pi``, ``vf`` and
    ``adv``. :meth:`pi_v` gives ``(Normal, V [B])`` and :meth:`advantage`
    ``A(x, a) [B]``, as the JAX model's methods do; ``forward(x)`` is
    ``pi_v(x)`` and ``forward(x, a)`` is ``advantage(x, a)``."""

    def __init__(self, pi: nn.Module, vf: nn.Module, adv: nn.Module):
        super().__init__()
        self.pi = pi
        self.vf = vf
        self.adv = adv

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for sub in (self.pi, self.vf, self.adv):
            sub.reset_parameters(generator)

    def flax_names(self) -> Dict[str, Any]:
        return {**scoped_names("pi", "pi", self.pi), **scoped_names("vf", "vf", self.vf),
                **scoped_names("adv", "adv", self.adv)}

    def pi_v(self, x: torch.Tensor):
        v = self.vf(x)
        return self.pi(x), (v[..., 0] if v.dim() > 1 else v)

    def advantage(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        q = self.adv(x, a)
        return q[..., 0] if q.dim() > 1 else q

    def forward(self, x: torch.Tensor, a: Optional[torch.Tensor] = None):
        return self.pi_v(x) if a is None else self.advantage(x, a)


class ACERContinuousCore:
    """Continuous-action ACER over an :class:`ACERSDNModel`; ``use_Q_opc``
    defaults to True, as in the JAX core."""

    global_denominator = True
    summed_metrics = ACERCore.summed_metrics

    def __init__(
        self,
        model: ACERSDNModel,
        optimizer,
        gamma: float = 0.99,
        beta: float = 1e-2,
        truncation_threshold: float = 5.0,
        n_sdn_samples: int = 5,
        use_trust_region: bool = True,
        trust_region_delta: float = 0.1,
        trust_region_alpha: float = 0.99,
        use_Q_opc: bool = True,
        phi: Callable = _identity,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.gamma = gamma
        self.beta = beta
        self.c = truncation_threshold
        self.n_sdn = n_sdn_samples
        self.use_trust_region = use_trust_region
        self.delta = trust_region_delta
        self.alpha = trust_region_alpha
        self.use_Q_opc = use_Q_opc
        self.phi = phi
        self.compute_dtype = check_compute_dtype(compute_dtype)

    # ----------------------------------------------------------------- setup
    def init(self, generator: torch.Generator, example_obs: torch.Tensor, example_action: torch.Tensor) -> ACERState:
        model = fresh_module(self.model, generator, example_obs.device)
        with torch.no_grad():  # shape check of every submodule
            self.pi_v(model, example_obs)
            self.advantage(model, example_obs, example_action)
        return self.state_from_model(model)

    state_from_model = ACERCore.state_from_model

    # ------------------------------------------------------------------- act
    def pi_v(self, model: nn.Module, obs: torch.Tensor):
        return apply_cast(model, self.compute_dtype, self.phi(obs))

    def advantage(self, model: nn.Module, obs: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return apply_cast(model, self.compute_dtype, self.phi(obs), a)

    @torch.no_grad()
    def select_action(self, state: ACERState, draws, obs, t: int, training: bool):
        pi, _ = self.pi_v(state.model, obs)
        return pi.sample(draws) if training else pi.mode()

    @torch.no_grad()
    def select_action_with_extras(self, state: ACERState, draws, obs, t: int, training: bool):
        """The action and the behaviour Gaussian, ``{"mu_mean", "mu_std"}``."""
        pi, _ = self.pi_v(state.model, obs)
        a = pi.sample(draws) if training else pi.mode()
        return a, {"mu_mean": pi.loc, "mu_std": pi.scale}

    # ---------------------------------------------------------------- update
    def update_episodic(self, state: ACERState, batch: EpisodeBatch, draws):
        """One gradient step on a batch of rows, in place."""
        B, T = batch.mask.shape
        pi, v = self.pi_v(state.model, _flat(batch.transitions.obs))
        d = pi.loc.shape[-1]
        loss, aux = self._loss_from_stats(state, pi.loc.reshape(B, T, d), pi.scale.reshape(B, T, d),
                                          v.reshape(B, T), batch, draws)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(loss, params)
        self.optimizer.update(params, grads, state.opt_state)
        soft_copy_param(state.avg_model, state.model, 1.0 - self.alpha)
        state.n_updates += 1
        aux["loss"] = loss.detach()
        aux["errors"] = torch.zeros(1, device=loss.device)
        return state, aux

    def _loss_from_stats(self, state: ACERState, mean, std, v, batch: EpisodeBatch, draws):
        tr = batch.transitions
        B, T, d = mean.shape
        mask = batch.mask
        obs_flat = _flat(tr.obs)
        a = tr.action.reshape(B, T, d)
        pad = (mask == 0)[..., None]
        # Padded steps hold zero-filled statistics: a standard normal there.
        mu = Normal(loc=torch.where(pad, 0.0, tr.extras["mu_mean"]),
                    scale=torch.where(pad, 1.0, tr.extras["mu_std"]))
        mean_sg, std_sg = mean.detach(), std.detach()
        with torch.no_grad():
            rho = torch.exp(Normal(loc=mean_sg, scale=std_sg).log_prob(a) - mu.log_prob(a))

        def adv_of(actions):  # [n, B, T, d] or [B, T, d] -> [n, B, T] or [B, T]
            lead = tuple(actions.shape[:-3])
            obs = obs_flat.expand(lead + tuple(obs_flat.shape)).reshape((-1,) + tuple(obs_flat.shape[1:]))
            return self.advantage(state.model, obs, actions.reshape(-1, d)).reshape(lead + (B, T))

        # SDN: Q(s, a) = V + A(s, a) - mean_i A(s, a_i), a_i ~ pi.
        # A per-row draw whose rows lie on axis 1: a rank's share keeps
        # ``[:, its rows]``, not a flat block of the draw.
        samples = mean_sg + std_sg * normal(draws, (self.n_sdn, B, T, d), row_axis=1)
        exp_adv = torch.mean(adv_of(samples), dim=0)
        q_a = v + adv_of(a) - exp_adv

        with torch.no_grad():
            _, next_v = self.pi_v(state.model, _flat(tr.next_obs))
            next_v = next_v.reshape(B, T)
            v_sg, q_a_sg = v.detach(), q_a.detach()
            # Retrace with the per-dimension coefficient min(1, rho^(1/d)).
            q_ret, q_opc = retrace(tr.reward, tr.terminated, next_v, torch.clamp_max(rho ** (1.0 / d), 1.0), v_sg,
                                   q_a_sg, batch.lengths, self.gamma, self.use_Q_opc)
            adv_ret = (q_opc if self.use_Q_opc else q_ret) - v_sg
            # The sampled bias correction's action and advantage.
            a_corr = mean_sg + std_sg * normal(draws, (B, T, d))  # per row, on axis 0
            corr_adv = (v_sg + adv_of(a_corr) - exp_adv.detach()) - v_sg
            trunc_rho = torch.clamp_max(rho, self.c)
            denom = torch.clamp_min(batch.valid_steps(), 1.0)

        def pi_loss_of(mean_, std_):
            p = Normal(loc=mean_, scale=std_)
            term1 = -trunc_rho * p.log_prob(a) * adv_ret
            lp_corr = p.log_prob(a_corr)
            rho_corr = torch.exp(lp_corr.detach() - mu.log_prob(a_corr))
            w = torch.relu(1.0 - self.c / torch.clamp_min(rho_corr, 1e-10))
            return term1 + -w * lp_corr * corr_adv

        if self.use_trust_region:
            with torch.no_grad():
                avg_pi, _ = self.pi_v(state.avg_model, obs_flat)
                avg = Normal(loc=avg_pi.loc.reshape(B, T, d), scale=avg_pi.scale.reshape(B, T, d))
            with torch.enable_grad():
                stats = (mean_sg.requires_grad_(), std_sg.requires_grad_())
                g = [-x for x in torch.autograd.grad(torch.sum(pi_loss_of(*stats) * mask), stats)]
                k = torch.autograd.grad(torch.sum(avg.kl(Normal(*stats)) * mask), stats)
            with torch.no_grad():
                kg = sum(torch.sum(ki * gi, dim=-1) for ki, gi in zip(k, g))
                k2 = sum(torch.sum(ki * ki, dim=-1) for ki in k)
                factor = torch.relu((kg - self.delta) / torch.clamp_min(k2, 1e-10))
                g_adj = [gi - factor[..., None] * ki for gi, ki in zip(g, k)]
                kl = _mean_over(avg.kl(Normal(loc=mean.detach(), scale=std.detach())), mask, denom)
            pi_loss = -(torch.sum(mean * g_adj[0], dim=-1) + torch.sum(std * g_adj[1], dim=-1))
        else:
            pi_loss = pi_loss_of(mean, std)
            kl = torch.zeros((), device=mean.device)

        entropy = Normal(loc=mean, scale=std).entropy()
        pi_loss = pi_loss - self.beta * entropy
        # Q toward Q_ret, and V toward min(1, rho) (Q_ret - Q) + V.
        q_loss = 0.5 * (q_ret - q_a) ** 2
        v_target = torch.clamp_max(rho, 1.0) * (q_ret - q_a_sg) + v_sg
        q_loss = q_loss + 0.5 * (v_target - v) ** 2
        total = torch.sum((pi_loss + q_loss) * mask) / denom
        with torch.no_grad():
            aux = {"pi_loss": _mean_over(pi_loss, mask, denom), "q_loss": _mean_over(q_loss, mask, denom), "kl": kl,
                   "entropy": _mean_over(entropy, mask, denom)}
        return total, aux
