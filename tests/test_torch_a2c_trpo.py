"""``A2CCore``, ``conjugate_gradient`` and ``TRPOCore`` of the port against
the JAX package's.

A2C: one full-batch update from a converted warm state (the JAX core's
initial weights after one JAX update) for both target branches (n-step
returns, GAE) with the recipe's RMSprop behind a global-norm clip at 40
(not reached) and at 0.05 (every step clips). CG: on SPD matrices, within
and beyond the iteration count at which the residual falls below ``tol``
and the iterate freezes. TRPO: one update from a converted state whose value
function's Adam is warm, with the line search accepting a step (its margins
printed and held far from the float32 decision boundary), with an entropy
bonus, and with no step accepted (a rollout with no advantage anywhere: the
surrogate cannot rise, the policy stays bit for bit); the value function's
fit draws one permutation per epoch (``jax.random.permutation`` replaced by
value, ``test_torch_ppo.py``).

Tolerances: A2C parameters 1e-6 absolute, RMSprop's ``nu`` 1e-4 relative to
each tensor's largest entry, losses 1e-5 relative. CG 1e-5 relative to the
solution's largest entry (float32 dots over up to 50 terms, amplified by the
condition number). TRPO: the policy's change 2e-3 relative to its largest
entry, and the step's KL 1e-3 relative: the surrogate's gradient and the
Fisher-vector products agree to 1e-7 (double backward here,
forward-over-reverse there), but ten unconverged float32 CG iterations
amplify rounding, and each package's direction lies 1.6e-3 (relative to
its largest entry) from a float64 CG on the same operator, 1.5e-3 from the
other's. The value function 1e-6, its Adam moments 1e-4 relative; the
rejected step's policy exact; counts and the accept flag exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_actor_critic_modules import np_tree
from test_torch_ppo import (
    ACT,
    HIDDEN,
    OBS,
    GivenDraws,
    JaxGaussianPi,
    JaxSoftmaxPiV,
    assert_metrics,
    both_rollouts,
    jax_update,
    numpy_rollout,
    permutations,
)
from test_torch_sac import assert_adam, assert_network

from pfrl_tpu.agents.a2c import A2CCore as JaxA2CCore
from pfrl_tpu.agents.trpo import TRPOCore as JaxTRPOCore
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu.utils.conjugate_gradient import conjugate_gradient as jax_cg
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents.a2c import A2CCore
from pfrl_tpu_torch.agents.trpo import TRPOCore
from pfrl_tpu_torch.experiments.onpolicy import GaussianPolicy, SoftmaxPiV
from pfrl_tpu_torch.models import MLP
from pfrl_tpu_torch.optimizers import Adam, RMSprop
from pfrl_tpu_torch.utils.conjugate_gradient import conjugate_gradient

torch.set_num_threads(1)


# ------------------------------------------------------------------- A2C
def a2c_cores(use_gae, max_grad_norm):
    kw = dict(gamma=0.99, use_gae=use_gae, entropy_coeff=0.01, v_loss_coef=0.5, max_grad_norm=max_grad_norm)
    jcore = JaxA2CCore(JaxSoftmaxPiV(), optax.rmsprop(7e-4, decay=0.99, eps=1e-5), **kw)
    tcore = A2CCore(SoftmaxPiV(OBS, 2, HIDDEN), RMSprop(7e-4, decay=0.99, eps=1e-5), **kw)
    return jcore, tcore


def assert_rmsprop_chain(tstate, jstate, what):
    nu = convert.torch_arrays(tstate.model, np_tree(jstate.opt_state[1][0].nu))
    for name, got in zip([n for n, _ in tstate.model.named_parameters()], tstate.opt_state):
        np.testing.assert_allclose(
            got.numpy(), nu[name], rtol=1e-4, atol=1e-4 * float(np.abs(nu[name]).max()) + 1e-12, err_msg=f"{what} {name}"
        )


@pytest.mark.parametrize("use_gae", [False, True])
@pytest.mark.parametrize("max_grad_norm", [40.0, 0.05])
def test_a2c_update_matches_jax(use_gae, max_grad_norm):
    jcore, tcore = a2c_cores(use_gae, max_grad_norm)
    jstate = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    warm = jax.jit(jcore.update)
    jstate, _ = warm(jstate, None, both_rollouts(numpy_rollout(100, jcore, jstate.params, discrete=True))[0])
    tstate = convert.ppo_state_from_flax(tcore, np_tree(jstate), device="cpu")
    assert tstate.n_updates == 1
    assert_rmsprop_chain(tstate, jstate, "a2c converted")
    jr, tr = both_rollouts(numpy_rollout(1, jcore, jstate.params, discrete=True))
    jstate, jaux = warm(jstate, None, jr)
    draws = GivenDraws()
    _, aux = tcore.update(tstate, draws, tr)
    assert not draws.kinds and tstate.n_updates == int(jstate.n_updates) == 2
    assert_network(tstate.model, jstate.params, 1e-6, "a2c")
    assert_rmsprop_chain(tstate, jstate, "a2c")
    assert_metrics(aux, jaux)
    assert all(p.grad is None for p in tstate.model.parameters())


# -------------------------------------------------------------------- CG
@pytest.mark.parametrize("size,max_iter", [(4, 2), (4, 30), (16, 10), (50, 10)])
def test_conjugate_gradient_matches_jax_on_spd_operators(size, max_iter):
    """(4, 30): the residual falls below ``tol`` early and the iterate stays."""
    rs = np.random.RandomState(size)
    m = rs.normal(size=(size, size)).astype(np.float32)
    a = (m @ m.T / size + 0.5 * np.eye(size)).astype(np.float32)
    b = rs.normal(size=size).astype(np.float32)
    want = np.asarray(jax_cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), max_iter=max_iter))
    ta = torch.from_numpy(a)
    calls = []

    def product(v):
        calls.append(1)
        return ta @ v

    got = conjugate_gradient(product, torch.from_numpy(b), max_iter=max_iter).numpy()
    assert len(calls) == max_iter + 1  # r0, then one product per iteration: no early exit
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    if max_iter > 2 * size:
        np.testing.assert_allclose(a @ got, b, rtol=0, atol=1e-4)


# ------------------------------------------------------------------ TRPO
def trpo_cores(entropy_coef=0.0):
    kw = dict(gamma=0.99, lambd=0.95, max_kl=0.01, vf_epochs=2, vf_batch_size=16, entropy_coef=entropy_coef)
    jcore = JaxTRPOCore(
        policy=JaxGaussianPi(act_dim=ACT), vf=JaxMLP(out_size=1, hidden_sizes=(HIDDEN, HIDDEN)),
        vf_optimizer=optax.adam(1e-3), **kw,
    )
    tcore = TRPOCore(
        policy=GaussianPolicy(OBS, ACT, HIDDEN, mean_scale=1e-4), vf=MLP(OBS, 1, (HIDDEN, HIDDEN)),
        vf_optimizer=Adam(1e-3), **kw,
    )
    return jcore, tcore


def trpo_rollout(seed, jcore, jstate, no_advantage=False):
    d = numpy_rollout(seed, _PolicyAsPiV(jcore, jstate), None)
    if no_advantage:  # every step terminal with value = reward: every TD error, so every advantage, is 0
        d["terminated"][:] = True
        d["done"][:] = True
        d["value"] = d["reward"].copy()
    return d


class _PolicyAsPiV:
    """``numpy_rollout`` asks a PPO-style core for (dist, value)."""

    def __init__(self, jcore, jstate):
        self.jcore, self.jstate = jcore, jstate

    def forward(self, _, obs):
        return self.jcore.forward(self.jstate, obs), self.jcore.value(self.jstate.vf_params, obs)


def warm_trpo(jcore, tcore):
    jstate = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    jr, _ = both_rollouts(trpo_rollout(100, jcore, jstate))
    jstate, _ = jax_update(jcore, jstate, permutations(100, 2, 64), jr)
    return jstate, convert.trpo_state_from_flax(tcore, np_tree(jstate), device="cpu")


def _capture_line_search(tcore, monkeypatch):
    seen = {}
    original = tcore._line_search

    def capture(*args):
        seen["args"] = args
        out = original(*args)
        seen["out"] = out
        return out

    monkeypatch.setattr(tcore, "_line_search", capture)
    return seen


def _margins(tcore, args):
    """(gain - gain0, max_kl - kl) of every candidate."""
    fp, old_dist, flat0, full_step, gain0, actions, old_lp, adv = args
    out = []
    with torch.no_grad():
        for i in range(tcore.max_backtrack):
            dist = fp.dist(flat0 + full_step * (0.5**i))
            gain = tcore._gain(dist, actions, old_lp, adv)
            out.append((float(gain - gain0), tcore.max_kl - float(torch.mean(old_dist.kl(dist)))))
    return out


def _assert_trpo_states(tstate, jstate, what):
    """Everything but the policy."""
    assert tstate.n_updates == int(jstate.n_updates), what
    assert_network(tstate.vf, jstate.vf_params, 1e-6, f"{what} vf")
    assert_adam(tstate.vf_opt_state, tstate.vf, jstate.vf_opt_state, f"{what} vf adam")


def _policy_step_difference(tstate, jstate_before, jstate_after) -> float:
    """The largest difference of the two policy changes over the largest
    entry of the JAX change."""
    before = convert.torch_arrays(tstate.policy, np_tree(jstate_before.policy_params))
    after = convert.torch_arrays(tstate.policy, np_tree(jstate_after.policy_params))
    diff = scale = 0.0
    for name, p in tstate.policy.named_parameters():
        want = after[name] - before[name]
        diff = max(diff, float(np.abs(p.detach().numpy() - before[name] - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    return diff / scale


@pytest.mark.parametrize("entropy_coef", [0.0, 0.01])
def test_trpo_update_with_an_accepted_step_matches_jax(entropy_coef, monkeypatch):
    jcore, tcore = trpo_cores(entropy_coef)
    jstate, tstate = warm_trpo(jcore, tcore)
    assert tstate.vf_opt_state.count == 2 * 4 and tstate.n_updates == 1
    before = [p.detach().clone() for p in tstate.policy.parameters()]
    jr, tr = both_rollouts(trpo_rollout(1, jcore, jstate))
    perms = permutations(1, 2, 64)
    jbefore = jstate
    jstate, jaux = jax_update(jcore, jstate, perms, jr)
    seen = _capture_line_search(tcore, monkeypatch)
    draws = GivenDraws(*perms)
    _, aux = tcore.update(tstate, draws, tr)
    assert draws.kinds == ["permutation"] * 2
    margins = _margins(tcore, seen["args"])
    first = next(i for i, (g, k) in enumerate(margins) if g > 0 and k >= 0)
    print(f"trpo line search (entropy {entropy_coef}): accepted candidate {first}; "
          f"(gain - gain0, max_kl - kl) per candidate {margins}")
    for i, (g, k) in enumerate(margins[: first + 1]):  # the decisions that count, far from the boundary
        assert abs(g) > 1e-7 and abs(k) > 1e-6, (i, g, k)
    assert float(aux["step_accepted"]) == float(jaux["step_accepted"]) == 1.0
    np.testing.assert_allclose(float(aux["kl"]), float(jaux["kl"]), rtol=1e-3)
    assert 0.0 < float(aux["kl"]) <= tcore.max_kl
    assert_metrics(aux, jaux, ("policy_loss", "value_loss", "entropy", "loss"))
    _assert_trpo_states(tstate, jstate, "trpo")
    step_diff = _policy_step_difference(tstate, jbefore, jstate)
    print(f"trpo policy step: port vs JAX {step_diff:.2e} of the step's largest entry")
    assert step_diff <= 2e-3
    assert any(not torch.equal(a, b) for a, b in zip(before, tstate.policy.parameters()))
    assert all(p.grad is None for p in list(tstate.policy.parameters()) + list(tstate.vf.parameters()))


def test_trpo_update_with_no_step_accepted_keeps_the_policy(monkeypatch):
    jcore, tcore = trpo_cores()
    jstate, tstate = warm_trpo(jcore, tcore)
    before = [p.detach().clone() for p in tstate.policy.parameters()]
    jr, tr = both_rollouts(trpo_rollout(2, jcore, jstate, no_advantage=True))
    perms = permutations(2, 2, 64)
    jpolicy = jstate.policy_params
    jstate, jaux = jax_update(jcore, jstate, perms, jr)
    seen = _capture_line_search(tcore, monkeypatch)
    _, aux = tcore.update(tstate, GivenDraws(*perms), tr)
    print(f"trpo line search, no advantage: (gain - gain0, max_kl - kl) {_margins(tcore, seen['args'])[:2]}")
    assert float(aux["step_accepted"]) == float(jaux["step_accepted"]) == 0.0
    assert float(aux["kl"]) == float(jaux["kl"]) == 0.0
    for a, b in zip(before, tstate.policy.parameters()):
        assert torch.equal(a, b)
    jax.tree.map(np.testing.assert_array_equal, np_tree(jpolicy), np_tree(jstate.policy_params))
    _assert_trpo_states(tstate, jstate, "trpo rejected")  # the value function still fits
