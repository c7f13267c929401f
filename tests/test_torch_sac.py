"""``SACCore`` of the port against the JAX package's: from a converted
state with non-zero Adam moments, one and three ``update`` calls on the
same numpy batch with the same noise, and ``select_action``.

The JAX core runs un-jitted with ``jax.random.normal`` replaced by a
function that hands out given arrays in order (the critic's noise, then
the actor's); the port draws the same arrays from :class:`GivenDraws`.

Tolerances, all float32 through 16-wide MLPs whose dots are summed in
another order: losses and the temperature 1e-5 relative; errors 1e-5;
parameters, targets and ``log_temperature`` 1e-6 absolute after one update
and 3e-6 after three (Adam's first steps move a weight by about the
learning rate whatever the gradient's size, so a rounding difference in a
tiny gradient shows at the 1e-6 level); Adam's moments 1e-4 relative to
each tensor's largest entry; counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_actor_critic_modules import ACT, HIDDEN, OBS, JaxSACPolicy, np_tree

from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents.soft_actor_critic import SACCore as JaxSACCore
from pfrl_tpu.replay import TransitionBatch as JaxBatch
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import SACCore, SACState
from pfrl_tpu_torch.experiments.mujoco_actor_critic import squashed_gaussian_policy, uniform_burnin
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCSAQFunction
from pfrl_tpu_torch.replay import TransitionBatch

torch.set_num_threads(1)

BATCH = 12
LR = 3e-3  # larger than the recipe's 3e-4, so three updates move the weights visibly


class GivenDraws:
    """Hands out given arrays in order, whatever the kind of draw."""

    def __init__(self, *arrays):
        self.queue = [np.asarray(a) for a in arrays]

    def _pop(self, n):
        a = self.queue.pop(0)
        assert a.size == n, (a.shape, n)
        return torch.from_numpy(a.reshape(-1).copy())

    normal = uniform = _pop


def give_jax(monkeypatch, *arrays, uniforms=()):
    """Replace ``jax.random.normal`` (and ``uniform``) by queues of arrays."""
    normals, uniforms = [np.asarray(a) for a in arrays], [np.asarray(a) for a in uniforms]

    def normal(key, shape=(), dtype=jnp.float32):
        a = normals.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = jnp.asarray(uniforms.pop(0), dtype).reshape(shape)
        return jnp.maximum(minval, u * (maxval - minval) + minval)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    return normals, uniforms


def numpy_batch(seed, batch=BATCH, obs=OBS, act=ACT):
    rs = np.random.RandomState(seed)
    return dict(
        obs=rs.normal(size=(batch, obs)).astype(np.float32),
        action=rs.uniform(-1, 1, (batch, act)).astype(np.float32),
        reward=rs.normal(size=batch).astype(np.float32),
        next_obs=rs.normal(size=(batch, obs)).astype(np.float32),
        discount=np.where(rs.uniform(size=batch) < 0.7, 0.99, 0.99**2).astype(np.float32),
        is_terminal=rs.uniform(size=batch) < 0.3,
        weight=np.ones(batch, np.float32),
        indices=np.arange(batch, dtype=np.int32),
    )


def both_batches(d):
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in d.items()}, extras=FrozenDict())
    tb = TransitionBatch(**{k: torch.from_numpy(v.copy()) for k, v in d.items()})
    return jb, tb


def assert_network(module, flax_tree, atol, what):
    got = dict(module.named_parameters())
    for name, want in convert.torch_arrays(module, np_tree(flax_tree)).items():
        np.testing.assert_allclose(got[name].detach().numpy(), want, atol=atol, rtol=0, err_msg=f"{what} {name}")


def assert_adam(opt_state, module, jax_opt_state, what):
    adam = jax_opt_state[0]
    assert opt_state.count == int(adam.count), what
    names = [n for n, _ in module.named_parameters()]
    for moments, tree in ((opt_state.mu, adam.mu), (opt_state.nu, adam.nu)):
        want = convert.torch_arrays(module, np_tree(tree))
        for name, m in zip(names, moments):
            atol = 1e-4 * float(np.abs(want[name]).max()) + 1e-12
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4, atol=atol, err_msg=f"{what} {name}")


def assert_close(got, want, rtol, what, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# ------------------------------------------------------------------------ SAC
def _cores(entropy_target=-float(ACT), burnin=False):
    jqf = lambda: jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=HIDDEN)  # noqa: E731
    tqf = lambda: FCSAQFunction(OBS, ACT, HIDDEN, 2)  # noqa: E731
    jburn = (lambda rng, n: jax.random.uniform(rng, (n, ACT), minval=-1.0, maxval=1.0)) if burnin else None
    jcore = JaxSACCore(
        policy=JaxSACPolicy(), q_func1=jqf(), q_func2=jqf(),
        policy_optimizer=optax.adam(LR), q_func1_optimizer=optax.adam(LR), q_func2_optimizer=optax.adam(LR),
        temperature_optimizer=optax.adam(LR), gamma=0.99, entropy_target=entropy_target,
        initial_temperature=0.7, burnin_action_func=jburn, burnin_steps=100 if burnin else 0,
    )
    tcore = SACCore(
        policy=squashed_gaussian_policy(OBS, ACT, HIDDEN), q_func1=tqf(), q_func2=tqf(),
        policy_optimizer=Adam(LR), q_func1_optimizer=Adam(LR), q_func2_optimizer=Adam(LR),
        temperature_optimizer=Adam(LR), gamma=0.99, entropy_target=entropy_target,
        initial_temperature=0.7, burnin_action_func=uniform_burnin(ACT) if burnin else None,
        burnin_steps=100 if burnin else 0,
    )
    return jcore, tcore


def _noise(seed, n_updates):
    rs = np.random.RandomState(seed)
    return [rs.normal(size=(BATCH, ACT)).astype(np.float32) for _ in range(2 * n_updates)]


def _warm_state(monkeypatch, jcore, n_warm=2):
    """A JAX state after ``n_warm`` updates: moments, counts and targets
    all differ from a fresh state's."""
    jstate = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    jb, _ = both_batches(numpy_batch(100))
    give_jax(monkeypatch, *_noise(101, n_warm))
    for _ in range(n_warm):
        jstate, _ = jcore.update(jstate, jax.random.PRNGKey(0), jb)
    return jstate


def _assert_states(tstate, jstate, atol, tag):
    assert isinstance(tstate, SACState)
    assert tstate.n_updates == int(jstate.n_updates), tag
    for attr, field in (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params"),
                        ("target_q_func1", "target_q1_params"), ("target_q_func2", "target_q2_params")):
        assert_network(getattr(tstate, attr), getattr(jstate, field), atol, f"{tag} {attr}")
    for attr, module, field in (("policy_opt_state", tstate.policy, "policy_opt_state"),
                                ("q1_opt_state", tstate.q_func1, "q1_opt_state"),
                                ("q2_opt_state", tstate.q_func2, "q2_opt_state")):
        assert_adam(getattr(tstate, attr), module, getattr(jstate, field), f"{tag} {attr}")
    assert_close(tstate.log_temperature.detach(), jstate.log_temperature, 0, f"{tag} log_temperature", atol)
    tadam, jadam = tstate.temperature_opt_state, jstate.temperature_opt_state[0]
    assert tadam.count == int(jadam.count) and len(tadam.mu) == len(tadam.nu) == 1
    assert tadam.mu[0].shape == tadam.nu[0].shape == ()  # a 0-d Adam state
    assert_close(tadam.mu[0], jadam.mu, 1e-4, f"{tag} temperature mu", 1e-9)
    assert_close(tadam.nu[0], jadam.nu, 1e-4, f"{tag} temperature nu", 1e-12)


@pytest.mark.parametrize("n_updates,atol", [(1, 1e-6), (3, 3e-6)])
def test_sac_updates_match_jax_from_a_converted_state(monkeypatch, n_updates, atol):
    jcore, tcore = _cores()
    jstate = _warm_state(monkeypatch, jcore)
    tstate = convert.sac_state_from_flax(tcore, np_tree(jstate), device="cpu")
    _assert_states(tstate, jstate, 0.0, "converted")  # the converter is exact
    assert tstate.n_updates == 2 and tstate.policy_opt_state.count == 2
    assert not torch.equal(tstate.target_q_func1.mlp.layers[0].weight, tstate.q_func1.mlp.layers[0].weight)

    jb, tb = both_batches(numpy_batch(1))
    noise = _noise(2, n_updates)
    give_jax(monkeypatch, *noise)
    draws = GivenDraws(*noise)
    log_temp0 = float(tstate.log_temperature.detach())
    for k in range(n_updates):
        jstate, jaux = jcore.update(jstate, jax.random.PRNGKey(0), jb)
        same, taux = tcore.update(tstate, tb, draws)
        assert same is tstate  # in place
        assert set(taux) == set(jaux)
        for name in ("loss", "actor_loss", "temperature_loss", "entropy", "temperature"):
            assert_close(taux[name], jaux[name], 1e-5, f"update {k} {name}", 1e-6)
            assert not taux[name].requires_grad and taux[name].shape == ()
        assert_close(taux["errors"], jaux["errors"], 1e-5, f"update {k} errors", 1e-5)
    assert not draws.queue
    _assert_states(tstate, jstate, atol, f"after {n_updates}")
    assert tstate.n_updates == 2 + n_updates == tstate.q1_opt_state.count == tstate.temperature_opt_state.count
    assert abs(float(tstate.log_temperature.detach()) - log_temp0) > 1e-3  # the temperature is learned
    assert_close(taux["temperature"], np.exp(float(tstate.log_temperature.detach())), 1e-6, "temperature = exp(log)")


def test_sac_gradients_reach_only_what_each_loss_differentiates(monkeypatch):
    """No gradient is left on any parameter (``autograd.grad``, never
    ``backward``), the targets take none, and with a fixed temperature
    ``log_temperature`` and its Adam state stay as they were, as in JAX."""
    jcore, tcore = _cores(entropy_target=None)
    assert not tcore.learn_temperature
    jstate = _warm_state(monkeypatch, jcore)
    tstate = convert.sac_state_from_flax(tcore, np_tree(jstate), device="cpu")
    jb, tb = both_batches(numpy_batch(3))
    noise = _noise(4, 1)
    give_jax(monkeypatch, *noise)
    jstate, jaux = jcore.update(jstate, jax.random.PRNGKey(0), jb)
    _, taux = tcore.update(tstate, tb, GivenDraws(*noise))
    _assert_states(tstate, jstate, 1e-6, "fixed temperature")
    assert float(taux["temperature_loss"]) == float(jaux["temperature_loss"]) == 0.0
    assert tstate.temperature_opt_state.count == 0
    assert_close(tstate.log_temperature.detach(), np.log(np.float32(0.7)), 1e-7, "log_temperature")
    modules = (tstate.policy, tstate.q_func1, tstate.q_func2, tstate.target_q_func1, tstate.target_q_func2)
    assert all(p.grad is None for m in modules for p in m.parameters())
    assert tstate.log_temperature.grad is None
    assert not any(p.requires_grad for m in modules[3:] for p in m.parameters())


def test_sac_select_action_training_evaluating_and_burn_in_match_jax(monkeypatch):
    jcore, tcore = _cores(burnin=True)
    jstate = _warm_state(monkeypatch, jcore)
    tstate = convert.sac_state_from_flax(tcore, np_tree(jstate), device="cpu")
    rs = np.random.RandomState(5)
    obs = rs.normal(size=(6, OBS)).astype(np.float32)
    eps = rs.normal(size=(6, ACT)).astype(np.float32)
    u = rs.uniform(size=(6, ACT)).astype(np.float32)
    key = jax.random.PRNGKey(0)

    # Evaluating: the mode, no draw at all.
    want = jcore.select_action(jstate, key, jnp.asarray(obs), jnp.int32(0), False)
    got = tcore.select_action(tstate, GivenDraws(), torch.from_numpy(obs), 0, False)
    assert_close(got, want, 0, "mode", 1e-6)
    # Past burn-in: a sample from the act noise; the port draws no burn-in actions.
    give_jax(monkeypatch, eps, uniforms=[u])
    want = jcore.select_action(jstate, key, jnp.asarray(obs), jnp.int32(100), True)
    draws = GivenDraws(eps)
    got = tcore.select_action(tstate, draws, torch.from_numpy(obs), 100, True)
    assert_close(got, want, 0, "sample", 1e-6)
    assert not draws.queue and float(got.abs().max()) < 1.0 and not got.requires_grad
    # During burn-in: the act noise is drawn first, then the uniform actions, which win.
    give_jax(monkeypatch, eps, uniforms=[u])
    want = jcore.select_action(jstate, key, jnp.asarray(obs), jnp.int32(99), True)
    draws = GivenDraws(eps, u)
    got = tcore.select_action(tstate, draws, torch.from_numpy(obs), 99, True)
    assert not draws.queue
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.maximum(np.float32(-1), u * np.float32(2) + np.float32(-1)))


def test_sac_init_draws_weights_from_the_generator_and_checks_shapes():
    _, tcore = _cores()
    obs, act = torch.zeros(4, OBS), torch.zeros(4, ACT)
    a = tcore.init(torch.Generator().manual_seed(0), obs, act)
    b = tcore.init(torch.Generator().manual_seed(0), obs, act)
    c = tcore.init(torch.Generator().manual_seed(1), obs, act)
    first = lambda s: s.policy.mlp.layers[0].weight  # noqa: E731
    assert torch.equal(first(a), first(b)) and not torch.equal(first(a), first(c))
    assert not torch.equal(a.q_func1.mlp.layers[0].weight, a.q_func2.mlp.layers[0].weight)  # twins differ
    assert torch.equal(a.target_q_func2.mlp.layers[0].weight, a.q_func2.mlp.layers[0].weight)
    assert a.n_updates == 0 and a.temperature_opt_state.count == 0
    assert abs(float(a.log_temperature.detach()) - np.log(0.7)) < 1e-7 and a.log_temperature.shape == ()
    assert first(tcore.init(torch.Generator().manual_seed(0), obs, act)) is not tcore.policy.mlp.layers[0].weight
    with pytest.raises(RuntimeError):
        tcore.init(torch.Generator().manual_seed(0), obs, torch.zeros(4, ACT + 1))
