"""The converted-zoo gate for the on-policy checkpoints in ``zoo/``
(``train_state.msgpack`` files): PPO and TRPO on the time-limited Pendulum
and A2C on the time-limited CartPole (written by
``tools/record_curves.py``), and the real-MuJoCo PPO Hopper-v5
reproduction. Each is restored by the JAX package, handed to the port's
converters as a numpy tree, and held against the JAX cores.

(a) Greedy actions on 256 seeded observations: within 1e-5 (Pendulum,
    Hopper: obs 11, action 3); CartPole's argmax exactly, on observations
    whose two logits lie more than 1e-3 apart (away from ties).
(b) ``EvalLoop`` over 10 lanes from the start states of ``JaxEvalLoop`` on
    a real key, against that JAX run on the same checkpoint: Pendulum
    10 x 201 steps, the mean within 0.01 (of returns between -400 and 0)
    and each lane within 1e-4 relative + 0.01; CartPole 10 x 501 steps,
    every lane's return equal (integers; a trained controller keeps the
    pole up, so float32 differences do not grow into another action).
    Both means are printed. Hopper's Gymnasium env is not ported: greedy
    actions only.

Only this test reads msgpack; the port never does.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_actor_critic_modules import np_tree
from test_torch_ppo import JaxGaussianPi, JaxGaussianPiV, JaxSoftmaxPiV

from pfrl_tpu import envs as jenvs
from pfrl_tpu.agents.a2c import A2CCore as JaxA2CCore
from pfrl_tpu.agents.ppo import PPOCore as JaxPPOCore
from pfrl_tpu.agents.trpo import TRPOCore as JaxTRPOCore
from pfrl_tpu.experiments import JaxEvalLoop
from pfrl_tpu.models import MLP as JaxMLP
from pfrl_tpu.replay.persistent import load_state
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents.ppo import PPOCore
from pfrl_tpu_torch.experiments import onpolicy as onp
from pfrl_tpu_torch.experiments.runner import EvalLoop
from pfrl_tpu_torch.optimizers import Adam

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
LANES = 10


def _jax_core(kind):
    """The architecture and optimizer the checkpoint was trained with."""
    if kind == "ppo":
        return JaxPPOCore(JaxGaussianPiV(act_dim=1, hidden=64, mean_scale=1e-4), optax.adam(3e-4), epochs=10,
                          minibatch_size=64, entropy_coef=0.0, standardize_advantages=True)
    if kind == "trpo":
        return JaxTRPOCore(policy=JaxGaussianPi(act_dim=1, hidden=64), vf=JaxMLP(out_size=1, hidden_sizes=(64, 64)),
                           vf_optimizer=optax.adam(1e-3), gamma=0.99, lambd=0.95, max_kl=0.01, vf_epochs=5)
    if kind == "hopper":
        return JaxPPOCore(JaxGaussianPiV(act_dim=3, hidden=64, mean_scale=1e-4), optax.adam(3e-4), gamma=0.995,
                          lambd=0.97, epochs=10, minibatch_size=64, entropy_coef=0.0)
    return JaxA2CCore(JaxSoftmaxPiV(hidden=64), optax.rmsprop(7e-4, decay=0.99, eps=1e-5), gamma=0.99,
                      entropy_coeff=0.01, v_loss_coef=0.5, max_grad_norm=40.0)


ENTRIES = {"ppo": ("ppo", "pendulum", 3), "trpo": ("trpo", "pendulum", 3), "a2c": ("a2c", "cartpole", 4),
           "hopper": ("ppo", "hopper_real", 11)}


def _port(kind, jstate):
    if kind == "hopper":
        core = PPOCore(onp.GaussianPiV(11, 3, 64, mean_scale=1e-4), Adam(3e-4), gamma=0.995, lambd=0.97, epochs=10,
                       minibatch_size=64, entropy_coef=0.0)
        return None, convert.ppo_state_from_flax(core, np_tree(jstate), device="cpu"), core
    runner = {"ppo": onp.make_ppo_pendulum_runner, "trpo": onp.make_trpo_pendulum_runner,
              "a2c": onp.make_a2c_cartpole_runner}[kind](device="cpu")
    from_flax = convert.trpo_state_from_flax if kind == "trpo" else convert.ppo_state_from_flax
    return runner, from_flax(runner.core, np_tree(jstate), device="cpu"), runner.core


@functools.lru_cache(maxsize=None)
def checkpoint(kind):
    alg, env, obs_dim = ENTRIES[kind]
    jcore = _jax_core(kind)
    template = jcore.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    jstate = load_state(template, os.path.join(ZOO, alg, env, "best", "train_state.msgpack"))
    runner, tstate, core = _port(kind, jstate)
    return kind, jcore, jstate, runner, tstate, core


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_converted_checkpoint_carries_the_whole_state(kind):
    _, _, jstate, _, tstate, _ = checkpoint(kind)
    assert tstate.n_updates == int(jstate.n_updates) > 50  # a trained state (TRPO: one per iteration), not the template
    if kind == "trpo":
        assert tstate.vf_opt_state.count == int(jstate.vf_opt_state[0].count) > 0
        kernel = jstate.policy_params["params"]["Dense_0"]["kernel"]
        np.testing.assert_array_equal(tstate.policy.pi[0].weight.detach().numpy(), np.asarray(kernel).T)
        nu = np.asarray(jstate.vf_opt_state[0].nu["params"]["Dense_0"]["kernel"]).T
        np.testing.assert_array_equal(tstate.vf_opt_state.nu[0].numpy(), nu)
        return
    model = tstate.model
    first = model.trunk[0] if kind == "a2c" else model.pi[0]
    np.testing.assert_array_equal(
        first.weight.detach().numpy(), np.asarray(jstate.params["params"]["Dense_0"]["kernel"]).T
    )
    if kind == "a2c":
        nu = np.asarray(jstate.opt_state[1][0].nu["params"]["Dense_0"]["kernel"]).T
        np.testing.assert_array_equal(tstate.opt_state[0].numpy(), nu)
    else:
        assert tstate.opt_state.count == int(jstate.opt_state[0].count) > 0
        nu = np.asarray(jstate.opt_state[0].nu["params"]["Dense_0"]["kernel"]).T
        np.testing.assert_array_equal(tstate.opt_state.nu[0].numpy(), nu)
        log_std = np.asarray(jstate.params["params"]["GaussianHeadWithStateIndependentCovariance_0"]["log_std"])
        np.testing.assert_array_equal(model.head.log_std.detach().numpy(), log_std)
    assert nu.max() > 0


def _observations(kind):
    rs = np.random.RandomState(0)
    if kind in ("ppo", "trpo"):
        th = rs.uniform(-np.pi, np.pi, 256)
        return np.stack([np.cos(th), np.sin(th), rs.uniform(-8, 8, 256)], axis=1).astype(np.float32)
    if kind == "a2c":
        return (rs.uniform(-1, 1, (256, 4)) * np.array([2.0, 2.0, 0.2, 2.0])).astype(np.float32)
    return rs.normal(size=(256, 11)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_converted_checkpoint_gives_the_jax_greedy_actions(kind):
    _, jcore, jstate, _, tstate, core = checkpoint(kind)
    obs = _observations(kind)
    want = np.asarray(jcore.select_action(jstate, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.int32(0), False))
    got = core.select_action(tstate, None, torch.from_numpy(obs), 0, False).numpy()
    assert got.shape == want.shape
    if kind == "a2c":
        dist, _ = jcore.forward(jstate.params, jnp.asarray(obs))
        margin = np.abs(np.diff(np.asarray(dist.logits), axis=1))[:, 0]
        away = margin > 1e-3
        assert away.sum() > 200
        np.testing.assert_array_equal(got[away], want[away])
        assert 0 < want.mean() < 1  # both actions taken
        return
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want).max() > 0.1 and want.std() > 0.05  # a policy that acts


@pytest.mark.parametrize("kind", ["a2c", "ppo", "trpo"])
def test_converted_checkpoint_evaluates_like_the_jax_eval_loop(kind):
    """Hopper's Gymnasium env is not ported: its greedy actions are held above."""
    _, jcore, jstate, runner, tstate, core = checkpoint(kind)
    cartpole = kind == "a2c"
    jenv = jenvs.TimeLimit(jenvs.CartPole(), 500) if cartpole else jenvs.TimeLimit(jenvs.Pendulum(), 200)
    max_steps = 501 if cartpole else 201
    key = jax.random.PRNGKey(11)
    want = JaxEvalLoop(jenv, jcore, LANES, max_steps).evaluate(jstate, key)

    lane_keys = jax.random.split(jax.random.split(key)[1], LANES)
    if cartpole:
        first = [np.concatenate([np.asarray(jax.random.uniform(k, (4,))) for k in lane_keys])]
    else:
        halves = [jax.random.split(k) for k in lane_keys]
        first = [np.array([float(jax.random.uniform(h[i], ())) for h in halves], np.float32) for i in (0, 1)]
    rs = np.random.RandomState(0)

    class StartStates:
        def uniform(self, n):
            return torch.from_numpy(first.pop(0).copy() if first else rs.uniform(size=n).astype(np.float32))

    got = EvalLoop(runner.env.env, core, LANES, max_steps, device="cpu").evaluate(tstate, StartStates())
    print(f"zoo {kind}: JaxEvalLoop mean return {want.mean():.3f}, port EvalLoop {got.mean():.3f}; "
          f"largest lane difference {np.abs(got - want).max():.4f}")
    assert got.shape == want.shape == (LANES,) and np.isfinite(got).all()
    if cartpole:
        np.testing.assert_array_equal(got, want)
        assert want.mean() >= 300.0
        return
    assert (got <= 0).all() and want.mean() > -400.0  # the checkpoint swings the pendulum up
    assert abs(float(got.mean()) - float(want.mean())) <= 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.01)


def test_the_hopper_policy_module_is_the_reproductions():
    """obs 11, action 3, the same flax scopes as the JAX ``PiV``."""
    model = onp.GaussianPiV(11, 3, 64, mean_scale=1e-4)
    params = JaxGaussianPiV(act_dim=3, hidden=64, mean_scale=1e-4).init(jax.random.PRNGKey(0), jnp.zeros((1, 11)))
    arrays = convert.torch_arrays(model, np_tree(params))
    assert set(arrays) == {name for name, _ in model.named_parameters()}
    assert arrays["pi.2.weight"].shape == (3, 64) and arrays["v.0.weight"].shape == (64, 11)
