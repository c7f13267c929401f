"""The converted-zoo gate for the five checkpoints of the host-env object
path (``train_state.msgpack``, written by the JAX shells' runs of
``tools/record_curves.py``): ``zoo/double_dqn/lunarlander_real`` (the
``DoubleDQN`` shell of ``tests/test_zoo.py``'s slow gate),
``zoo/reinforce/cartpole`` and ``zoo/reinforce/cartpole_real``
(``train_reinforce_gym.py``'s ``REINFORCE``), ``zoo/sac/hopper_real`` and
``zoo/td3/halfcheetah_real`` (the ``SoftActorCritic`` and ``TD3`` shells of
the MuJoCo reproduction scripts, as ``tests/test_zoo.py``'s slow gates
build them). Each JAX shell loads its checkpoint (``agent.load`` before the
first act, applied when the shell builds its state), and its
``train_state`` goes to the port's shell through
``convert.dqn_shell_from_flax``, ``convert.reinforce_state_from_flax`` or
``convert.actor_critic_shell_from_flax``, optimizer moments included. With
them, all 26 checkpoints of ``zoo/`` convert.

(a) The whole state converts: the first layer's kernel and Adam moments to
    the bit, Adam's count and ``n_updates``.
(b) Greedy actions through the shells' ``batch_act`` in evaluation mode
    are equal on 256 observations of the env each was trained on (seeded
    rollouts of gymnasium's ``LunarLander-v3`` and ``CartPole-v1``, and of
    the port's CartPole), where the two best Q-values or logits lie more
    than 1e-3 apart (away from ties).
    The actor-critic policies' greedy actions agree within 1e-5 on 256
    observations of seeded random-action rollouts of gymnasium's
    ``Hopper-v5`` and ``HalfCheetah-v5`` (MuJoCo).
(c) The REINFORCE policies evaluate through the port's
    ``eval_performance``: 4 greedy episodes each, on the port's CartPole
    and on gymnasium's, held to the slow gate's mean of 400
    (``tests/test_zoo.py``). The real-env evaluations of the JAX package
    stay ``slow``; LunarLander's, Hopper's and HalfCheetah's too.

Only this test reads msgpack; the port never does.
"""

import functools
import os

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_host_agents import JaxPolicy
from test_torch_rainbow_modules import np_tree

from pfrl_tpu import explorers as jexplorers
from pfrl_tpu.agents import DQN as JaxDQN
from pfrl_tpu.agents import REINFORCE as JaxREINFORCE
from pfrl_tpu.agents import DoubleDQNCore as JaxDoubleDQNCore
from pfrl_tpu.q_functions import FCStateQFunctionWithDiscreteAction as JaxFCQ
from pfrl_tpu.replay import ReplayBuffer as JaxReplayBuffer
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import DoubleDQN
from pfrl_tpu_torch.envs import SerialVectorEnv, make_gymnasium_env
from pfrl_tpu_torch.experiments import eval_performance
from pfrl_tpu_torch.experiments.reinforce_gym import make_cartpole_env, make_reinforce_agent
from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.q_functions import FCStateQFunctionWithDiscreteAction
from pfrl_tpu_torch.replay import ReplayBuffer
from pfrl_tpu_torch.wrappers import CastObservationToFloat32

torch.set_num_threads(1)

ZOO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "zoo")
KINDS = ("double_dqn/lunarlander_real", "reinforce/cartpole", "reinforce/cartpole_real")
OBS = {"double_dqn/lunarlander_real": 8, "reinforce/cartpole": 4, "reinforce/cartpole_real": 4}


def _jax_shell(kind):
    if kind.startswith("double_dqn"):
        return JaxDQN(JaxFCQ(n_actions=4, n_hidden_channels=256, n_hidden_layers=2), optax.adam(6e-4),
                      JaxReplayBuffer(1000, gamma=0.99), 0.99, jexplorers.LinearDecayEpsilonGreedy(1.0, 0.05, 100, 4),
                      replay_start_size=10, minibatch_size=64, seed=0, core_cls=JaxDoubleDQNCore)
    return JaxREINFORCE(JaxPolicy(n_actions=2, hidden=128), optax.adam(1e-3), gamma=0.99, beta=1e-4, batchsize=10,
                        max_episode_len=500, baseline=True, seed=0)


@functools.lru_cache(maxsize=None)
def checkpoint(kind):
    """The JAX shell with its checkpoint loaded, and the port's shell
    converted from it (on the CPU)."""
    jagent = _jax_shell(kind)
    jagent.load(os.path.join(ZOO, kind, "best"))
    with jagent.eval_mode():
        jagent.batch_act(np.zeros((1, OBS[kind]), np.float32))  # builds the state: the pending load lands
    state = np_tree(jagent.train_state)
    if kind.startswith("double_dqn"):
        tagent = DoubleDQN(FCStateQFunctionWithDiscreteAction(8, 4, 2, 256), Adam(6e-4),
                           ReplayBuffer(1000, gamma=0.99, device="cpu"), 0.99,
                           LinearDecayEpsilonGreedy(1.0, 0.05, 100, 4), replay_start_size=10, minibatch_size=64,
                           device="cpu")
        convert.dqn_shell_from_flax(tagent, state)
    else:
        tagent = make_reinforce_agent(device="cpu")
        tagent.train_state = convert.reinforce_state_from_flax(tagent.core, state, device="cpu")
    return jagent, tagent


@pytest.mark.parametrize("kind", KINDS)
def test_converted_checkpoint_carries_the_whole_state(kind):
    jagent, tagent = checkpoint(kind)
    js, ts = jagent.train_state, tagent.train_state
    assert ts.n_updates == int(js.n_updates) > 50  # a trained state, not the template
    adam = js.opt_state[0]
    assert ts.opt_state.count == int(adam.count) == int(js.n_updates)
    dense = ("MLP_0", "Dense_0") if kind.startswith("double_dqn") else ("Dense_0",)

    def first_layer(tree):
        node = np_tree(tree)["params"]
        for part in dense:
            node = node[part]
        return node["kernel"]

    weight = next(iter(ts.model.parameters()))
    np.testing.assert_array_equal(weight.detach().numpy(), first_layer(js.params).T)
    np.testing.assert_array_equal(ts.opt_state.nu[0].numpy(), first_layer(adam.nu).T)
    np.testing.assert_array_equal(ts.opt_state.mu[0].numpy(), first_layer(adam.mu).T)
    if kind.startswith("double_dqn"):
        target = next(iter(ts.target_model.parameters()))
        np.testing.assert_array_equal(target.detach().numpy(), first_layer(js.target_params).T)


def _rollout_observations(env, n, seed):
    """``n`` observations of ``env`` under seeded random actions."""
    rs = np.random.RandomState(seed)
    obs, out = env.reset(), []
    while len(out) < n:
        out.append(np.asarray(obs, np.float32))
        obs, _, done, info = env.step(int(rs.randint(env.action_space.n)))
        if done or info.get("needs_reset"):
            obs = env.reset()
    return np.stack(out)


def _observations(kind):
    if kind == "reinforce/cartpole":
        return _rollout_observations(make_cartpole_env(seed=1, device="cpu"), 256, 0)
    pytest.importorskip("gymnasium")
    if kind.startswith("double_dqn"):
        pytest.importorskip("Box2D")
        return _rollout_observations(make_gymnasium_env("LunarLander-v3", seed=1), 256, 0)
    return _rollout_observations(make_gymnasium_env("CartPole-v1", seed=1), 256, 0)


def _jax_margins(jagent, obs, kind):
    if kind.startswith("double_dqn"):
        scores = np.asarray(jagent.core.action_value(jagent.train_state.params, jax.random.PRNGKey(0), obs).q_values)
    else:
        scores = np.asarray(jagent.core.model.apply(jagent.train_state.params, obs).logits)
    top = np.sort(scores, axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("kind", KINDS)
def test_converted_checkpoint_gives_the_jax_greedy_actions(kind):
    jagent, tagent = checkpoint(kind)
    obs = _observations(kind)
    with jagent.eval_mode(), tagent.eval_mode():
        want = np.asarray(jagent.batch_act(obs))
        got = tagent.batch_act(obs)
    away = _jax_margins(jagent, obs, kind) > 1e-3
    assert got.shape == want.shape == (256,) and away.sum() > 200
    np.testing.assert_array_equal(got[away], want[away])
    assert len(np.unique(want)) > 1


@pytest.mark.parametrize("kind", ["reinforce/cartpole", "reinforce/cartpole_real"])
def test_converted_reinforce_policy_balances_the_pole(kind):
    _, tagent = checkpoint(kind)
    if kind == "reinforce/cartpole":
        env = SerialVectorEnv([make_cartpole_env(seed=10_000 + i, device="cpu") for i in range(4)])
    else:
        pytest.importorskip("gymnasium")
        env = SerialVectorEnv([CastObservationToFloat32(make_gymnasium_env("CartPole-v1", seed=10_000 + i))
                               for i in range(4)])
    stats = eval_performance(env=env, agent=tagent, n_steps=None, n_episodes=4)
    print(f"{kind}: the port's greedy mean over 4 episodes {stats['mean']}")
    assert stats["episodes"] == 4 and stats["mean"] >= 400.0, stats


# ------------------------------------------------- the actor-critic gates
AC_KINDS = {"sac/hopper_real": ("Hopper-v5", 11, 3), "td3/halfcheetah_real": ("HalfCheetah-v5", 17, 6)}


@functools.lru_cache(maxsize=None)
def actor_critic_checkpoint(kind):
    """The JAX shell of the slow gate with its checkpoint loaded, and the
    port's shell of ``mujoco_host`` converted from it (on the CPU)."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from pfrl_tpu import spaces as jspaces
    from pfrl_tpu.agents.soft_actor_critic import SoftActorCritic as JaxSAC
    from pfrl_tpu.agents.td3 import TD3 as JaxTD3
    from pfrl_tpu.models import MLP as JaxMLP
    from pfrl_tpu.policies import DeterministicHead, SquashedGaussianHead
    from pfrl_tpu.q_functions import FCSAQFunction as JaxFCSAQFunction

    from pfrl_tpu_torch.experiments import mujoco_host

    _, obs_size, action_size = AC_KINDS[kind]

    class SACPolicy(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return SquashedGaussianHead(action_size=action_size)(
                JaxMLP(out_size=2 * action_size, hidden_sizes=(256, 256))(x))

    class TD3Policy(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return DeterministicHead()(jnp.tanh(JaxMLP(out_size=action_size, hidden_sizes=(400, 300))(x)))

    burnin = functools.partial(lambda n, rng, b: jax.random.uniform(rng, (b, n), minval=-1.0), action_size)
    kw = dict(action_space=jspaces.box(-1.0, 1.0, (action_size,)), replay_start_size=10,
              burnin_action_func=burnin, burnin_steps=0, seed=0)
    if kind.startswith("sac"):
        qf = lambda: JaxFCSAQFunction(n_hidden_channels=256, n_hidden_layers=2)  # noqa: E731
        jagent = JaxSAC(SACPolicy(), qf(), qf(), optax.adam(3e-4), optax.adam(3e-4), optax.adam(3e-4),
                        JaxReplayBuffer(1000, gamma=0.99), 0.99, **kw)
        tagent = mujoco_host.make_sac_agent(obs_size, action_size, replay_start_size=10, capacity=1000, device="cpu")
    else:
        qf = lambda: JaxFCSAQFunction(n_hidden_channels=400, n_hidden_layers=2)  # noqa: E731
        jagent = JaxTD3(TD3Policy(), qf(), qf(), optax.adam(3e-4), optax.adam(3e-4), optax.adam(3e-4),
                        JaxReplayBuffer(1000, gamma=0.99), 0.99,
                        jexplorers.AdditiveGaussian(0.1, low=-1.0, high=1.0), **kw)
        tagent = mujoco_host.make_td3_agent(obs_size, action_size, replay_start_size=10, capacity=1000, device="cpu")
    jagent.load(os.path.join(ZOO, kind, "best"))
    with jagent.eval_mode():
        jagent.batch_act(np.zeros((1, obs_size), np.float32))  # builds the state: the pending load lands
    convert.actor_critic_shell_from_flax(tagent, np_tree(jagent.train_state))
    return jagent, tagent


def _first_dense(tree):
    return np_tree(tree)["params"]["MLP_0"]["Dense_0"]["kernel"]


@pytest.mark.parametrize("kind", sorted(AC_KINDS))
def test_converted_actor_critic_checkpoint_carries_the_whole_state(kind):
    """The first layers of the policy and both critics, their Adam moments
    to the bit; Adam's counts and ``n_updates``; SAC's temperature."""
    jagent, tagent = actor_critic_checkpoint(kind)
    js, ts = jagent.train_state, tagent.train_state
    assert ts.n_updates == int(js.n_updates) > 1000
    for net, opt, jnet, jopt in (("policy", "policy_opt_state", "policy_params", "policy_opt_state"),
                                 ("q_func1", "q1_opt_state", "q1_params", "q1_opt_state"),
                                 ("q_func2", "q2_opt_state", "q2_params", "q2_opt_state")):
        module, adam = getattr(ts, net), getattr(js, jopt)[0]
        weight = next(iter(module.parameters()))
        np.testing.assert_array_equal(weight.detach().numpy(), _first_dense(getattr(js, jnet)).T, err_msg=net)
        np.testing.assert_array_equal(getattr(ts, opt).mu[0].numpy(), _first_dense(adam.mu).T, err_msg=net)
        np.testing.assert_array_equal(getattr(ts, opt).nu[0].numpy(), _first_dense(adam.nu).T, err_msg=net)
        assert getattr(ts, opt).count == int(adam.count) > 1000
    target = next(iter(ts.target_q_func1.parameters()))
    np.testing.assert_array_equal(target.detach().numpy(), _first_dense(js.target_q1_params).T)
    if kind.startswith("sac"):
        assert float(ts.log_temperature) == float(np.asarray(js.log_temperature))
        assert ts.temperature_opt_state.count == int(js.temperature_opt_state[0].count)
    else:
        target = next(iter(ts.target_policy.parameters()))
        np.testing.assert_array_equal(target.detach().numpy(), _first_dense(js.target_policy_params).T)


@pytest.mark.parametrize("kind", sorted(AC_KINDS))
def test_converted_actor_critic_checkpoint_gives_the_jax_greedy_actions(kind):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    env_id, obs_size, action_size = AC_KINDS[kind]
    jagent, tagent = actor_critic_checkpoint(kind)
    env = CastObservationToFloat32(make_gymnasium_env(env_id, seed=1))
    rs = np.random.RandomState(0)
    obs, rows = env.reset(), []
    while len(rows) < 256:
        rows.append(np.asarray(obs, np.float32))
        obs, _, done, info = env.step(rs.uniform(-1.0, 1.0, action_size).astype(np.float32))
        if done or info.get("needs_reset"):
            obs = env.reset()
    batch = np.stack(rows)
    assert batch.shape == (256, obs_size)
    with jagent.eval_mode(), tagent.eval_mode():
        want = np.asarray(jagent.batch_act(batch))
        got = tagent.batch_act(batch)
    assert got.shape == want.shape == (256, action_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.5  # a trained policy, not the template
