"""The converted-zoo gate for the three checkpoints of the host-env object
path (``train_state.msgpack``, written by the JAX shells' runs of
``tools/record_curves.py``): ``zoo/double_dqn/lunarlander_real`` (the
``DoubleDQN`` shell of ``tests/test_zoo.py``'s slow gate),
``zoo/reinforce/cartpole`` and ``zoo/reinforce/cartpole_real``
(``train_reinforce_gym.py``'s ``REINFORCE``). Each JAX shell loads its
checkpoint (``agent.load`` before the first act, applied when the shell
builds its state), and its ``train_state`` goes to the port's shell through
``convert.dqn_shell_from_flax`` or ``convert.reinforce_state_from_flax``,
optimizer moments included. With them, 24 of the 26 checkpoints of ``zoo/``
convert.

(a) The whole state converts: the first layer's kernel and Adam moments to
    the bit, Adam's count and ``n_updates``.
(b) Greedy actions through the shells' ``batch_act`` in evaluation mode
    are equal on 256 observations of the env each was trained on (seeded
    rollouts of gymnasium's ``LunarLander-v3`` and ``CartPole-v1``, and of
    the port's CartPole), where the two best Q-values or logits lie more
    than 1e-3 apart (away from ties).
(c) The REINFORCE policies evaluate through the port's
    ``eval_performance``: 4 greedy episodes each, on the port's CartPole
    and on gymnasium's, held to the slow gate's mean of 400
    (``tests/test_zoo.py``). The real-env evaluations of the JAX package
    stay ``slow``; LunarLander's too.

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
