"""The ported slice as a whole: prioritized-replay Nature DQN on AtariSim
frames, the port's ``OffPolicyRunner`` against a loop over the JAX
package's own module functions fed the very same draws.

The port's runner takes its draws from :class:`KeyedDraws`, which records
each one with the JAX key it came from. The JAX side replays the record:
the explorer's mask and random actions and the env resets as values, the
PER sampler's uniforms by handing ``buffer.sample`` the same key. Both
start from the same converted parameters.

Tolerances: the env, the ring and the step counter are exact; parameters,
losses and priorities go through the network's convolutions, which reduce
in another order in the two libraries, so they match within ``rtol 1e-5``
(losses ``1e-4``, accumulated over the run), with an absolute floor of
``1e-5`` for priorities and ``1e-6`` for parameters.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict

from pfrl_tpu.agents import DQNCore as JaxDQNCore
from pfrl_tpu.envs import AtariSim as JaxAtariSim
from pfrl_tpu.envs.atari_sim import AtariSimState as JaxAtariSimState
from pfrl_tpu.explorers import LinearDecayEpsilonGreedy as JaxLinearDecay
from pfrl_tpu.models import LargeAtariCNN as JaxLargeAtariCNN
from pfrl_tpu.q_functions import DiscreteActionValueHead as JaxHead
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu.utils.pytree import tree_where
from pfrl_tpu_torch import _device, convert
from pfrl_tpu_torch.agents.dqn import DQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim, AtariSimState
from pfrl_tpu_torch.envs.vector_env import VectorTorchEnv
from pfrl_tpu_torch.experiments.atari_per_dqn import NatureQ, make_per_dqn_runner
from pfrl_tpu_torch.experiments.runner import OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers import LinearDecayEpsilonGreedy
from pfrl_tpu_torch.optimizers import RMSprop
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer
from pfrl_tpu_torch.utils import atari_phi

torch.set_num_threads(1)

N_ACTIONS, LANES, BATCH = 6, 4, 8
CAPACITY = 8196  # a tree of 16,384 leaves: two chunks of the Pallas kernel
MEAN_EP_LEN = 5  # short episodes, so lanes reset inside the run
STEPS = 20       # 80 transitions: updates from 32, one target sync at 48


class JaxNatureQ(nn.Module):
    """bench.py's NatureQ."""

    @nn.compact
    def __call__(self, x):
        return JaxHead()(nn.Dense(N_ACTIONS)(JaxLargeAtariCNN()(x)))


class KeyedDraws:
    """A draw source whose every draw comes from its own JAX key, logged
    as ``(key, values)``; ``kinds`` names the method behind each entry."""

    def __init__(self, seed):
        self.base = jax.random.PRNGKey(seed)
        self.log = []
        self.kinds = []

    def _record(self, kind, draw):
        key = jax.random.fold_in(self.base, len(self.log))
        values = np.array(draw(key))
        self.log.append((key, values))
        self.kinds.append(kind)
        return torch.from_numpy(values)

    def uniform(self, n):
        return self._record("uniform", lambda key: jax.random.uniform(key, (n,)))

    def normal(self, n):
        return self._record("normal", lambda key: jax.random.normal(key, (n,)))

    def randint(self, high, n):
        return self._record(
            "randint", lambda key: jax.random.randint(key, (n,), 0, high, dtype=jnp.int32)
        )

    def randint_below(self, high, n):
        """The bound is a 0-d tensor; JAX's own integers for that bound."""
        bound = int(high)
        return self._record(
            "randint_below", lambda key: jax.random.randint(key, (n,), 0, bound, dtype=jnp.int32)
        )


def _jax_reset_states(seeds, u):
    """AtariSim.reset's arithmetic on given draws, as constructed states."""
    ep_len = (1.0 + -jnp.log1p(-jnp.asarray(u)) * MEAN_EP_LEN).astype(jnp.int32)
    return JaxAtariSimState(t=jnp.zeros(seeds.shape, jnp.int32), seed=jnp.asarray(seeds), ep_len=ep_len)


def test_env_reset_and_step_match_jax():
    jenv = JaxAtariSim(N_ACTIONS, MEAN_EP_LEN)
    tenv = VectorTorchEnv(AtariSim(N_ACTIONS, MEAN_EP_LEN, device="cpu"), 3)
    draws = KeyedDraws(7)
    tstates, tobs = tenv.reset(draws)
    (_, seeds), (_, u) = draws.log
    jstates = _jax_reset_states(seeds, u)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jax.vmap(jenv._obs)(jstates)))
    rs = np.random.RandomState(0)
    for i in range(12):
        actions = rs.randint(0, N_ACTIONS, 3).astype(np.int32)
        tstates, vec = tenv.step(draws, tstates, torch.from_numpy(actions))
        new, ts = jax.vmap(jenv.step, in_axes=(None, 0, 0))(None, jstates, jnp.asarray(actions))
        (_, seeds), (_, u) = draws.log[-2:]
        reset = _jax_reset_states(seeds, u)
        jstates = tree_where(ts.done, reset, new)
        for name in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(vec.ts, name).numpy(), np.asarray(getattr(ts, name)))
        np.testing.assert_array_equal(
            vec.obs.numpy(), np.asarray(tree_where(ts.done, jax.vmap(jenv._obs)(reset), ts.obs))
        )
        for name in ("t", "seed", "ep_len"):
            np.testing.assert_array_equal(getattr(tstates, name).numpy(), np.asarray(getattr(jstates, name)))
    assert isinstance(tstates, AtariSimState)
    for space in ("observation_space", "action_space"):
        j, t = getattr(jenv, space), getattr(tenv, space)
        assert (t.shape, t.dtype) == (j.shape, j.dtype)
    np.testing.assert_array_equal(tenv.observation_space.high, jenv.observation_space.high)
    assert tenv.action_space.n == jenv.action_space.n == N_ACTIONS
    assert tenv.observation_space.contains(tobs[0].numpy())


def _port_runner():
    core = DQNCore(
        model=NatureQ(N_ACTIONS),
        optimizer=RMSprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=LinearDecayEpsilonGreedy(1.0, 0.1, 100, N_ACTIONS),
        gamma=0.99,
        batch_accumulator="sum",
        phi=atari_phi,
    )
    buffer = PrioritizedReplayBuffer(
        CAPACITY, alpha=0.6, beta0=0.4, gamma=0.99, num_lanes=LANES,
        store_next_obs=False, fused_dequant_scale=1.0 / 255.0, device="cpu",
    )
    config = RunnerConfig(
        num_envs=LANES, replay_start_size=32, update_interval=4,
        target_update_interval=48, minibatch_size=BATCH,
    )
    env = AtariSim(N_ACTIONS, MEAN_EP_LEN, device="cpu")
    return OffPolicyRunner(env, core, buffer, config, device="cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _run_jax(log, params, updates_per_step):
    """The slice's scan step over the JAX package's module functions."""
    jenv = JaxAtariSim(N_ACTIONS, MEAN_EP_LEN)
    explorer = JaxLinearDecay(1.0, 0.1, 100, N_ACTIONS)
    core = JaxDQNCore(
        model=JaxNatureQ(), optimizer=optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2),
        explorer=explorer, gamma=0.99, batch_accumulator="sum", phi=jax_atari_phi,
    )
    buf = JaxPER(
        CAPACITY, alpha=0.6, beta0=0.4, gamma=0.99, num_lanes=LANES,
        store_next_obs=False, use_pallas=True, fused_dequant_scale=1.0 / 255.0,
    )
    assert buf.tree_capacity == 2 * 8192
    add = jax.jit(buf.add, donate_argnums=0)
    sample = jax.jit(buf.sample, static_argnums=2)
    update = jax.jit(core.update)
    feedback = jax.jit(buf.update_priorities)
    greedy_of = jax.jit(lambda p, o: core.action_value(p, jax.random.PRNGKey(0), o).greedy_actions())
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    vobs = jax.jit(jax.vmap(jenv._obs))

    log = list(log)
    pop = lambda: log.pop(0)  # noqa: E731
    (_, seeds), (_, u) = pop(), pop()
    env_states = _jax_reset_states(seeds, u)
    obs = vobs(env_states)
    train = core.init(jax.random.PRNGKey(0), obs).replace(params=params, target_params=params)
    example = JaxTransition(
        obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
        terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict(),
    )
    replay = buf.init(example)
    t, losses, syncs = 0, [], 0
    ep_ret, finished = np.zeros(LANES, np.float32), []
    for _ in range(STEPS):
        greedy = greedy_of(train.params, obs)
        (_, u), (_, random_actions) = pop(), pop()
        actions = jnp.where(jnp.asarray(u) < explorer.epsilon_at(jnp.int32(t)), random_actions, greedy)
        new, ts = vstep(None, env_states, actions)
        (_, seeds), (_, u) = pop(), pop()
        reset = _jax_reset_states(seeds, u)
        env_states = tree_where(ts.done, reset, new)
        next_obs = tree_where(ts.done, vobs(reset), ts.obs)
        replay = add(replay, JaxTransition(
            obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
            terminated=ts.terminated, done=ts.done, extras=FrozenDict(),
        ))
        t_prev, t = t, t + LANES
        ep_ret += np.asarray(ts.reward)
        done = np.asarray(ts.done)
        finished += list(ep_ret[done])
        ep_ret[done] = 0.0
        loss = 0.0
        if t >= 32:
            for _ in range(updates_per_step):
                key, _ = pop()
                batch, replay = sample(replay, key, BATCH)
                train, aux = update(train, key, batch)
                replay = feedback(replay, batch.indices, aux["errors"])
                loss = float(aux["loss"])
        losses.append(loss)
        if t // 48 != t_prev // 48:
            train, syncs = core.sync_target(train), syncs + 1
        obs = next_obs
    assert not log  # every draw the port made was replayed
    return t, replay, train, np.asarray(losses, np.float32), syncs, finished


def test_slice_matches_jax_module_loop():
    runner = _port_runner()
    draws = KeyedDraws(0)
    state = runner.init(0, draws=draws)
    flax_params = _np_tree(JaxNatureQ().init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4))))
    fresh = _np_tree(optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2).init(flax_params))
    state.train_state = convert.dqn_state_from_flax(runner.core, flax_params, flax_params, fresh, device="cpu")

    state, metrics = runner.run_chunk(state, STEPS)
    assert runner.config.updates_per_step == 1
    t, replay, train, losses, syncs, finished = _run_jax(draws.log, flax_params, runner.config.updates_per_step)

    assert state.t == t == STEPS * LANES
    assert int(state.replay_state.cursor) == int(replay.base.cursor) == STEPS * LANES
    assert state.train_state.n_updates == int(train.n_updates) == 13
    assert syncs == 1
    tr, jr = state.replay_state, replay
    np.testing.assert_array_equal(tr.base.storage["obs"].numpy(), np.asarray(jr.base.storage.obs))
    np.testing.assert_array_equal(tr.base.storage["action"].numpy(), np.asarray(jr.base.storage.action))
    np.testing.assert_array_equal(tr.base.storage["done"].numpy(), np.asarray(jr.base.storage.done))
    # Priorities come from |y - t|, whose absolute noise is that of Q-values.
    np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.min_tree.numpy(), np.asarray(jr.min_tree), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tr.max_priority), float(jr.max_priority), rtol=1e-5)
    np.testing.assert_allclose(float(tr.beta), float(jr.beta), rtol=1e-6)
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=1e-4, atol=1e-6)
    assert int(metrics["done_count"].sum()) == int(state.recent_count) == len(finished) > 0
    np.testing.assert_allclose(runner.recent_return_mean(state), np.mean(finished), rtol=1e-6)
    for module, tree in ((state.train_state.model, train.params), (state.train_state.target_model, train.target_params)):
        for name, want in convert.torch_arrays(module, _np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_entry_point_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_per_dqn_runner()
    with pytest.raises(RuntimeError):
        _device.resolve_device("cuda")
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_runner_rejects_mismatched_lanes():
    env = AtariSim(N_ACTIONS, device="cpu")
    buffer = PrioritizedReplayBuffer(64, num_lanes=2, device="cpu")
    with pytest.raises(ValueError):
        OffPolicyRunner(env, None, buffer, RunnerConfig(num_envs=4), device="cpu")
