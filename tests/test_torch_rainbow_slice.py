"""The Rainbow path as a whole at a small size: noisy distributional
dueling network, categorical Double DQN, Adam, 3-step prioritized replay
read by adjacency, the ``Greedy`` explorer, through the port's
``OffPolicyRunner`` and ``EvalLoop``, against a loop over the JAX package's
own module functions fed the very same draws.

The port draws from ``KeyedDraws`` (``test_torch_slice.py``), which logs
every draw with its JAX key. The JAX side replays the log: env resets as
values, the PER sampler's uniforms by handing ``buffer.sample`` the same
key (it finds slots with the Pallas kernel in interpret mode), and the
noise by running ``select_action`` and ``update`` un-jitted with
``jax.random.normal`` replaced by a function that hands out the logged
draws in order, so every forward of every layer sees the port's noise
(nonzero sigmas throughout).

Tolerances: the env, the ring, the step counter and the evaluation returns
are exact; parameters, losses, priorities and trees go through the
network's convolutions, which reduce in another order in the two
libraries: ``rtol 1e-5`` with an absolute floor of ``1e-6`` for parameters
and ``1e-5`` for priorities, ``rtol 1e-4`` for losses, accumulated over
the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import FrozenDict
from test_torch_categorical_dqn import _cores
from test_torch_slice import KeyedDraws, _jax_reset_states, _np_tree

from pfrl_tpu.envs import AtariSim as JaxAtariSim
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.utils.pytree import tree_where
from pfrl_tpu_torch import convert
from pfrl_tpu_torch.agents import CategoricalDoubleDQNCore
from pfrl_tpu_torch.envs.atari_sim import AtariSim
from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_core, make_rainbow_runner
from pfrl_tpu_torch.experiments.runner import EvalLoop, OffPolicyRunner, RunnerConfig
from pfrl_tpu_torch.explorers import Greedy
from pfrl_tpu_torch.optimizers import Adam
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer

torch.set_num_threads(1)

N_ACTIONS, LANES, BATCH = 6, 4, 8
CAPACITY = 8196  # a tree of 16,384 leaves: two chunks of the Pallas kernel
MEAN_EP_LEN = 5  # short episodes: lanes reset, 3-step windows are cut short
STEPS = 20       # 80 transitions: updates from 32, one target sync at 48
PER = dict(alpha=0.5, beta0=0.4, betasteps=100, num_steps=3, gamma=0.99,
           num_lanes=LANES, store_next_obs=False)


def _port_runner():
    buffer = PrioritizedReplayBuffer(CAPACITY, device="cpu", **PER)
    config = RunnerConfig(
        num_envs=LANES, replay_start_size=32, update_interval=4,
        target_update_interval=48, minibatch_size=BATCH,
    )
    env = AtariSim(N_ACTIONS, MEAN_EP_LEN, device="cpu")
    return OffPolicyRunner(env, make_rainbow_core(N_ACTIONS), buffer, config, device="cpu")


def _initial_states(port_core):
    """The JAX core with its freshly initialized state, and the same state
    converted for the port (Adam's moments zero, count 0)."""
    jcore, _ = _cores("categorical_double")
    train = jcore.init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4), jnp.uint8))
    params = _np_tree(train.params)
    return jcore, train, convert.dqn_state_from_flax(port_core, params, params, _np_tree(train.opt_state), device="cpu")


class _Replay:
    """The port's log, popped in order; ``normal`` stands in for
    ``jax.random.normal`` and hands out the logged noise."""

    def __init__(self, draws):
        self.entries = list(zip(draws.kinds, draws.log))

    def pop(self, kind):
        got, (key, values) = self.entries.pop(0)
        assert got == kind, (got, kind)
        return key, values

    def normal(self, key, shape=(), dtype=jnp.float32):
        _, values = self.pop("normal")
        assert values.shape == tuple(shape), (values.shape, shape)
        return jnp.asarray(values, dtype)

    def env_reset(self):
        (_, seeds), (_, u) = self.pop("randint"), self.pop("uniform")
        return _jax_reset_states(seeds, u)


def _run_jax(monkeypatch, replay_log, jcore, train):
    """Rainbow's scan step over the JAX package's module functions."""
    jenv = JaxAtariSim(N_ACTIONS, MEAN_EP_LEN)
    buf = JaxPER(CAPACITY, use_pallas=True, **PER)
    assert buf.tree_capacity == 2 * 8192
    add = jax.jit(buf.add, donate_argnums=0)
    sample = jax.jit(buf.sample, static_argnums=2)
    feedback = jax.jit(buf.update_priorities)
    vstep = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0)))
    vobs = jax.jit(jax.vmap(jenv._obs))

    env_states = replay_log.env_reset()
    obs = vobs(env_states)
    example = JaxTransition(
        obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()), next_obs=obs[0],
        terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict(),
    )
    replay = buf.init(example)
    monkeypatch.setattr(jax.random, "normal", replay_log.normal)
    key0 = jax.random.PRNGKey(0)  # unused: every normal draw comes from the log
    t, losses, syncs, actions_seen = 0, [], 0, []
    for _ in range(STEPS):
        actions = jcore.select_action(train, key0, obs, jnp.int32(t), True)  # 4 noise draws
        actions_seen.append(np.asarray(actions))
        new, ts = vstep(None, env_states, actions)
        reset = replay_log.env_reset()
        env_states = tree_where(ts.done, reset, new)
        next_obs = tree_where(ts.done, vobs(reset), ts.obs)
        replay = add(replay, JaxTransition(
            obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
            terminated=ts.terminated, done=ts.done, extras=FrozenDict(),
        ))
        t_prev, t = t, t + LANES
        loss = 0.0
        if t >= 32:
            key, _ = replay_log.pop("uniform")
            batch, replay = sample(replay, key, BATCH)
            train, aux = jcore.update(train, key0, batch)  # 12 noise draws
            replay = feedback(replay, batch.indices, aux["errors"])
            loss = float(aux["loss"])
        losses.append(loss)
        if t // 48 != t_prev // 48:
            train, syncs = jcore.sync_target(train), syncs + 1
        obs = next_obs
    assert not replay_log.entries  # every draw the port made was replayed
    return t, replay, train, np.asarray(losses, np.float32), syncs, np.stack(actions_seen)


def test_rainbow_slice_matches_jax_module_loop(monkeypatch):
    runner = _port_runner()
    draws = KeyedDraws(0)
    state = runner.init(0, draws=draws)
    jcore, jtrain, state.train_state = _initial_states(runner.core)
    assert float(state.train_state.model.advantage.w_sigma.detach().min()) > 0  # noise is on
    state, metrics = runner.run_chunk(state, STEPS)
    assert draws.kinds.count("normal") == 4 * STEPS + 12 * 13

    t, replay, train, losses, syncs, _ = _run_jax(monkeypatch, _Replay(draws), jcore, jtrain)

    assert state.t == t == STEPS * LANES
    assert int(state.replay_state.cursor) == int(replay.base.cursor) == STEPS * LANES
    assert state.train_state.n_updates == int(train.n_updates) == 13
    assert state.train_state.opt_state.count == int(train.opt_state[0].count) == 13
    assert syncs == 1
    tr, jr = state.replay_state, replay
    for name in ("obs", "action", "reward", "terminated", "done"):
        np.testing.assert_array_equal(
            tr.base.storage[name].numpy(), np.asarray(getattr(jr.base.storage, name)), err_msg=name
        )
    # Priorities come from the per-sample cross-entropy, clipped to [0, 1].
    np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.min_tree.numpy(), np.asarray(jr.min_tree), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tr.max_priority), float(jr.max_priority), rtol=1e-5)
    np.testing.assert_allclose(float(tr.beta), float(jr.beta), rtol=1e-6)
    assert float(tr.beta) > 0.4
    assert (metrics["loss"][7:] > 0).all()
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=1e-4, atol=1e-6)
    for module, tree in ((state.train_state.model, train.params), (state.train_state.target_model, train.target_params)):
        for name, want in convert.torch_arrays(module, _np_tree(tree)).items():
            got = dict(module.named_parameters())[name].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
    names = [n for n, _ in state.train_state.model.named_parameters()]
    adam = train.opt_state[0]
    for moments, tree in ((state.train_state.opt_state.mu, adam.mu), (state.train_state.opt_state.nu, adam.nu)):
        want = convert.torch_arrays(state.train_state.model, _np_tree(tree))
        for name, m in zip(names, moments):
            atol = 1e-4 * float(np.abs(want[name]).max())
            np.testing.assert_allclose(m.numpy(), want[name], rtol=1e-4, atol=atol, err_msg=name)


def test_eval_loop_matches_jax_eval_arithmetic_on_replayed_draws(monkeypatch):
    """``JaxEvalLoop``'s scan body, step by step, on the port's draws: the
    first finished episode of each lane scores, an unfinished lane gives
    its partial return, and the act noise is drawn on every step."""
    lanes, max_steps = 16, 6
    tcore = make_rainbow_core(N_ACTIONS)
    jcore, jtrain, ttrain = _initial_states(tcore)
    loop = EvalLoop(AtariSim(N_ACTIONS, MEAN_EP_LEN, device="cpu"), tcore, lanes, max_steps, device="cpu")
    draws = KeyedDraws(0)
    got = loop.evaluate(ttrain, draws)
    assert got.dtype == np.float32 and got.shape == (lanes,)
    assert draws.kinds.count("normal") == 4 * max_steps

    log = _Replay(draws)
    jenv = JaxAtariSim(N_ACTIONS, MEAN_EP_LEN)
    vstep = jax.vmap(jenv.step, in_axes=(None, 0, 0))
    vobs = jax.vmap(jenv._obs)
    env_states = log.env_reset()
    obs = vobs(env_states)
    monkeypatch.setattr(jax.random, "normal", log.normal)
    ep_ret, final_ret = jnp.zeros((lanes,), jnp.float32), jnp.zeros((lanes,), jnp.float32)
    finished = jnp.zeros((lanes,), bool)
    for _ in range(max_steps):
        actions = jcore.select_action(jtrain, jax.random.PRNGKey(0), obs, jnp.zeros((), jnp.int32), False)
        new, ts = vstep(None, env_states, actions)
        reset = log.env_reset()
        env_states = tree_where(ts.done, reset, new)
        obs = tree_where(ts.done, vobs(reset), ts.obs)
        ep_ret = ep_ret + ts.reward * (~finished)
        newly = ts.done & (~finished)
        final_ret = jnp.where(newly, ep_ret, final_ret)
        finished = finished | ts.done
    assert not log.entries
    want = np.asarray(jnp.where(finished, final_ret, ep_ret))
    assert 0 < int(finished.sum()) < lanes  # finished and unfinished lanes
    assert want.sum() > 0  # AtariSim's reward is sparse: a few lanes score
    np.testing.assert_array_equal(got, want)


def test_rainbow_runner_holds_the_recipe_and_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_rainbow_runner()
    runner = make_rainbow_runner(capacity=1_024, device="cpu")
    core, buf, cfg = runner.core, runner.buffer, runner.config
    assert type(core) is CategoricalDoubleDQNCore and core.batch_accumulator == "mean"
    assert isinstance(core.explorer, Greedy) and core.gamma == 0.99
    assert isinstance(core.optimizer, Adam)
    assert (core.optimizer.learning_rate, core.optimizer.b1, core.optimizer.b2, core.optimizer.eps) == (
        6.25e-5, 0.9, 0.999, 1.5e-4)
    model = core.model
    assert (model.n_actions, model.n_atoms) == (6, 51)
    assert (float(model.z_values[0]), float(model.z_values[-1])) == (-10.0, 10.0)
    assert model.advantage.w_mu.shape == (6 * 51, 512) and model.value.w_mu.shape == (51, 512)
    assert model.advantage.sigma_scale == model.value.sigma_scale == 0.5
    assert (buf.alpha, buf.beta0, buf.num_steps, buf.gamma) == (0.5, 0.4, 3, 0.99)
    assert buf.beta_add == (1.0 - 0.4) / (5e7 / 4)
    assert not buf.store_next_obs and buf.fused_dequant_scale is None and not buf.iid_samples
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.target_update_interval,
            cfg.minibatch_size, cfg.updates_per_step) == (64, 20_000, 4, 32_000, 32, 16)
    x = torch.arange(6, dtype=torch.uint8)
    assert torch.equal(core.phi(x), x.to(torch.float32) / 255.0)
