"""The bf16 recipes as a whole, at a small width, against the JAX package
at ``compute_dtype=jnp.bfloat16`` on the same draws:

- DQN-CartPole-bf16 (``make_dqn_cartpole_bf16_runner``, the recipe of
  ``zoo/dqn_bf16/cartpole``) through the port's ``OffPolicyRunner``
  against the JAX package's own ``OffPolicyRunner.run_chunk`` under
  ``jax.disable_jit`` on the port's logged draws (``Tape``/``install_tape``
  and ``TapeEnv``, as ``test_torch_cartpole_value_slice.py``);
- PER-DQN on AtariSim at bf16 (``make_dqn_runner(prioritized=True,
  compute_dtype=torch.bfloat16)``) against a loop over the JAX package's
  module functions, the PER sample jitted through the Pallas kernel as in
  ``test_torch_slice.py`` and the network's forwards and updates run
  eagerly (``jax.disable_jit``), so that each op rounds to bf16 as the
  port's do;
- SAC-Pendulum-bf16 (``make_sac_pendulum_bf16_runner``) against the same
  kind of loop over the JAX package's ``VectorJaxEnv``, ring and
  ``SACCore``, burn-in included, on the port's logged draws through
  ``ValueKeys``.

Sizes: DQN-CartPole as the float32 slice (4 lanes, hidden 16, batch 8,
11 scan steps, 18 updates, a sync at 24); PER-DQN 4 lanes of 84x84x4
frames, batch 8, 20 scan steps (13 updates, a sync at 48); SAC 4 lanes
of Pendulum cut to 10 steps, hidden 32, batch 16, burn-in 24, 30 scan
steps (23 updates, one per scan step from 32 transitions on).

Tolerances. Counters, flags, ids and actions are exact; the ring's
observations as in the float32 slices. The bf16 forwards are bit-equal to
JAX's eager ones on the MLPs and within a few bf16 ulps on the Nature CNN
(``test_torch_precision.py``); the backwards round bf16 gradients
differently (``test_torch_bf16_cores.py``), and the differences add up
over the updates. Held: losses 2e-2 relative (PER-DQN's 5e-2: a sum of
eight Huber terms of TD errors that nearly cancel, through a CNN whose
outputs are a few bf16 ulps apart; measured 3.2%); priorities 2e-2
relative to the largest; the total change of every parameter tensor over
the run within 5% (L2, relative) of JAX's; SAC's ring actions within 2e-2
(its actions are samples of the bf16 policy). PER-DQN's changes within
15%: RMSprop with its eps of 1e-2 steps in proportion to the gradient, and
the bf16 CNN's gradients, summed over thousands of positions that nearly
cancel, carry bf16 noise that the updates compound. Measured, the port's
changes differ from eager JAX's by 1.1-10.9%; JAX's own jitted run (the
reference as the JAX package runs it) differs from its eager run by
8.5-31%, and its losses by up to 68%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict
from test_torch_actor_critic_modules import JaxSACPolicy, np_tree
from test_torch_cartpole_value_slice import (
    CAPACITY,
    DECAY,
    HIDDEN,
    LANES,
    LIMIT,
    SMALL,
    STEPS,
    port_state,
)
from test_torch_cartpole_value_slice import _run_jax as run_jax_runner
from test_torch_continuous_envs import LoggedDraws, ValueKeys, pendulum_keys, step_keys
from test_torch_slice import JaxNatureQ, KeyedDraws, _jax_reset_states
from test_torch_value_modules import Tape, install_tape

from pfrl_tpu import envs as jenvs
from pfrl_tpu import explorers as jexplorers
from pfrl_tpu import q_functions as jq
from pfrl_tpu.agents import DQNCore as JaxDQN
from pfrl_tpu.agents.soft_actor_critic import SACCore as JaxSAC
from pfrl_tpu.envs import AtariSim as JaxAtariSim
from pfrl_tpu.envs.vector_jax_env import VectorJaxEnv
from pfrl_tpu.replay import PrioritizedReplayBuffer as JaxPER
from pfrl_tpu.replay import ReplayBuffer as JaxReplay
from pfrl_tpu.replay import Transition as JaxTransition
from pfrl_tpu.utils import atari_phi as jax_atari_phi
from pfrl_tpu.utils.pytree import tree_where
from pfrl_tpu_torch import convert
from pfrl_tpu_torch import envs as tenvs
from pfrl_tpu_torch.agents import DQNCore, SACCore
from pfrl_tpu_torch.experiments import cartpole_value as cv
from pfrl_tpu_torch.experiments import mujoco_actor_critic as mac
from pfrl_tpu_torch.experiments.atari_per_dqn import make_dqn_runner
from pfrl_tpu_torch.experiments.atari_rainbow import make_rainbow_runner
from pfrl_tpu_torch.replay import PrioritizedReplayBuffer
from pfrl_tpu_torch.utils.precision import map_floating

torch.set_num_threads(1)

BF16 = torch.bfloat16
CHANGE_RTOL = 0.05


def assert_changes_agree(module, start, flax_tree, what, rtol=CHANGE_RTOL):
    """Every parameter tensor's total change over the run agrees with JAX's
    within ``rtol`` (L2, relative); the masters are float32."""
    want = convert.torch_arrays(module, np_tree(flax_tree))
    moved = 0
    for name, p in module.named_parameters():
        assert p.dtype == torch.float32, name
        change, jchange = p.detach().numpy() - start[name], want[name] - start[name]
        size = float(np.linalg.norm(jchange))
        assert float(np.linalg.norm(change - jchange)) <= rtol * size + 1e-7, f"{what} {name}"
        moved += size > 0
    assert moved, what


def snapshot(module):
    return {n: p.detach().clone().numpy() for n, p in module.named_parameters()}


def assert_moments_float32(opt_state):
    """Every floating tensor of an optimizer's state (Adam's ``mu`` and
    ``nu``, RMSprop's list of ``nu``) is float32."""
    dtypes = []
    map_floating(lambda x: dtypes.append(x.dtype) or x, opt_state)
    assert dtypes and set(dtypes) == {torch.float32}


# ------------------------------------------------------- DQN-CartPole-bf16
def _dqn_cartpole():
    env = tenvs.TimeLimit(tenvs.CartPole(device="cpu"), LIMIT)
    runner, _ = cv.make_dqn_cartpole_bf16_runner(env=env, device="cpu", hidden=HIDDEN, decay_steps=DECAY, **SMALL)
    jcore = JaxDQN(
        model=jq.FCStateQFunctionWithDiscreteAction(n_actions=2, n_hidden_channels=HIDDEN, n_hidden_layers=2),
        optimizer=optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3)),
        explorer=jexplorers.LinearDecayEpsilonGreedy(1.0, 0.05, DECAY, 2), gamma=0.99, compute_dtype=jnp.bfloat16,
    )
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((LANES, 4)))
    tape = Tape(cv.DQN_BF16_SEED)
    state = runner.init(cv.DQN_BF16_SEED, draws=tape)
    state.train_state = port_state(runner.core, jtrain)
    start = snapshot(state.train_state.model)
    state, metrics = runner.run_chunk(state, STEPS)
    with pytest.MonkeyPatch.context() as mp:
        install_tape(mp, tape)
        jrunner, jstate, jmetrics = run_jax_runner(jcore, jtrain, JaxReplay(CAPACITY, gamma=0.99, num_lanes=LANES),
                                                   tape)
    return runner, state, metrics, start, jstate, jmetrics


# ------------------------------------------------------ PER-DQN on AtariSim
ATARI_LANES, ATARI_BATCH, ATARI_CAPACITY, ATARI_STEPS, MEAN_EP_LEN = 4, 8, 8196, 20, 5
PER_CHANGE_RTOL = 0.15


def _per_dqn():
    runner = make_dqn_runner(num_envs=ATARI_LANES, capacity=ATARI_CAPACITY, replay_start_size=32,
                             target_update_interval=48, minibatch_size=ATARI_BATCH, prioritized=True,
                             compute_dtype=BF16, device="cpu")
    runner.env.env.mean_episode_len = MEAN_EP_LEN
    draws = KeyedDraws(0)
    state = runner.init(0, draws=draws)
    flax_params = np_tree(JaxNatureQ().init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4))))
    fresh = np_tree(optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2).init(flax_params))
    state.train_state = convert.dqn_state_from_flax(runner.core, flax_params, flax_params, fresh, device="cpu")
    start = snapshot(state.train_state.model)
    state, metrics = runner.run_chunk(state, ATARI_STEPS)
    return runner, state, metrics, start, _per_dqn_jax(draws.log, flax_params)


def _per_dqn_jax(log, params):
    """The recipe's scan step over the JAX package's module functions at
    bf16: the env, the ring and the PER sample jitted (they do not touch the
    network), the forwards and updates eager."""
    jenv = JaxAtariSim(6, MEAN_EP_LEN)
    explorer = jexplorers.LinearDecayEpsilonGreedy(1.0, 0.1, 1_000_000, 6)
    core = JaxDQN(model=JaxNatureQ(), optimizer=optax.rmsprop(2.5e-4, decay=0.95, eps=1e-2), explorer=explorer,
                  gamma=0.99, batch_accumulator="sum", phi=jax_atari_phi, compute_dtype=jnp.bfloat16)
    buf = JaxPER(ATARI_CAPACITY, alpha=0.6, beta0=0.4, gamma=0.99, num_lanes=ATARI_LANES, store_next_obs=False,
                 use_pallas=True, fused_dequant_scale=1.0 / 255.0)
    add, sample = jax.jit(buf.add, donate_argnums=0), jax.jit(buf.sample, static_argnums=2)
    feedback = jax.jit(buf.update_priorities)
    vstep, vobs = jax.jit(jax.vmap(jenv.step, in_axes=(None, 0, 0))), jax.jit(jax.vmap(jenv._obs))
    log = list(log)
    pop = lambda: log.pop(0)  # noqa: E731
    (_, seeds), (_, u) = pop(), pop()
    env_states = _jax_reset_states(seeds, u)
    obs = vobs(env_states)
    train = core.init(jax.random.PRNGKey(0), obs).replace(params=params, target_params=params)
    replay = buf.init(JaxTransition(obs=obs[0], action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()),
                                    next_obs=obs[0], terminated=jnp.zeros((), bool), done=jnp.zeros((), bool),
                                    extras=FrozenDict()))
    t, losses = 0, []
    for _ in range(ATARI_STEPS):
        with jax.disable_jit():
            greedy = core.action_value(train.params, jax.random.PRNGKey(0), obs).greedy_actions()
        (_, u), (_, random_actions) = pop(), pop()
        actions = jnp.where(jnp.asarray(u) < explorer.epsilon_at(jnp.int32(t)), random_actions, greedy)
        new, ts = vstep(None, env_states, actions)
        (_, seeds), (_, u) = pop(), pop()
        reset = _jax_reset_states(seeds, u)
        env_states = tree_where(ts.done, reset, new)
        next_obs = tree_where(ts.done, vobs(reset), ts.obs)
        replay = add(replay, JaxTransition(obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
                                           terminated=ts.terminated, done=ts.done, extras=FrozenDict()))
        t_prev, t = t, t + ATARI_LANES
        loss = 0.0
        if t >= 32:
            key, _ = pop()
            batch, replay = sample(replay, key, ATARI_BATCH)
            with jax.disable_jit():
                train, aux = core.update(train, key, batch)
            replay = feedback(replay, batch.indices, aux["errors"])
            loss = float(aux["loss"])
        losses.append(loss)
        if t // 48 != t_prev // 48:
            train = core.sync_target(train)
        obs = next_obs
    assert not log  # every draw the port made was replayed
    return t, replay, train, np.asarray(losses, np.float32)


# ------------------------------------------------------ SAC-Pendulum-bf16
SAC_LANES, SAC_HIDDEN, SAC_BATCH, SAC_START, SAC_CAPACITY, SAC_STEPS, SAC_LIMIT, BURNIN = 4, 32, 16, 32, 96, 30, 10, 24


def _sac_pendulum():
    tenv = tenvs.NormalizeActionSpace(tenvs.TimeLimit(tenvs.Pendulum(device="cpu"), SAC_LIMIT))
    runner = mac.make_sac_pendulum_bf16_runner(num_envs=SAC_LANES, capacity=SAC_CAPACITY, replay_start_size=SAC_START,
                                               minibatch_size=SAC_BATCH, hidden=SAC_HIDDEN, burnin_steps=BURNIN,
                                               env=tenv)
    jcore = JaxSAC(
        policy=JaxSACPolicy(act_dim=1, hidden=SAC_HIDDEN),
        q_func1=jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=SAC_HIDDEN),
        q_func2=jq.FCSAQFunction(n_hidden_layers=2, n_hidden_channels=SAC_HIDDEN),
        policy_optimizer=optax.adam(3e-4), q_func1_optimizer=optax.adam(3e-4), q_func2_optimizer=optax.adam(3e-4),
        gamma=0.99, entropy_target=-1.0, burnin_steps=BURNIN, compute_dtype=jnp.bfloat16,
        burnin_action_func=lambda rng, n: jax.random.uniform(rng, (n, 1), minval=-1.0, maxval=1.0),
    )
    jtrain = jcore.init(jax.random.PRNGKey(1), jnp.zeros((SAC_LANES, 3)), jnp.zeros((SAC_LANES, 1)))
    draws = LoggedDraws(0)
    state = runner.init(0, draws=draws)
    state.train_state = convert.sac_state_from_flax(runner.core, np_tree(jtrain), device="cpu")
    starts = {a: snapshot(getattr(state.train_state, a)) for a in ("policy", "q_func1", "q_func2")}
    state, metrics = runner.run_chunk(state, SAC_STEPS)
    kinds = [k for k, _ in draws.log]
    with pytest.MonkeyPatch.context() as mp:
        jax_run = _sac_jax(mp, jcore, jtrain, draws, runner.config.updates_per_step)
    return runner, state, metrics, starts, kinds, jax_run


def _sac_jax(monkeypatch, jcore, train, draws, updates_per_step):
    """``OffPolicyRunner._one_step``'s order over the JAX package's vector
    env, ring and core at bf16; ``ValueKeys``: a key is the values."""
    ValueKeys(monkeypatch)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, minval, maxval, dtype=jnp.int32: key.astype(dtype))
    jvec = VectorJaxEnv(jenvs.NormalizeActionSpace(jenvs.TimeLimit(jenvs.Pendulum(), SAC_LIMIT)), SAC_LANES)
    buf = JaxReplay(SAC_CAPACITY, gamma=0.99, num_lanes=SAC_LANES)
    vstep, add = jax.jit(jvec.step), jax.jit(buf.add)
    sample_indices, gather = jax.jit(buf.sample_indices, static_argnums=2), jax.jit(buf.gather)
    env_states, obs = jvec.reset(pendulum_keys(draws, SAC_LANES))
    replay = buf.init(JaxTransition(obs=obs[0], action=jnp.zeros((1,)), reward=jnp.zeros(()), next_obs=obs[0],
                                    terminated=jnp.zeros((), bool), done=jnp.zeros((), bool), extras=FrozenDict()))
    t, losses = 0, []
    zeros = jnp.zeros((SAC_LANES, 1))
    for _ in range(SAC_STEPS):
        (eps,) = draws.take("normal")
        burn = draws.take("uniform")[0].reshape(SAC_LANES, 1) if t < BURNIN else zeros
        with jax.disable_jit():
            actions = jcore.select_action(train, jnp.stack([jnp.asarray(eps.reshape(SAC_LANES, 1)), jnp.asarray(burn)]),
                                          obs, jnp.int32(t), True)
        env_states, vec = vstep(step_keys(pendulum_keys(draws, SAC_LANES)), env_states, actions)
        ts = vec.ts
        replay = add(replay, JaxTransition(obs=obs, action=actions, reward=ts.reward, next_obs=ts.obs,
                                           terminated=ts.terminated, done=ts.done, extras=FrozenDict()))
        t += SAC_LANES
        loss = 0.0
        if t >= SAC_START:
            (id_values,) = draws.take("randint_below")
            ids = sample_indices(replay, jnp.asarray(id_values), updates_per_step * SAC_BATCH)
            for row in ids.reshape(updates_per_step, SAC_BATCH):
                key = jnp.stack([jnp.asarray(e.reshape(SAC_BATCH, 1)) for e in draws.take("normal", "normal")])
                with jax.disable_jit():
                    train, aux = jcore.update(train, key, gather(replay, row))
                loss = float(aux["loss"])
        losses.append(loss)
        obs = vec.obs
    assert not draws.log  # every draw the port made was replayed
    return t, replay, train, np.asarray(losses, np.float32)


@pytest.fixture(scope="module")
def runs():
    return {"dqn_cartpole": _dqn_cartpole(), "per_dqn": _per_dqn(), "sac_pendulum": _sac_pendulum()}


# ------------------------------------------------------------------ tests
def test_dqn_cartpole_bf16_matches_the_jax_runner(runs):
    runner, state, metrics, start, jstate, jmetrics = runs["dqn_cartpole"]
    assert runner.core.compute_dtype is BF16 and isinstance(runner.core, DQNCore)
    assert state.t == int(jstate.t) == STEPS * LANES
    ts, jts = state.train_state, jstate.train_state
    assert ts.n_updates == int(jts.n_updates) == 18
    ring, jring = state.replay_state, jstate.replay_state
    for name in ("action", "terminated", "done"):
        np.testing.assert_array_equal(ring.storage[name].numpy(), np.asarray(getattr(jring.storage, name)), name)
    np.testing.assert_allclose(ring.storage["obs"].numpy(), np.asarray(jring.storage.obs), rtol=0, atol=1e-5)
    assert (ring.storage["done"] & ~ring.storage["terminated"]).any()
    np.testing.assert_allclose(metrics["loss"].numpy(), np.asarray(jmetrics["loss"]), rtol=2e-2, atol=1e-7)
    np.testing.assert_array_equal(metrics["done_count"].numpy(), np.asarray(jmetrics["done_count"]))
    assert_changes_agree(ts.model, start, jts.params, "online")
    assert_moments_float32(ts.opt_state)
    target = dict(ts.target_model.named_parameters())
    assert all(not torch.equal(p, target[n]) for n, p in ts.model.named_parameters() if p.dim() == 2)


def test_per_dqn_atarisim_bf16_matches_the_jax_module_loop(runs):
    runner, state, metrics, start, (t, replay, train, losses) = runs["per_dqn"]
    assert runner.core.compute_dtype is BF16 and isinstance(runner.buffer, PrioritizedReplayBuffer)
    assert state.t == t == ATARI_STEPS * ATARI_LANES
    assert state.train_state.n_updates == int(train.n_updates) == 13
    tr, jr = state.replay_state, replay
    for name in ("obs", "action", "done"):
        np.testing.assert_array_equal(tr.base.storage[name].numpy(), np.asarray(getattr(jr.base.storage, name)), name)
    top = float(np.asarray(jr.tree).max())
    np.testing.assert_allclose(tr.tree.numpy(), np.asarray(jr.tree), rtol=0, atol=2e-2 * top)
    np.testing.assert_allclose(float(tr.max_priority), float(jr.max_priority), rtol=2e-2)
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=5e-2, atol=1e-6)
    assert (losses[-13:] > 0).all()
    assert_changes_agree(state.train_state.model, start, train.params, "per-dqn", rtol=PER_CHANGE_RTOL)
    assert_moments_float32(state.train_state.opt_state)


def test_sac_pendulum_bf16_matches_the_jax_module_loop(runs):
    runner, state, metrics, starts, kinds, (t, replay, train, losses) = runs["sac_pendulum"]
    core = runner.core
    assert isinstance(core, SACCore) and core.compute_dtype is BF16 and core.burnin_steps == BURNIN
    assert state.t == t == SAC_STEPS * SAC_LANES
    ts = state.train_state
    assert ts.n_updates == int(train.n_updates) == 23
    assert kinds.count("uniform") == 2 * (SAC_STEPS + 1) + BURNIN // SAC_LANES  # resets, burn-in
    storage = state.replay_state.storage
    for name in ("terminated", "done"):
        np.testing.assert_array_equal(storage[name].numpy(), np.asarray(getattr(replay.storage, name)), name)
    burn = BURNIN  # rows written while burning in hold the uniform draws
    np.testing.assert_allclose(storage["action"].numpy()[:burn], np.asarray(replay.storage.action)[:burn], atol=1e-6)
    np.testing.assert_allclose(storage["action"].numpy(), np.asarray(replay.storage.action), rtol=0, atol=2e-2)
    np.testing.assert_allclose(metrics["loss"].numpy(), losses, rtol=2e-2, atol=1e-6)
    for attr, field in (("policy", "policy_params"), ("q_func1", "q1_params"), ("q_func2", "q2_params")):
        assert_changes_agree(getattr(ts, attr), starts[attr], getattr(train, field), f"sac {attr}")
    for attr in ("policy_opt_state", "q1_opt_state", "q2_opt_state", "temperature_opt_state"):
        assert_moments_float32(getattr(ts, attr))
    np.testing.assert_allclose(float(ts.log_temperature.detach()), float(train.log_temperature), rtol=2e-2)


def test_bf16_recipes_hold_their_sources_and_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (cv.make_dqn_cartpole_bf16_runner, mac.make_sac_pendulum_bf16_runner,
                 lambda: make_dqn_runner(prioritized=True, compute_dtype=BF16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    runner, loop = cv.make_dqn_cartpole_bf16_runner(device="cpu", capacity=1_024)
    fp32, _ = cv.make_dqn_cartpole_runner(device="cpu", capacity=1_024)
    assert runner.core.compute_dtype is BF16 and fp32.core.compute_dtype is None and cv.DQN_BF16_SEED == 3
    assert runner.config == fp32.config and loop.max_steps == 501
    sac = mac.make_sac_pendulum_bf16_runner(device="cpu", capacity=1_024)
    cfg, core = sac.config, sac.core
    assert (cfg.num_envs, cfg.replay_start_size, cfg.update_interval, cfg.minibatch_size) == (16, 1_000, 4, 128)
    assert core.compute_dtype is BF16 and core.burnin_steps == 1_000 and core.entropy_target == -1.0
    assert [tuple(layer.weight.shape) for layer in core.policy.mlp.layers] == [(256, 3), (256, 256), (2, 256)]
    assert [tuple(layer.weight.shape) for layer in core.q_func1.mlp.layers] == [(256, 4), (256, 256), (1, 256)]
    assert core.policy_optimizer.learning_rate == core.temperature_optimizer.learning_rate == 3e-4
    assert isinstance(sac.env.env, tenvs.NormalizeActionSpace) and sac.env.env.env.max_steps == 200
    assert mac.make_sac_pendulum_runner(device="cpu", capacity=1_024).core.compute_dtype is None
    per = make_dqn_runner(num_envs=4, capacity=64, prioritized=True, compute_dtype=BF16, device="cpu")
    assert per.core.compute_dtype is BF16 and isinstance(per.buffer, PrioritizedReplayBuffer)
    rainbow = make_rainbow_runner(capacity=1_024, compute_dtype=BF16, device="cpu")
    assert rainbow.core.compute_dtype is BF16
